"""The port's sharded probe table (``kaarme_tpu_torch/parallel/
sharded.py::ShardedKmerCounter``) on CPU shards, whose K3 and T1 run
their plain versions: golden counts at k = 13 and 51 on 1, 2 and 8
shards with both output modes, the JAX package's ``ShardedKmerCounter``
on a 4-device mesh (each shard's occupied (key row, count) pairs, the
slot layout, ``find``, the batch and growth counters), skewed input
routed to one owner without drops, growth, and checkpoints across shard
counts and across the packages.  Every quantity is an integer:
tolerance 0."""

import numpy as np
import pytest
import torch

from kaarme_tpu.parallel.sharded import (ShardedCounterConfig as RefConfig,
                                         ShardedKmerCounter as RefCounter,
                                         make_mesh as ref_mesh)
from kaarme_tpu.utils import codec
from kaarme_tpu_torch.parallel import ShardedCounterConfig, ShardedKmerCounter, make_mesh

JAX_CFG = dict(k=13, min_slots=1 << 9, tile=128, batch_tiles=8, min_abundance=1, max_probes=8)



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite runs several worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(n, seed, p_sep=0.005):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < p_sep] = 4
    return codes


def _fasta_codes(seed, n=4000):
    """A two-record FASTA with wrapped lines, lowercase, an N and a
    repeated stretch."""
    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
    seq = seq[:500] + seq[500:900].lower() + "N" + seq[901:2500] + seq[100:600] + seq[2500:]
    wrap = lambda s: "\n".join(s[i:i + 60] for i in range(0, len(s), 60))
    text = ">a\n" + wrap(seq[:2000]) + "\n>b two\n" + wrap(seq[2000:]) + "\n"
    return codec.encode_fasta(text.encode())[0]


def _want(golden, mode, abu):
    clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
    return {s: clip(c) for s, c in golden.items() if clip(c) >= abu}


def _port(ndev, **kw):
    return ShardedKmerCounter(ShardedCounterConfig(**kw), make_mesh(ndev, "cpu"))


def _shard_pairs(tk, cn, ndev):
    """Per shard: sorted (key row, count) pairs of its occupied slots."""
    per = tk.shape[0] // ndev
    out = []
    for d in range(ndev):
        t, c = tk[d * per: (d + 1) * per], cn[d * per: (d + 1) * per]
        occ = c > 0
        out.append(sorted(zip(map(tuple, t[occ].tolist()), c[occ].tolist())))
    return out


@pytest.mark.parametrize("k,ndev", [(13, 1), (13, 2), (13, 8), (51, 1), (51, 2), (51, 8)])
def test_sharded_table_golden(k, ndev, tmp_path):
    codes = _fasta_codes(k * ndev)
    c = _port(ndev, k=k, min_slots=1 << 13, tile=256, batch_tiles=8,
              min_abundance=1).count_codes(codes)
    golden = codec.golden_count(codes, k)
    for mode, abu in ((0, 1), (2, 2)):
        c.cfg.mode, c.cfg.min_abundance = mode, abu
        assert c.as_dict() == _want(golden, mode, abu)
    out = tmp_path / "o.txt"
    n = c.write_output(str(out))
    got = {ln.split()[0]: int(ln.split()[1]) for ln in out.read_text().splitlines()}
    assert n == len(got) and got == _want(golden, 2, 2)
    some = sorted(golden)[:10]
    assert c.find(some) == [golden[s] for s in some]
    assert c.find([codec.revcomp(s) for s in some]) == [golden[s] for s in some]
    assert c.find(["A" * (k - 1)]) == [-1]
    assert c.occupancy() == (len(golden), 1 << 13)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX sharded table count on 4 devices that outgrows its 2^9
    slots, checkpointed mid-stream."""
    codes = _codes(20000, 7)
    half = 9000
    path = str(tmp_path_factory.mktemp("jax") / "ref.npz")
    ref = RefCounter(RefConfig(**JAX_CFG), ref_mesh(4))
    ref.add_codes(codes[:half])
    ref.save(path)
    ref.add_codes(codes[half:])
    ref.finish()
    golden = codec.golden_count(codes, 13)
    queries = sorted(golden)[:40] + ["ACGTACGTACGTA", "A" * 12]
    return (codes, half, path, np.asarray(ref.tkeys), np.asarray(ref.counts),
            ref.find(queries), queries, dict(ref.stats))


def test_sharded_table_matches_jax(jax_run, tmp_path):
    codes, half, _, tk, cn, found, queries, stats = jax_run
    c = _port(4, **JAX_CFG)
    c.add_codes(codes[:half])
    c.save(str(tmp_path / "port.npz"))
    c.add_codes(codes[half:])
    c.finish()
    ptk, pcn = c._host_table()
    assert _shard_pairs(ptk, pcn, 4) == _shard_pairs(tk, cn, 4)
    # the plain insert places every record in the JAX slot (same order)
    assert np.array_equal(ptk, tk) and np.array_equal(pcn, cn)
    assert c.find(queries) == found
    for key in ("batches", "windows_processed", "grow_events"):
        assert c.stats[key] == stats[key], key
    assert stats["grow_events"] >= 1


def test_checkpoint_from_jax_resumes_in_port(jax_run):
    codes, half, path, *_ = jax_run
    c = ShardedKmerCounter.load(path, ShardedCounterConfig(**JAX_CFG), make_mesh(2, "cpu"))
    c.add_codes(codes[half:])
    c.finish()
    assert c.as_dict() == codec.golden_count(codes, 13)


def test_checkpoint_from_port_resumes_in_jax(tmp_path):
    codes = _codes(9000, 8)
    half = 4000
    path = str(tmp_path / "port.npz")
    c = _port(8, **JAX_CFG)
    c.add_codes(codes[:half])
    c.save(path)
    ref = RefCounter.load(path, RefConfig(**JAX_CFG), ref_mesh(2))
    ref.add_codes(codes[half:])
    ref.finish()
    assert ref.as_dict() == codec.golden_count(codes, 13)


def test_checkpoint_across_shard_counts(tmp_path):
    """Save on 8 shards (the unprocessed tail included), load on 4 into a
    smaller table (restore grows it) and continue: golden; the live
    counter continues exactly too."""
    codes = _codes(12000, 9)
    half = 6100
    path = str(tmp_path / "ck.npz")
    cfg = dict(k=13, min_slots=1 << 12, tile=128, batch_tiles=8, min_abundance=1)
    c = _port(8, **cfg)
    c.add_codes(codes[:half])
    c.save(path)
    assert str(np.load(path)["kind"]) == "sharded_table"
    r = ShardedKmerCounter.load(path, ShardedCounterConfig(**dict(cfg, min_slots=1 << 8,
                                                                  max_probes=8)),
                                make_mesh(4, "cpu"))
    assert r.stats["grow_events"] >= 1
    r.add_codes(codes[half:])
    r.finish()
    golden = codec.golden_count(codes, 13)
    assert r.as_dict() == golden
    c.add_codes(codes[half:])
    c.finish()
    assert c.as_dict() == golden


def test_skewed_input_one_owner_no_drops():
    """Every window the same key: all records route to one shard."""
    codes = codec.encode_plain(b"A" * 3000)
    c = _port(8, k=9, min_slots=1 << 12, tile=64, batch_tiles=8, min_abundance=1)
    c.count_codes(codes)
    assert c.as_dict() == {"A" * 9: 3000 - 8}
    assert sum(int((cn > 0).sum()) > 0 for _, cn in c.tables) == 1


def test_growth_and_config_rules():
    codes = _codes(30000, 3)
    c = _port(2, k=9, min_slots=1 << 8, tile=128, batch_tiles=8, min_abundance=1,
              max_probes=8).count_codes(codes)
    assert c.stats["grow_events"] >= 1
    assert c.as_dict() == codec.golden_count(codes, 9)
    with pytest.raises(ValueError, match="multiple of the device count"):
        _port(8, k=9, batch_tiles=4)
