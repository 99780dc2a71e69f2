"""The port's sharded super-k-mer counter (``kaarme_tpu_torch/parallel/
sharded_skm.py``) on CPU shards, whose kernels (K5, K2) run their plain
versions: golden counts at k = 17, 31, 51 on 1, 2 and 8 shards with both
output modes, the JAX package's ``ShardedSkmCounter`` on a 4-device mesh
record for record (each shard's k-mer records after the exchange, the
dump, the round, growth and S-ladder counters at a small slot budget),
store growth, and checkpoints across shard counts and across the
packages.  Every quantity is an integer: tolerance 0."""

import numpy as np
import pytest
import torch

from kaarme_tpu.parallel.sharded import make_mesh as ref_mesh
from kaarme_tpu.parallel.sharded_skm import (ShardedSkmConfig as RefConfig,
                                             ShardedSkmCounter as RefCounter)
from kaarme_tpu.utils import codec
from kaarme_tpu_torch.parallel import ShardedSkmConfig, ShardedSkmCounter, make_mesh

JAX_CFG = dict(k=31, batch_windows=1 << 10, prefix_cap=1 << 8, skm_slots=8, min_abundance=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite runs several worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(seed, glen=900, n_reads=250, read_len=100):
    """Reads of a random genome, one separator after each, so k-mers
    repeat (coverage)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    parts = []
    for _ in range(n_reads):
        s = int(rng.integers(0, glen - read_len))
        parts += [genome[s: s + read_len], np.full(1, 4, np.uint8)]
    return np.concatenate(parts)


def _fasta_codes(seed):
    """The reads as a two-record FASTA with wrapped lines, lowercase
    reads and an N."""
    reads = "".join("ACGTN"[c] for c in _reads(seed, n_reads=60)).split("N")
    reads = [r.lower() if i % 5 == 1 else r for i, r in enumerate(reads) if r]
    reads[7] = reads[7][:40] + "N" + reads[7][41:]
    body = lambda rs: "\n".join(rs)
    text = ">r1\n" + body(reads[:30]) + "\n>r2 second\n" + body(reads[30:]) + "\n"
    return codec.encode_fasta(text.encode())[0]


def _want(golden, mode, abu):
    clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
    return {s: clip(c) for s, c in golden.items() if clip(c) >= abu}


def _port(ndev, **kw):
    return ShardedSkmCounter(ShardedSkmConfig(**kw), make_mesh(ndev, "cpu"))


@pytest.mark.parametrize("k,ndev,slots", [
    (17, 1, 96), (17, 2, 8), (17, 8, 96), (31, 1, 8), (31, 2, 96), (31, 8, 8),
    (51, 1, 96), (51, 2, 8), (51, 8, 96)])
def test_sharded_skm_golden(k, ndev, slots, tmp_path):
    codes = _fasta_codes(k + ndev)
    c = _port(ndev, k=k, batch_windows=1 << 10, prefix_cap=1 << 10, skm_slots=slots,
              min_abundance=1).count_codes(codes)
    golden = codec.golden_count(codes, k)
    for mode, abu in ((0, 1), (2, 2)):
        c.cfg.mode, c.cfg.min_abundance = mode, abu
        assert c.as_dict() == _want(golden, mode, abu)
    out = tmp_path / "o.txt"
    n = c.write_output(str(out))
    got = {ln.split()[0]: int(ln.split()[1]) for ln in out.read_text().splitlines()}
    assert n == len(got) and got == _want(golden, 2, 2)
    some = sorted(golden)[:5]
    assert c.find(some) == [golden[s] for s in some]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX sharded skm count on 4 devices (S=8: the ladder replays;
    a 2^8-row store: capacity growth), checkpointed mid-stream."""
    codes = np.concatenate([_reads(5, n_reads=120),
                            np.random.default_rng(9).integers(0, 4, 6000).astype(np.uint8)])
    half = int(np.flatnonzero(codes >= 4)[60]) + 1
    path = str(tmp_path_factory.mktemp("jax") / "ref.npz")
    ref = RefCounter(RefConfig(rows=1 << 5, **JAX_CFG), ref_mesh(4))
    ref.add_codes(codes[:half])
    ref.save(path)
    ref.add_codes(codes[half:])
    ref.finish()
    dump = ref.dump()
    w = codec.words_per_kmer(31)
    cols = [np.asarray(c) for c in ref.prefix]
    shards = []
    for d in range(4):
        live = cols[-1][d] > 0
        shards.append((np.stack([cols[j][d][live] for j in range(w)], 1),
                       cols[-1][d][live].astype(np.int64)))
    return codes, half, path, dump, shards, dict(ref.stats)


def test_sharded_skm_matches_jax(jax_run, tmp_path):
    codes, half, _, dump, shards, stats = jax_run
    c = _port(4, **JAX_CFG)
    c.add_codes(codes[:half])
    c.save(str(tmp_path / "port.npz"))
    c.add_codes(codes[half:])
    c.finish()
    got = c.dump()
    assert np.array_equal(got[0], dump[0]) and np.array_equal(got[1], dump[1])
    for (pk, pc), (rk, rc) in zip(c.shard_dumps(), shards):
        assert np.array_equal(pk, rk) and np.array_equal(pc, rc)
    for key in ("batches", "windows_processed", "grow_events", "compactions",
                "slot_grow_events"):
        assert c.stats[key] == stats[key], key
    assert stats["slot_grow_events"] >= 1 and stats["grow_events"] >= 1


def test_checkpoint_from_jax_resumes_in_port(jax_run):
    codes, half, path, _, _, _ = jax_run
    c = ShardedSkmCounter.load(path, ShardedSkmConfig(**JAX_CFG), make_mesh(8, "cpu"))
    c.add_codes(codes[half:])
    c.finish()
    assert c.as_dict() == codec.golden_count(codes, 31)


def test_checkpoint_from_port_resumes_in_jax(tmp_path):
    codes = _reads(6, n_reads=80)
    half = int(np.flatnonzero(codes >= 4)[40]) + 1
    path = str(tmp_path / "port.npz")
    c = _port(8, **JAX_CFG)
    c.add_codes(codes[:half])
    c.save(path)
    ref = RefCounter.load(path, RefConfig(rows=1 << 5, **JAX_CFG), ref_mesh(2))
    ref.add_codes(codes[half:])
    ref.finish()
    assert ref.as_dict() == codec.golden_count(codes, 31)


def test_checkpoint_across_shard_counts(tmp_path):
    """Run rows saved on 8 shards load on 4 (``kind="sharded_sort"``, the
    config from the checkpoint when none is given) and continue: golden."""
    codes = _reads(13, glen=800, n_reads=200, read_len=90)
    half = int(np.flatnonzero(codes >= 4)[100]) + 1
    c = _port(8, k=31, batch_windows=1 << 10, prefix_cap=1 << 10, min_abundance=1)
    c.count_codes(codes[:half])
    path = str(tmp_path / "ck.npz")
    c.save(path)
    assert str(np.load(path)["kind"]) == "sharded_sort"
    r = ShardedSkmCounter.load(path, ShardedSkmConfig(k=31, batch_windows=1 << 10,
                                                      min_abundance=1), make_mesh(4, "cpu"))
    r.count_codes(codes[half:])
    assert r.as_dict() == codec.golden_count(codes, 31)
    d = ShardedSkmCounter.load(path, devices=make_mesh(2, "cpu"))
    assert isinstance(d.cfg, ShardedSkmConfig) and d.cfg.min_abundance == 1
    assert d.stats["windows_processed"] == c.stats["windows_processed"]


def test_store_growth_and_finalize_once():
    codes = np.random.default_rng(11).integers(0, 4, 30000).astype(np.uint8)
    c = _port(2, k=17, batch_windows=1 << 10, prefix_cap=1 << 8, min_abundance=1)
    c.count_codes(codes)
    assert c.stats["grow_events"] >= 1
    assert c.as_dict() == codec.golden_count(codes, 17)
    keys = c.dump()[0]
    assert keys.shape[1] == codec.words_per_kmer(17)
    with pytest.raises(RuntimeError):
        c.add_codes(codes[:100])
