"""The port's sharded sort counter (``kaarme_tpu_torch/parallel/
sharded_sort.py``) on CPU shards, whose kernels run their plain
versions: golden counts at k = 13, 31, 51 on 1, 2 and 8 shards (both
compactors, both output modes), the JAX package's ``ShardedSortCounter``
on a 4-device mesh record for record (each shard's records after the
exchange, the dump, the round and growth counters), poly-A counts whose
per-shard parts sum past 2^20, checkpoints across shard counts and
across the packages, the record exchange, the routing hash and the
device list.  Every quantity is an integer: tolerance 0."""

import numpy as np
import pytest
import torch

from kaarme_tpu.ops.hashing import hash_words_np as ref_hash_words_np
from kaarme_tpu.parallel.sharded import make_mesh as ref_mesh
from kaarme_tpu.parallel.sharded_sort import (ShardedSortConfig as RefConfig,
                                              ShardedSortCounter as RefCounter)
from kaarme_tpu.utils import codec
from kaarme_tpu_torch.ops.hashing import hash_words, hash_words_np
from kaarme_tpu_torch.parallel import ShardedSortConfig, ShardedSortCounter, make_mesh
from kaarme_tpu_torch.parallel.exchange import exchange, owner_by_hash

JAX_CFG = dict(k=13, batch_windows=1 << 10, prefix_cap=1 << 9, min_abundance=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite runs several worker processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fasta_codes(seed, n=6000):
    """Codes of a two-record FASTA with wrapped lines, a lowercase
    stretch, an N and a repeated stretch (so counts exceed one)."""
    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
    seq = seq[:700] + seq[700:1500].lower() + "N" + seq[1501:3000] + seq[200:900] + seq[3000:]
    half = len(seq) // 2
    wrap = lambda s: "\n".join(s[i:i + 70] for i in range(0, len(s), 70))
    text = ">r1 first\n" + wrap(seq[:half]) + "\n>r2\n" + wrap(seq[half:]) + "\n"
    return codec.encode_fasta(text.encode())[0]


def _stream(seed, n, p_sep=0.01):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < p_sep] = 4
    return codes


def _want(golden, mode, abu):
    clip = (lambda c: c & 0xFFFF) if mode == 0 else (lambda c: min(c, 16383))
    return {s: clip(c) for s, c in golden.items() if clip(c) >= abu}


def _port(ndev, **kw):
    return ShardedSortCounter(ShardedSortConfig(**kw), make_mesh(ndev, "cpu"))


@pytest.mark.parametrize("k,ndev,compactor", [
    (13, 1, "auto"), (13, 2, "merge"), (13, 8, "auto"),
    (31, 1, "merge"), (31, 2, "auto"), (31, 8, "merge"),
    (51, 1, "auto"), (51, 2, "merge"), (51, 8, "auto")])
def test_sharded_sort_golden(k, ndev, compactor, tmp_path):
    codes = _fasta_codes(k + ndev)
    c = _port(ndev, k=k, batch_windows=1 << 9, prefix_cap=1 << 10, compactor=compactor,
              min_abundance=1).count_codes(codes)
    golden = codec.golden_count(codes, k)
    for mode, abu in ((0, 1), (2, 2)):
        c.cfg.mode, c.cfg.min_abundance = mode, abu
        assert c.as_dict() == _want(golden, mode, abu)
    out = tmp_path / "o.txt"
    assert c.write_output(str(out)) == len(_want(golden, 2, 2))
    got = {ln.split()[0]: int(ln.split()[1]) for ln in out.read_text().splitlines()}
    assert got == _want(golden, 2, 2)
    some = sorted(golden)[:8]
    assert c.find(some + ["A" * (k - 1)]) == [min(golden[s], 16383) for s in some] + [-1]
    # every shard holds the keys it owns, sorted, one record each
    w = codec.words_per_kmer(k)
    for d, (keys, cnt) in enumerate(c.shard_dumps()):
        cols = tuple(torch.from_numpy(keys[:, j].astype(np.int64)) for j in range(w))
        assert bool((owner_by_hash(cols, ndev) == d).all())
        assert (np.lexsort(keys.T[::-1]) == np.arange(len(keys))).all()


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX sharded count on 4 devices: a checkpoint after the first
    half (JAX-written), then the rest; its per-shard records and stats."""
    codes = _stream(7, 30000)
    half = 13000
    path = str(tmp_path_factory.mktemp("jax") / "ref.npz")
    ref = RefCounter(RefConfig(rows=1 << 5, **JAX_CFG), ref_mesh(4))
    ref.add_codes(codes[:half])
    ref.save(path)
    ref.add_codes(codes[half:])
    ref.finish()
    dump = ref.dump()
    w = codec.words_per_kmer(13)
    cols = [np.asarray(c) for c in ref.prefix]
    shards = []
    for d in range(4):
        live = cols[-1][d] > 0
        shards.append((np.stack([cols[j][d][live] for j in range(w)], 1),
                       cols[-1][d][live].astype(np.int64)))
    return codes, half, path, dump, shards, dict(ref.stats)


def test_sharded_sort_matches_jax(jax_run, tmp_path):
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
    for key in ("batches", "windows_processed", "grow_events", "compactions"):
        assert c.stats[key] == stats[key], key
    assert stats["grow_events"] >= 1 and c.stats["replayed_rounds"] >= 1


def test_checkpoint_from_jax_resumes_in_port(jax_run):
    codes, half, path, _, _, _ = jax_run
    c = ShardedSortCounter.load(path, ShardedSortConfig(**JAX_CFG), make_mesh(2, "cpu"))
    c.add_codes(codes[half:])
    c.finish()
    assert c.as_dict() == codec.golden_count(codes, 13)


def test_checkpoint_from_port_resumes_in_jax(tmp_path):
    codes = _stream(8, 9000)
    half = 5000
    path = str(tmp_path / "port.npz")
    c = _port(8, **JAX_CFG)
    c.add_codes(codes[:half])
    c.save(path)
    ref = RefCounter.load(path, RefConfig(rows=1 << 5, **JAX_CFG), ref_mesh(2))
    ref.add_codes(codes[half:])
    ref.finish()
    assert ref.as_dict() == codec.golden_count(codes, 13)


def test_checkpoint_across_shard_counts(tmp_path):
    """Save on 8 shards mid-stream (duplicate partial counts on several
    shards), load on 4 and 1, continue: golden.  The live counter is
    left untouched and continues too; a finalized one cannot save."""
    rng = np.random.default_rng(21)
    base = rng.integers(0, 4, 500).astype(np.uint8)
    codes = np.tile(np.concatenate([base, [4]]), 30)      # heavy duplication
    half = 7000
    path = str(tmp_path / "ck.npz")
    c = _port(8, k=17, batch_windows=1 << 9, prefix_cap=1 << 10, min_abundance=1)
    c.add_codes(codes[:half])
    c.save(path)
    golden = codec.golden_count(codes, 17)
    for ndev, compactor in ((4, "merge"), (1, "auto")):
        r = ShardedSortCounter.load(path, ShardedSortConfig(
            k=17, batch_windows=1 << 9, prefix_cap=1 << 10, min_abundance=1,
            compactor=compactor), make_mesh(ndev, "cpu"))
        r.add_codes(codes[half:])
        r.finish()
        assert r.as_dict() == golden
    c.add_codes(codes[half:])
    c.finish()
    assert c.as_dict() == golden
    with pytest.raises(RuntimeError):
        c.save(path)
    with pytest.raises(RuntimeError):
        c.add_codes(codes[:10])


def test_poly_a_counts_past_2_20():
    """One key in every window: four shards each hold a partial count
    below 2^20 whose sum passes it; the exchange's clamped sum keeps
    both output contracts (uint16 wrap, 14-bit saturation)."""
    n = (1 << 20) + 70000
    codes = np.zeros(n, np.uint8)
    c = _port(4, k=13, batch_windows=1 << 16, prefix_cap=1 << 12, min_abundance=1)
    c.count_codes(codes)
    parts = [int(p[-1][:nd].sum()) for p, nd in zip(c.prefix, c._nd)]
    assert max(parts) < 1 << 20 < sum(parts)
    windows = n - 12
    assert c.as_dict() == {"A" * 13: 16383}
    c.cfg.mode = 0
    assert c.as_dict() == {"A" * 13: windows & 0xFFFF}
    assert c.find("T" * 13) == [windows & 0xFFFF]


def test_hash_words_np_matches_jax():
    rng = np.random.default_rng(3)
    for w in (1, 4, 13):
        words = [rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
                 for _ in range(w)]
        want = ref_hash_words_np(words)
        assert np.array_equal(hash_words_np(words), want)
        port = hash_words(tuple(torch.from_numpy(x.astype(np.int64)) for x in words))
        assert np.array_equal(port.numpy().astype(np.uint32), want)


def test_exchange_routes_live_records_in_source_order():
    rng = np.random.default_rng(5)
    devs = make_mesh(4, "cpu")
    cols, owners = [], []
    for s in range(4):
        n = int(rng.integers(0, 50))
        vals = torch.from_numpy(rng.integers(0, 1000, n)) + 1000 * s
        own = torch.from_numpy(rng.integers(0, 4, n))
        cols.append((vals, own.clone()))
        owners.append(own)
    recv = exchange(cols, owners, devs)
    for d, (vals, own) in enumerate(recv):
        assert (own == d).all()
        want = torch.cat([c[0][o == d] for c, o in zip(cols, owners)])
        assert torch.equal(vals, want)
    with pytest.raises(ValueError):
        exchange(cols[:2], owners[:2], devs)


def test_make_mesh_rules(monkeypatch):
    assert make_mesh(8, "cpu") == (torch.device("cpu"),) * 8
    assert make_mesh(0, "cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="power of two"):
        make_mesh(3, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        ShardedSortCounter(ShardedSortConfig(k=13), ("cpu",) * 3)
    # no CPU fallback for "cuda": too few cards is an error
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh(1) == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        make_mesh(2, "cuda")
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        make_mesh()
