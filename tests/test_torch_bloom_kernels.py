"""B1 and B2's plain versions (``kaarme_tpu_torch/ops/cuda_bloom.py``) held
bit for bit to the JAX package on JAX-CPU: the pass-1 insert
(``bloom_insert_plain``, and ``bloom_insert`` on CPU tensors) against the
validity mask, ``hashing.hash_words64`` and ``ops/bloom.insert_batch`` of
``kaarme_tpu``, batch after batch (equal BF1 and BF2 words, equal
``new_in_first`` / ``new_in_second``), and the pass-2 gate
(``bloom_gate_plain``, ``bloom_gate``) against
``kaarme_tpu.ops.sortcount._bloom_miss_mask`` ORed into the keys.  Keys
are made with numpy from a seed: in-batch doubletons and triples, keys
held in BF1 but not BF2, invalid (all-ones) keys, W = 1, 2, 4 and 13,
filters of 2^10 bits (roots sharing words) and 2^14 bits, and key
columns as K3 lays them out (views of one ``(W, N)`` buffer), as
separate tensors, and as the rows of an ``(N, W)`` buffer.  Every
quantity is an integer, so the tolerance is 0."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaarme_tpu.ops import bloom as ref_bloom
from kaarme_tpu.ops import hashing as ref_hashing
from kaarme_tpu.ops import sortcount as ref_sortcount
from kaarme_tpu_torch.ops import bloom, cuda_bloom, sortcount

HFN = 7
N = 600


def _words(bf):
    return bf.numpy().view(np.uint32)


def _columns(rows: np.ndarray, layout: str):
    """(N, W) uint32 key rows as int32 key columns laid out as ``layout``."""
    r = rows.view(np.int32)
    if layout == "k3":
        return tuple(torch.from_numpy(np.ascontiguousarray(r.T)).unbind(0))
    if layout == "separate":
        return tuple(torch.from_numpy(r[:, w].copy()) for w in range(r.shape[1]))
    return tuple(torch.from_numpy(r.copy()).unbind(1))


def _batches(W: int, seed: int, n_batches: int = 5):
    """Key rows batch by batch: a pool of 250 keys drawn with repeats (so
    each batch holds doubletons and triples and meets keys of earlier
    batches), one key that only ever comes three times in one batch, and
    about 8% invalid all-ones rows."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, (250, W), dtype=np.uint32)
    out = []
    for b in range(n_batches):
        rows = pool[rng.integers(0, 250, N)]
        rows[rng.random(N) < 0.08] = 0xFFFFFFFF
        if b == 2:
            rows[:3] = rng.integers(0, 1 << 32, (1, W), dtype=np.uint32)
        out.append(rows)
    return out


def _ref_insert(rb1, rb2, rows):
    cols = [jnp.asarray(rows[:, w]) for w in range(rows.shape[1])]
    valid = jnp.asarray(~(rows == 0xFFFFFFFF).all(1))
    r1, r2 = ref_hashing.hash_words64(cols)
    return ref_bloom.insert_batch(rb1, rb2, r1, r2, valid, HFN)


@pytest.mark.parametrize("layout", ["k3", "separate", "rows"])
@pytest.mark.parametrize("bits", [1 << 10, 1 << 14])
@pytest.mark.parametrize("W", [1, 2, 4, 13])
@pytest.mark.parametrize("fn", ["wrapper", "plain"])
def test_insert_matches_reference_over_batches(fn, W, bits, layout):
    insert = cuda_bloom.bloom_insert if fn == "wrapper" else cuda_bloom.bloom_insert_plain
    rb1, rb2 = ref_bloom.make_bloom(bits), ref_bloom.make_bloom(bits)
    pb1, pb2 = bloom.make_bloom(bits, "cpu"), bloom.make_bloom(bits, "cpu")
    seen = []
    for rows in _batches(W, seed=W * 31 + bits.bit_length()):
        rb1, rb2, n1, n2 = _ref_insert(rb1, rb2, rows)
        b1, b2 = pb1, pb2
        m1, m2 = insert(pb1, pb2, _columns(rows, layout), HFN)
        assert pb1 is b1 and pb2 is b2            # updated in place
        assert m1.dtype == m2.dtype == torch.int64 and m1.dim() == m2.dim() == 0
        assert (int(m1), int(m2)) == (int(n1), int(n2))
        np.testing.assert_array_equal(_words(pb1), np.asarray(rb1))
        np.testing.assert_array_equal(_words(pb2), np.asarray(rb2))
        seen.append((int(m1), int(m2)))
    # the batches exercised both counters (the 2^10-bit filter saturates)
    assert sum(a for a, _ in seen) > 0 and sum(b for _, b in seen) > 0


def test_insert_ranks_roots_within_the_batch():
    """From empty filters: a triple, a doubleton and a singleton add 3 to
    BF1's counter and 2 to BF2's; the next batch's second sight of the
    singleton reaches BF2 (held in BF1, not BF2), a new key only BF1, and
    invalid rows nothing; the JAX package agrees at every step."""
    a, b, c, d = (np.full((1, 2), v, np.uint32) for v in (11, 22, 33, 44))
    bad = np.full((1, 2), 0xFFFFFFFF, np.uint32)
    rb1, rb2 = ref_bloom.make_bloom(1 << 14), ref_bloom.make_bloom(1 << 14)
    pb1, pb2 = bloom.make_bloom(1 << 14, "cpu"), bloom.make_bloom(1 << 14, "cpu")
    for rows, want in ((np.concatenate([a, b, a, bad, c, a, b]), (3, 2)),
                       (np.concatenate([c, d, bad, bad]), (1, 1)),
                       (np.concatenate([a, b, c, c]), (0, 0))):
        rb1, rb2, n1, n2 = _ref_insert(rb1, rb2, rows)
        got = cuda_bloom.bloom_insert(pb1, pb2, _columns(rows, "k3"), HFN)
        assert tuple(int(x) for x in got) == (int(n1), int(n2)) == want
        np.testing.assert_array_equal(_words(pb2), np.asarray(rb2))


@pytest.mark.parametrize("layout", ["k3", "separate", "rows"])
@pytest.mark.parametrize("W", [1, 2, 4, 13])
@pytest.mark.parametrize("fn", ["wrapper", "plain", "sortcount"])
def test_gate_matches_reference(fn, W, layout):
    """Half the keys are in BF2 (the rest miss unless a false positive
    admits them); invalid keys stay all-ones.  The gate works in place on
    the columns it was given and returns them."""
    rng = np.random.default_rng(W)
    rows = rng.integers(0, 1 << 32, (N, W), dtype=np.uint32)
    rows[rng.random(N) < 0.08] = 0xFFFFFFFF
    cols = [jnp.asarray(rows[:, w]) for w in range(W)]
    r1, r2 = ref_hashing.hash_words64(cols)
    held = jnp.asarray(np.arange(N) % 2 == 0)
    rbf2 = ref_bloom.set_bits(ref_bloom.make_bloom(1 << 14), r1, r2, HFN, held)
    miss = ref_sortcount._bloom_miss_mask(rbf2, cols, HFN)
    want = np.stack([np.asarray(c | miss) for c in cols], 1)
    assert 0 < (want == 0xFFFFFFFF).all(1).sum() < N
    pbf2 = torch.from_numpy(np.asarray(rbf2).view(np.int32).copy())
    keys = _columns(rows, layout)
    gate = {"wrapper": cuda_bloom.bloom_gate, "plain": cuda_bloom.bloom_gate_plain,
            "sortcount": lambda b, k, h: sortcount.bloom_gate(b, k, h, "cuda")}[fn]
    got = gate(pbf2, keys, HFN)
    assert all(g is k for g, k in zip(got, keys))
    np.testing.assert_array_equal(torch.stack(got, 1).numpy().view(np.uint32), want)


def test_gate_on_int64_columns_keeps_the_u32_range():
    """int64 key columns (values in [0, 2^32)) gate to 2^32 - 1, as the
    JAX gate's uint32 words do."""
    rows = np.array([[5, 6], [7, 8], [0xFFFFFFFF, 0xFFFFFFFF]], np.uint32)
    keys = tuple(torch.from_numpy(rows[:, w].astype(np.int64)) for w in range(2))
    got = cuda_bloom.bloom_gate(bloom.make_bloom(1 << 10, "cpu"), keys, HFN)
    assert all(bool((g == 0xFFFFFFFF).all()) for g in got)


def test_scratch_and_checks():
    """B1's scratch: none off a card; slots a power of two >= 2n.  Bad
    filters, key columns or devices are refused, never run elsewhere."""
    assert cuda_bloom.scratch_for(1 << 20, "cpu") is None
    for n, slots in ((1, 2), (3, 8), (1 << 20, 1 << 21), ((1 << 20) + 1, 1 << 22)):
        assert cuda_bloom._slots(n) == slots
    bf = bloom.make_bloom(1 << 10, "cpu")
    keys = (torch.zeros(4, dtype=torch.int32),)
    with pytest.raises(ValueError, match="power of two"):
        cuda_bloom.bloom_gate(torch.zeros(24, dtype=torch.int32), keys, HFN)
    with pytest.raises(ValueError, match="one size"):
        cuda_bloom.bloom_insert(bf, bloom.make_bloom(1 << 11, "cpu"), keys, HFN)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        cuda_bloom.bloom_insert(bf, bf.clone(), keys + (torch.zeros(3, dtype=torch.int32),), HFN)
    meta = torch.zeros(32, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_bloom.bloom_gate(meta, (torch.zeros(4, dtype=torch.int32, device="meta"),), HFN)
