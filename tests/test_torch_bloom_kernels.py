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


def _mask_np(r2, hfn: int):
    b0, stride = r2 & 31, ((r2 >> 5) | 1) & 31
    m = np.zeros_like(r2)
    for j in range(hfn):
        m |= np.uint32(1) << ((b0 + np.uint32(j) * stride) & 31)
    return m


def _model_insert(bf1, bf2, r1, r2, valid, hfn: int, rng, stats):
    """B1's decision order (``csrc/bloom.cu``) in numpy: warps of 32
    windows, groups of a warp's valid lanes with one root led by the
    lowest lane, the groups taken in a random order (any order of the
    kernel's atomics); each leader reads in1 and in2 from the filters as
    they stood, skips the scratch set when both hold, else ranks the root
    with a count that saturates: a count >= need (2 when neither filter
    holds the root, 1 when one does) decides 0 with no add.  Then the
    decisions are applied to the filters.  Returns (bf1, bf2, n1, n2)."""
    nwords = bf1.shape[0]
    groups = []
    for w0 in range(0, r1.shape[0], 32):
        lanes = {}
        for i in range(w0, min(w0 + 32, r1.shape[0])):
            if valid[i]:
                lanes.setdefault((int(r1[i]), int(r2[i])), []).append(i)
        groups += [(root, ix[0], len(ix)) for root, ix in lanes.items()]
    counts, dec = {}, np.zeros(r1.shape[0], np.uint8)
    for gi in rng.permutation(len(groups)):
        (a, b), lead, g = groups[gi]
        w, m = a & (nwords - 1), int(_mask_np(np.uint32(b), hfn))
        in1, in2 = int(bf1[w]) & m == m, int(bf2[w]) & m == m
        stats["in2_not_in1"] += in2 and not in1
        if in1 and in2:
            stats["skipped"] += 1
            continue
        need = 1 if in1 or in2 else 2
        o = counts.get((a, b))
        if o is None:
            counts[(a, b)], o = g, 0
        elif o >= need:
            stats["saturated"] += 1
            continue
        else:
            counts[(a, b)] = o + g
        first, second = o == 0, o <= 1 < o + g
        set1 = first and not in1
        set2 = not in2 and ((first and in1) or (second and not in1))
        dec[lead] = set1 | set2 << 1
    out = []
    for bit, bf in ((1, bf1), (2, bf2)):
        bf = bf.copy()
        on = np.flatnonzero(dec & bit)
        np.bitwise_or.at(bf, r1[on] & (nwords - 1), _mask_np(r2[on], hfn))
        out.append(bf)
    return out[0], out[1], int((dec & 1).astype(bool).sum()), int((dec & 2).astype(bool).sum())


@pytest.mark.parametrize("start", ["empty", "random"])
@pytest.mark.parametrize("bits", [1 << 6, 1 << 14])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decision_order_matches_reference(seed, bits, start):
    """The reasoning B1 rests on, held to the JAX ``insert_batch`` batch by
    batch with tolerance 0 (equal BF1 and BF2 words and counters): the
    filter-first skip, the count saturating at need, any group order.
    Batches hold runs of one key (groups of several lanes) and keys of
    earlier batches.  Filters filled by inserts alone keep BF2's bits
    inside BF1's, so ``in2 && !in1`` (a BF2 false positive: set1 must
    still land on a first occurrence) needs the "random" start, whose
    BF2 is denser than BF1; the 2^6-bit filter (two words) is full of
    false positives."""
    rng = np.random.default_rng(seed)
    W, words = 2, bits // 32
    if start == "random":
        f1 = (rng.random((words, 32)) < 0.5).astype(np.uint64)
        f2 = (rng.random((words, 32)) < 0.8).astype(np.uint64)
        to_words = lambda f: (f << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
        b1, b2 = to_words(f1), to_words(f2)
    else:
        b1, b2 = np.zeros(words, np.uint32), np.zeros(words, np.uint32)
    rb1, rb2 = jnp.asarray(b1), jnp.asarray(b2)
    stats = dict(in2_not_in1=0, skipped=0, saturated=0)
    pool = rng.integers(0, 1 << 32, (200, W), dtype=np.uint32)
    for _ in range(6):
        rows = pool[rng.integers(0, 200, N)]
        for at in rng.integers(0, N - 40, 6):       # runs of one key inside warps
            rows[at:at + rng.integers(2, 40)] = rows[at]
        rows[rng.random(N) < 0.05] = 0xFFFFFFFF
        cols = [jnp.asarray(rows[:, w]) for w in range(W)]
        valid = ~(rows == 0xFFFFFFFF).all(1)
        r1, r2 = (np.asarray(x, np.uint32) for x in ref_hashing.hash_words64(cols))
        b1, b2, m1, m2 = _model_insert(b1, b2, r1, r2, valid, HFN, rng, stats)
        rb1, rb2, n1, n2 = ref_bloom.insert_batch(rb1, rb2, jnp.asarray(r1), jnp.asarray(r2),
                                                  jnp.asarray(valid), HFN)
        assert (m1, m2) == (int(n1), int(n2))
        np.testing.assert_array_equal(b1, np.asarray(rb1))
        np.testing.assert_array_equal(b2, np.asarray(rb2))
    assert stats["skipped"] > 0 and stats["saturated"] > 0
    assert (stats["in2_not_in1"] > 0) == (start == "random")


def test_scratch_and_checks():
    """B1's scratch: none off a card; slots a power of two >= 2n, 16 B
    each, then 8 B of decisions per 32 windows (a table batch: 32 MiB of
    set, a 2^26-window superstep 2 GiB); epochs run 1 .. EPOCH_MAX and then
    wrap to 1,
    asking for the set to be cleared.  Bad filters, key columns or
    devices are refused, never run elsewhere."""
    assert cuda_bloom.scratch_for(1 << 20, "cpu") is None
    for n, slots in ((1, 2), (3, 8), (1 << 20, 1 << 21), ((1 << 20) + 1, 1 << 22)):
        assert cuda_bloom._slots(n) == slots
        assert cuda_bloom._scratch_words(n) == 4 * slots + 2 * -(-n // 32)
    assert 4 * 4 * cuda_bloom._slots(1 << 20) == 32 << 20
    assert 4 * 4 * cuda_bloom._slots(1 << 26) == 2 << 30
    sc = cuda_bloom.BloomScratch(5, "cpu")
    assert (sc.slots, sc.buf.numel(), int(sc.buf.abs().sum())) == (16, 66, 0)
    assert [sc.next_epoch() for _ in range(2)] == [(1, False), (2, False)]
    sc.epoch = cuda_bloom.EPOCH_MAX - 1
    assert [sc.next_epoch() for _ in range(3)] == [(cuda_bloom.EPOCH_MAX, False), (1, True),
                                                   (2, False)]
    assert cuda_bloom.EPOCH_MAX == (1 << 31) - 1
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
