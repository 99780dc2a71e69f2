"""K4 (linear merge of two sorted runs + segment sum and dense
compaction) of the PyTorch port, held exactly to the JAX package: the
plain version (what the CPU runs) against ``merge_compact_dense`` in
interpret mode.  The JAX kernel takes the batch DESCENDING; the port
takes it ascending, so each case hands the JAX side the reversed batch.
Live records are compared in order, with nd_exact.  Tolerance 0: every
quantity is an integer.  The CUDA kernel itself is compared with the
plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaarme_tpu.ops import pallas_merge as ref_pm
from kaarme_tpu_torch.ops import cuda_merge

SENT = 0xFFFFFFFF
BIG = 1 << 20


def _clamp(c):
    return c if c <= BIG else BIG + (c & (BIG - 1))


def _key_cols(keys, W, eb):
    """(m, W) int64 key words with the last word's low ``eb`` bits zero."""
    keys = keys.copy()
    keys[:, -1] = (keys[:, -1] << eb) & SENT
    return keys


def _case(W, eb, na, nb, n_a_rows, n_b_rows, span, seed):
    """A: distinct sorted keys with counts, padded with sentinels to
    n_a_rows; B: sorted keys with repeats, sentinels after them, n_b_rows.
    Returns uint32 column lists (A: W words, + a count column when eb=0)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, span, (na, W))
    raw[:, 0] |= 0x80000000
    a = np.unique(_key_cols(raw, W, eb), axis=0)
    acnt = rng.integers(1, 1 << 21, a.shape[0])
    braw = rng.integers(0, span, (nb, W))
    braw[:, 0] |= 0x80000000
    b = _key_cols(braw, W, eb)
    b = b[np.lexsort(b.T[::-1])]
    if eb:
        a[:, -1] |= acnt
        b[:, -1] |= 1
    a = np.concatenate([a, np.full((n_a_rows - a.shape[0], W), SENT)])
    b = np.concatenate([b, np.full((n_b_rows - b.shape[0], W), SENT)])
    a_cols = [a[:, w].astype(np.uint32) for w in range(W)]
    if not eb:
        a_cols.append(np.concatenate([acnt, np.zeros(n_a_rows - acnt.shape[0], np.int64)])
                      .astype(np.uint32))
    return a_cols, [b[:, w].astype(np.uint32) for w in range(W)]


def _both(a_cols, b_cols, eb):
    """(port rows (nd, W+1) uint32, nd) and (reference live rows, nd)."""
    W = len(b_cols)
    t = lambda cols: torch.from_numpy(np.stack(cols).view(np.int32))
    keys, cnt, ndv = cuda_merge.merge_compact(t(a_cols), t(b_cols), embedded=eb > 0,
                                              ebits=eb)
    nd, ndu = ndv.tolist()
    assert nd == ndu
    got = np.concatenate([keys.numpy().view(np.uint32), cnt.numpy()[None].view(np.uint32)]).T
    assert (got[nd:, :W] == SENT).all() and (got[nd:, W] == 0).all()
    a_j = tuple(jnp.asarray(c if i < W else c.view(np.int32)) for i, c in enumerate(a_cols))
    rk, rc, rnd, rndu = ref_pm.merge_compact_dense(
        a_j, tuple(jnp.asarray(c[::-1].copy()) for c in b_cols), embedded=eb > 0, ebits=eb,
        block_rows=8, interpret=True)
    ref = np.stack([np.asarray(c)[:int(rndu)].astype(np.uint32) for c in rk]
                   + [np.asarray(rc)[:int(rndu)].astype(np.uint32)], 1)
    return got[:nd], nd, ref[ref[:, -1] > 0], int(rnd)


@pytest.mark.parametrize("W,eb", [(4, 26), (2, 0)])
def test_merge_matches_pallas(W, eb):
    """Embedded (W=4, ebits=26: the k=51 layout) and separate count (W=2:
    k=32), with keys shared between the runs, repeats in the batch and
    sentinels in both."""
    a_cols, b_cols = _case(W, eb, 1400, 1900, 1536, 2048, span=24 if W == 4 else 48, seed=W)
    got, nd, ref, rnd = _both(a_cols, b_cols, eb)
    assert nd == rnd and nd > 1300
    np.testing.assert_array_equal(got, ref)


def test_merge_exact_fit():
    """Both runs full of real records, no sentinel anywhere (the TPU
    kernel needed an extra all-sentinel block here)."""
    a_cols, b_cols = _case(2, 26, 1024, 1024, 1024, 1024, span=1 << 16, seed=5)
    assert all((c != SENT).all() for c in a_cols + b_cols)
    got, nd, ref, rnd = _both(a_cols, b_cols, 26)
    assert nd == rnd
    np.testing.assert_array_equal(got, ref)


def test_merge_hot_key_across_blocks_clamps():
    """One key filling the batch across several 1024-row blocks, whose
    prefix count pushes the total past 2^20: the modular clamp."""
    eb, nb = 26, 3 * 1024 + 50
    hot = np.array([[0x80000123, 5 << eb]], np.int64)
    a = np.concatenate([hot | [[0, BIG - 5]], np.full((127, 2), SENT)])
    b = np.concatenate([np.repeat(hot | [[0, 1]], nb, 0), np.full((3200 - nb, 2), SENT)])
    a_cols = [a[:, w].astype(np.uint32) for w in range(2)]
    b_cols = [b[:, w].astype(np.uint32) for w in range(2)]
    got, nd, ref, rnd = _both(a_cols, b_cols, eb)
    assert nd == rnd == 1
    assert int(got[0, -1]) == _clamp(BIG - 5 + nb) < 2 * BIG
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("eb", [26, 0], ids=["embedded", "separate"])
def test_merge_hot_key_in_both_runs(eb):
    """One key with a row in A (its count near 2^20) and 7,000 rows in B,
    among other keys in both runs: its segment spans many of the
    reference's 1024-row blocks and the merge boundary, and its total
    crosses the clamp.  Both layouts."""
    W, nb_hot = 3, 7000
    rng = np.random.default_rng(11 + eb)
    hot = _key_cols(np.array([[0x80000400, 7, 9]], np.int64), W, eb)
    raw = rng.integers(0, 1 << 11, (200, W))
    raw[:, 0] |= 0x80000000
    a = np.unique(np.concatenate([_key_cols(raw, W, eb), hot]), axis=0)
    acnt = rng.integers(1, 50, a.shape[0])
    acnt[(a == hot).all(1)] = BIG - 11
    braw = rng.integers(0, 1 << 11, (700, W))
    braw[:, 0] |= 0x80000000
    b = np.concatenate([_key_cols(braw, W, eb), np.repeat(hot, nb_hot, 0)])
    b = b[np.lexsort(b.T[::-1])]
    if eb:
        a[:, -1] |= acnt
        b[:, -1] |= 1
    a = np.concatenate([a, np.full((1024 - a.shape[0], W), SENT)])
    b = np.concatenate([b, np.full((8192 - b.shape[0], W), SENT)])
    a_cols = [a[:, w].astype(np.uint32) for w in range(W)]
    if not eb:
        a_cols.append(np.concatenate([acnt, np.zeros(1024 - acnt.shape[0], np.int64)])
                      .astype(np.uint32))
    got, nd, ref, rnd = _both(a_cols, [b[:, w].astype(np.uint32) for w in range(W)], eb)
    assert nd == rnd
    row = np.flatnonzero((got[:, :W] == hot[0]).all(1))
    assert row.shape == (1,) and int(got[row[0], W]) == _clamp(BIG - 11 + nb_hot) > BIG
    np.testing.assert_array_equal(got, ref)


def test_empty_prefix_and_overflow_cut():
    """The first superstep's all-sentinel prefix; a capacity below nd
    keeps the first out_len records and reports nd."""
    a_cols, b_cols = _case(1, 0, 0, 600, 256, 640, span=1 << 10, seed=7)
    t = lambda cols: torch.from_numpy(np.stack(cols).view(np.int32))
    k, c, ndv = cuda_merge.merge_compact(t(a_cols), t(b_cols), embedded=False)
    nd = int(ndv[0])
    b = b_cols[0][b_cols[0] != SENT]
    vals, cnts = np.unique(b, return_counts=True)
    assert nd == vals.shape[0]
    np.testing.assert_array_equal(k[0, :nd].numpy().view(np.uint32), vals)
    np.testing.assert_array_equal(c[:nd].numpy(), cnts)
    k2, c2, nd2 = cuda_merge.merge_compact(t(a_cols), t(b_cols), embedded=False,
                                           out_len=nd // 2)
    assert nd2.tolist() == [nd, nd] and k2.shape == (1, nd // 2)
    assert torch.equal(k2, k[:, :nd // 2]) and torch.equal(c2, c[:nd // 2])


def test_argument_checks():
    z = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_merge.merge_compact(z, z, embedded=False)            # needs W+1 = 3
    with pytest.raises(ValueError):
        cuda_merge.merge_compact(z, z, embedded=True, ebits=0)
    with pytest.raises(ValueError):
        cuda_merge.merge_compact(z[:1], z[:1], embedded=True, ebits=26, out_len=-1)
