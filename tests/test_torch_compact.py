"""K2 (fused segment-sum + compaction) of the PyTorch port, held
exactly to the JAX package in both main-path modes: the plain version
(what the CPU runs) against ``sortcount._pallas_finish`` (the Pallas
kernel ``segsum_compact`` in interpret mode) and against the XLA
formulations ``_compact_embedded`` / ``compact(clamped=True)``.
Tolerance 0: every quantity is an integer.  The CUDA kernel itself is
compared with the plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaarme_tpu.ops import sortcount as ref_sc
from kaarme_tpu_torch.ops import cuda_compact, sortcount

SENT = 0xFFFFFFFF
EB = 26


def _sorted(cols):
    """Columns (uint32, the last is payload when ``payload``) sorted
    lexicographically by all key columns, as numpy uint32 arrays."""
    order = np.lexsort(tuple(cols[::-1]))
    return [c[order] for c in cols]


def _embedded_case(seed):
    """W=6 merge-shaped rows: keys with values >= 2^31, adjacent keys
    differing only in the lowest key bit above the count field, many
    rows per segment, prefix counts straddling 2^20 and 2^21, and
    sentinel rows."""
    rng = np.random.default_rng(seed)
    W, nk = 6, 300
    keys = rng.integers(0, 1 << 32, (nk, W), dtype=np.uint64).astype(np.uint32)
    keys[:, 0] |= np.uint32(0x80000000)
    keys[:, W - 1] &= np.uint32(~((1 << EB) - 1) & SENT)
    keys[1::2] = keys[0::2]                       # pairs differing in bit 26 only
    keys[1::2, W - 1] ^= np.uint32(1 << EB)
    picks = rng.integers(0, nk, 6000)
    picks[:3000] = 7                              # one very long segment
    rows = keys[picks]
    cnt = np.ones(picks.shape[0], np.uint32)
    firsts = np.unique(picks, return_index=True)[1]
    big = np.array([(1 << 20) - 1, 1 << 20, (1 << 20) + 1, (1 << 21) - 1, 5, 1000])
    cnt[firsts] = big[np.arange(firsts.shape[0]) % big.shape[0]]   # one prefix row per key
    last = rows[:, W - 1] | cnt
    cols = [rows[:, w].copy() for w in range(W - 1)] + [last]
    cols = [np.concatenate([c, np.full(500, SENT, np.uint32)]) for c in cols]
    return _sorted(cols)


def _full_sum_case(seed):
    """W=4 finalize-shaped rows + an int32 count column: segments whose
    clamped sum exceeds 2^32 true mass, counts around 2^20, sentinels
    with count 0."""
    rng = np.random.default_rng(seed)
    W, nk, n = 4, 200, 20000
    keys = rng.integers(0, 1 << 32, (nk, W), dtype=np.uint64).astype(np.uint32)
    keys[:5, 0] = np.uint32(0x80000000)          # sign bit set, shared first word
    picks = rng.integers(0, nk, n)
    picks[:6000] = 3                              # 6000 rows x ~2^20 > 2^32
    cnt = rng.integers(1, 1 << 21, n).astype(np.int64)
    cnt[:6000] = (1 << 20) - rng.integers(0, 3, 6000)
    rows = keys[picks]
    cols = [rows[:, w].copy() for w in range(W)] + [cnt.astype(np.uint32)]
    cols = [np.concatenate([c, np.full(300, 0 if i == W else SENT, np.uint32)])
            for i, c in enumerate(cols)]
    order = np.lexsort(tuple(cols[:W][::-1]))
    return [c[order] for c in cols]


def _port_finish(cols, cap, embedded):
    s = torch.from_numpy(np.stack(cols).view(np.int32))
    out, ndv = sortcount._kernel_finish(s, cap, embedded, EB if embedded else 0, "cuda")
    arr = np.stack([c.numpy().view(np.uint32) for c in out], 1)
    return arr, [int(x) for x in ndv]


def _ref_live(store, ndu):
    arr = np.stack([np.asarray(c)[:ndu].astype(np.uint32) for c in store], 1)
    return arr[arr[:, -1] > 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_embedded_matches_pallas_and_xla(seed):
    cols = _embedded_case(seed)
    N = cols[0].shape[0]
    arr, (nd, ndu) = _port_finish(cols, N, True)
    assert nd == ndu
    ref, rndv = ref_sc._pallas_finish(tuple(jnp.asarray(c) for c in cols), N, True, EB,
                                      True)
    assert nd == int(rndv[0])
    np.testing.assert_array_equal(arr[:nd], _ref_live(ref, int(rndv[1])))
    xla, xnd = ref_sc._compact_embedded([jnp.asarray(c) for c in cols], EB)
    assert nd == int(xnd)
    np.testing.assert_array_equal(arr, np.stack([np.asarray(c).astype(np.uint32)
                                                 for c in xla], 1))
    assert (arr[nd:, :-1] == SENT).all() and (arr[nd:, -1] == 0).all()
    assert arr[:nd, -1].max() < (1 << 21)


@pytest.mark.parametrize("seed", [0, 1])
def test_full_sum_matches_pallas_and_xla(seed):
    cols = _full_sum_case(seed)
    N = cols[0].shape[0]
    arr, (nd, ndu) = _port_finish(cols, N, False)
    assert nd == ndu
    jcols = tuple(jnp.asarray(c) for c in cols[:-1]) + (jnp.asarray(cols[-1].astype(np.int32)),)
    ref, rndv = ref_sc._pallas_finish(jcols, N, False, 0, True, full_sum=True)
    assert nd == int(rndv[0])
    np.testing.assert_array_equal(arr[:nd], _ref_live(ref, int(rndv[1])))
    xla, xnd = ref_sc.compact(jcols, clamped=True)
    assert nd == int(xnd)
    # (the XLA partition leaves dead rows' keys in place past nd)
    np.testing.assert_array_equal(arr[:nd], np.stack([np.asarray(c)[:nd].astype(np.uint32)
                                                      for c in xla], 1))


@pytest.mark.parametrize("embedded", [True, False], ids=["embedded", "full_sum"])
def test_segment_across_tiles_matches_pallas_and_xla(embedded):
    """One key over rows 100 .. 4900, across two boundaries of the CUDA
    kernel's 2048-row tiles, whose total crosses the 2^20 clamp: in
    embedded mode c_last + len - 1 with c_last near 2^20, in full_sum
    mode ~4800 counts near 2^19 (a clamped sum that crosses 2^20 again
    and again).  Short segments and sentinel rows around it."""
    rng = np.random.default_rng(9)
    W, N = (3, 5200) if embedded else (2, 5200)
    keys = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64).astype(np.uint32)
    keys[100:4900] = keys[100]
    if embedded:
        keys[:, -1] &= np.uint32(~((1 << EB) - 1) & SENT)
        keys[:, -1] |= np.uint32(1)
        keys[4899, -1] |= np.uint32((1 << 20) - 10)
    keys[5100:] = SENT
    cols = [keys[:, w].copy() for w in range(W)]
    if not embedded:
        cnt = rng.integers(1 << 18, 1 << 19, N).astype(np.uint32)
        cnt[5100:] = 0
        cols.append(cnt)
    order = np.lexsort(tuple(cols[:W][::-1]))
    cols = [c[order] for c in cols]
    arr, (nd, ndu) = _port_finish(cols, N, embedded)
    assert nd == ndu
    if embedded:
        jcols = tuple(jnp.asarray(c) for c in cols)
        ref, rndv = ref_sc._pallas_finish(jcols, N, True, EB, True)
        xla, xnd = ref_sc._compact_embedded(list(jcols), EB)
    else:
        jcols = tuple(jnp.asarray(c) for c in cols[:-1]) + (jnp.asarray(cols[-1].astype(np.int32)),)
        ref, rndv = ref_sc._pallas_finish(jcols, N, False, 0, True, full_sum=True)
        xla, xnd = ref_sc.compact(jcols, clamped=True)
    assert nd == int(rndv[0]) == int(xnd)
    np.testing.assert_array_equal(arr[:nd], _ref_live(ref, int(rndv[1])))
    np.testing.assert_array_equal(arr[:nd], np.stack([np.asarray(c)[:nd].astype(np.uint32)
                                                      for c in xla], 1))
    big = arr[:nd, -1].max()
    assert (1 << 20) < big < (1 << 21)


def test_cap_cut_reports_overflow():
    cols = _embedded_case(2)
    arr_full, (nd, _) = _port_finish(cols, cols[0].shape[0], True)
    arr, (nd2, ndu2) = _port_finish(cols, 100, True)
    assert nd2 == ndu2 == nd > 100
    np.testing.assert_array_equal(arr, arr_full[:100])


def test_empty_and_all_sentinel():
    for N in (0, 5):
        keys = torch.full((3, N), -1, dtype=torch.int32)
        okeys, ocnt, ndv = cuda_compact.segsum_compact(keys, None, ebits=EB)
        assert ndv.tolist() == [0, 0] and okeys.shape == (3, N)
        assert (okeys == -1).all() and (ocnt == 0).all()

