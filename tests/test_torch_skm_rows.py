"""K1 (dense run segmentation) of the PyTorch port, held exactly to the
JAX package: the plain version (what the CPU runs) against
``pallas_skm.run_rows_dense_pallas(interpret=True)`` and the NumPy
mirror ``skm.run_rows_np``.  Every quantity is an integer, so the
tolerance is 0.  The CUDA kernel itself is compared with the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaarme_tpu.ops import pallas_skm, skm
from kaarme_tpu_torch.ops import cuda_skm

SENT = 0xFFFFFFFF


def _codes(n, k, seed, sep_every=151):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n + k - 1).astype(np.uint8)
    c[::sep_every] = 4          # read separators
    c[1000:1003] = 5            # an N patch
    inv = (c >= 4).astype(np.uint32)
    return c, (c & 3).astype(np.uint32) | (inv << 2)


def _port(codes_u32, k, n, cap):
    cols, rows = cuda_skm.run_rows_dense(
        torch.from_numpy(codes_u32.view(np.int32)), k=k, n=n, cap=cap)
    arr = np.stack([c.numpy().view(np.uint32) for c in cols], 1)
    return arr, [int(x) for x in rows]


def _mirror_dict(rows):
    got = {}
    for r in rows:
        key = tuple(int(x) for x in r[:-1]) + (int(r[-1]) & ~((1 << 26) - 1),)
        got[key] = got.get(key, 0) + (int(r[-1]) & ((1 << 26) - 1))
    return got


@pytest.mark.parametrize("k,n", [(31, 1 << 15), (51, 1 << 15), (31, 1 << 17)])
def test_plain_k1_matches_pallas_and_mirror(k, n):
    """n = 2^17 spans four blocks of the Pallas kernel (its cross-block
    carries and residual row)."""
    c_u8, c32 = _codes(n, k, seed=11)
    cap = n // 4
    arr, (exact, used) = _port(c32, k, n, cap)
    cols, ndv = pallas_skm.run_rows_dense_pallas(jnp.asarray(c32), k=k, n=n, cap=cap,
                                                 interpret=True)
    ref = np.stack([np.asarray(c) for c in cols], 1)
    ref_live = ref[ref[:, -1] != SENT]
    assert exact == used == int(ndv[0]) == ref_live.shape[0]
    # same rows in the same (stream) order; everything after is sentinel
    np.testing.assert_array_equal(arr[:exact], ref_live)
    assert (arr[exact:] == SENT).all()
    assert _mirror_dict(arr[:exact]) == skm.run_rows_np(c_u8, k, n)


@pytest.mark.parametrize("k,n", [(16, 3000), (51, 777), (101, 4096)])
def test_plain_k1_any_n_matches_mirror(k, n):
    """The port takes any n (no block alignment) and any k >= 16."""
    c_u8, c32 = _codes(n, k, seed=n, sep_every=97)
    arr, (exact, _) = _port(c32, k, n, 1 << 13)
    assert _mirror_dict(arr[:exact]) == skm.run_rows_np(c_u8, k, n)


def test_plain_k1_overflow_writes_nothing_past_cap():
    k, n = 31, 1 << 15
    _, c32 = _codes(n, k, seed=3)
    full, (exact, _) = _port(c32, k, n, 1 << 13)
    small, (e2, u2) = _port(c32, k, n, 1024)
    assert e2 == u2 == exact > 1024          # the caller must replay
    np.testing.assert_array_equal(small, full[:1024])
    _, ndv = pallas_skm.run_rows_dense_pallas(jnp.asarray(c32), k=k, n=n, cap=1024,
                                              interpret=True)
    assert int(ndv[1]) > 1024                # the reference reports it too

