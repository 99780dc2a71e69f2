"""K1 (dense run segmentation) of the PyTorch port, held exactly to the
JAX package: the plain version (what the CPU runs) against
``pallas_skm.run_rows_dense_pallas(interpret=True)`` and the NumPy
mirror ``skm.run_rows_np`` — from codes, and from the transfer chunk
(packed 2-bit words plus the separator bitmap) that the wrapper takes,
against the JAX package's ``unpack_codes`` followed by the Pallas
kernel.  Every quantity is an
integer, so the tolerance is 0.  The CUDA kernel itself is compared with
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chunk_noise import noisy_tail
from kaarme_tpu.ops import pallas_skm, skm
from kaarme_tpu.ops import sortcount as ref_sc
from kaarme_tpu_torch.io import fastio
from kaarme_tpu_torch.ops import cuda_skm

SENT = 0xFFFFFFFF


def _codes(n, k, seed, sep_every=151):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n + k - 1).astype(np.uint8)
    c[::sep_every] = 4          # read separators
    c[1000:1003] = 5            # an N patch
    inv = (c >= 4).astype(np.uint32)
    return c, (c & 3).astype(np.uint32) | (inv << 2)


def _chunk(c_u8, seed):
    """The transfer chunk of a code stream: packed words with random bases
    under the invalid positions too (they must not matter), and the
    bitmap."""
    L = c_u8.shape[0]
    bases = np.where(c_u8 >= 4, np.random.default_rng(seed).integers(0, 4, L), c_u8)
    packed, _ = fastio.pack_stream_np(bases.astype(np.uint8))
    _, mask = fastio.pack_stream_np(c_u8)
    return packed, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _rows(cols, rows):
    return np.stack([c.numpy().view(np.uint32) for c in cols], 1), [int(x) for x in rows]


def _port(codes_u32, k, n, cap):
    return _rows(*cuda_skm.run_rows_dense_torch(_t(codes_u32), k=k, n=n, cap=cap))


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


@functools.lru_cache(maxsize=None)
def _jax_chunk_rows(k, n, cap):
    """The JAX package's unpack of the clean chunk of ``_codes(n, k, 11)``
    and its Pallas kernel (interpret mode): (live rows, rows_exact), made
    once for the ``noisy_tail`` and ``dense`` cases below."""
    packed, mask = _chunk(_codes(n, k, seed=11)[0], seed=k)
    ref_codes = ref_sc.unpack_codes(jnp.asarray(packed), jnp.asarray(mask), n + k - 1)
    cols, ndv = pallas_skm.run_rows_dense_pallas(ref_codes, k=k, n=n, cap=cap, interpret=True)
    ref = np.stack([np.asarray(c) for c in cols], 1)
    return ref[ref[:, -1] != SENT], int(ndv[0])


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy_tail", "dense"])
@pytest.mark.parametrize("k,n", [(31, 1 << 15), (51, 1 << 15)])
def test_chunk_k1_matches_jax_unpack_and_pallas(k, n, noisy):
    """The wrapper on CPU tensors, from the chunk, against the JAX
    package's unpack of the same chunk and its Pallas kernel; L = n + k - 1
    is no multiple of 16 or 32.  ``noisy_tail``: the wrapper reads the
    chunk with random bases and bitmap bits at and past L, the reference
    the clean one."""
    c_u8, _ = _codes(n, k, seed=11)
    packed, mask = _chunk(c_u8, seed=k)
    cap = n // 4
    ref_live, ref_exact = _jax_chunk_rows(k, n, cap)
    if noisy:
        packed, mask = noisy_tail(packed, mask, n + k - 1, seed=k)
    arr, (exact, used) = _rows(*cuda_skm.run_rows_dense(_t(packed), _t(mask), k=k, n=n, cap=cap))
    assert exact == used == ref_exact == ref_live.shape[0]
    np.testing.assert_array_equal(arr[:exact], ref_live)
    assert (arr[exact:] == SENT).all()


@pytest.mark.parametrize("k,n", [(16, 3000), (51, 777), (101, 4096)])
def test_plain_k1_any_n_matches_mirror(k, n):
    """The port takes any n (no block alignment) and any k >= 16, from
    codes and from the chunk, clean and with a noisy tail."""
    c_u8, c32 = _codes(n, k, seed=n, sep_every=97)
    arr, (exact, _) = _port(c32, k, n, 1 << 13)
    assert _mirror_dict(arr[:exact]) == skm.run_rows_np(c_u8, k, n)
    packed, mask = _chunk(c_u8, seed=n)
    for p, m in ((packed, mask), noisy_tail(packed, mask, n + k - 1, seed=n)):
        got, rows = _rows(*cuda_skm.run_rows_dense(_t(p), _t(m), k=k, n=n, cap=1 << 13))
        assert rows == [exact, exact]
        np.testing.assert_array_equal(got, arr)


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


def test_k1_wrapper_refuses_what_it_does_not_take():
    packed, sep = _t(np.zeros(4, np.uint32)), _t(np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="k >= 16"):
        cuda_skm.run_rows_dense(packed, sep, k=15, n=10, cap=8)
    with pytest.raises(ValueError, match="bases"):
        cuda_skm.run_rows_dense(packed, sep, k=31, n=40, cap=8)
    with pytest.raises(ValueError, match="bitmap"):
        cuda_skm.run_rows_dense(packed, sep[:1], k=31, n=20, cap=8)
    with pytest.raises(ValueError, match="int32"):
        cuda_skm.run_rows_dense(packed.long(), sep, k=31, n=20, cap=8)
