"""Host packing, device unpack and device resolution of the PyTorch port
(kaarme_tpu_torch.io.fastio, ops.sortcount unpack, utils.device),
held exactly to the JAX package's functions on the same inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaarme_tpu.ops import sortcount as ref_sc
from kaarme_tpu_torch.io import fastio
from kaarme_tpu_torch.ops import sortcount
from kaarme_tpu_torch.utils.device import resolve_device


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, n).astype(np.uint8)
    s[::151] = 4
    s[1000:1003] = 4
    return s


@pytest.mark.parametrize("n", [1, 31, 32, 1000, (1 << 21) * 3 + 17])
def test_pack_stream_matches_reference(n):
    s = _stream(n, seed=n % 97)
    want = ref_sc.pack_stream_np(s)
    for got in (fastio.pack_stream(s), fastio.pack_stream_np(s)):
        assert got[0].dtype == np.uint32 and got[1].dtype == np.uint32
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if fastio.get_lib() is not None:
        np.testing.assert_array_equal(fastio.pack_stream(s, threads=3)[0], want[0])


@pytest.mark.parametrize("L", [1, 17, 5000])
def test_unpack_codes_dense_and_sparse(L):
    """The unpack of the bitmap chunk (the one form the port ships)."""
    s = _stream(L, seed=L)
    packed, mask = ref_sc.pack_stream_np(s)
    want = np.asarray(ref_sc.unpack_codes(jnp.asarray(packed), jnp.asarray(mask), L))
    t = lambda a: torch.from_numpy(a.view(np.int32))
    got = sortcount.unpack_codes(t(packed), t(mask), L).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_store_helpers_match_reference():
    for x in (1, 4095, 4097, 6145, 1 << 22, (1 << 22) + 1, 10 ** 8):
        for coarse in (False, True):
            assert sortcount.next_store_size(x, coarse) == ref_sc.next_store_size(x, coarse)
    rng = np.random.default_rng(5)
    w = rng.integers(0, 1 << 32, 1000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(ref_sc._pairrev32(jnp.asarray(w)))
    got = sortcount._pairrev32(torch.from_numpy(w.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    c = np.array([0, 1, (1 << 20) - 1, 1 << 20, (1 << 20) + 1, (1 << 21) + 5, 1 << 30],
                 np.int32)
    np.testing.assert_array_equal(
        sortcount._clamp_count(torch.from_numpy(c)).numpy(),
        np.asarray(ref_sc._clamp_count(jnp.asarray(c))))


def test_resolve_device():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
