"""K3 (canonical window keys) of the PyTorch port, held exactly to the
JAX package: the plain version (what the CPU runs) against
``window_keys_pallas`` (the Pallas kernel in interpret mode) and against
the XLA formulation ``sortcount.window_keys_from_codes``.  Tolerance 0:
every key word is an integer.  The CUDA kernel itself is compared with
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaarme_tpu.ops import sortcount as ref_sc
from kaarme_tpu.ops.pallas_winkeys import window_keys_pallas
from kaarme_tpu_torch.ops import cuda_winkeys

N = 1 << 13


def _codes(L, seed, sep_every=61):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=L).astype(np.uint32)
    codes[::sep_every] = 4
    codes[1000:1003] = 5                 # base bits under the invalid flag
    return codes


def _port(codes, k, n):
    return [c.numpy().view(np.uint32)
            for c in cuda_winkeys.window_keys(torch.from_numpy(codes.view(np.int32)), k, n)]


@pytest.mark.parametrize("k", [13, 16, 51, 201])
def test_window_keys_match_pallas_and_xla(k):
    """k=201 needs 13 words and a halo longer than 128 positions (its
    separators are sparser, so that some windows stay valid)."""
    codes = _codes(N + k - 1, seed=k, sep_every=61 if k < 61 else 1021)
    got = _port(codes, k, N)
    assert len(got) == -(-k // 16)
    cd = jnp.asarray(codes)
    pallas = window_keys_pallas(cd, k=k, n=N, block_rows=8, interpret=True)
    xla = ref_sc.window_keys_from_codes(cd, k, N, 1 << 9)
    for g, p, x in zip(got, pallas, xla):
        np.testing.assert_array_equal(g, np.asarray(p))
        np.testing.assert_array_equal(g, np.asarray(x))
    sent = np.logical_and.reduce([g == 0xFFFFFFFF for g in got])
    assert 0 < sent.sum() < N
    if k % 16:                           # left-aligned trailing word, low bits zero
        assert (got[-1][~sent] & ((1 << (2 * (16 - k % 16))) - 1) == 0).all()


@pytest.mark.parametrize("k,n", [(13, 5003), (201, 777), (2, 1)])
def test_odd_tail_lengths_match_xla(k, n):
    """Tail supersteps: any n, and exactly n + k - 1 codes (nothing past
    the stream is read)."""
    codes = _codes(n + k - 1, seed=n, sep_every=97)
    got = _port(codes, k, n)
    want = ref_sc.window_keys_from_codes(jnp.asarray(codes), k, n, 1)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(x))


def test_canonical_orientation_and_sentinels():
    """A window and its reverse complement get one key (ties go to the
    forward strand); any invalid position makes every word all-ones."""
    k = 33                                # W = 3, trailing word holds one base
    rng = np.random.default_rng(3)
    fwd = rng.integers(0, 4, k).astype(np.uint32)
    pal = np.concatenate([fwd[:16], 3 - fwd[:16][::-1]]).astype(np.uint32)   # k=32
    stream = np.concatenate([fwd, [4], 3 - fwd[::-1], [4], pal, [4]]).astype(np.uint32)
    n = stream.shape[0] - k + 1
    keys = np.stack(_port(stream, k, n), 1)
    assert (keys[0] == keys[k + 1]).all()
    assert (keys[1:k + 1] == 0xFFFFFFFF).all()
    # a reverse-complement palindrome of even length: forward == rc
    pk = np.stack(_port(pal, 32, 1), 1)[0]
    want = [int("".join(f"{int(c):02b}" for c in pal[16 * w: 16 * w + 16]), 2)
            for w in range(2)]
    assert pk.tolist() == want


def test_argument_checks():
    codes = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_winkeys.window_keys(codes, 5, 7)          # needs 11 codes
    with pytest.raises(ValueError):
        cuda_winkeys.window_keys(codes, 1, 5)
    with pytest.raises(ValueError):
        cuda_winkeys.window_keys(codes.long(), 5, 6)
    assert [c.shape for c in cuda_winkeys.window_keys(codes, 5, 0)] == [(0,)]
