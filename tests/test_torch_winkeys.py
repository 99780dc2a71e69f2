"""K3 (canonical window keys) of the PyTorch port, held exactly to the
JAX package: the definition from codes (``window_keys_torch``) against
``window_keys_pallas`` (the Pallas kernel in interpret mode) and against
the XLA formulation ``sortcount.window_keys_from_codes``; the chunk
entry point (``window_keys`` on CPU tensors: its plain version, the
unpack then the definition) against the JAX package's
``_keys_from_chunk`` on the bitmap in both its unpack-then-kernel route
(``winkeys="legacy"``, Pallas in interpret mode) and its packed route
(``winkeys="packed"``, ``window_keys_packed``).  Tolerance 0: every key
word is an integer.  The CUDA kernel itself is compared with the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chunk_noise import noisy_tail
from kaarme_tpu.ops import sortcount as ref_sc
from kaarme_tpu.ops.pallas_winkeys import window_keys_pallas
from kaarme_tpu_torch.io import fastio
from kaarme_tpu_torch.ops import cuda_winkeys

N = 1 << 13
M32 = 0xFFFFFFFF


def _codes(L, seed, sep_every=61):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=L).astype(np.uint32)
    codes[::sep_every] = 4
    codes[1000:1003] = 5                 # base bits under the invalid flag
    return codes


def _port(codes, k, n):
    return [c.numpy().view(np.uint32)
            for c in cuda_winkeys.window_keys_torch(torch.from_numpy(codes.view(np.int32)), k, n)]


def _chunk(n, k, seed):
    """The transfer chunk as the host ships it (``fastio.pack_stream_np``):
    random bases under the invalid positions too (the bitmap decides), and
    the bitmap.  Returns uint32 arrays."""
    rng = np.random.default_rng(seed)
    L = n + k - 1
    bases = rng.integers(0, 4, L).astype(np.uint8)
    inv = np.zeros(L, bool)
    inv[::61 if k < 61 else 1021] = True
    inv[1000:1003] = True
    packed, _ = fastio.pack_stream_np(bases)
    _, mask = fastio.pack_stream_np(inv.astype(np.uint8) * 4)
    return packed, mask


@functools.lru_cache(maxsize=None)
def _jax_chunk_keys(k, n, seed, routes):
    """The JAX package's ``_keys_from_chunk`` on the clean chunk
    ``_chunk(n, k, seed)``, one key list (numpy words) per route
    ("legacy": unpack + Pallas in interpret mode, or its XLA formulation
    where n is no multiple of 16; "packed"), made once for a test's
    ``noisy_tail`` and ``dense`` cases."""
    pj, sj = (jnp.asarray(a) for a in _chunk(n, k, seed))
    pallas = {"legacy": "interpret", "packed": "off"}
    return [[np.asarray(x) for x in ref_sc._keys_from_chunk(pj, sj, True, k, n, 1, pallas[r], r)]
            for r in routes]


def _from_chunk(packed, mask, k, n, noisy):
    """The port's keys from the chunk; ``noisy``: from ``noisy_tail`` of
    it, with random bases and bitmap bits at and past L."""
    if noisy:
        packed, mask = noisy_tail(packed, mask, n + k - 1, seed=n + k)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    return [c.numpy().view(np.uint32)
            for c in cuda_winkeys.window_keys(t(packed), t(mask), k=k, n=n)]


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


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy_tail", "dense"])
@pytest.mark.parametrize("k", [2, 13, 16, 17, 51, 201])
def test_window_keys_from_chunk_match_jax_chunk_routes(k, noisy):
    """The chunk entry point on CPU tensors against the JAX package's
    chunk routes on the clean bitmap: unpack + Pallas (interpret) and the
    packed formulation.  L = 2047 + k is a multiple of 16 only at k = 17
    and of 32 never; the noisy tail must not change a key."""
    n = 2048
    got = _from_chunk(*_chunk(n, k, seed=k + 100), k, n, noisy)
    assert len(got) == -(-k // 16)
    legacy, packed_route = _jax_chunk_keys(k, n, k + 100, ("legacy", "packed"))
    for g, x, p in zip(got, legacy, packed_route):
        np.testing.assert_array_equal(g, x)
        np.testing.assert_array_equal(g, p)
    sent = np.logical_and.reduce([g == M32 for g in got])
    assert 0 < sent.sum() < n


@pytest.mark.parametrize("noisy", [True, False], ids=["noisy_tail", "dense"])
@pytest.mark.parametrize("k,n", [(13, 5003), (51, 777), (2, 1)])
def test_window_keys_from_chunk_odd_tails(k, n, noisy):
    """Tail supersteps from the chunk: n no multiple of 16, so the JAX
    package's chunk route unpacks and takes its XLA formulation (on the
    clean bitmap)."""
    got = _from_chunk(*_chunk(n, k, seed=n + 1), k, n, noisy)
    (want,) = _jax_chunk_keys(k, n, n + 1, ("legacy",))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


def _funnel(packed, p):
    """Little-endian 16-base word at positions p .. p+15 of the packed
    stream (uint64 arrays; positions before 0 or past the words read 0)."""
    z = np.zeros(1, np.uint64)
    pk = np.concatenate([z, packed.astype(np.uint64), z, z])    # pk[i + 1] = packed[i]
    q, r = p // 16 + 1, p % 16
    pair = pk[q] | (pk[q + 1] << np.uint64(32))
    return (pair >> (np.uint64(2) * r.astype(np.uint64))) & np.uint64(M32)


def _pairrev(x):
    out = np.zeros_like(x)
    for j in range(16):
        out |= ((x >> np.uint64(2 * j)) & np.uint64(3)) << np.uint64(2 * (15 - j))
    return out


@pytest.mark.parametrize("k", [2, 13, 16, 17, 33, 51, 201])
def test_packed_word_identities(k):
    """The kernel's formulation, word by word, against the words built
    base by base from the bases: forward word w is the 2-bit-field
    reversal of the little-endian word at t + 16w; reverse-complement word
    w is the bitwise NOT of the little-endian word at t + k - 16(w+1)
    (before position 0 for the trailing word of the first windows, read
    as zeros).  Both masked to the trailing word's kept bits."""
    n = 700
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 4, n + k - 1).astype(np.uint8)
    packed, _ = fastio.pack_stream_np(bases)
    b = bases.astype(np.uint64)
    t = np.arange(n)
    W, r = -(-k // 16), k % 16
    tmask = np.uint64(M32 if r == 0 else (M32 << (32 - 2 * r)) & M32)
    for w in range(W):
        m = tmask if w == W - 1 else np.uint64(M32)
        fwd = _pairrev(_funnel(packed, t + 16 * w)) & m
        rc = ~_funnel(packed, t + k - 16 * (w + 1)) & np.uint64(M32) & m
        want_f = np.zeros(n, np.uint64)
        want_r = np.zeros(n, np.uint64)
        for j in range(min(16, k - 16 * w)):
            sh = np.uint64(2 * (15 - j))
            want_f |= b[t + 16 * w + j] << sh
            want_r |= (np.uint64(3) - b[t + k - 1 - 16 * w - j]) << sh
        np.testing.assert_array_equal(fwd, want_f)
        np.testing.assert_array_equal(rc, want_r)


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
    # the same from the chunk
    packed, mask = fastio.pack_stream_np(stream.astype(np.uint8))
    assert (np.stack(_from_chunk(packed, mask, k, n, False), 1) == keys).all()


def test_argument_checks():
    codes = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_winkeys.window_keys_torch(codes, 5, 7)    # needs 11 codes
    with pytest.raises(ValueError):
        cuda_winkeys.window_keys_torch(codes, 1, 5)
    with pytest.raises(ValueError):
        cuda_winkeys.window_keys_torch(codes.long(), 5, 6)
    assert [c.shape for c in cuda_winkeys.window_keys_torch(codes, 5, 0)] == [(0,)]
    packed, sep = torch.zeros(2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_winkeys.window_keys(packed, sep, k=5, n=29)          # 33 bases > 32
    with pytest.raises(ValueError):
        cuda_winkeys.window_keys(packed, sep[:0], k=5, n=20)      # no bitmap words
    with pytest.raises(ValueError):
        cuda_winkeys.window_keys(packed.long(), sep, k=5, n=20)
    assert [c.shape for c in cuda_winkeys.window_keys(packed, sep, k=5, n=0)] == [(0,)]
