"""K5 (slotted run segmentation) of the PyTorch port, held exactly to
the JAX package: the wrapper on CPU tensors (its plain version, what the
CPU runs), fed the transfer chunk as the counter ships it
(``fastio.pack_stream_np``: packed 2-bit words and the separator
bitmap), against the reference's ``run_rows`` +
``pack_slots`` and against ``pallas_skm.run_rows_slotted_pallas
(interpret=True)``, on the cases of tests/test_pallas_skm.py, plus an
unaligned tail against the NumPy mirror ``skm.run_rows_np``.  Every
quantity is an integer, so the tolerance is 0.  The CUDA kernel itself
is compared with the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bench import make_reads
from chunk_noise import noisy_tail
from kaarme_tpu.ops import pallas_skm, skm, sortcount
from kaarme_tpu_torch.io import fastio
from kaarme_tpu_torch.ops import cuda_skm

BLK = 128 * 128      # the JAX kernel's block at block_rows=128


def _stream(rng, n, k, p_sep=0.01, glen=600, read_len=120):
    """Coverage-shaped code stream (tests/test_pallas_skm.py's shape)."""
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    parts, tot = [], 0
    while tot < n + k:
        s = int(rng.integers(0, glen - read_len))
        r = genome[s: s + read_len].copy()
        r[rng.random(read_len) < p_sep] = 4
        parts += [r, np.full(1, 4, np.uint8)]
        tot += read_len + 1
    return np.concatenate(parts)[: n + k - 1]


def _codes32(codes):
    return torch.from_numpy(((codes & 3) | ((codes >= 4) << 2)).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _port(codes, k, n, S, noisy=False):
    """The wrapper from the chunk of ``codes``; ``noisy``: with random
    bases at the invalid positions and random bases and bitmap bits at
    and past L (``noisy_tail``), which must not matter."""
    L = codes.shape[0]
    _, mask = fastio.pack_stream_np(codes)
    bases = codes
    if noisy:
        noise = np.random.default_rng(L).integers(0, 4, L).astype(np.uint8)
        bases = np.where(codes >= 4, noise, codes)
    packed, _ = fastio.pack_stream_np(bases)
    if noisy:
        packed, mask = noisy_tail(packed, mask, L, seed=L)
    cols, maxruns = cuda_skm.run_rows_slotted(_t(packed), _t(mask), k=k, n=n, S=S)
    return [c.numpy().view(np.uint32) for c in cols], int(maxruns)


def _xla(codes, k, n, S):
    packed, maskw = sortcount.pack_stream_np(codes)
    Wc = skm.content_words(k)
    need_words = (n + 16 * (Wc - 1)) // 16 + 2
    pk = jnp.concatenate([jnp.asarray(packed),
                          jnp.zeros((max(0, need_words - packed.shape[0]),), jnp.uint32)])
    inval = sortcount.invalid_from_dense(jnp.asarray(maskw), n + k - 1)
    b, cols = skm.run_rows(pk, inval, k, n)
    cols, maxruns = skm.pack_slots(b, cols, n, S, k)
    return [np.asarray(c) for c in cols], int(maxruns)


def _pallas(codes, k, n, S):
    packed, maskw = sortcount.pack_stream_np(codes)
    cod = sortcount.unpack_codes(jnp.asarray(packed), jnp.asarray(maskw), n + k - 1)
    cols, maxruns = pallas_skm.run_rows_slotted_pallas(cod, k=k, n=n, S=S, block_rows=128,
                                                       interpret=True)
    return [np.asarray(c) for c in cols], int(maxruns)


def _assert_same(a, b):
    assert a[1] == b[1]
    assert len(a[0]) == len(b[0])
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)


def _poly_a(n, k):
    base = np.zeros(n + k - 1, np.uint8)
    base[n // 2] = 4
    return base


def _late_tiles(n, k):
    codes = make_reads(n / 1e6 / 0.66, 1, 150)[: n + k - 1]
    return np.concatenate([codes, np.full(max(0, n + k - 1 - codes.shape[0]), 4, np.uint8)])


@pytest.mark.parametrize("k", [16, 31, 51])
def test_plain_k5_matches_reference(k):
    n, S = 2 * BLK, 16
    codes = _stream(np.random.default_rng(k), n, k)
    got = _port(codes, k, n, S)
    _assert_same(got, _xla(codes, k, n, S))
    _assert_same(got, _pallas(codes, k, n, S))


@functools.lru_cache(maxsize=None)
def _formats_case(k):
    """The stream of ``test_chunk_k5_formats_match_reference`` and the
    reference's slots for it, made once for its two cases; the shape of
    ``test_plain_k5_matches_reference``, whose reference ops are then
    compiled already."""
    n, S = 2 * BLK, 16
    codes = _stream(np.random.default_rng(k + 7), n, k)
    return codes, _xla(codes, k, n, S)


@pytest.mark.parametrize("noisy", [False, True], ids=["dense", "noisy_tail"])
@pytest.mark.parametrize("k", [16, 51])
def test_chunk_k5_formats_match_reference(k, noisy):
    """The bitmap, clean and with random bases under its separators and
    random bases and bits at and past L, gives the reference's slots
    (``run_rows`` + ``pack_slots`` on the clean bitmap)."""
    codes, want = _formats_case(k)
    _assert_same(_port(codes, k, 2 * BLK, 16, noisy), want)


def test_plain_k5_slot_overflow_matches_reference():
    """Random stream (minimizer churn), S = 4: the same dropped rows and
    the same max_tile_runs > S."""
    k, n, S = 17, BLK, 4
    codes = np.random.default_rng(3).integers(0, 4, size=n + k - 1).astype(np.uint8)
    got = _port(codes, k, n, S)
    assert got[1] > S
    _assert_same(got, _xla(codes, k, n, S))
    _assert_same(got, _pallas(codes, k, n, S))


@pytest.mark.parametrize("case", ["poly_a", "late_tiles"])
def test_plain_k5_runs_across_tiles_match_reference(case):
    """Poly-A: runs cross tile and block edges and the LMAX cap cascades;
    coverage-1 reads: tiles whose few starts sit late, before tiles with
    early starts."""
    k, S = (31, 96) if case == "poly_a" else (51, 96)
    n = 2 * BLK
    codes = _poly_a(n, k) if case == "poly_a" else _late_tiles(n, k)
    got = _port(codes, k, n, S)
    _assert_same(got, _xla(codes, k, n, S))
    _assert_same(got, _pallas(codes, k, n, S))
    _assert_same(_port(codes, k, n, S, noisy=True), got)


@pytest.mark.parametrize("k,n", [(16, 3000), (51, 777), (31, 1025), (101, 4096)])
def test_plain_k5_unaligned_tail_matches_mirror(k, n):
    """Any n: the live rows (a multiset) equal the NumPy mirror, the last
    tile is partial, and max_tile_runs is the most run starts (dead ones
    included) below n in any tile."""
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n + k - 1).astype(np.uint8)
    codes[::97] = 4
    S = 512
    cols, maxruns = _port(codes, k, n, S, noisy=True)
    rows = np.stack(cols, 1)
    assert rows.shape[0] == -(-n // 512) * S
    got = {}
    for r in rows[rows[:, -1] != 0xFFFFFFFF]:
        key = tuple(int(x) for x in r[:-1]) + (int(r[-1]) & ~((1 << 26) - 1),)
        got[key] = got.get(key, 0) + (int(r[-1]) & ((1 << 26) - 1))
    assert got == skm.run_rows_np(codes, k, n)
    runs, _ = skm.runs_np(codes, k, n)
    assert maxruns == np.bincount([s // 512 for s, _, _ in runs]).max()


def test_plain_k5_equals_dense_rows():
    """The live slotted rows, in order, are K1's dense rows when no tile
    overflows."""
    k, n = 51, 5000
    codes = _stream(np.random.default_rng(1), n, k)
    cols, maxruns = _port(codes, k, n, 512)
    slotted = np.stack(cols, 1)
    slotted = slotted[slotted[:, -1] != 0xFFFFFFFF]
    dense, rows = cuda_skm.run_rows_dense_torch(_codes32(codes), k=k, n=n, cap=n)
    dense = np.stack([c.numpy().view(np.uint32) for c in dense], 1)[: int(rows[0])]
    np.testing.assert_array_equal(slotted, dense)


def test_plain_k5_rejects_bad_slots():
    packed, sep = _t(np.zeros(7, np.uint32)), _t(np.zeros(3, np.uint32))
    for S in (0, 513):
        with pytest.raises(ValueError, match="S must be"):
            cuda_skm.run_rows_slotted(packed, sep, k=31, n=50, S=S)
    with pytest.raises(ValueError, match="bases"):
        cuda_skm.run_rows_slotted(packed, sep, k=31, n=100, S=8)
    with pytest.raises(ValueError, match="bitmap"):
        cuda_skm.run_rows_slotted(packed, sep[:1], k=31, n=50, S=8)
