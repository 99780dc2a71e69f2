"""The probe-table route's host tiling and device windows in the PyTorch
port, held to the JAX package: ``canonical_windows`` and
``windows_with_hash`` against ``kaarme_tpu.ops.windows`` (keys, validity
and slot hashes at k from 2 to 51, with N patches and invalid codes),
the table route's windows from the transfer chunk against them,
``TileBatcher`` against ``kaarme_tpu.models.tiling`` batch for batch, and
the table sizing helpers.  Every quantity is an integer: tolerance 0."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaarme_tpu.models import tiling as ref_tiling
from kaarme_tpu.ops import windows as ref_windows
from kaarme_tpu.utils import mathutils as ref_math
from kaarme_tpu_torch.models import sort_counter, tiling
from kaarme_tpu_torch.ops import sortcount, windows
from kaarme_tpu_torch.ops.hashing import hash_words
from kaarme_tpu_torch.utils import mathutils


def _tiles(seed, shape=(3, 180)):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    codes[0, 40:43] = 4                # an N patch
    codes[1, ::37] = 4
    codes[2, 100:160] = 0              # poly-A: forward == reverse complement of poly-T
    return codes


@pytest.mark.parametrize("k", [2, 5, 15, 16, 17, 31, 33, 51])
def test_canonical_windows_match_reference(k):
    codes = _tiles(k)
    rk, rv = ref_windows.canonical_windows(jnp.asarray(codes), k)
    pk, pv = windows.canonical_windows(torch.from_numpy(codes), k)
    assert len(pk) == len(rk) == windows.words_per_kmer(k) == ref_windows.words_per_kmer(k)
    for a, b in zip(rk, pk):
        assert b.dtype == torch.int64
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
    np.testing.assert_array_equal(np.asarray(rv), pv.numpy())
    assert not pv.numpy().all() and pv.numpy().any()


@pytest.mark.parametrize("k", [2, 5, 15, 16, 17, 31, 33, 51])
def test_windows_with_hash_match_reference(k):
    codes = _tiles(100 + k)
    rk, rv, rh = ref_windows.windows_with_hash(jnp.asarray(codes), k)
    pk, pv, ph = windows.windows_with_hash(torch.from_numpy(codes), k)
    for a, b in zip(rk, pk):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
    np.testing.assert_array_equal(np.asarray(rv), pv.numpy())
    np.testing.assert_array_equal(np.asarray(rh).astype(np.int64), ph.numpy())


def test_windows_of_unfolded_flat_batch_equal_reference_tiles():
    """The counters cut tiles on the device from the flat batch
    (``unfold``): the windows of the JAX package's host tile view."""
    k, tile, bt = 21, 64, 4
    flat = _tiles(7, (3, bt * tile + k - 1)).reshape(-1)[: bt * tile + k - 1]
    (host,) = list(ref_tiling.TileBatcher(k, tile, bt).add(flat))
    rk, rv, rh = ref_windows.windows_with_hash(jnp.asarray(host), k)
    pk, pv, ph = windows.windows_with_hash(torch.from_numpy(flat).unfold(0, tile + k - 1, tile), k)
    for a, b in zip(list(rk) + [rv, rh], list(pk) + [pv, ph]):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64))


@pytest.mark.parametrize("k", [2, 5, 15, 16, 17, 31, 33, 51])
def test_chunk_windows_equal_tile_windows(k):
    """The table route's key columns (K3's plain version on the batch's
    transfer chunk): all-ones exactly where ``windows_with_hash`` on the
    batch's tiles is invalid, and the same keys and hashes wherever
    valid."""
    tile, bt = 64, 4
    flat = _tiles(200 + k, (3, bt * tile + k - 1)).reshape(-1)[: bt * tile + k - 1]
    words, bits, n = sort_counter.pack_chunk(flat, bt * tile)
    cpu = torch.device("cpu")
    ck = sortcount.window_keys_from_chunk(sort_counter.to_device(words, cpu),
                                          sort_counter.to_device(bits, cpu), k=k, n=n)
    cv, ch = sortcount._is_sentinel_i32(ck) == 0, hash_words(ck)
    wk, wv, wh = windows.windows_with_hash(torch.from_numpy(flat).unfold(0, tile + k - 1, tile), k)
    assert torch.equal(cv, wv) and not cv.all() and cv.any()
    for a, b in zip(ck, wk):
        assert a.dtype == torch.int32
        assert torch.equal((a.to(torch.int64) & 0xFFFFFFFF)[cv], b[cv])
        assert bool((a[~cv] == -1).all())
    assert torch.equal(ch[cv], wh[cv])


def test_short_tile_raises():
    with pytest.raises(ValueError, match="tile length"):
        windows.canonical_windows(torch.zeros((2, 10), dtype=torch.uint8), 11)


@pytest.mark.parametrize("k,tile,bt", [(5, 16, 3), (31, 64, 4), (51, 32, 2)])
def test_tile_batcher_matches_reference(k, tile, bt):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, 1500).astype(np.uint8)
    pieces = np.array_split(codes, [0, 1, 200, 201, 700, 1499])
    ref = ref_tiling.TileBatcher(k, tile, bt)
    port = tiling.TileBatcher(k, tile, bt)
    want, flats = [], []
    for p in pieces:
        want += [np.array(t) for t in ref.add(p)]
        flats += [np.array(t) for t in port.add_flat(p)]
    want += [np.array(t) for t in ref.finish()]
    flats += [np.array(t) for t in port.finish_flat()]
    assert len(want) == len(flats) >= 2
    for w, f in zip(want, flats):
        assert f.shape == (bt * tile + k - 1,)
        np.testing.assert_array_equal(torch.from_numpy(f).unfold(0, tile + k - 1, tile).numpy(), w)


@pytest.mark.parametrize("n", [0, 1, 2, 255, 256, 257, 4095, 4096, 8_000_000])
def test_sizing_helpers_match_reference(n):
    assert mathutils.capacity_log2(n) == ref_math.capacity_log2(n)
    assert mathutils.next_pow2(n) == ref_math.next_pow2(n)
