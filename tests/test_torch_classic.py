"""The classic sort pipeline of the PyTorch port (one row per window:
K3 keys, then sort + K2, or K4's linear merge under
``compactor="merge"``), held exactly to the JAX package: each superstep
against the JAX superstep on its Pallas kernels in interpret mode, the
streaming counter against the JAX counter and ``codec.golden_count``,
grow-and-replay, and ``.npz`` checkpoints in both directions.  The k=13
and k=31 supersteps pin the port's full_sum route against the JAX
package's c_last route.  Tolerance 0: every quantity is an integer."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bench import make_reads
from kaarme_tpu.models.sort_counter import SortCounterConfig as RefConfig
from kaarme_tpu.models.sort_counter import SortKmerCounter as RefCounter
from kaarme_tpu.ops import sortcount as ref_sc
from kaarme_tpu.utils import codec
from kaarme_tpu_torch.models.sort_counter import SortCounterConfig, SortKmerCounter
from kaarme_tpu_torch.ops import sortcount
from kaarme_tpu_torch.utils import convert

N = 1 << 12          # windows per superstep
CAP = 1 << 13        # store rows


def _chunk(k, seed, ref_dense):
    """A superstep's transfer chunk: reads drawn from a short genome (so
    keys repeat within and across chunks), separators every 61.  Returns
    (words, bitmap, the separators for the JAX superstep: the bitmap, or
    without ``ref_dense`` its padded separator list, valid windows)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    codes = genome[rng.integers(0, 600 - 60, N // 60 + 2)[:, None] + np.arange(60)].reshape(-1)
    codes = codes[:N + k - 1].copy()
    codes[::61] = 4
    packed, maskw = ref_sc.pack_stream_np(codes)
    seps = np.flatnonzero(codes >= 4).astype(np.uint32)
    ref_sep = maskw if ref_dense else np.concatenate([seps, np.full(9, codes.shape[0], np.uint32)])
    inv = np.concatenate([[0], np.cumsum(codes >= 4)])
    return packed, maskw, ref_sep, int(((inv[k:k + N] - inv[:N]) == 0).sum())


def _port_step(variant, packed, sep, prefix, k):
    t = lambda a: torch.from_numpy(a.view(np.int32))
    kw = dict(k=k, n=N, kernels="cuda")
    if variant == "merged":
        return sortcount.superstep_merged(t(packed), t(sep), prefix,
                                          ebits=sortcount.embed_bits(k), **kw)
    if variant == "embedded":
        return sortcount.superstep_embedded(t(packed), t(sep), prefix,
                                            ebits=sortcount.embed_bits(k), **kw)
    return sortcount.superstep_plain(t(packed), t(sep), prefix, **kw)


def _ref_step(variant, packed, sep, prefix, k, dense):
    kw = dict(k=k, n=N, rows=1 << 5, dense=dense)
    args = (jnp.asarray(packed), jnp.asarray(sep), prefix)
    if variant == "merged":
        return ref_sc.superstep_merged(*args, ebits=ref_sc.embed_bits(k),
                                       pallas="merge_interpret", **kw)
    if variant == "embedded":
        return ref_sc.superstep_embedded(*args, ebits=ref_sc.embed_bits(k),
                                         pallas="interpret", **kw)
    return ref_sc.superstep_plain(*args, pallas="interpret", **kw)


def _live(cols, ndu):
    arr = np.stack([np.asarray(c)[:ndu].astype(np.uint32) for c in cols], 1)
    return arr[arr[:, -1] > 0]


@pytest.mark.parametrize("k,variant,ref_dense", [
    (13, "plain", False), (31, "plain", True), (51, "embedded", False),
    (13, "merged", False), (51, "merged", True)])
def test_superstep_matches_reference(k, variant, ref_dense):
    """Superstep 2 of a stream (superstep 1, on the port, fills the
    prefix) on both packages from the same prefix: the port's from the
    bitmap, the JAX package's from its bitmap (``ref_dense``) or its
    separator list."""
    W = codec.words_per_kmer(k)
    p1, b1, _, _ = _chunk(k, 1, ref_dense)
    prefix, nd1 = _port_step(variant, p1, b1, sortcount.make_store(CAP, W, "cpu"), k)
    assert 0 < int(nd1[0]) < CAP
    p2, b2, s2, valid = _chunk(k, 2, ref_dense)
    got, ndv = _port_step(variant, p2, b2, prefix, k)
    nd, ndu = ndv.tolist()
    assert nd == ndu <= CAP
    ref_prefix = tuple(jnp.asarray(c) for c in convert.columns_to_numpy(prefix))
    ref, rnd = _ref_step(variant, p2, s2, ref_prefix, k, ref_dense)
    assert nd == int(np.asarray(rnd)[0])
    mine = _live(convert.columns_to_numpy(got), nd)
    assert mine.shape[0] == nd
    np.testing.assert_array_equal(mine, _live(ref, int(np.asarray(rnd)[1])))
    # rows past nd are sentinels with count 0
    assert all(bool((c[nd:] == (0 if i == W else -1)).all()) for i, c in enumerate(got))
    # total mass: the prefix's counts + every valid window of the chunk
    assert int(mine[:, -1].sum()) == int(prefix[-1].sum()) + valid > valid > 0


@pytest.fixture(scope="module")
def reads():
    return make_reads(0.05, 6, 150, seed=9)


_REF_DUMPS = {}


def _ref_dump(codes, k):
    """The JAX counter's dump (its XLA route on the CPU), once per k."""
    if k not in _REF_DUMPS:
        _REF_DUMPS[k] = RefCounter(RefConfig(
            k=k, batch_windows=1 << 14, rows=1 << 7, superbatch_batches=2,
            prefix_cap=1 << 16, min_abundance=1)).count_codes(codes).dump()
    return _REF_DUMPS[k]


def _port(k, compactor, **kw):
    base = dict(k=k, min_abundance=1, device="cpu", batch_windows=1 << 14,
                superbatch_batches=2, prefix_cap=1 << 12, compactor=compactor)
    base.update(kw)
    return SortKmerCounter(SortCounterConfig(**base))


@pytest.mark.parametrize("k", [13, 31, 51])
@pytest.mark.parametrize("compactor", ["auto", "merge"])
def test_counter_matches_reference_and_golden(reads, k, compactor):
    """A store of 2^12 rows for ~50,000 distinct k-mers: grow-and-replay
    runs on every route."""
    c = _port(k, compactor).count_codes(reads)
    assert c.stats["grow_events"] >= 1
    pk, pc = c.dump()
    rk, rc = _ref_dump(reads, k)
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(pc, rc)
    assert c.as_dict() == codec.golden_count(reads, k)


def test_checkpoint_reference_to_port(reads, tmp_path):
    k, half = 13, reads.shape[0] // 2
    ref = RefCounter(RefConfig(k=k, batch_windows=1 << 14, rows=1 << 7,
                               superbatch_batches=2, prefix_cap=1 << 16, min_abundance=1))
    ref.add_codes(reads[:half])
    p = str(tmp_path / "ref.npz")
    ref.save(p)
    c = SortKmerCounter.load(p, SortCounterConfig(k=k, min_abundance=1, device="cpu",
                                                  batch_windows=1 << 14,
                                                  superbatch_batches=2, compactor="merge"))
    assert c.n_distinct == ref.n_distinct
    c.add_codes(reads[half:])
    c.finish()
    assert c.as_dict() == codec.golden_count(reads, k)


def test_checkpoint_port_to_reference(reads, tmp_path):
    k, half = 51, reads.shape[0] // 2
    c = _port(k, "auto")
    c.add_codes(reads[:half])
    p = str(tmp_path / "port.npz")
    c.save(p)
    ref = RefCounter.load(p, RefConfig(k=k, batch_windows=1 << 14, rows=1 << 7,
                                       superbatch_batches=2, prefix_cap=1 << 16,
                                       min_abundance=1))
    assert ref.n_distinct == c.n_distinct
    ref.add_codes(reads[half:])
    ref.finish()
    assert ref.as_dict() == codec.golden_count(reads, k)
    back = SortKmerCounter.load(p, device="cpu")
    assert back.cfg.k == k and back.n_distinct == c.n_distinct


def test_config_checks():
    with pytest.raises(ValueError, match="compactor"):
        SortCounterConfig(k=13, compactor="xla", device="cpu")
