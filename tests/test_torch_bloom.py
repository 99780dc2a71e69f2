"""The two-pass Bloom prefilter (``-b``) of the PyTorch port on the sort
backend, held exactly to the JAX package: the hashes against
``hash_words_np``; the filter operations, word for word, against
``kaarme_tpu.ops.bloom``; and the two-pass counters (classic, with and
without the linear merge, and skm, dense and slotted) against the golden
count >= 2 and the JAX counters, down to their BF2 words and their
``new_in_first`` / ``new_in_second`` at equal superstep sizes.  Every
quantity is an integer, so the tolerance is 0."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaarme_tpu.models import bloom_counter as ref_bc
from kaarme_tpu.models.skm_counter import SkmCounterConfig as RefSkmConfig
from kaarme_tpu.models.sort_counter import SortCounterConfig as RefSortConfig
from kaarme_tpu.ops import bloom as ref_bloom
from kaarme_tpu.ops import hashing as ref_hashing
from kaarme_tpu.utils import codec
from kaarme_tpu_torch.models import bloom_counter
from kaarme_tpu_torch.models.skm_counter import SkmCounterConfig
from kaarme_tpu_torch.models.sort_counter import SortCounterConfig
from kaarme_tpu_torch.ops import bloom, hashing
from kaarme_tpu_torch.utils import convert


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _words(bf):
    return bf.numpy().view(np.uint32)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_hash_words_matches_reference(W):
    rng = np.random.default_rng(W)
    words = [rng.integers(0, 1 << 32, 5000, dtype=np.uint32) for _ in range(W)]
    words[0][:7] = 0xFFFFFFFF
    cols = [torch.from_numpy(w.view(np.int32)) for w in words]
    lo, hi = hashing.hash_words64(cols)
    np.testing.assert_array_equal(lo.numpy().astype(np.uint32), ref_hashing.hash_words_np(words))
    np.testing.assert_array_equal(hi.numpy().astype(np.uint32),
                                  ref_hashing.hash_words_np(words, 0x5BD1E995))
    r1, r2 = ref_hashing.hash_words64([jnp.asarray(w) for w in words])
    np.testing.assert_array_equal(lo.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(r2))


def test_set_and_contains_roundtrip():
    rng = np.random.default_rng(0)
    r1 = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    r2 = rng.integers(0, 2**32, size=100, dtype=np.uint32)
    active = np.arange(100) % 2 == 0
    bf = bloom.set_bits(bloom.make_bloom(1 << 12, device="cpu"), _t(r1), _t(r2), 5,
                        torch.from_numpy(active))
    got = bloom.contains(bf, _t(r1), _t(r2), 5).numpy()
    assert got[::2].all() and got[1::2].sum() < 10
    ref = ref_bloom.set_bits(ref_bloom.make_bloom(1 << 12), jnp.asarray(r1), jnp.asarray(r2),
                             5, jnp.asarray(active))
    np.testing.assert_array_equal(_words(bf), np.asarray(ref))


def test_set_bits_lands_every_bit_under_contention():
    """4096 keys in 32 words: every bit lands (no scatter loses one)."""
    n = 4096
    r1 = (np.arange(n, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(np.uint32)
    r2 = (np.arange(n, dtype=np.uint64) * 40503 + 7).astype(np.uint32)
    bf = bloom.set_bits(bloom.make_bloom(1 << 10, device="cpu"), _t(r1), _t(r2), 7,
                        torch.ones(n, dtype=torch.bool))
    assert bool(bloom.contains(bf, _t(r1), _t(r2), 7).all())
    ref = ref_bloom.set_bits(ref_bloom.make_bloom(1 << 10), jnp.asarray(r1), jnp.asarray(r2), 7,
                             jnp.ones((n,), bool))
    np.testing.assert_array_equal(_words(bf), np.asarray(ref))


def test_insert_batch_matches_reference_over_batches():
    """Batches with in-batch doubletons, keys seen in earlier batches and
    invalid entries; the port's filters start from the JAX state after
    the first batch (utils.convert), then both run on."""
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2**32, (400, 2), dtype=np.uint32)
    bits, hfn = 1 << 13, 5
    rb1, rb2 = ref_bloom.make_bloom(bits), ref_bloom.make_bloom(bits)
    pb1 = pb2 = None
    for i in range(5):
        b = keys[rng.integers(0, 400, 600)]
        valid = rng.random(600) < 0.9
        rb1, rb2, n1, n2 = ref_bloom.insert_batch(rb1, rb2, jnp.asarray(b[:, 0]),
                                                  jnp.asarray(b[:, 1]), jnp.asarray(valid), hfn)
        if pb1 is None:
            pb1, pb2 = convert.bloom_to_torch(rb1, "cpu"), convert.bloom_to_torch(rb2, "cpu")
            continue
        pb1, pb2, m1, m2 = bloom.insert_batch(pb1, pb2, _t(b[:, 0]), _t(b[:, 1]),
                                              torch.from_numpy(valid), hfn)
        assert (int(m1), int(m2)) == (int(n1), int(n2))
        np.testing.assert_array_equal(_words(pb1), np.asarray(rb1))
        np.testing.assert_array_equal(_words(pb2), np.asarray(rb2))
    assert int(m2) > 0


def _dup_stream(seed, n, dup):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[rng.random(n) < 0.01] = 4
    return np.concatenate([codes, codes[dup[0]:dup[1]]])   # duplication pressure


@pytest.fixture(scope="module")
def sort_codes():
    return _dup_stream(11, 30000, (0, 9000))


def _golden2(codes, k):
    return {km: n for km, n in codec.golden_count(codes, k).items() if n >= 2}


def _same_run(port, ref, codes, k):
    assert port.as_dict() == ref.as_dict() == _golden2(codes, k)
    for key in ("new_in_first", "new_in_second", "bloom_bits", "bloom_hash_functions"):
        assert port.stats[key] == ref.stats[key], key
    np.testing.assert_array_equal(_words(port.bf2), np.asarray(ref.bf2))
    assert port.bf1 is None


@pytest.mark.parametrize("k,compactor", [(13, "auto"), (21, "auto"), (27, "auto"),
                                         (13, "merge"), (21, "merge")])
def test_bloom_sort_count_matches_reference(sort_codes, k, compactor):
    """k=13 and 27: the separate-count superstep; 21: the embedded one;
    merge: K4's superstep with the gate."""
    kw = dict(batch_windows=1 << 10, superbatch_batches=2, prefix_cap=1 << 12,
              min_abundance=2)
    port = bloom_counter.bloom_sort_count_codes(
        SortCounterConfig(k=k, device="cpu", compactor=compactor, **kw), 4000, 0.01,
        sort_codes)
    ref = ref_bc.bloom_sort_count_codes(RefSortConfig(k=k, rows=1 << 5, **kw), 4000, 0.01,
                                        sort_codes)
    _same_run(port, ref, sort_codes, k)
    assert port.cfg.prefix_cap == ref.cfg.prefix_cap
    assert port.stats["pass1_batches"] == ref.stats["pass1_batches"]


@pytest.mark.parametrize("k,segpack", [(19, "dense"), (21, "dense"), (21, "slotted")])
def test_bloom_skm_count_matches_reference(k, segpack):
    codes = _dup_stream(21, 60000, (0, 20000))
    kw = dict(batch_windows=1 << 14, superbatch_batches=2, prefix_cap=1 << 14,
              min_abundance=2)
    port = bloom_counter.bloom_skm_count_codes(
        SkmCounterConfig(k=k, device="cpu", segpack=segpack, skm_slots=32, **kw), 8000, 0.01,
        codes)
    ref = ref_bc.bloom_skm_count_codes(
        RefSkmConfig(k=k, rows=1 << 9, segpack="xla", compactor="xla", **kw), 8000, 0.01,
        codes)
    _same_run(port, ref, codes, k)
    # start_pass2 reset the stream statistics: they count pass 2 alone
    assert port.stats["windows_processed"] == ref.stats["windows_processed"]
    assert port.stats["pass1_batches"] == ref.stats["pass1_batches"] > 0


def test_bloom_file_two_pass_matches_in_memory(tmp_path):
    codes = _dup_stream(5, 8000, (1000, 5000))
    text = codec.decode_codes(codes).replace("N", "\n")
    p = tmp_path / "reads.txt"
    p.write_text(text + "\n")
    cfg = dict(k=15, device="cpu", batch_windows=1 << 10, superbatch_batches=2,
               prefix_cap=1 << 12, min_abundance=2)
    a = bloom_counter.bloom_sort_count_file(SortCounterConfig(**cfg), 3000, 0.01, str(p))
    b = bloom_counter.bloom_sort_count_codes(SortCounterConfig(**cfg), 3000, 0.01,
                                             codec.encode_plain(p.read_bytes()))
    assert a.as_dict() == b.as_dict()
    assert a.stats["new_in_second"] == b.stats["new_in_second"] > 0
    with pytest.raises(RuntimeError, match="twice"):
        a.start_pass2()
