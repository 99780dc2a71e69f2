"""The super-k-mer slice of the PyTorch port end to end on the CPU
(plain PyTorch versions of K1/K2/K5), held exactly to the JAX package's
``SkmCounter`` (Pallas kernels in interpret mode, or its XLA route on
the slotted layout) and to ``codec.golden_count``; grow-and-replay paths
and the slotted layout's S-ladder; ``.npz`` checkpoints in both
directions; store conversion between the packages."""

import numpy as np
import pytest

from bench import make_reads
from kaarme_tpu.models.skm_counter import SkmCounter as RefSkmCounter
from kaarme_tpu.models.skm_counter import SkmCounterConfig as RefSkmConfig
from kaarme_tpu.ops import skm as ref_skm
from kaarme_tpu.utils import codec
from kaarme_tpu_torch.models.skm_counter import SkmCounter, SkmCounterConfig
from kaarme_tpu_torch.ops import skm
from kaarme_tpu_torch.utils import convert


@pytest.fixture(scope="module")
def reads():
    codes = make_reads(0.12, 6, 150, seed=9)
    return codes, codec.golden_count(codes, 31)


def _port(**kw):
    base = dict(k=31, min_abundance=1, device="cpu", batch_windows=1 << 16,
                superbatch_batches=2, prefix_cap=1 << 15)
    base.update(kw)
    return SkmCounter(SkmCounterConfig(**base))


def test_dump_matches_reference_interpret_and_golden(reads):
    codes, golden = reads
    ref = RefSkmCounter(RefSkmConfig(
        k=31, batch_windows=1 << 16, rows=1 << 9, superbatch_batches=2,
        prefix_cap=1 << 15, min_abundance=1, segpack="dense_interpret",
        compactor="interpret")).count_codes(codes)
    c = _port().count_codes(codes)
    rk, rc = ref.dump()
    pk, pc = c.dump()
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(pc, rc)
    assert c.as_dict() == golden
    assert c.distinct_kmers() == ref.distinct_kmers() == len(golden)
    assert c.n_distinct == ref.n_distinct          # distinct run rows


def test_rows_overflow_replay(reads):
    codes, golden = reads
    c = _port(skm_cap_frac=4096).count_codes(codes)
    assert c.stats["slot_grow_events"] >= 1
    assert c.as_dict() == golden


def test_slotted_matches_reference_and_golden_through_the_ladder(reads):
    """segpack="slotted" (K5's layout) with S = 8: reads give tiles with
    more starts than that, so the S-ladder replays; the dump equals the
    JAX package's slotted counter (its XLA pack_slots route, same S)."""
    codes, golden = reads
    c = _port(segpack="slotted", skm_slots=8).count_codes(codes)
    assert c.stats["slot_grow_events"] > 0 and c._S > 8
    assert c.stats["replayed_supersteps"] >= c.stats["slot_grow_events"]
    assert c.as_dict() == golden
    ref = RefSkmCounter(RefSkmConfig(
        k=31, batch_windows=1 << 16, rows=1 << 9, superbatch_batches=2,
        prefix_cap=1 << 15, min_abundance=1, segpack="xla", skm_slots=8)).count_codes(codes)
    for a, b in zip(c.dump(), ref.dump()):
        np.testing.assert_array_equal(a, b)
    assert c.n_distinct == ref.n_distinct          # distinct run rows
    assert ref.stats["slot_grow_events"] > 0


def test_slotted_store_growth_and_unaligned_tail():
    """The slotted layout with store growth replays and a tail superstep
    of no whole number of 512-window tiles (the port takes any n)."""
    codes = make_reads(0.05, 3, 150, seed=2)
    codes = codes[: codes.shape[0] - 333]
    c = _port(segpack="slotted", batch_windows=1 << 12, superbatch_batches=1,
              prefix_cap=1 << 12).count_codes(codes)
    assert c.stats["grow_events"] >= 1
    assert (codes.shape[0] - 30) % (1 << 12) % 512
    assert c.as_dict() == codec.golden_count(codes, 31)


@pytest.mark.parametrize("segpack", ["pallas", "xla", "dense_interpret", "bogus"])
def test_segpack_names(segpack):
    with pytest.raises(ValueError, match="kernels='plain'" if segpack != "bogus"
                       else "segpack must be"):
        _port(segpack=segpack)
    assert _port(segpack="auto").cfg.segpack == "dense"


def test_store_growth_replay(reads):
    codes, golden = reads
    c = _port(batch_windows=1 << 12, superbatch_batches=1,
              prefix_cap=1 << 12).count_codes(codes)
    assert c.stats["grow_events"] >= 1
    assert c.as_dict() == golden


def test_growth_replay_after_quiet_supersteps():
    """A novel burst after low-novelty supersteps overflows a working
    size sized from the recent deltas; the replay must use the grown
    size (a replay at the same size would overflow again forever)."""
    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 4000).astype(np.uint8)
    starts = rng.integers(0, 4000 - 150, 3000)
    quiet = np.full((3000, 151), 4, np.uint8)
    quiet[:, :150] = genome[starts[:, None] + np.arange(150)]
    burst = rng.integers(0, 4, 300_000).astype(np.uint8)
    codes = np.concatenate([quiet.reshape(-1), burst])
    c = _port(batch_windows=1 << 15, superbatch_batches=1, prefix_cap=1 << 16)
    c.count_codes(codes)
    assert c.stats["grow_events"] + c.stats["compactions"] > 0
    assert c._eff_floor > 0                       # the overflow path ran
    assert c.as_dict() == codec.golden_count(codes, 31)


def test_checkpoint_reference_to_port(reads, tmp_path):
    codes, golden = reads
    half = codes.shape[0] // 2
    ref = RefSkmCounter(RefSkmConfig(k=31, batch_windows=1 << 16, rows=1 << 9,
                                     superbatch_batches=2, prefix_cap=1 << 15,
                                     min_abundance=1))
    ref.add_codes(codes[:half])
    p = str(tmp_path / "ref.npz")
    ref.save(p)
    c = SkmCounter.load(p, SkmCounterConfig(k=31, min_abundance=1, device="cpu",
                                            batch_windows=1 << 16, superbatch_batches=2,
                                            prefix_cap=1 << 15))
    assert c.n_distinct == ref.n_distinct
    c.add_codes(codes[half:])
    c.finish()
    assert c.as_dict() == golden


def test_checkpoint_port_to_reference(tmp_path):
    codes = make_reads(0.05, 6, 150, seed=9)
    golden = codec.golden_count(codes, 31)
    half = codes.shape[0] // 2
    c = _port()
    c.add_codes(codes[:half])
    p = str(tmp_path / "port.npz")
    c.save(p)
    ref = RefSkmCounter.load(p, RefSkmConfig(k=31, batch_windows=1 << 16, rows=1 << 9,
                                             superbatch_batches=2, prefix_cap=1 << 15,
                                             min_abundance=1))
    ref.add_codes(codes[half:])
    ref.finish()
    # The reference's cold-start working size after a load (2^14 rows
    # here) ignores the live rows, and a store overflow on that path
    # replays at the same size without end (ROADMAP C): this store stays
    # below it, so the reference resumes exactly.
    assert ref.n_used <= 1 << 14
    assert ref.as_dict() == golden


def test_resume_keeps_a_large_store_whole(tmp_path):
    """Resuming a store larger than the cold-start working size must
    not cut its live rows (the port counts n_used in the cold start)."""
    codes = make_reads(0.4, 3, 150, seed=4)
    golden = codec.golden_count(codes, 31)
    kw = dict(k=31, min_abundance=1, device="cpu", batch_windows=1 << 15,
              superbatch_batches=1, prefix_cap=1 << 17)
    c = SkmCounter(SkmCounterConfig(**kw))
    half = codes.shape[0] // 2
    c.add_codes(codes[:half])
    p = str(tmp_path / "big.npz")
    c.save(p)
    assert c.n_used > (1 << 14) + (1 << 15) // 32   # above the old cold-start target
    c2 = SkmCounter.load(p, SkmCounterConfig(**kw))
    c2.add_codes(codes[half:])
    c2.finish()
    assert c2.as_dict() == golden


@pytest.mark.parametrize("single_shot_rows", [None, 1 << 10])
def test_finalize_of_reference_run_store(reads, single_shot_rows):
    """The JAX package's run store, converted to port tensors, finalizes
    to the JAX package's k-mer store (single-shot and chunked)."""
    codes, _ = reads
    ref = RefSkmCounter(RefSkmConfig(k=31, batch_windows=1 << 16, rows=1 << 9,
                                     superbatch_batches=2, prefix_cap=1 << 15,
                                     min_abundance=1)).count_codes(codes)
    run_cols = [np.asarray(col[: ref.n_used]) for col in ref.prefix]
    want_k, want_c = ref_skm.finalize_counts(tuple(run_cols), 31)
    store, nd = skm.finalize_store(convert.columns_to_torch(run_cols, "cpu"), 31,
                                   chunk_rows=1 << 8, single_shot_rows=single_shot_rows,
                                   kernels="plain")
    cols = convert.columns_to_numpy(tuple(c[:nd] for c in store))
    keys = np.stack(cols[:-1], 1)
    cnt = cols[-1].astype(np.int64)
    live = cnt > 0
    np.testing.assert_array_equal(keys[live], want_k)
    np.testing.assert_array_equal(cnt[live], want_c)


def test_find_save_roundtrip_and_device_error(reads, tmp_path):
    codes, golden = reads
    c = _port(mode=0, min_abundance=2).count_codes(codes)
    some = list(golden)[:5]
    assert c.find(some) == [golden[s] & 0xFFFF for s in some]
    assert c.find(["N" * 31, "ACGT"]) == [-1, -1]
    p = str(tmp_path / "again.npz")
    c.save(p)
    back = SkmCounter.load(p, device="cpu")
    assert back.cfg.mode == 0 and back.as_dict() == c.as_dict()
