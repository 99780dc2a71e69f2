"""Two-pass Bloom-prefiltered counting, in PyTorch — the counterpart of
``kaarme_tpu/models/bloom_counter.py`` (the reference's ``-b`` mode), on
the probe table (``bloom_count_file``: ``--backend table -b``) and on
the sort backend.

pass 1  stream the whole input; every valid window's canonical key
        (K3) is hashed to a 64-bit root and inserted into the two-stage
        blocked Bloom filter (BF1 = seen once, BF2 = seen twice);
sizing  the probe table and the classic store are sized from 2 x the
        BF2 counter ``new_in_second``; BF1 is dropped;
pass 2  stream the input again and count only k-mers whose bits are all
        set in BF2: the probe table inserts only windows that hit BF2
        (``BloomFilteredCounter``); on the classic pipeline failing windows become
        sentinel rows before the sort (the ``bloom``/``hfn`` gate of
        ``ops/sortcount``'s supersteps, with K2 or K4); on the skm
        pipeline runs stream unfiltered (a run row packs up to LMAX
        windows) and the gate applies at finalize expansion, where
        windows materialize.

Singletons never reach the final store; false positives only admit
singletons that the min-abundance threshold drops.  Both backends size
the filters alike (``make_filters``) and run the same pass-1 step
(``sortcount.bloom_pass1_superstep``: K3 on the transfer chunk, then the
filter insert, B1, with one scratch allocated per pass; the pass-2 gate
is B2), each over its own batches: the table's tile batches, the
sort backend's supersteps.  BF words and both counters equal the JAX
package's at equal batch sizes (tile and batch_tiles on the table,
superstep sizes on the sort backend): the batch boundaries decide which
second occurrences a batch sees.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io import reader as io_reader
from ..ops import bloom as bloom_ops
from ..ops import cuda_bloom, sortcount
from ..utils import trace
from ..utils.device import resolve_device
from ..utils.mathutils import bloom_sizing
from .counter import CounterConfig, KmerCounter
from .skm_counter import SkmCounter
from .sort_counter import SortKmerCounter, pack_chunk, to_device
from .tiling import TileBatcher


def make_filters(expected_unique: int, fpr: float, device):
    """(bits, hfn, BF1, BF2): the two empty filters sized for
    ``expected_unique`` keys at ``fpr``."""
    bits, hfn = bloom_sizing(expected_unique, fpr)
    # blocked layout: extra bits buy back the one-word fp inflation
    bits = max(bits, 1 << 10) * bloom_ops.BLOCK_COMPENSATION
    return bits, hfn, bloom_ops.make_bloom(bits, device), bloom_ops.make_bloom(bits, device)


# ---------------------------------------------------------------------------
# The probe table (--backend table -b)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BloomCounterConfig:
    k: int
    expected_unique: int
    fpr: float = 0.01
    mode: int = 2
    min_abundance: int = 2
    tile: int = 1 << 14
    batch_tiles: int = 64
    max_probes: int = 64
    device: str = "cuda"
    kernels: str = "cuda"


class BloomFilteredCounter(KmerCounter):
    """Pass-2 counter on the probe table: windows must hit BF2 to be
    counted."""

    def __init__(self, config: CounterConfig, bf2, hfn: int):
        super().__init__(config)
        self.bf2 = bf2
        self.hfn = hfn

    def _window_kwargs(self) -> dict:
        return {"bloom": self.bf2, "hfn": self.hfn}


def bloom_pass1(cfg: BloomCounterConfig, chunks):
    """Stream chunks through the Bloom filter in the table's batches;
    returns (bf2, hfn, stats)."""
    dev = resolve_device(cfg.device)
    bits, hfn, bf1, bf2 = make_filters(cfg.expected_unique, cfg.fpr, dev)
    new1 = new2 = 0        # device scalars after the first batch: one sync at the end
    stats = {"bloom_bits": bits, "bloom_hash_functions": hfn}

    def run(batch):
        nonlocal bf1, bf2, new1, new2
        with trace.span("pack", stats):
            packed, sep, n, dense = pack_chunk(batch, cfg.tile * cfg.batch_tiles)
        with trace.span("to_device", stats):
            packed_d, sep_d = to_device(packed, dev), to_device(sep, dev)
        with trace.span("dispatch", stats):
            bf1, bf2, n1, n2 = sortcount.bloom_pass1_superstep(
                bf1, bf2, packed_d, sep_d, k=cfg.k, n=n, dense=dense, hfn=hfn,
                kernels=cfg.kernels, scratch=scratch)
            new1 = new1 + n1
            new2 = new2 + n2

    with trace.span("bloom_pass1", stats):
        batcher = TileBatcher(cfg.k, cfg.tile, cfg.batch_tiles)
        # B1's scratch, allocated once for every batch (None off a card)
        scratch = (cuda_bloom.scratch_for(cfg.tile * cfg.batch_tiles, dev)
                   if cfg.kernels == "cuda" else None)
        for codes in chunks:
            for batch in batcher.add_flat(codes):
                run(batch)
        for batch in batcher.finish_flat():
            run(batch)
        with trace.span("drain", stats):
            trace.count("host_syncs", 2, stats)
            stats["new_in_first"], stats["new_in_second"] = int(new1), int(new2)
    # squeeze: BF1 and B1's scratch are no longer needed once sizing is known
    del bf1, scratch
    return bf2, hfn, stats


def _pass2_counter(cfg: BloomCounterConfig, bf2, hfn: int, stats) -> BloomFilteredCounter:
    """The pass-2 counter, its table sized from the BF2 counter (the
    reference's 2 x new_in_second)."""
    ccfg = CounterConfig(
        k=cfg.k, min_slots=max(1 << 10, 2 * stats["new_in_second"]), mode=cfg.mode,
        min_abundance=cfg.min_abundance, tile=cfg.tile, batch_tiles=cfg.batch_tiles,
        max_probes=cfg.max_probes, device=cfg.device, kernels=cfg.kernels)
    counter = BloomFilteredCounter(ccfg, bf2, hfn)
    counter.stats.update(stats)
    return counter


def bloom_count_file(cfg: BloomCounterConfig, path: str,
                     chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                     prefetch: int = 4) -> BloomFilteredCounter:
    """Both passes over a file (it is read twice)."""
    def stream():
        chunks = io_reader.CodeChunkReader(path, chunk_bytes=chunk_bytes)
        if prefetch:
            chunks = io_reader.PrefetchingReader(chunks, depth=prefetch)
        return chunks

    counter = _pass2_counter(cfg, *bloom_pass1(cfg, stream()))
    return counter.count_file(path, chunk_bytes=chunk_bytes, prefetch=prefetch)


def bloom_count_codes(cfg: BloomCounterConfig, codes: np.ndarray) -> BloomFilteredCounter:
    """In-memory two-pass variant (tests, library use)."""
    counter = _pass2_counter(cfg, *bloom_pass1(cfg, [np.asarray(codes, np.uint8)]))
    return counter.count_codes(codes)


# ---------------------------------------------------------------------------
# The sort backend (skm and classic pipelines)
# ---------------------------------------------------------------------------


class _TwoPassBloom:
    """Pass 1 and the pass switch of the two-pass Bloom counters (mixed
    into a sort-backend counter).  Drive with ``count_file_two_pass`` /
    ``count_codes_two_pass``, or by hand: stream pass 1 with
    add_codes, call ``start_pass2()``, then stream again and finish."""

    def _init_bloom(self, expected_unique: int, fpr: float):
        bits, self.hfn, self.bf1, self.bf2 = make_filters(expected_unique, fpr, self.device)
        self._phase = 1
        self._n12 = []
        self._scratch = None      # B1's, allocated at the first pass-1 superstep
        self.stats.update({"bloom_bits": bits, "bloom_hash_functions": self.hfn,
                           "new_in_first": 0, "new_in_second": 0,
                           "bloom_pass1_seconds": 0.0})

    def _superstep_kwargs(self) -> dict:
        return {"bloom": self.bf2, "hfn": self.hfn} if self._phase == 2 else {}

    def _dispatch(self, packed_d, sep_d, n: int, dense: bool):
        if self._phase != 1:
            return super()._dispatch(packed_d, sep_d, n, dense)
        if self.cfg.kernels == "cuda":
            self._scratch = cuda_bloom.scratch_for(n, self.device, self._scratch)
        self.bf1, self.bf2, n1, n2 = sortcount.bloom_pass1_superstep(
            self.bf1, self.bf2, packed_d, sep_d, k=self.cfg.k, n=n, dense=dense,
            hfn=self.hfn, kernels=self.cfg.kernels, scratch=self._scratch)
        self._n12.append((n1, n2))

    def start_pass2(self):
        """Finish pass 1: record the exactly-once counters, reset the
        stream statistics and drop BF1 (the reference's squeeze) and B1's
        scratch."""
        if self._phase != 1:
            raise RuntimeError("start_pass2 called twice")
        self.finish()
        with trace.span("drain", self.stats):
            trace.count("host_syncs", 2 * len(self._n12), self.stats)
            self.stats["new_in_first"] = sum(int(a) for a, _ in self._n12)
            self.stats["new_in_second"] = sum(int(b) for _, b in self._n12)
        self._n12 = []
        self.stats["pass1_batches"] = self.stats["batches"]
        self.stats["batches"] = 0
        self.stats["windows_processed"] = 0
        self.bf1 = self._scratch = None
        self._phase = 2

    def count_codes_two_pass(self, codes: np.ndarray):
        """Both passes over an in-memory code stream."""
        with trace.span("bloom_pass1", self.stats):
            self.add_codes(np.asarray(codes, np.uint8))
            self.start_pass2()
        return self.count_codes(codes)

    def count_file_two_pass(self, path: str,
                            chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                            prefetch: int = 4):
        """Both passes over a file (it is read twice)."""
        with trace.span("bloom_pass1", self.stats):
            self._stream_file(path, chunk_bytes, prefetch)
            self.start_pass2()
        return self.count_file(path, chunk_bytes=chunk_bytes, prefetch=prefetch)


class BloomSortCounter(_TwoPassBloom, SortKmerCounter):
    """Classic pipeline with the two-stage Bloom prefilter: pass 2 gates
    windows before the sort."""

    def __init__(self, config, expected_unique: int, fpr: float = 0.01):
        super().__init__(config)
        self._init_bloom(expected_unique, fpr)

    def start_pass2(self):
        """Also size the store from the BF2 counter (the reference's
        2 x new_in_second table size)."""
        super().start_pass2()
        min_slots = max(1 << 10, 2 * self.stats["new_in_second"])
        need = 1 << (min_slots - 1).bit_length()
        if need > self.cfg.prefix_cap:
            self.cfg.prefix_cap = need
            self.prefix = sortcount.make_store(need, self.cfg.words, self.device)


class BloomSkmCounter(_TwoPassBloom, SkmCounter):
    """Super-k-mer pipeline with the two-stage Bloom prefilter: pass 2
    streams runs unfiltered and gates the k-mers at finalize expansion.
    The run store grows by replay, so it needs no sizing from BF2."""

    def __init__(self, config, expected_unique: int, fpr: float = 0.01):
        super().__init__(config)
        self._init_bloom(expected_unique, fpr)


def bloom_sort_count_codes(cfg, expected_unique: int, fpr: float,
                           codes: np.ndarray) -> BloomSortCounter:
    return BloomSortCounter(cfg, expected_unique, fpr).count_codes_two_pass(codes)


def bloom_sort_count_file(cfg, expected_unique: int, fpr: float, path: str,
                          chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                          prefetch: int = 4) -> BloomSortCounter:
    return BloomSortCounter(cfg, expected_unique, fpr).count_file_two_pass(
        path, chunk_bytes, prefetch)


def bloom_skm_count_codes(cfg, expected_unique: int, fpr: float,
                          codes: np.ndarray) -> BloomSkmCounter:
    return BloomSkmCounter(cfg, expected_unique, fpr).count_codes_two_pass(codes)


def bloom_skm_count_file(cfg, expected_unique: int, fpr: float, path: str,
                         chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                         prefetch: int = 4) -> BloomSkmCounter:
    return BloomSkmCounter(cfg, expected_unique, fpr).count_file_two_pass(
        path, chunk_bytes, prefetch)
