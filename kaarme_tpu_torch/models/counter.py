"""Streaming canonical k-mer counter on the probe table, in PyTorch — the
counterpart of ``kaarme_tpu/models/counter.py`` (the ``--backend
table`` route).

The host reads and encodes the input, cuts the code stream into fixed
batches of ``batch_tiles`` tiles of ``tile`` windows (``TileBatcher``)
and packs each batch's codes into the transfer chunk (2 bits per base
plus the separator bitmap, ``sort_counter.pack_chunk``); on the device
K3 makes every window's canonical key from the chunk, and T1
(``ops/table.insert``) accumulates the counts in an open-addressing
table in device memory (``ops/table.count_step``).  A full table does not
abort: the windows that found no slot within ``max_probes`` probes come
back pending, and the table doubles, migrates its rows (amount = the
stored count) and re-inserts exactly the pending windows, up to
``max_grows`` times.

Mode semantics (output only; the counting is the same):
- mode 2 ("kaarme"): counts saturate at 16383 (the 14-bit count field);
- mode 0 ("plain"): counts wrap mod 2^16 (the uint16 count array).

The count file is in slot order, as the JAX package writes it:
comparisons sort (``utils/compare.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..io import reader as io_reader
from ..ops import sortcount
from ..ops import table as table_ops
from ..ops.hashing import hash_words
from ..utils import codec, trace
from ..utils.device import resolve_device
from ..utils.mathutils import capacity_log2
from .sort_counter import CountOutput, pack_chunk, rows_to_host, to_device
from .tiling import TileBatcher


@dataclasses.dataclass
class CounterConfig:
    k: int
    min_slots: int = 1 << 22
    mode: int = 2              # 0 = plain, 2 = kaarme (output clipping)
    min_abundance: int = 2
    tile: int = 1 << 14        # window positions per tile row
    batch_tiles: int = 64      # tile rows per device step
    max_probes: int = 64
    max_grows: int = 8
    device: str = "cuda"       # "cuda" raises when there is no card
    kernels: str = "cuda"      # "cuda": T1 (its plain version on CPU tensors);
                               # "plain": the plain probe rounds everywhere

    def __post_init__(self):
        if self.k < 2:
            raise ValueError("k must be >= 2")
        if self.mode not in (0, 1, 2):
            raise ValueError("mode must be 0, 1 or 2")
        sortcount.check_kernels(self.kernels)

    @property
    def words(self) -> int:
        return codec.words_per_kmer(self.k)

    @property
    def cap_log2(self) -> int:
        return capacity_log2(self.min_slots)

    @property
    def batch_windows(self) -> int:
        return self.tile * self.batch_tiles


class KmerCounter(CountOutput):
    """Streaming canonical k-mer counter on one device's probe table."""

    def __init__(self, config: CounterConfig):
        self.cfg = config
        self.device = resolve_device(config.device)
        self.cap_log2 = config.cap_log2
        self.tkeys, self.counts = table_ops.make_table(self.cap_log2, config.words, self.device)
        self._batcher = TileBatcher(config.k, config.tile, config.batch_tiles)
        self.stats = {
            "windows_processed": 0,   # padded tile positions: tiles x tile
            "batches": 0,
            "grow_events": 0,
            "build_seconds": 0.0,     # count_file / count_codes wall time
            "write_seconds": 0.0,
        }

    # -- streaming ---------------------------------------------------------

    def add_codes(self, codes: np.ndarray):
        """Append encoded codes; flush full batches to the device."""
        for batch in self._batcher.add_flat(codes):
            self._flush(batch)

    def finish(self):
        """Process the remaining (padded) positions."""
        for batch in self._batcher.finish_flat():
            self._flush(batch)

    def _window_kwargs(self) -> dict:
        """Extra keyword arguments of ``table_ops.count_step``: the Bloom
        counter passes its filter here (``bloom``, ``hfn``)."""
        return {}

    def _flush(self, batch: np.ndarray):
        cfg = self.cfg
        with trace.span("pack", self.stats):
            packed, sep, n = pack_chunk(batch, cfg.batch_windows)
        with trace.span("to_device", self.stats):
            chunk = dict(packed=to_device(packed, self.device), sep=to_device(sep, self.device),
                         k=cfg.k, n=n, kernels=cfg.kernels)
        with trace.span("dispatch", self.stats):
            self.tkeys, self.counts, overflow, pending = table_ops.count_step(
                self.tkeys, self.counts, max_probes=cfg.max_probes, **chunk,
                **self._window_kwargs())
        with trace.span("drain", self.stats):
            trace.count("host_syncs", stats=self.stats)
            if int(overflow):
                with trace.span("replay", self.stats):
                    self._grow_and_retry(chunk, pending)
        trace.count("batches", stats=self.stats)
        self.stats["windows_processed"] += n

    def _grow_and_retry(self, chunk: dict, pending):
        """Double capacity, migrate, and re-insert the exact pending set.

        Windows that already landed stay counted; only the insert's own
        pending mask is retried, so nothing is double-counted."""
        cfg = self.cfg
        keys = sortcount.window_keys_from_chunk(**chunk)
        for _ in range(cfg.max_grows):
            trace.count("grow_events", stats=self.stats)
            self.cap_log2 += 1
            new_tk, new_cn = table_ops.make_table(self.cap_log2, cfg.words, self.device)
            # migrate existing entries (amount = stored count)
            old_tk, old_cn = self.tkeys, self.counts
            okeys = tuple(old_tk[:, w] for w in range(old_tk.shape[1]))
            new_tk, new_cn, _, n_mig = table_ops.insert(
                new_tk, new_cn, okeys, old_cn > 0, amount=old_cn, max_probes=cfg.max_probes,
                kernels=cfg.kernels)
            trace.count("host_syncs", stats=self.stats)
            if int(n_mig):
                continue  # did not fit either: grow again
            new_tk, new_cn, pending, n_left = table_ops.insert(
                new_tk, new_cn, keys, pending, max_probes=cfg.max_probes, kernels=cfg.kernels)
            self.tkeys, self.counts = new_tk, new_cn
            trace.count("host_syncs", stats=self.stats)
            if int(n_left) == 0:
                return
        raise RuntimeError("hash table could not grow to fit the input")

    # -- end-to-end --------------------------------------------------------

    def count_file(self, path: str, chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                   prefetch: int = 4):
        with trace.span("count", self.stats):
            chunks = io_reader.CodeChunkReader(path, chunk_bytes=chunk_bytes)
            if prefetch:
                chunks = io_reader.PrefetchingReader(chunks, depth=prefetch)
            for codes in chunks:
                self.add_codes(codes)
            self.finish()
        return self

    def count_codes(self, codes: np.ndarray):
        with trace.span("count", self.stats):
            self.add_codes(np.asarray(codes, np.uint8))
            self.finish()
        return self

    # -- output ------------------------------------------------------------

    def dump_columns(self):
        """The whole table as one dump part, in slot order, on the device:
        its key columns (views of the ``(C, W)`` slot rows) and count
        column; empty slots have count 0 and write nothing."""
        return [(tuple(self.tkeys.unbind(1)), self.counts)]

    def dump(self):
        """(kmers (N, W) uint32, counts (N,) int32) of occupied slots in
        slot order, *before* abundance filtering / clipping."""
        return rows_to_host(self.dump_columns(), np.int32)

    # -- queries -----------------------------------------------------------

    def find(self, kmers) -> list:
        """Counts for query k-mer strings (0 if absent, -1 if malformed),
        clipped per table mode."""
        if isinstance(kmers, str):
            kmers = [kmers]
        w = self.cfg.words
        packed = np.zeros((len(kmers), w), np.uint32)
        ok = np.ones(len(kmers), bool)
        for i, s in enumerate(kmers):
            if len(s) != self.cfg.k or any(ch not in "ACGTacgt" for ch in s):
                ok[i] = False
                continue
            packed[i] = codec.pack_kmer(codec.canonical(s.upper()))
        keys = tuple(torch.from_numpy(packed[:, j].astype(np.int64)).to(self.device)
                     for j in range(w))
        out = table_ops.lookup(self.tkeys, self.counts, keys, hash_words(keys),
                               max_probes=self.cfg.max_probes).cpu().numpy()
        out = self._clip(out)
        return [int(c) if good else -1 for c, good in zip(out, ok)]

    # -- diagnostics ---------------------------------------------------------

    def occupancy(self) -> tuple:
        """(slots in use, capacity)."""
        return int((self.counts > 0).sum()), int(self.counts.shape[0])
