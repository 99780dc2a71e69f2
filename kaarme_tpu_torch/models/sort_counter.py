"""Streaming base of the sort-backend counters, in PyTorch — the
counterpart of ``kaarme_tpu/models/sort_counter.py``.

The host reads and encodes the input, packs each superstep's code span
to 2 bits per base plus a separator list on a worker thread, and copies
it to the device (pinned host memory, ``non_blocking``).  The device
merges every superstep into a distinct store.  Dispatch is optimistic:
superstep s+1 chains on s's unverified output and verification trails
by up to ``_max_inflight`` supersteps; when a superstep overflowed the
store's working size, the store grows and that superstep and every
later one are replayed from their kept inputs.

The superstep itself belongs to the subclass (``_dispatch``); the
super-k-mer pipeline (models/skm_counter.py) is the one ported so far.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import time

import numpy as np
import torch

from kaarme_tpu.io import codebuf
from kaarme_tpu.io import reader as io_reader
from kaarme_tpu.utils import codec

from ..io import fastio
from ..ops import sortcount
from ..utils.device import resolve_device

_Step = collections.namedtuple("_Step", "packed sep n dense eff prefix_in")


def _format_lines(tk: np.ndarray, cn: np.ndarray, k: int) -> bytes:
    """b"KMER COUNT\\n" lines for (N, W) uint32 keys and int64 counts,
    assembled as one byte matrix: k bases (decoded 8 at a time from the
    keys' big-endian 16-bit halves), a space, the count's digits
    right-aligned in the widest count's width, a newline; the unused
    leading digit cells are then dropped row by row."""
    n, W = tk.shape
    base4 = np.frombuffer(b"ACGT", np.uint8)[(np.arange(256)[:, None] >> [6, 4, 2, 0]) & 3]
    lut16 = np.concatenate([np.repeat(base4, 256, 0), np.tile(base4, (256, 1))], 1)
    halves = tk.astype(">u4").view(">u2").astype(np.uint16).reshape(n, 2 * W)
    D = len(str(int(cn.max())))
    m = np.empty((n, k + D + 2), np.uint8)
    m[:, :k] = np.take(lut16, halves, axis=0).reshape(n, 16 * W)[:, :k]
    m[:, k] = ord(" ")
    v = cn.astype(np.int64)
    for j in range(k + D, k, -1):
        m[:, j] = ord("0") + v % 10
        v //= 10
    m[:, -1] = ord("\n")
    ndig = np.ones(n, np.int64)
    for j in range(1, D):
        ndig += cn >= 10 ** j
    keep = np.ones(m.shape, bool)
    keep[:, k + 1: k + 1 + D] = np.arange(D)[None, :] >= (D - ndig)[:, None]
    return m[keep].tobytes()


def live_rows_to_host(cols, nd: int, words: int):
    """The first ``nd`` rows of store columns (``words`` key columns + a
    count column) -> host (keys (N, words) uint32, counts (N,) int64),
    rows with count 0 dropped."""
    if not nd:
        return np.zeros((0, words), np.uint32), np.zeros((0,), np.int64)
    keys = torch.stack([c[:nd] for c in cols[:-1]], 1).cpu().numpy().view(np.uint32)
    cnt = cols[-1][:nd].cpu().numpy().astype(np.int64)
    live = cnt > 0
    return keys[live], cnt[live]


@dataclasses.dataclass
class SortCounterConfig:
    k: int
    mode: int = 2                  # 0 = plain (uint16 wrap), 2 = kaarme (14-bit saturation)
    min_abundance: int = 2
    batch_windows: int = 1 << 23   # windows per batch (power of two)
    superbatch_batches: int = 4    # batches per superstep
    prefix_cap: int = 1 << 22      # distinct-store capacity; grows on demand
    min_slots: int = 0             # the reference's -s: initial store sizing
    device: str = "cuda"           # "cuda" raises when there is no card
    kernels: str = "cuda"          # "cuda": hand-written kernels (their plain
                                   # versions on CPU tensors); "plain": the
                                   # plain PyTorch versions everywhere

    def __post_init__(self):
        if self.k < 2:
            raise ValueError("k must be >= 2")
        if self.mode not in (0, 1, 2):
            raise ValueError("mode must be 0, 1 or 2")
        if self.batch_windows & (self.batch_windows - 1) or self.batch_windows < 32:
            raise ValueError("batch_windows must be a power of two >= 32")
        if self.superbatch_batches < 1:
            raise ValueError("superbatch_batches must be >= 1")
        if self.kernels not in ("cuda", "plain"):
            raise ValueError("kernels must be 'cuda' or 'plain'")
        if self.min_slots:
            need = 1 << (int(self.min_slots) - 1).bit_length()
            self.prefix_cap = max(self.prefix_cap, need)

    @property
    def words(self) -> int:
        return codec.words_per_kmer(self.k)

    @property
    def superstep_windows(self) -> int:
        return self.batch_windows * self.superbatch_batches


class SortKmerCounter:
    """Streaming counter: supersteps merged into a compacted distinct store."""

    def __init__(self, config: SortCounterConfig):
        self.cfg = config
        self.device = resolve_device(config.device)
        self.prefix = sortcount.make_store(config.prefix_cap, config.words, self.device)
        self.n_distinct = 0
        self.n_used = 0          # store rows occupied (== n_distinct: dense stores)
        self._buf = codebuf.CodeBuffer()
        self._inflight = collections.deque()   # (nd tensor, _Step)
        self._max_inflight = 2
        self._eff_floor = 0      # store working size an overflow proved needed
        # one worker: superstep s+1's host pack overlaps superstep s
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._prepped = []       # futures of packed supersteps
        self.stats = {
            "windows_processed": 0,
            "batches": 0,
            "compactions": 0,
            "grow_events": 0,
            "build_seconds": 0.0,    # count_file / count_codes wall time,
                                     # the final verification included
            "write_seconds": 0.0,    # write_output wall time (finalize included)
        }

    # -- streaming ---------------------------------------------------------

    def add_codes(self, codes: np.ndarray):
        self._buf.append(codes)
        sb = self.cfg.superstep_windows
        need = sb + self.cfg.k - 1
        while len(self._buf) >= need:
            # the k-1 overlap stays buffered for the next superstep
            self._process_stream(self._buf.take(need, sb), sb)

    def finish(self):
        """Process the buffered tail and verify every superstep."""
        stream = self._buf.take_all()
        if stream.shape[0] >= self.cfg.k:
            self._process_stream(stream, stream.shape[0] - self.cfg.k + 1)
        self._launch(final=True)
        self._drain()

    def count_codes(self, codes: np.ndarray):
        t0 = time.perf_counter()
        self.add_codes(np.asarray(codes, np.uint8))
        self.finish()
        self.stats["build_seconds"] += time.perf_counter() - t0
        return self

    def count_file(self, path: str, chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                   prefetch: int = 4):
        t0 = time.perf_counter()
        chunks = io_reader.CodeChunkReader(path, chunk_bytes=chunk_bytes)
        if prefetch:
            chunks = io_reader.PrefetchingReader(chunks, depth=prefetch)
        for codes in chunks:
            self.add_codes(codes)
        self.finish()
        self.stats["build_seconds"] += time.perf_counter() - t0
        return self

    # -- device steps ------------------------------------------------------

    def _process_stream(self, stream: np.ndarray, n_windows: int):
        self._prepped.append(self._pool.submit(self._prepare, stream, n_windows))
        # keep one packed superstep queued behind the one dispatched
        if len(self._prepped) > 1:
            self._launch(final=False)

    def _prepare(self, stream: np.ndarray, n: int):
        """Worker-thread half: 2-bit pack and separator list (host only).
        Separators ship as an index list unless they are denser than
        1/32 of the positions, where the n/8-byte bitmap is smaller."""
        stream = stream[: n + self.cfg.k - 1]
        packed, maskw = fastio.pack_stream(stream)
        seps = np.flatnonzero(stream >= 4).astype(np.uint32)
        if seps.shape[0] <= max(n // 32, 32):
            return packed, seps, n, False
        return packed, maskw, n, True

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _launch(self, final: bool):
        """Main-thread half: copy and dispatch prepared supersteps (all of
        them when ``final``, else all but the newest)."""
        while self._prepped and (final or len(self._prepped) > 1):
            packed, sep, n, dense = self._prepped.pop(0).result()
            packed_d, sep_d = self._to_device(packed), self._to_device(sep)
            self._drain(keep=self._max_inflight)
            self._dispatch(packed_d, sep_d, n, dense)
            self.stats["batches"] += 1
            self.stats["windows_processed"] += n

    def _dispatch(self, packed_d, sep_d, n: int, dense: bool):
        """Run one superstep, append (nd tensor, _Step) to ``_inflight``
        and set ``self.prefix`` to the unverified output."""
        raise NotImplementedError(
            "the classic sort pipeline is not ported yet; use SkmCounter")

    def _sized_prefix(self, eff: int):
        """The store sliced, or padded with dead rows, to ``eff`` rows."""
        cur = self.prefix[0].shape[0]
        if cur == eff:
            return self.prefix
        if cur > eff:
            return tuple(c[:eff] for c in self.prefix)
        last = len(self.prefix) - 1
        return tuple(torch.cat([c, sortcount.dead_fill(eff - cur, i == last, self.device)])
                     for i, c in enumerate(self.prefix))

    def _rows_overflow(self, vals, step: _Step) -> bool:
        """Subclass hook: replay and return True when a superstep's extra
        verification scalars (past [nd_exact, nd_used]) show lost rows."""
        return False

    def _accept(self, nd_exact: int, nd: int):
        self.n_distinct = nd_exact
        self.n_used = nd
        self.stats["compactions"] += 1

    def _replay_all(self, steps):
        for s in steps:
            self._dispatch(s.packed, s.sep, s.n, s.dense)
            self._drain(keep=0)

    def _drain(self, keep: int = 0):
        """Verify in-flight supersteps down to ``keep`` outstanding: accept
        each output, or grow the store and replay the overflowing
        superstep and everything dispatched after it."""
        while len(self._inflight) > keep:
            nd_h, step = self._inflight.popleft()
            vals = nd_h.tolist()
            if self._rows_overflow(vals, step):
                continue
            nd_exact, nd = vals[0], vals[1]
            cap_used = step.prefix_in[0].shape[0]
            if nd <= cap_used:
                self._accept(nd_exact, nd)
                continue
            steps = [step] + [s for (_, s) in self._inflight]
            self._inflight.clear()
            # nd counts every record, so it bounds the size that fits;
            # the superstep's input mass bounds the growth per retry
            bound = min(cap_used + step.n, 2 * max(nd, cap_used))
            new_eff = sortcount.next_store_size(bound)
            self._eff_floor = max(self._eff_floor, new_eff)
            if new_eff > self.cfg.prefix_cap:
                self.cfg.prefix_cap = new_eff
                self.stats["grow_events"] += 1
            self.prefix = step.prefix_in   # pre-overflow store, still live
            self.prefix = self._sized_prefix(new_eff)
            self._replay_all(steps)

    def _merge(self):
        """The pipeline sync point: verify all in-flight supersteps."""
        self._drain()

    # -- output ------------------------------------------------------------

    def _clip(self, counts: np.ndarray) -> np.ndarray:
        if self.cfg.mode == 0:
            return counts & 0xFFFF        # uint16 wrap, reference plain table
        return np.minimum(counts, 16383)  # 14-bit saturation, kaarme table

    def _flush(self):
        """Treat the buffered input as the end of the stream (dump, find
        and save must not drop partial reads)."""
        if len(self._buf):
            self.finish()

    def dump(self):
        """(keys (N, W) uint32 sorted, counts (N,) int64) of all distinct
        k-mers, before abundance filtering and clipping."""
        raise NotImplementedError

    def _dump_device(self):
        """Store rows -> host (keys (N, words) uint32, counts int64),
        without flushing; rows with count 0 are dropped."""
        return live_rows_to_host(self.prefix, self.n_used, self.cfg.words)

    def as_dict(self) -> dict:
        tk, cn = self.dump()
        cn = self._clip(cn)
        keep = cn >= self.cfg.min_abundance
        names = codec.unpack_kmers(tk[keep], self.cfg.k) if keep.any() else []
        return dict(zip(names, cn[keep].tolist()))

    def write_output(self, path: str) -> int:
        """`KMER COUNT` lines, canonical k-mers in sorted order."""
        t0 = time.perf_counter()
        tk, cn = self.dump()
        cn = self._clip(cn)
        keep = cn >= self.cfg.min_abundance
        tk, cn = tk[keep], cn[keep]
        n = tk.shape[0]
        with open(path, "wb") as f:
            if n:
                f.write(_format_lines(tk, cn, self.cfg.k))
        self.stats["write_seconds"] += time.perf_counter() - t0
        return int(n)

    def find(self, kmers) -> list:
        """Counts for query k-mer strings (0 if absent, -1 if malformed)."""
        if isinstance(kmers, str):
            kmers = [kmers]
        tk, cn = self.dump()
        packed = np.zeros((len(kmers), codec.words_per_kmer(self.cfg.k)), np.uint32)
        ok = np.ones(len(kmers), bool)
        for i, s in enumerate(kmers):
            if len(s) != self.cfg.k or any(ch not in "ACGTacgt" for ch in s):
                ok[i] = False
                continue
            packed[i] = codec.pack_kmer(codec.canonical(s.upper()))
        out = self._clip(sortcount.lookup_sorted(tk, cn, packed))
        return [int(c) if good else -1 for c, good in zip(out, ok)]

    # -- checkpoint / resume (the kaarme_tpu .npz format) --------------------

    def save(self, path: str):
        """Snapshot the merged store + config to ``.npz``: key columns
        col0..col{words-1} as uint32, the count column as int32, and the
        unprocessed host tail verbatim (restored by ``load``, so windows
        spanning the checkpoint are neither lost nor double-counted)."""
        tail = self._buf.take_all()
        self._launch(final=True)
        self._drain()
        keys, cnt = self._dump_device()
        cols = {f"col{i}": keys[:, i] for i in range(self.cfg.words)}
        cols[f"col{self.cfg.words}"] = cnt.astype(np.int32)
        np.savez_compressed(
            path, n_distinct=keys.shape[0], k=self.cfg.k, mode=self.cfg.mode,
            min_abundance=self.cfg.min_abundance,
            windows_processed=self.stats["windows_processed"], tail=tail, **cols)
        self._buf.append(tail)

    @classmethod
    def load(cls, path: str, config: SortCounterConfig):
        """Restore a counter from a ``save`` checkpoint of either package."""
        from ..utils.convert import store_from_numpy

        z = np.load(path)
        k = int(z["k"])
        if config.k != k:
            raise ValueError(f"checkpoint is for k={k}, config has k={config.k}")
        self = cls(config)
        nd = int(z["n_distinct"])
        while nd > self.cfg.prefix_cap:
            self.cfg.prefix_cap *= 2
        cols = [z[f"col{i}"] for i in range(config.words + 1)]
        self.prefix = store_from_numpy(cols, self.cfg.prefix_cap, self.device)
        self.n_distinct = nd
        self.n_used = nd
        self.stats["windows_processed"] = int(z["windows_processed"])
        if "tail" in z.files:
            self._buf.append(z["tail"].astype(np.uint8))
        return self

    def occupancy(self) -> tuple:
        self._merge()
        return self.n_distinct, self.cfg.prefix_cap
