"""Streaming sort-backend counter, in PyTorch — the counterpart of
``kaarme_tpu/models/sort_counter.py``: the classic pipeline (one sorted
row per window) and the base of the super-k-mer counter.

Each superstep ships as a transfer chunk: its code span packed to 2 bits
per base plus its separators.  From FASTA and plain-text files the device
makes the chunks itself: the raw bytes go to the card and P1 parses and
packs them there (``count_file``, ``io/rawstream.py``).  Codes handed in
(``add_codes``) and FASTQ files are packed on the host, on a worker
thread, and copied to the device (pinned host memory, ``non_blocking``).
The device merges every superstep into a distinct store.  Dispatch is
optimistic: superstep s+1 chains on s's unverified output and
verification trails by up to ``_max_inflight`` supersteps; when a
superstep overflowed the store's working size, the store grows and that
superstep and every later one are replayed from their kept inputs.

The classic superstep (``_dispatch``) makes every window's canonical
key (K3) and merges the keys into the store: one sort of prefix ++ keys
and K2, or, with ``compactor="merge"``, a sort of the keys alone and
K4's linear merge with the already sorted prefix.  The super-k-mer
pipeline (models/skm_counter.py) overrides the superstep.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools

import numpy as np
import torch

from ..io import codebuf, fastio, rawstream
from ..io import reader as io_reader
from ..ops import sortcount, writer
from ..utils import codec, trace
from ..utils.device import resolve_device

_Step = collections.namedtuple("_Step", "packed sep n dense eff prefix_in")


def store_part(cols, nd: int):
    """The first ``nd`` rows of store columns (key columns + a count
    column) as a dump part: (key columns, count column), on the device."""
    return tuple(c[:nd] for c in cols[:-1]), cols[-1][:nd]


def rows_to_host(parts, count_dtype=np.int64):
    """Dump parts ((key columns, counts) on their devices) -> host (keys
    (N, W) uint32, counts (N,) ``count_dtype``) in part and row order,
    rows with count <= 0 dropped on the device."""
    keys, cnts = [], []
    for cols, cnt in parts:
        live = torch.nonzero(cnt > 0).flatten()
        keys.append(torch.stack([c.index_select(0, live) for c in cols], 1)
                    .cpu().numpy().view(np.uint32).reshape(-1, len(cols)))
        cnts.append(cnt.index_select(0, live).cpu().numpy().astype(count_dtype))
    return np.concatenate(keys), np.concatenate(cnts)


def sized_store(store, rows: int) -> tuple:
    """Store columns sliced, or padded with dead rows, to ``rows`` rows."""
    cur = store[0].shape[0]
    if cur == rows:
        return store
    if cur > rows:
        return tuple(c[:rows] for c in store)
    last, dev = len(store) - 1, store[0].device
    return tuple(torch.cat([c, sortcount.dead_fill(rows - cur, i == last, dev)])
                 for i, c in enumerate(store))


def pack_chunk(stream: np.ndarray, n: int):
    """The transfer chunk of an n-window span of codes (its n + k - 1
    codes): (2-bit packed words, separators, n, dense).  Separators ship
    as an index list unless they are denser than 1/32 of the positions,
    where the n/8-byte bitmap is smaller."""
    packed, maskw = fastio.pack_stream(stream)
    seps = np.flatnonzero(stream >= 4).astype(np.uint32)
    if seps.shape[0] <= max(n // 32, 32):
        return packed, seps, n, False
    return packed, maskw, n, True


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array of 4-byte words -> int32 tensor on ``device`` (pinned,
    non-blocking copy to a card)."""
    t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class CountOutput:
    """The output every counter shares, on its ``dump_columns()`` (the
    dump's parts on their devices, before filtering and clipping),
    ``cfg`` and ``stats``."""

    def dump(self):
        """(keys (N, W) uint32, counts (N,) int64) of ``dump_columns()``
        on the host, count-0 rows dropped, before filtering and clipping."""
        return rows_to_host(self.dump_columns())

    def _clip(self, counts: np.ndarray) -> np.ndarray:
        if self.cfg.mode == 0:
            return counts & 0xFFFF        # uint16 wrap, reference plain table
        return np.minimum(counts, 16383)  # 14-bit saturation, kaarme table

    def as_dict(self) -> dict:
        """{kmer string: clipped count >= min_abundance}."""
        tk, cn = self.dump()
        cn = self._clip(cn)
        keep = cn >= self.cfg.min_abundance
        names = codec.unpack_kmers(tk[keep], self.cfg.k) if keep.any() else []
        return dict(zip(names, cn[keep].tolist()))

    def write_output(self, path: str) -> int:
        """`KMER COUNT` lines in the dump's order (sorted; the probe table's
        is slot order, so comparisons sort), assembled where the dump lies
        (``ops/writer.write_lines``: W1 on a card).  Returns #lines
        written."""
        cfg = self.cfg
        with trace.span("write", self.stats):
            return writer.write_lines(path, self.dump_columns(), k=cfg.k, mode=cfg.mode,
                                      min_abundance=cfg.min_abundance, kernels=cfg.kernels)


class SortedOutput(CountOutput):
    """``CountOutput`` plus ``find`` by binary search of a sorted dump."""

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


@dataclasses.dataclass
class SortCounterConfig:
    k: int
    mode: int = 2                  # 0 = plain (uint16 wrap), 2 = kaarme (14-bit saturation)
    min_abundance: int = 2
    batch_windows: int = 1 << 23   # windows per batch (power of two)
    superbatch_batches: int = 4    # batches per superstep
    prefix_cap: int = 1 << 22      # distinct-store capacity; grows on demand
    min_slots: int = 0             # the reference's -s: initial store sizing
    compactor: str = "auto"        # classic superstep: "auto" = sort + K2,
                                   # "merge" = sort the batch only + K4
                                   # (the skm pipeline ignores it)
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
        sortcount.check_kernels(self.kernels)
        if self.compactor not in ("auto", "merge"):
            raise ValueError("compactor must be 'auto' or 'merge' (the kernels are "
                             "chosen by 'kernels')")
        if self.min_slots:
            need = 1 << (int(self.min_slots) - 1).bit_length()
            self.prefix_cap = max(self.prefix_cap, need)

    @property
    def words(self) -> int:
        return codec.words_per_kmer(self.k)

    @property
    def superstep_windows(self) -> int:
        return self.batch_windows * self.superbatch_batches


class SortKmerCounter(SortedOutput):
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
        self._delta_max = None   # max verified distinct growth per superstep
        # one worker: superstep s+1's host pack overlaps superstep s
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._prepped = []       # futures of packed supersteps
        self.stats = {
            "windows_processed": 0,
            "batches": 0,
            "compactions": 0,
            "grow_events": 0,
            "replayed_supersteps": 0,   # dispatches again after any overflow
                                        # (store working size, capacity, rows)
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
        with trace.span("count", self.stats):
            self.add_codes(np.asarray(codes, np.uint8))
            self.finish()
        return self

    def count_file(self, path: str, chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                   prefetch: int = 4):
        with trace.span("count", self.stats):
            self._stream_file(path, chunk_bytes, prefetch)
            self.finish()
        return self

    def _stream_file(self, path: str, chunk_bytes: int, prefetch: int):
        """One pass over a file into supersteps, ``finish`` left to the
        caller.  FASTA and plain text go to the device as raw bytes, where
        P1 parses and packs them (``io/rawstream.py``); FASTQ is encoded
        and packed on the host."""
        fmt, gzipped = io_reader.sniff_format(path)
        if fmt == "fastq":
            chunks = io_reader.CodeChunkReader(path, chunk_bytes=chunk_bytes, fmt=fmt,
                                               gzipped=gzipped)
            if prefetch:
                chunks = io_reader.PrefetchingReader(chunks, depth=prefetch)
            for codes in chunks:
                self.add_codes(codes)
            return
        # buffered codes (a restored checkpoint's tail) open the stream:
        # whole supersteps of them on the host path, the rest on the device
        self.add_codes(np.empty(0, np.uint8))
        self._launch(final=True)
        head = self._buf.take_all()
        cfg = self.cfg
        stream = rawstream.CodeStream(self.device, cfg.k, cfg.superstep_windows, cfg.kernels)
        blocks = rawstream.RawBlockReader(path, gzipped, chunk_bytes, prefetch + 2,
                                          pin=self.device.type == "cuda")
        items = io_reader.PrefetchingReader(blocks, depth=prefetch) if prefetch else blocks
        self._submit_all(stream.feed_codes(head))
        for slot, n in items:
            self._submit_all(stream.feed(blocks.block(slot, n), fmt == "fasta",
                                         release=functools.partial(blocks.release, slot)))
        self._submit_all(stream.close())

    def _submit_all(self, chunks):
        for words, bits, n in chunks:
            self._submit(words, bits, n, True)

    # -- device steps ------------------------------------------------------

    def _process_stream(self, stream: np.ndarray, n_windows: int):
        self._prepped.append(self._pool.submit(self._prepare, stream, n_windows))
        # keep one packed superstep queued behind the one dispatched
        if len(self._prepped) > 1:
            self._launch(final=False)

    def _prepare(self, stream: np.ndarray, n: int):
        """Worker-thread half: the superstep's transfer chunk (host only)."""
        with trace.span("pack"):
            return pack_chunk(stream[: n + self.cfg.k - 1], n)

    def _launch(self, final: bool):
        """Main-thread half: copy and dispatch prepared supersteps (all of
        them when ``final``, else all but the newest)."""
        while self._prepped and (final or len(self._prepped) > 1):
            with trace.span("pack_wait", self.stats):
                packed, sep, n, dense = self._prepped.pop(0).result()
            with trace.span("to_device", self.stats):
                packed_d, sep_d = to_device(packed, self.device), to_device(sep, self.device)
            self._submit(packed_d, sep_d, n, dense)

    def _submit(self, packed_d, sep_d, n: int, dense: bool):
        """Dispatch one superstep's transfer chunk, on the device."""
        self._drain(keep=self._max_inflight)
        with trace.span("dispatch", self.stats):
            self._dispatch(packed_d, sep_d, n, dense)
        trace.count("batches", stats=self.stats)
        self.stats["windows_processed"] += n

    def _eff_for_dispatch(self, n: int) -> int:
        """Store working size for the next superstep (the reference's
        live-prefix sizing): the live rows plus headroom for the
        in-flight window from the largest verified distinct growth (n
        before any), on the coarse ladder; never below a size that an
        overflow proved needed, so a replay cannot repeat the overflow."""
        cap = self.cfg.prefix_cap
        if cap <= (1 << 12):
            return cap
        delta = self._delta_max if self._delta_max is not None else n
        target = self.n_used + (self._max_inflight + 1) * max(delta, n // 16)
        eff = min(max(sortcount.next_store_size(target, coarse=True), self._eff_floor), cap)
        if self._inflight:
            # unverified in-flight outputs may hold up to the current
            # length of live rows: never cut below it
            eff = max(eff, self.prefix[0].shape[0])
        return eff

    def _dispatch(self, packed_d, sep_d, n: int, dense: bool):
        """Run one classic superstep, append (nd tensor, _Step) to
        ``_inflight`` and set ``self.prefix`` to the unverified output:
        merged (K4) under ``compactor="merge"``, else embedded when the
        trailing key word has >= 21 free bits, else the separate-count
        superstep."""
        cfg = self.cfg
        eb = sortcount.embed_bits(cfg.k)
        prefix_in = sized_store(self.prefix, self._eff_for_dispatch(n))
        kw = dict(k=cfg.k, n=n, dense=dense, kernels=cfg.kernels, **self._superstep_kwargs())
        if cfg.compactor == "merge":
            new_prefix, ndv = sortcount.superstep_merged(packed_d, sep_d, prefix_in,
                                                         ebits=eb, **kw)
        elif eb >= 21:
            new_prefix, ndv = sortcount.superstep_embedded(packed_d, sep_d, prefix_in,
                                                           ebits=eb, **kw)
        else:
            new_prefix, ndv = sortcount.superstep_plain(packed_d, sep_d, prefix_in, **kw)
        self._inflight.append((ndv, _Step(packed_d, sep_d, n, dense, 0, prefix_in)))
        self.prefix = new_prefix

    def _superstep_kwargs(self) -> dict:
        """Extra keyword arguments of the counting supersteps: the
        two-pass Bloom counters (models/bloom_counter.py) pass their
        second-stage filter here in pass 2 (``bloom``, ``hfn``).  The skm
        pipeline applies them at finalize expansion instead, where
        windows materialize."""
        return {}

    def _rows_overflow(self, vals, step: _Step) -> bool:
        """Subclass hook: replay and return True when a superstep's extra
        verification scalars (past [nd_exact, nd_used]) show lost rows."""
        return False

    def _accept(self, nd_exact: int, nd: int):
        if nd_exact > self.n_distinct:
            self._delta_max = max(self._delta_max or 0, nd_exact - self.n_distinct)
        self.n_distinct = nd_exact
        self.n_used = nd
        trace.count("compactions", stats=self.stats)

    def _replay_all(self, steps):
        trace.count("replayed_supersteps", len(steps), self.stats)
        with trace.span("replay", self.stats):
            for s in steps:
                with trace.span("dispatch", self.stats):
                    self._dispatch(s.packed, s.sep, s.n, s.dense)
                self._drain(keep=0)

    def _drain(self, keep: int = 0):
        """Verify in-flight supersteps down to ``keep`` outstanding: accept
        each output, or grow the store and replay the overflowing
        superstep and everything dispatched after it."""
        if len(self._inflight) <= keep:
            return
        with trace.span("drain", self.stats):
            while len(self._inflight) > keep:
                nd_h, step = self._inflight.popleft()
                trace.count("host_syncs", stats=self.stats)
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
                self._delta_max = max(self._delta_max or 0, new_eff - self.n_used)
                if new_eff > self.cfg.prefix_cap:
                    self.cfg.prefix_cap = new_eff
                    trace.count("grow_events", stats=self.stats)
                self.prefix = step.prefix_in   # pre-overflow store, still live
                self.prefix = sized_store(self.prefix, new_eff)
                self._replay_all(steps)

    def _merge(self):
        """The pipeline sync point: verify all in-flight supersteps."""
        self._drain()

    # -- output ------------------------------------------------------------

    def _flush(self):
        """Treat the buffered input as the end of the stream (dump, find
        and save must not drop partial reads)."""
        if len(self._buf):
            self.finish()

    def dump_columns(self):
        """The store's live rows as one dump part, on the device (sorted,
        before abundance filtering and clipping).  Flushes buffered input
        first."""
        self._flush()
        self._merge()
        return [store_part(self.prefix, self.n_used)]

    # -- checkpoint / resume (the kaarme_tpu .npz format) --------------------

    def save(self, path: str):
        """Snapshot the merged store + config to ``.npz``: key columns
        col0..col{words-1} as uint32, the count column as int32, and the
        unprocessed host tail verbatim (restored by ``load``, so windows
        spanning the checkpoint are neither lost nor double-counted)."""
        tail = self._buf.take_all()
        self._launch(final=True)
        self._drain()
        keys, cnt = rows_to_host([store_part(self.prefix, self.n_used)])
        cols = {f"col{i}": keys[:, i] for i in range(self.cfg.words)}
        cols[f"col{self.cfg.words}"] = cnt.astype(np.int32)
        np.savez_compressed(
            path, n_distinct=keys.shape[0], k=self.cfg.k, mode=self.cfg.mode,
            min_abundance=self.cfg.min_abundance,
            windows_processed=self.stats["windows_processed"], tail=tail, **cols)
        self._buf.append(tail)

    @classmethod
    def load(cls, path: str, config: "SortCounterConfig | None" = None, *,
             device: str = "cuda"):
        """Restore a counter from a ``save`` checkpoint of either package
        (without ``config``: the checkpoint's k, mode and abundance
        threshold on ``device``)."""
        from ..utils.convert import store_from_numpy

        z = np.load(path)
        k = int(z["k"])
        if config is None:
            config = SortCounterConfig(k=k, mode=int(z["mode"]),
                                       min_abundance=int(z["min_abundance"]), device=device)
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
