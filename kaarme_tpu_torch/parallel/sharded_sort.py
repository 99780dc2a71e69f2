"""Multi-device counting on the sort backend — the counterpart of
``kaarme_tpu/parallel/sharded_sort.py``.

Streaming is pure data parallelism: each round splits ``ndev x
batch_windows`` windows of the stream into one span per shard (with a
k-1 halo), packs each span into its transfer chunk on a worker thread,
and every shard merges its span into its own distinct (key, count)
store with the classic superstep (K3, then sort + K2, or K4 under
``compactor="merge"``).  No shard talks to another while counting.

Rounds are dispatched optimistically and verified ``_max_inflight`` - 1
behind; growth is decided on the largest ``nd_used`` over the shards,
so every shard grows to one capacity, and the overflowing round and
every round chained after it replay.

``finalize_exchange`` sends each live record to the shard that owns its
key (the top hash bits, ``exchange.owner_by_hash``) and compacts every
shard's received records (lexsort + K2 full_sum; the clamped sum keeps
c mod 2^20 and c >= 2^20, which both output contracts read).  Shard d
then holds the sorted distinct records that it owns.

The dump (``dump_columns``, read by the writer, ``dump`` and ``find``)
is in key ranges, one a device: split keys sampled from one shard's
sorted store cut every shard's store into ndev slices, and device r
merges every shard's slice of range r, so no device holds more than its
share of the distinct set.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses

import numpy as np
import torch

from ..io import codebuf
from ..io import reader as io_reader
from ..models.sort_counter import (SortedOutput, pack_chunk, rows_to_host, sized_store,
                                   store_part, to_device)
from ..ops import sortcount
from ..utils import codec, trace
from ..utils.convert import store_from_numpy
from .exchange import exchange, owner_by_hash
from .sharded import on_device, resolve_devices

_Round = collections.namedtuple("_Round", "chunks prefix_in")


@dataclasses.dataclass
class ShardedSortConfig:
    k: int
    mode: int = 2
    min_abundance: int = 2
    batch_windows: int = 1 << 22   # windows per shard per round (power of two)
    prefix_cap: int = 1 << 20      # per-shard distinct capacity; grows on demand
    compactor: str = "auto"        # "auto": sort + K2; "merge": sort the keys, K4
    kernels: str = "cuda"          # "cuda": the hand-written kernels (their plain
                                   # versions on CPU tensors); "plain": plain

    def __post_init__(self):
        if self.k < 2:
            raise ValueError("k must be >= 2")
        if self.mode not in (0, 1, 2):
            raise ValueError("mode must be 0, 1 or 2")
        if self.batch_windows < 1 or self.batch_windows & (self.batch_windows - 1):
            raise ValueError("batch_windows must be a power of two")
        if self.compactor not in ("auto", "merge"):
            raise ValueError("compactor must be 'auto' or 'merge' (the kernels are "
                             "chosen by 'kernels')")
        sortcount.check_kernels(self.kernels)

    @property
    def words(self) -> int:
        return codec.words_per_kmer(self.k)


class ShardedSortCounter(SortedOutput):
    """Same surface as ``models.sort_counter.SortKmerCounter``, over a
    device list (``sharded.make_mesh``; a device may repeat)."""

    def __init__(self, config: ShardedSortConfig, devices=None):
        self.cfg = config
        self.devices = resolve_devices(devices)
        self.ndev = len(self.devices)
        self.prefix = [sortcount.make_store(config.prefix_cap, config.words, d)
                       for d in self.devices]
        self._nd = [0] * self.ndev        # verified rows in use, per shard
        self._buf = codebuf.CodeBuffer()
        self._exchanged = False
        self._rounds = collections.deque()   # (per-shard nd tensors, _Round)
        self._max_inflight = 2
        # one worker: round r+1's host packing overlaps round r
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._prepped = []                # (future of per-shard chunks, real windows)
        self.stats = {"windows_processed": 0, "batches": 0, "compactions": 0,
                      "grow_events": 0, "replayed_rounds": 0, "build_seconds": 0.0,
                      "exchange_seconds": 0.0, "write_seconds": 0.0}

    # -- streaming ---------------------------------------------------------

    def add_codes(self, codes: np.ndarray):
        if self._exchanged:
            raise RuntimeError("cannot add input after finalize")
        self._buf.append(codes)
        sb = self.ndev * self.cfg.batch_windows
        need = sb + self.cfg.k - 1
        while len(self._buf) >= need:
            # the k-1 overlap stays buffered for the next round
            self._submit(self._buf.take(need, sb), sb)

    def finish(self):
        """The buffered tail as a last round padded with separators (its
        all-separator spans still run), then verify every round."""
        if self._exchanged:
            raise RuntimeError("cannot add input after finalize")
        stream = self._buf.take_all()
        k = self.cfg.k
        if stream.shape[0] >= k:
            padded = np.full(self.ndev * self.cfg.batch_windows + k - 1, codec.SEP, np.uint8)
            padded[:stream.shape[0]] = stream
            self._submit(padded, stream.shape[0] - k + 1)
        self._merge()

    def count_codes(self, codes: np.ndarray):
        with trace.span("count", self.stats):
            self.add_codes(np.asarray(codes, np.uint8))
            self.finish()
        return self

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

    def _submit(self, stream: np.ndarray, n_real: int):
        self._prepped.append((self._pool.submit(self._prepare, stream), n_real))
        # keep one packed round queued behind the one dispatched
        if len(self._prepped) > 1:
            self._launch(final=False)

    def _prepare(self, stream: np.ndarray) -> list:
        """Worker-thread half: shard d's span, windows [d, d + 1) * n plus
        the k-1 halo, as its transfer chunk."""
        n, k = self.cfg.batch_windows, self.cfg.k
        return [pack_chunk(stream[d * n: (d + 1) * n + k - 1], n) for d in range(self.ndev)]

    def _launch(self, final: bool):
        """Main-thread half: copy and dispatch prepared rounds (all of them
        when ``final``, else all but the newest)."""
        while self._prepped and (final or len(self._prepped) > 1):
            fut, n_real = self._prepped.pop(0)
            chunks = [(to_device(w, dev), to_device(b, dev), n)
                      for (w, b, n), dev in zip(fut.result(), self.devices)]
            self._drain(keep=self._max_inflight - 1)
            self._dispatch(chunks)
            trace.count("batches", stats=self.stats)
            self.stats["windows_processed"] += max(n_real, 0)

    # -- device steps ------------------------------------------------------

    def _superstep(self, chunk, prefix):
        """One shard's classic superstep: K4's merge under
        ``compactor="merge"``, else embedded when the trailing key word
        has >= 21 free bits, else the separate-count superstep."""
        cfg = self.cfg
        words, bits, n = chunk
        eb = sortcount.embed_bits(cfg.k)
        kw = dict(k=cfg.k, n=n, kernels=cfg.kernels)
        if cfg.compactor == "merge":
            return sortcount.superstep_merged(words, bits, prefix, ebits=eb, **kw)
        if eb >= 21:
            return sortcount.superstep_embedded(words, bits, prefix, ebits=eb, **kw)
        return sortcount.superstep_plain(words, bits, prefix, **kw)

    def _dispatch(self, chunks):
        """Run every shard's superstep on its device and queue the round
        for verification; ``self.prefix`` becomes the unverified output."""
        out, ndvs = [], []
        for chunk, prefix, dev in zip(chunks, self.prefix, self.devices):
            with on_device(dev):
                new_prefix, ndv = self._superstep(chunk, prefix)
            out.append(new_prefix)
            ndvs.append(ndv)
        self._rounds.append((ndvs, _Round(chunks, self.prefix)))
        self.prefix = out

    def _slots_overflow(self, vals, rnd: _Round) -> bool:
        """Subclass hook: replay and return True when the round's extra
        verification scalars (past [nd_exact, nd_used]) show lost rows."""
        return False

    def _replay(self, rounds):
        trace.count("replayed_rounds", len(rounds), self.stats)
        for rnd in rounds:
            self._dispatch(rnd.chunks)
            self._drain(keep=0)

    def _drain(self, keep: int = 0):
        """Verify queued rounds down to ``keep``: accept each, or grow
        every shard one ladder step past the largest nd_used and replay
        this round and every round chained after it (their inputs stay
        on the devices until verified)."""
        while len(self._rounds) > keep:
            ndvs, rnd = self._rounds.popleft()
            vals = [v.tolist() for v in ndvs]
            if self._slots_overflow(vals, rnd):
                continue
            nd_max = self._global_max(max(v[1] for v in vals))
            cap = rnd.prefix_in[0][0].shape[0]
            if nd_max <= cap:
                self._nd = [v[1] for v in vals]
                trace.count("compactions", stats=self.stats)
                continue
            rounds = [rnd] + [r for _, r in self._rounds]
            self._rounds.clear()
            new_cap = sortcount.next_store_size(
                min(cap + self.cfg.batch_windows, 2 * max(nd_max, cap)))
            if new_cap > self.cfg.prefix_cap:
                self.cfg.prefix_cap = new_cap
                trace.count("grow_events", stats=self.stats)
            self.prefix = [sized_store(p, new_cap) for p in rnd.prefix_in]
            self._replay(rounds)

    def _merge(self):
        """The pipeline sync point: dispatch every packed round, verify all."""
        self._launch(final=True)
        self._drain()

    # -- finalize: the exchange --------------------------------------------

    def _kmer_stores(self) -> list:
        """Per shard: (W key columns + count column, rows in use) of its
        k-mer records before the exchange."""
        return list(zip(self.prefix, self._nd))

    def _global_max(self, x: int) -> int:
        """Hook: the largest ``x`` over every process that counts with this
        one (the identity in one process).  Every decision that leads to
        a collective is taken on such a global value."""
        return x

    def _owners(self, cols, nshards: int) -> list:
        """Owner shard (of ``nshards``) of each shard's records."""
        w = codec.words_per_kmer(self.cfg.k)
        owners = []
        for rows, dev in zip(cols, self.devices):
            with on_device(dev):
                owners.append(owner_by_hash(rows[:w], nshards))
        return owners

    def _exchange(self, cols) -> list:
        """Hook: send each shard's live records (``cols[s]``, the W key
        columns and the count) to the shard that owns them; returns each
        shard's received records (one process: device copies)."""
        return exchange(cols, self._owners(cols, self.ndev), self.devices)

    def _retain(self, nd_max: int):
        """Grow the per-shard capacity to hold the largest received set,
        as the JAX package does after its exchange."""
        while nd_max > self.cfg.prefix_cap:
            self.cfg.prefix_cap *= 2
            trace.count("grow_events", stats=self.stats)

    def finalize_exchange(self):
        """Route every live record to the shard that owns its key and
        compact each shard's received records."""
        self._merge()
        if self._exchanged:
            return
        with trace.span("exchange", self.stats):
            cols = []
            for (store, nd), dev in zip(self._kmer_stores(), self.devices):
                with on_device(dev):
                    live = store[-1][:nd] > 0
                    cols.append(tuple(c[:nd][live] for c in store))
            recv = self._exchange(cols)
            self.prefix, self._nd = [], []
            for got, dev in zip(recv, self.devices):
                with on_device(dev):
                    store, ndv = sortcount.compact_clamped(got, self.cfg.kernels)
                nd = int(ndv[1])
                self.prefix.append(tuple(c[:nd] for c in store))
                self._nd.append(nd)
            self._retain(self._global_max(max(self._nd)))
            self._exchanged = True

    # -- output (``SortedOutput``: as_dict, write_output, find) ------------

    def shard_dumps(self) -> list:
        """Per shard, after the exchange: (keys (N, W) uint32 sorted,
        counts (N,) int64) of the records it owns."""
        self.finalize_exchange()
        return [rows_to_host([store_part(p, nd)]) for p, nd in zip(self.prefix, self._nd)]

    def dump_columns(self):
        """All distinct k-mers across shards in key order, before
        filtering and clipping, as one dump part a shard: part r is the
        r-th of ndev key ranges, on ``devices[r]`` (``_key_ranges``).
        Each shard's slice of range r is copied to device r and the
        slices merge there (``lexsort``); every device's copies and merge
        are queued before the one synchronise a device that ends the
        ``range_dump`` span.  ``dump_rows_moved`` counts the rows copied
        off the shard that held them."""
        self.finalize_exchange()
        w = codec.words_per_kmer(self.cfg.k)
        with trace.span("range_dump", self.stats):
            bounds = self._key_ranges(w)
            parts, moved = [], 0
            for r, dev in enumerate(self.devices):
                slices = [tuple(c[b[r]:b[r + 1]] for c in p)
                          for p, b in zip(self.prefix, bounds)]
                moved += sum(b[r + 1] - b[r] for s, b in enumerate(bounds) if s != r)
                rows = self._merge_range(slices, dev, w)
                parts.append((tuple(rows[:w].unbind(0)), rows[w]))
            trace.count("dump_rows_moved", moved, self.stats)
            for dev in dict.fromkeys(self.devices):
                if dev.type == "cuda":
                    trace.count("host_syncs", stats=self.stats)
                    torch.cuda.synchronize(dev)
        return parts

    def _key_ranges(self, w: int) -> list:
        """Per shard, the ndev + 1 row bounds of its sorted store's slices
        of the key ranges.  Owners are hash-routed, so the largest
        shard's store samples the whole key space: its leading 64-bit
        keys (``sortcount.sort_key`` of the first two words) at ranks
        N r / ndev are the ndev - 1 splits, and range r holds the keys
        whose leading key lies in [split r - 1, split r).  Rows with one
        leading key fall in one range, so ranges are disjoint whatever
        the balance."""
        ndev = self.ndev
        lead = []
        for p, nd, dev in zip(self.prefix, self._nd, self.devices):
            with on_device(dev):
                lead.append(sortcount.sort_key([c[:nd] for c in p[:min(w, 2)]]))
        big = max(range(ndev), key=self._nd.__getitem__)
        n = self._nd[big]
        ranks = torch.tensor([n * r // ndev for r in range(1, ndev)], dtype=torch.int64,
                             device=self.devices[big])
        splits = lead[big][ranks] if n else lead[big].new_zeros(ndev - 1)
        bounds = []
        for ld, nd, dev in zip(lead, self._nd, self.devices):
            with on_device(dev):
                cut = torch.searchsorted(ld, splits.to(dev))
            trace.count("host_syncs", stats=self.stats)
            bounds.append([0, *cut.tolist(), nd])
        return bounds

    @staticmethod
    def _merge_range(slices, dev, w: int) -> torch.Tensor:
        """Sorted, key-disjoint store slices copied to ``dev`` and merged
        there: the (W + 1, N) rows of ``lexsort``."""
        with on_device(dev):
            cols = [torch.cat([s[i].to(dev, non_blocking=True) for s in slices])
                    for i in range(w + 1)]
            return sortcount.lexsort(cols, num_keys=w)

    def occupancy(self):
        """(live records over all shards, ndev x per-shard capacity)."""
        self._merge()
        live = sum(int((p[-1][:nd] > 0).sum()) for p, nd in zip(self.prefix, self._nd))
        return live, self.ndev * self.cfg.prefix_cap

    # -- checkpoint / resume (the kaarme_tpu sharded_sort .npz) ------------

    def save(self, path: str):
        """Snapshot every shard's records WITHOUT the exchange, plus the
        not-yet-processed tail codes, so windows spanning the checkpoint
        are neither lost nor double-counted on resume.  A key may appear
        on several shards with partial counts; ``load`` sums them, so
        counting resumes on any number of shards.  The live counter is
        left untouched."""
        if self._exchanged:
            raise RuntimeError("cannot checkpoint after finalize")
        self._merge()
        keys, counts = rows_to_host([store_part(p, nd) for p, nd in zip(self.prefix, self._nd)])
        tail = self._buf.take_all()
        self._buf.append(tail)
        np.savez_compressed(
            path, kind="sharded_sort", k=self.cfg.k, mode=self.cfg.mode,
            min_abundance=self.cfg.min_abundance,
            keys=keys, counts=counts, tail=tail,
            windows_processed=self.stats["windows_processed"])

    @classmethod
    def _default_config(cls, z) -> ShardedSortConfig:
        return ShardedSortConfig(k=int(z["k"]), mode=int(z["mode"]),
                                 min_abundance=int(z["min_abundance"]))

    @classmethod
    def load(cls, path: str, config: "ShardedSortConfig | None" = None, devices=None):
        """Restore a ``save`` checkpoint of either package onto any number
        of shards; counting can resume.  Partial counts of one key are
        summed and the rows sorted before they are split over the shards
        (each store must be sorted with one row per key)."""
        z = np.load(path)
        k = int(z["k"])
        if config is None:
            config = cls._default_config(z)
        elif config.k != k:
            raise ValueError(f"checkpoint is for k={k}, config has k={config.k}")
        self = cls(config, devices)
        keys = z["keys"].astype(np.uint32)
        cnt = z["counts"].astype(np.int64)
        if keys.shape[0]:
            order = np.lexsort(keys.T[::-1])
            keys, cnt = keys[order], cnt[order]
            first = np.ones(keys.shape[0], bool)
            first[1:] = (keys[1:] != keys[:-1]).any(axis=1)
            starts = np.flatnonzero(first)
            cnt = np.add.reduceat(cnt, starts)
            keys = keys[starts]
        per = -(-max(keys.shape[0], 1) // self.ndev)
        while per > self.cfg.prefix_cap:
            self.cfg.prefix_cap *= 2
        self.prefix, self._nd = [], []
        for d, dev in enumerate(self.devices):
            # store_from_numpy clamps the summed counts below 2^21
            part = slice(d * per, (d + 1) * per)
            cols = [keys[part, j] for j in range(config.words)] + [cnt[part]]
            self.prefix.append(store_from_numpy(cols, self.cfg.prefix_cap, dev))
            self._nd.append(int(cols[0].shape[0]))
        if z["tail"].shape[0]:
            self._buf.append(z["tail"].astype(np.uint8))
        self.stats["windows_processed"] = int(z["windows_processed"])
        return self

