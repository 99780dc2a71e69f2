"""Multi-device counting on the probe table, and the device list of every
sharded counter — the counterpart of ``kaarme_tpu/parallel/sharded.py``.

One process drives a sequence of devices, one shard each (the JAX
package's 1-D mesh).  The table is one logical array of C = 2^cap_log2
slots split by hash prefix: a key's slot bits [shard_log2, cap_log2)
name its owner shard, and the owner probes its own 2^shard_log2 slots
with the low bits, so the shards are independent open-addressing tables
and a sharded count equals a single-device one as a multiset.

Each batch of ``batch_tiles`` tiles (``TileBatcher``) splits into ndev
groups of tiles; shard d packs its group into the transfer chunk, K3
makes its window keys, and every valid window travels as a (key words,
amount, hash) record to its owner (``exchange.exchange``), where T1
inserts it with its amount.  Records that find no slot come back
pending on their owner; then every shard is rebuilt at double the
capacity from the dump plus the pending records.  The JAX package
reaches this counter from the library only.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..io import reader as io_reader
from ..models.sort_counter import CountOutput, pack_chunk, rows_to_host, to_device
from ..models.tiling import TileBatcher
from ..ops import sortcount
from ..ops import table as table_ops
from ..ops.hashing import hash_words, hash_words_np
from ..utils import codec, trace
from ..utils.device import resolve_device
from ..utils.mathutils import capacity_log2
from .exchange import exchange


def make_mesh(n_devices: int = 0, device: str = "cuda") -> tuple:
    """The device list of ``n_devices`` shards (a power of two).

    ``device="cuda"``: cuda:0 .. cuda:n-1 (all visible cards when n is
    0); fewer cards than asked is an error, never a CPU run.
    ``device="cpu"``: n CPU shards (one when n is 0), the counterpart of
    the JAX tests' virtual CPU mesh.  The counters take any device
    sequence in place of one, and a device may repeat in it."""
    kind = torch.device(device).type
    if kind == "cpu":
        have = n = n_devices or 1
    elif kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or have
    else:
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    if n & (n - 1):
        raise ValueError(f"device count must be a power of two, got {n}")
    if have < max(n, 1):
        raise ValueError(f"need {max(n, 1)} devices, have {have}")
    if kind == "cpu":
        return (torch.device("cpu"),) * n
    return tuple(torch.device("cuda", i) for i in range(n))


def resolve_devices(devices) -> tuple:
    """A counter's device list: every card (``make_mesh()``) when None,
    else the given sequence resolved (a power-of-two count)."""
    if devices is None:
        return make_mesh()
    devs = tuple(resolve_device(d) for d in devices)
    n = len(devs)
    if n < 1 or n & (n - 1):
        raise ValueError(f"device count must be a power of two, got {n}")
    return devs


def on_device(dev: torch.device):
    """Context that makes ``dev`` the current CUDA device (a no-op off the
    card), so a shard's kernels and streams are its own device's."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


@dataclasses.dataclass
class ShardedCounterConfig:
    k: int
    min_slots: int = 1 << 22
    mode: int = 2
    min_abundance: int = 2
    tile: int = 1 << 14
    batch_tiles: int = 64          # must be a multiple of the device count
    max_probes: int = 64
    kernels: str = "cuda"          # "cuda": K3 and T1 (their plain versions on
                                   # CPU tensors); "plain": plain everywhere

    def __post_init__(self):
        if self.k < 2:
            raise ValueError("k must be >= 2")
        if self.mode not in (0, 1, 2):
            raise ValueError("mode must be 0, 1 or 2")
        sortcount.check_kernels(self.kernels)

    @property
    def words(self) -> int:
        return codec.words_per_kmer(self.k)


class ShardedKmerCounter(CountOutput):
    """Same pipeline surface as ``models.counter.KmerCounter``, over a
    device list."""

    def __init__(self, config: ShardedCounterConfig, devices=None):
        self.cfg = config
        self.devices = resolve_devices(devices)
        self.ndev = len(self.devices)
        if config.batch_tiles % self.ndev:
            raise ValueError("batch_tiles must be a multiple of the device count")
        self.cap_log2 = max(capacity_log2(config.min_slots),
                            (self.ndev - 1).bit_length() + 1)
        self._alloc_table()
        self._batcher = TileBatcher(config.k, config.tile, config.batch_tiles)
        self.stats = {"windows_processed": 0, "batches": 0, "grow_events": 0,
                      "build_seconds": 0.0, "write_seconds": 0.0}

    def _alloc_table(self):
        """Fresh zeroed table shards at the current capacity."""
        self.shard_log2 = self.cap_log2 - (self.ndev - 1).bit_length()
        self.tables = [table_ops.make_table(self.shard_log2, self.cfg.words, d)
                       for d in self.devices]

    # -- streaming (same surface as KmerCounter) ---------------------------

    def add_codes(self, codes: np.ndarray):
        for batch in self._batcher.add_flat(codes):
            self._flush(batch)

    def finish(self):
        for batch in self._batcher.finish_flat():
            self._flush(batch)

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

    def _flush(self, batch: np.ndarray):
        """One batch: shard d takes tiles [d, d + 1) * batch_tiles / ndev,
        makes their window keys from its transfer chunk (K3) and routes
        the valid windows, amount 1, to their owners."""
        cfg = self.cfg
        n = cfg.tile * cfg.batch_tiles // self.ndev
        records = []
        for d, dev in enumerate(self.devices):
            packed, sep, _ = pack_chunk(batch[d * n: (d + 1) * n + cfg.k - 1], n)
            with on_device(dev):
                keys = sortcount.window_keys_from_chunk(
                    to_device(packed, dev), to_device(sep, dev), k=cfg.k, n=n,
                    kernels=cfg.kernels)
                valid = sortcount._is_sentinel_i32(keys) == 0
                live = tuple(c[valid] for c in keys)
                records.append(live + (torch.ones_like(live[0]),))
        pend = self._route_insert(records)
        if pend is not None:
            self._grow_and_retry(pend)
        trace.count("batches", stats=self.stats)
        self.stats["windows_processed"] += cfg.tile * cfg.batch_tiles

    def _route_insert(self, records):
        """Send each shard's (W key columns, amount) records to their
        owners and insert them there (T1, with the amounts).  Returns
        None, or the pending records as a host (P, W + 1) uint32 array
        (key words, amount) when some found no slot."""
        w = self.cfg.words
        cols, owners = [], []
        for rec, dev in zip(records, self.devices):
            with on_device(dev):
                h = hash_words(rec[:w])
                owners.append((h & ((1 << self.cap_log2) - 1)) >> self.shard_log2)
                cols.append(rec + (sortcount.i32(h),))
        recv = exchange(cols, owners, self.devices)
        pending = []
        for (tkeys, counts), got, dev in zip(self.tables, recv, self.devices):
            with on_device(dev):
                # every record is a live key (never all-ones); the hash
                # is the one that routed it
                _, _, pend, n_pend = table_ops.insert(
                    tkeys, counts, got[:w], None, got[w + 1], amount=got[w],
                    max_probes=self.cfg.max_probes, kernels=self.cfg.kernels)
            pending.append((pend, n_pend, got[:w + 1]))
        if sum(int(n) for _, n, _ in pending) == 0:
            return None
        return np.concatenate(
            [torch.stack([c[pend] for c in got], 1).cpu().numpy().view(np.uint32)
             for pend, _, got in pending])

    def _grow_and_retry(self, pend: np.ndarray):
        """Double the global capacity, rebuild every shard from the live
        records, and re-insert the pending ones; again while any are left
        (reference contrast: exit(1) on a full table,
        source/kmer_hash_table.cpp:2553-2556)."""
        while True:
            live_tk, live_cn = self.dump()
            self.cap_log2 += 1
            trace.count("grow_events", stats=self.stats)
            self._alloc_table()
            recs = np.concatenate(
                [np.concatenate([live_tk, live_cn.astype(np.uint32)[:, None]], axis=1), pend])
            pend = self._insert_records(recs)
            if pend is None:
                return

    def _insert_records(self, recs: np.ndarray):
        """Insert host (key words..., amount) uint32 rows through the
        routed path: shard d sends rows [d, d + 1) * ceil(N / ndev)."""
        w = self.cfg.words
        per = -(-max(recs.shape[0], 1) // self.ndev)
        records = []
        for d, dev in enumerate(self.devices):
            part = torch.from_numpy(np.ascontiguousarray(
                recs[d * per: (d + 1) * per]).view(np.int32)).to(dev)
            records.append(tuple(part[:, j] for j in range(w + 1)))
        return self._route_insert(records)

    # -- output (``CountOutput``: as_dict, write_output in slot order) ------

    def _host_table(self):
        """The global table on the host: ((C, W) uint32 keys, (C,) int32
        counts), shard 0's slots first."""
        tk = np.concatenate([t.cpu().numpy().view(np.uint32) for t, _ in self.tables])
        return tk, np.concatenate([c.cpu().numpy() for _, c in self.tables])

    def dump_columns(self):
        """The table as one dump part per shard, in shard and slot order,
        each on its shard's device (empty slots have count 0 and write
        nothing)."""
        return [(tuple(tk.unbind(1)), cn) for tk, cn in self.tables]

    def dump(self):
        """(kmers (N, W) uint32, counts (N,) int32) of occupied slots in
        slot order (shard by shard), before filtering and clipping."""
        return rows_to_host(self.dump_columns(), np.int32)

    def occupancy(self):
        occ = sum(int((c > 0).sum()) for _, c in self.tables)
        return occ, 1 << self.cap_log2

    # -- checkpoint / resume (the kaarme_tpu sharded_table .npz) -----------

    def save(self, path: str):
        """Snapshot live (key, count) records + the not-yet-processed tail
        codes, so windows spanning the checkpoint are neither lost nor
        double-counted on resume.  The live counter is left untouched."""
        tk, cn = self.dump()
        np.savez_compressed(
            path, kind="sharded_table", k=self.cfg.k, mode=self.cfg.mode,
            min_abundance=self.cfg.min_abundance, keys=tk,
            counts=cn.astype(np.int64), tail=self._batcher._buf,
            windows_processed=self.stats["windows_processed"])

    @classmethod
    def load(cls, path: str, config: "ShardedCounterConfig | None" = None, devices=None):
        """Restore from a ``save`` checkpoint of either package onto any
        number of shards; counting can resume."""
        z = np.load(path)
        k = int(z["k"])
        if config is None:
            config = ShardedCounterConfig(k=k, mode=int(z["mode"]),
                                          min_abundance=int(z["min_abundance"]))
        elif config.k != k:
            raise ValueError(f"checkpoint is for k={k}, config has k={config.k}")
        self = cls(config, devices)
        keys = z["keys"].astype(np.uint32)
        if keys.shape[0]:
            recs = np.concatenate([keys, z["counts"].astype(np.uint32)[:, None]], axis=1)
            pend = self._insert_records(recs)
            if pend is not None:
                self._grow_and_retry(pend)
        if z["tail"].shape[0]:
            self._batcher._buf = z["tail"].astype(np.uint8)
        self.stats["windows_processed"] = int(z["windows_processed"])
        return self

    # -- queries ---------------------------------------------------------------

    def find(self, kmers) -> list:
        """Host-side point lookups: route by hash prefix and emulate the
        owner's probe sequence in NumPy (bit for bit the device hash)."""
        if isinstance(kmers, str):
            kmers = [kmers]
        tk, cn = self._host_table()
        shard_slots = 1 << self.shard_log2
        out = []
        for s in kmers:
            if len(s) != self.cfg.k or any(ch not in "ACGTacgt" for ch in s):
                out.append(-1)
                continue
            packed = codec.pack_kmer(codec.canonical(s.upper()))
            h = int(hash_words_np(tuple(np.uint32(x) for x in packed)))
            base = ((h & ((1 << self.cap_log2) - 1)) >> self.shard_log2) * shard_slots
            cnt = 0
            for i in range(self.cfg.max_probes):
                slot = base + (h + i * (i + 1) // 2) % shard_slots
                if cn[slot] <= 0:
                    break
                if (tk[slot] == packed).all():
                    cnt = int(cn[slot])
                    break
            out.append(int(self._clip(np.asarray([cnt]))[0]))
        return out
