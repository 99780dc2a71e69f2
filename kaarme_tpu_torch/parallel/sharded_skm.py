"""Multi-device counting on the super-k-mer pipeline — the counterpart of
``kaarme_tpu/parallel/sharded_skm.py``.

Streaming has the shape of ``ShardedSortCounter``'s, with the slotted
skm superstep on every shard: K5 segments the shard's transfer chunk
into S run rows per 512-window tile, and the rows merge into the
shard's run store (sort + K2 embedded).  Each round also reports every
shard's largest per-tile run count: when any exceeds S, S doubles (the
S-ladder) and the round replays, before the store's capacity is
checked.

Finalize expands each shard's distinct runs into k-mer records on its
own device (``skm.finalize_store``), then runs the sort counter's
exchange at k-mer width: run rows never travel.
"""

from __future__ import annotations

import dataclasses

from ..ops import cuda_skm, skm
from ..utils import trace
from .sharded import on_device
from .sharded_sort import ShardedSortConfig, ShardedSortCounter, _Round


@dataclasses.dataclass
class ShardedSkmConfig(ShardedSortConfig):
    skm_slots: int = 96        # run-slot budget S per 512-window tile
                               # (doubled on overflow, up to 512)

    def __post_init__(self):
        super().__post_init__()
        if not skm.supported(self.k):
            raise ValueError(f"skm pipeline requires k >= {skm.M}")
        if self.batch_windows % cuda_skm.SLOT_TILE:
            raise ValueError(f"batch_windows must be a multiple of {cuda_skm.SLOT_TILE}")
        if not 1 <= self.skm_slots <= cuda_skm.SLOT_TILE:
            raise ValueError(f"skm_slots must be in [1, {cuda_skm.SLOT_TILE}]")

    @property
    def words(self) -> int:
        """Store key columns are RUN rows until finalize: Wc content
        words + the meta word."""
        return skm.store_words(self.k)


class ShardedSkmCounter(ShardedSortCounter):
    """``ShardedSortCounter`` with the slotted skm superstep and an
    expand-then-exchange finalize.  Same surface; ``compactor`` is
    ignored, as on the single-device skm route."""

    def __init__(self, config: ShardedSkmConfig, devices=None):
        super().__init__(config, devices)
        self._S = config.skm_slots
        self.stats["slot_grow_events"] = 0

    def _superstep(self, chunk, prefix):
        words, bits, n = chunk
        kernels = self.cfg.kernels
        rows, maxruns = skm.skm_segpack_step(words, bits, k=self.cfg.k, n=n, S=self._S,
                                             kernels=kernels)
        return skm.skm_merge_step(rows, maxruns, prefix, kernels=kernels)

    def _slots_overflow(self, vals, rnd: _Round) -> bool:
        """Some shard's tile had more run starts than S, so K5 dropped
        rows: S doubles until it holds them (512 holds every start of a
        tile) and this round and every later one replay from the
        pre-overflow stores."""
        maxruns = max(v[2] for v in vals)
        if maxruns <= self._S:
            return False
        rounds = [rnd] + [r for _, r in self._rounds]
        self._rounds.clear()
        while self._S < maxruns:
            self._S = min(2 * self._S, cuda_skm.SLOT_TILE)
        trace.count("slot_grow_events", stats=self.stats)
        self.prefix = list(rnd.prefix_in)
        self._replay(rounds)
        return True

    def _kmer_stores(self) -> list:
        """Each shard's distinct runs expanded into its sorted k-mer store."""
        out = []
        for p, nd, dev in zip(self.prefix, self._nd, self.devices):
            with on_device(dev):
                out.append(skm.finalize_store(tuple(c[:nd] for c in p), self.cfg.k,
                                              kernels=self.cfg.kernels))
        return out

    def _retain(self, nd_max: int):
        """The run-store capacity is not the k-mer stores' (the JAX
        package sizes the received k-mer stores on their own)."""

    @classmethod
    def _default_config(cls, z) -> ShardedSkmConfig:
        return ShardedSkmConfig(k=int(z["k"]), mode=int(z["mode"]),
                                min_abundance=int(z["min_abundance"]))
