"""Streaming counter on the super-k-mer (minimizer-run) pipeline, in
PyTorch — the counterpart of ``kaarme_tpu/models/skm_counter.py``.

Each superstep segments the stream into run rows and merges them into
the run store (sort + K2).  Two layouts (``segpack``):

- "dense" (the default): K1 front-packs the live run rows; the first
  ``eff`` of them are merged and the superstep reports [nd_exact,
  nd_used, rows_exact, rows_used];
- "slotted": K5 gives each 512-window tile S rows (``skm_slots``); all
  ceil(n / 512) * S rows are merged, mostly sentinels, and the superstep
  reports [nd_exact, nd_used, max_tile_runs].

Optimistic sizes are verified afterwards and replayed larger when they
were too small: the dense run-row capacity / merge mass (rows_used >
eff), the slot budget (max_tile_runs > S: S doubles up to 512, which
holds every start of a tile, so the ladder ends) and the store's
working size (nd_used > its capacity).  Canonical k-mer keys
materialize once, at finalize, from the distinct runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import cuda_skm, skm, sortcount
from ..utils import trace
from .sort_counter import SortCounterConfig, SortKmerCounter, _Step, sized_store, store_part

_JAX_SEGPACKS = ("pallas", "pallas_interpret", "dense_interpret", "xla")


@dataclasses.dataclass
class SkmCounterConfig(SortCounterConfig):
    skm_cap_frac: int = 8      # run-row capacity = next_store_size(n // frac)
                               # (run mass is ~n/14 on 150 bp reads; an
                               # overflow replays at a larger capacity)
    skm_slots: int = 96        # slotted layout: rows S per 512-window tile
                               # (doubled on overflow, up to 512)
    segpack: str = "auto"      # run-row layout: "dense" (K1; "auto") or
                               # "slotted" (K5)

    def __post_init__(self):
        super().__post_init__()
        if not skm.supported(self.k):
            raise ValueError(f"skm pipeline requires k >= {skm.M}")
        if self.skm_cap_frac < 1:
            raise ValueError("skm_cap_frac must be >= 1")
        if not 1 <= self.skm_slots <= cuda_skm.SLOT_TILE:
            raise ValueError(f"skm_slots must be in [1, {cuda_skm.SLOT_TILE}]")
        if self.segpack in _JAX_SEGPACKS:
            raise ValueError(f"segpack {self.segpack!r} is a JAX-package variant; the port "
                             "takes 'auto', 'dense' or 'slotted' and runs the plain "
                             "versions of the kernels with kernels='plain'")
        if self.segpack == "auto":
            self.segpack = "dense"
        if self.segpack not in ("dense", "slotted"):
            raise ValueError("segpack must be 'auto', 'dense' or 'slotted'")

    @property
    def words(self) -> int:
        """Store key columns are RUN rows: Wc content words + meta."""
        return skm.store_words(self.k)


class SkmCounter(SortKmerCounter):
    """Super-k-mer streaming counter."""

    def __init__(self, config: SkmCounterConfig):
        super().__init__(config)
        self._final_cache = None
        self._rows_hw = 0          # verified high-water of rows_exact
        self._rows_eff_min = 0     # floor for the merge-mass ladder
        self._deltas = []          # last verified distinct-growth deltas
        self._S = config.skm_slots # slotted layout: current slot budget
        self.stats["slot_grow_events"] = 0   # run-row replays (rows_used > eff,
                                             # or max_tile_runs > S)
        self.stats["finalize_seconds"] = 0.0

    # -- sizing --------------------------------------------------------------

    def _eff_for_dispatch(self, n: int) -> int:
        """Run-store working size for the next merge: the live rows plus
        headroom from the last few verified growth deltas (an underguess
        is caught by verification and replayed bigger).  The cold start
        counts the live rows too, so a resumed store is never cut below
        them, and a size that an overflow proved needed is never undercut
        again (the store only grows), so a replay cannot repeat the
        overflow."""
        cap = self.cfg.prefix_cap
        if cap <= (1 << 12):
            return cap
        if self._deltas:
            recent = max(self._deltas[-3:])
            target = self.n_used + (self._max_inflight + 1) * max(recent, n // 256)
        else:
            target = self.n_used + max(n // 32, 1 << 14)
        eff = min(max(sortcount.next_store_size(target), self._eff_floor), cap)
        if self._inflight:
            # unverified in-flight outputs may hold up to the current
            # length of live rows: never cut below it
            eff = max(eff, self.prefix[0].shape[0])
        return eff

    def _dense_cap(self, n: int) -> int:
        """K1 output capacity for an n-window superstep."""
        want = max(n // self.cfg.skm_cap_frac, 1 << 12)
        if self._rows_eff_min:
            want = max(want, min(self._rows_eff_min, n))
        return sortcount.next_store_size(want)

    def _dense_eff(self, n: int, cap: int) -> int:
        """Run rows merged this superstep: the verified rows high-water
        plus 1/16 headroom (n/12 before any is known), never below a
        prior overflow's requirement."""
        if self._rows_hw == 0:
            want = sortcount.next_store_size(max(n // 12, 1 << 12))
        else:
            want = sortcount.next_store_size(
                self._rows_hw + max(self._rows_hw // 16, 1 << 12))
        return min(cap, max(want, self._rows_eff_min))

    # -- device steps ----------------------------------------------------------

    def _dispatch(self, words_d, bits_d, n: int):
        """One superstep in the configured layout; ``step.eff`` is the
        dense merge mass, or None on the slotted layout."""
        cfg = self.cfg
        prefix_in = sized_store(self.prefix, self._eff_for_dispatch(n))
        if cfg.segpack == "slotted":
            eff = None
            rows, maxruns = skm.skm_segpack_step(
                words_d, bits_d, k=cfg.k, n=n, S=self._S, kernels=cfg.kernels)
            new_prefix, ndv = skm.skm_merge_step(rows, maxruns, prefix_in,
                                                 kernels=cfg.kernels)
        else:
            cap = self._dense_cap(n)
            eff = self._dense_eff(n, cap)
            rows, rows_nd = skm.skm_segpack_dense_step(
                words_d, bits_d, k=cfg.k, n=n, cap=cap, kernels=cfg.kernels)
            new_prefix, ndv = skm.skm_merge_dense_step(
                rows, rows_nd, prefix_in, eff=eff, kernels=cfg.kernels)
        self._inflight.append((ndv, _Step(words_d, bits_d, n, eff, prefix_in)))
        self.prefix = new_prefix
        self._final_cache = None

    def _rows_overflow(self, vals, step: _Step) -> bool:
        """Run rows were lost: on the dense layout rows_used > eff (live
        rows cut from the merge), so the merge-mass floor rises; on the
        slotted layout max_tile_runs > S (starts past S dropped), so S
        doubles until it holds them (the S-ladder; 512 holds every start
        of a tile).  Either way the superstep and every later one replay
        from the pre-overflow store.  Every superstep in flight was
        dispatched at the current S: a ladder step replays all of them."""
        if step.eff is None:
            maxruns = vals[2]
            if maxruns <= self._S:
                return False
            while self._S < maxruns:
                self._S = min(2 * self._S, cuda_skm.SLOT_TILE)
        else:
            rows_exact, rows_used = vals[2], vals[3]
            self._rows_hw = max(self._rows_hw, rows_exact)
            if rows_used <= step.eff:
                return False
            self._rows_eff_min = sortcount.next_store_size(max(rows_used, 2 * step.eff))
        steps = [step] + [s for (_, s) in self._inflight]
        self._inflight.clear()
        trace.count("slot_grow_events", stats=self.stats)
        self.prefix = step.prefix_in
        self._replay_all(steps)
        return True

    def _accept(self, nd_exact: int, nd: int):
        self._deltas.append(max(nd_exact - self.n_distinct, 0))
        del self._deltas[:-8]
        super()._accept(nd_exact, nd)

    # -- output ------------------------------------------------------------------

    def finalize_device(self):
        """Expand the distinct run store into the sorted k-mer store on
        the device: (W key columns + count column, n_used), cached until
        more input arrives.  Counting may continue afterwards."""
        self._flush()
        self._merge()
        tag = (self.stats["windows_processed"], self.n_used)
        if self._final_cache is not None and self._final_cache[0] == tag:
            return self._final_cache[1]
        with trace.span("finalize", self.stats):      # ends in the nd read, a sync
            run_cols = tuple(c[: self.n_used] for c in self.prefix)
            out = skm.finalize_store(run_cols, self.cfg.k, kernels=self.cfg.kernels,
                                     **self._superstep_kwargs())
        self._final_cache = (tag, out)
        return out

    def distinct_kmers(self) -> int:
        """Exact distinct k-mer count of the finalized store."""
        store, nd = self.finalize_device()
        return int((store[-1][:nd] > 0).sum()) if nd else 0

    def dump_columns(self):
        """The finalized k-mer store's rows as one dump part, on the
        device (sorted, before abundance filtering and clipping)."""
        store, nd = self.finalize_device()
        return [store_part(store, nd)]

    @classmethod
    def load(cls, path: str, config: "SkmCounterConfig | None" = None, *,
             device: str = "cuda"):
        if config is None:
            z = np.load(path)
            config = SkmCounterConfig(k=int(z["k"]), mode=int(z["mode"]),
                                      min_abundance=int(z["min_abundance"]),
                                      device=device)
        return super().load(path, config, device=device)
