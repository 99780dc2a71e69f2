"""Streaming counter on the super-k-mer (minimizer-run) pipeline, in
PyTorch — the counterpart of ``kaarme_tpu/models/skm_counter.py`` on its
dense path.

Each superstep segments the stream into dense run rows (K1), merges the
first ``eff`` of them into the run store (sort + K2) and reports
[nd_exact, nd_used, rows_exact, rows_used].  Two optimistic sizes are
verified afterwards and replayed larger when they were too small: the
run-row capacity / merge mass (rows_used > eff) and the store's working
size (nd_used > its capacity).  Canonical k-mer keys materialize once,
at finalize, from the distinct runs.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from kaarme_tpu.utils import codec

from ..ops import skm, sortcount
from .sort_counter import SortCounterConfig, SortKmerCounter, _Step, live_rows_to_host


@dataclasses.dataclass
class SkmCounterConfig(SortCounterConfig):
    skm_cap_frac: int = 8      # run-row capacity = next_store_size(n // frac)
                               # (run mass is ~n/14 on 150 bp reads; an
                               # overflow replays at a larger capacity)

    def __post_init__(self):
        super().__post_init__()
        if not skm.supported(self.k):
            raise ValueError(f"skm pipeline requires k >= {skm.M}")
        if self.skm_cap_frac < 1:
            raise ValueError("skm_cap_frac must be >= 1")

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
        self.stats["slot_grow_events"] = 0   # run-row (rows_used > eff) replays
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

    def _dispatch(self, packed_d, sep_d, n: int, dense: bool):
        cfg = self.cfg
        prefix_in = self._sized_prefix(self._eff_for_dispatch(n))
        cap = self._dense_cap(n)
        eff = self._dense_eff(n, cap)
        rows, rows_nd = skm.skm_segpack_dense_step(
            packed_d, sep_d, k=cfg.k, n=n, cap=cap, dense=dense, kernels=cfg.kernels)
        new_prefix, ndv = skm.skm_merge_dense_step(
            rows, rows_nd, prefix_in, eff=eff, kernels=cfg.kernels)
        self._inflight.append((ndv, _Step(packed_d, sep_d, n, dense, eff, prefix_in)))
        self.prefix = new_prefix
        self._final_cache = None

    def _rows_overflow(self, vals, step: _Step) -> bool:
        """rows_used > eff: live rows were cut from the merge.  Raise the
        merge-mass floor and replay this and every later superstep."""
        rows_exact, rows_used = vals[2], vals[3]
        if rows_used <= step.eff:
            self._rows_hw = max(self._rows_hw, rows_exact)
            return False
        steps = [step] + [s for (_, s) in self._inflight]
        self._inflight.clear()
        self._rows_hw = max(self._rows_hw, rows_exact)
        self._rows_eff_min = sortcount.next_store_size(max(rows_used, 2 * step.eff))
        self.stats["slot_grow_events"] += 1
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
        t0 = time.perf_counter()
        run_cols = tuple(c[: self.n_used] for c in self.prefix)
        out = skm.finalize_store(run_cols, self.cfg.k, kernels=self.cfg.kernels)
        self.stats["finalize_seconds"] += time.perf_counter() - t0  # nd read = synced
        self._final_cache = (tag, out)
        return out

    def distinct_kmers(self) -> int:
        """Exact distinct k-mer count of the finalized store."""
        store, nd = self.finalize_device()
        return int((store[-1][:nd] > 0).sum()) if nd else 0

    def dump(self):
        """(keys (N, W) uint32 sorted, counts (N,) int64) of all distinct
        k-mers, before abundance filtering and clipping."""
        store, nd = self.finalize_device()
        return live_rows_to_host(store, nd, codec.words_per_kmer(self.cfg.k))

    @classmethod
    def load(cls, path: str, config: "SkmCounterConfig | None" = None, *,
             device: str = "cuda"):
        if config is None:
            z = np.load(path)
            config = SkmCounterConfig(k=int(z["k"]), mode=int(z["mode"]),
                                      min_abundance=int(z["min_abundance"]),
                                      device=device)
        return super().load(path, config)
