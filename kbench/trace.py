"""The harness's spans and its reading of the device trace.

Spans are recorded from the harness's own files: ``install`` wraps, for
the run, the program's entry points of each layer (a counter's
``count_file``, ``count_file_two_pass``, ``write_output``, and the wait
for the reader's next chunk) so that each call is a span (name, thread,
start and end on ``time.perf_counter_ns``).  The program is not edited.

``device_summary`` reads the device activity that ``torch.profiler``
recorded over the window (CUDA activity only, so that the host runs as
it does untraced; ``profiler_events``), card by card: each card's busy
time is the union of its own kernels, copies and memsets, and its idle
gaps are the window less that union, named by the span the main thread
was in.  ``busy_s`` and each idle gap are the mean over the cards, so
that one busy card beside three idle ones reads 75% idle; the kernels'
own time and the device operations that took most time are summed over
the cards.  Host and device clocks are tied by an anchor: the first
device operation of the trace, one the harness launches on the first
card at a known host time before the window, with every card idle; it
launches one on each other card too, so that every card of the cell
appears in the trace.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

NAME_CHARS = 120           # device operation names are cut to this length


class Spans:
    """Span records of one run; ``install`` wraps the program's layer
    entry points and ``uninstall`` puts them back."""

    def __init__(self):
        self.records = []            # (name, thread ident, start ns, end ns)
        self.main = threading.get_ident()
        self._saved = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.records.append((name, threading.get_ident(), t0, time.perf_counter_ns()))

    def _wrap_method(self, cls, attr: str, name: str):
        orig = cls.__dict__[attr]
        spans = self

        def wrapped(*a, **kw):
            with spans.span(name):
                return orig(*a, **kw)

        self._saved.append((cls, attr, orig))
        setattr(cls, attr, wrapped)

    def _wrap_iter(self, cls, name: str):
        orig = cls.__dict__["__iter__"]
        spans = self

        def __iter__(self_):
            it = orig(self_)
            while True:
                with spans.span(name):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                yield item

        self._saved.append((cls, "__iter__", orig))
        cls.__iter__ = __iter__

    def install(self):
        from kaarme_tpu_torch.io import reader
        from kaarme_tpu_torch.models import bloom_counter, counter, sort_counter
        from kaarme_tpu_torch.parallel import sharded_sort

        self._wrap_method(sort_counter.SortKmerCounter, "count_file", "count_file")
        self._wrap_method(counter.KmerCounter, "count_file", "count_file")
        self._wrap_method(sharded_sort.ShardedSortCounter, "count_file", "count_file")
        self._wrap_method(bloom_counter._TwoPassBloom, "count_file_two_pass",
                          "count_file_two_pass")
        self._wrap_method(sort_counter.CountOutput, "write_output", "write_output")
        self._wrap_iter(reader.PrefetchingReader, "reader_wait")
        return self

    def uninstall(self):
        for cls, attr, orig in reversed(self._saved):
            setattr(cls, attr, orig)
        self._saved.clear()


def _segments(records, main: int):
    """The main thread's spans as elementary segments (start ns, end ns,
    name of the innermost span there)."""
    ev = sorted([(t0, 1, -t1, name) for name, tid, t0, t1 in records if tid == main]
                + [(t1, 0, 0, name) for name, tid, t0, t1 in records if tid == main])
    out, stack, last = [], [], None
    for t, kind, _, name in ev:
        if stack and last is not None and t > last:
            out.append((last, t, stack[-1]))
        if kind == 1:
            stack.append(name)
        elif stack[-1] == name:
            stack.pop()
        else:
            stack.remove(name)
        last = t
    return out


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged intervals of an (n, 2) array of [start, end)."""
    if iv.shape[0] == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(iv.shape[0], bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = ends[np.r_[last[1:] - 1, iv.shape[0] - 1]]
    return np.stack([starts, stops], 1)


def profiler_events(prof) -> list:
    """(category, name, start us, end us, card index) of each device
    operation a stopped ``torch.profiler.profile`` recorded, read in
    memory.  The card's torch gives events no activity type: copies and
    memsets are told by their names."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        cat = {"Memcpy": "gpu_memcpy", "Memset": "gpu_memset"}.get(e.name()[:6], "kernel")
        s = e.start_ns() / 1e3
        out.append((cat, e.name(), s, s + e.duration_ns() / 1e3, e.device_index()))
    return out


def device_summary(events, spans: Spans, anchor_ns: int, w0_ns: int, w1_ns: int):
    """What the device ``events`` say of the window [w0_ns, w1_ns]
    (perf_counter_ns), as ``profiler_events`` gives them (an event
    without a card index is on card 0).  The cards are those the events
    name; the first event of the lowest is the anchor, launched at
    ``anchor_ns``.  Returns busy_s (the mean over the cards),
    busy_s_per_card, window_s, kernel_s and device_ops (summed over the
    cards) and idle_gaps (the mean over the cards); device_ops and
    idle_gaps each at most 10 [name, seconds], largest first.  None
    without events."""
    if not events:
        return None
    card = [e[4] if len(e) > 4 else 0 for e in events]
    cards = sorted(set(card))
    a_us = min(e[2] for e, c in zip(events, card) if c == cards[0])

    def us(t_ns):
        return a_us + (t_ns - anchor_ns) / 1e3

    w0, w1 = us(w0_ns), us(w1_ns)
    by_name = {}
    kernel_us = 0.0
    for cat, name, s, t, *_ in events:
        d = min(t, w1) - max(s, w0)
        if d <= 0:
            continue
        by_name[name[:NAME_CHARS]] = by_name.get(name[:NAME_CHARS], 0.0) + d
        if cat == "kernel":
            kernel_us += d
    segs = [(us(a), us(b), n) for a, b, n in _segments(spans.records, spans.main)]
    busy_s, idle = [], {}
    for c in cards:
        iv = np.array([(max(e[2], w0), min(e[3], w1)) for e, ec in zip(events, card)
                       if ec == c and e[3] > w0 and e[2] < w1],
                      dtype=np.float64).reshape(-1, 2)
        busy = _union(iv)
        busy_s.append(float((busy[:, 1] - busy[:, 0]).sum()) / 1e6 if busy.size else 0.0)
        # idle gaps: the window minus the card's busy union, named by the main span
        edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        j = 0
        for g0, g1 in gaps:        # gaps and segments are both sorted and disjoint
            while j < len(segs) and segs[j][1] <= g0:
                j += 1
            covered, i = 0.0, j
            while i < len(segs) and segs[i][0] < g1:
                d = min(g1, segs[i][1]) - max(g0, segs[i][0])
                idle[segs[i][2]] = idle.get(segs[i][2], 0.0) + d
                covered += d
                i += 1
            if g1 - g0 > covered:
                idle["harness"] = idle.get("harness", 0.0) + (g1 - g0 - covered)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gtop = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    n = len(cards)
    return dict(busy_s=sum(busy_s) / n, busy_s_per_card=busy_s,
                window_s=(w1 - w0) / 1e6, kernel_s=kernel_us / 1e6,
                device_ops=[[name, v / 1e6] for name, v in top],
                idle_gaps=[[name, v / 1e6 / n] for name, v in gtop])
