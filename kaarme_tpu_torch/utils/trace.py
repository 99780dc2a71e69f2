"""The port's tracer: named spans and counters, on ``time.perf_counter_ns``.

- ``span(name, stats=None)`` times a block.  Its duration is added to a
  counter's ``stats`` under ``key(name)`` (``name + "_seconds"``; the
  ``count`` span keeps the historical key ``build_seconds``).  A span
  given ``stats`` also makes that dict the running job's for its
  extent, so the spans and counters under it, on any thread, add to
  the same dict; pass ``stats`` only on the thread that drives the job.
- ``count(name, n=1, stats=None)`` adds ``n`` to the same totals.  Two
  of the counters say which input path ran: ``device_parsed_bytes``, the
  raw bytes P1 parsed on the device (``ops/cuda_parse.py``), and
  ``host_encoded_bytes``, the bytes the host's encoders took
  (``io/reader.CodeChunkReader``).

Recording is off by default: then only the totals are kept.  With
``record(True)`` (the CLI's ``--trace-out PATH``) every span also
appends ``(name, thread ident, start ns, end ns, parent)`` to one
process-wide buffer (``parent``: the enclosing span's name on the same
thread, or None), and every counter ``(name, thread ident, ns, total)``.
The first four fields of a span record have the shape of the
benchmark's own span records, on the clock its device trace is tied to,
so ``program_spans()`` can stand in for them.  ``write_chrome`` writes
the records as Chrome trace-event JSON (Perfetto, ``chrome://tracing``):
spans as "X" events and counters as "C" events, in microseconds of that
clock, one track per thread.
"""

from __future__ import annotations

import json
import os
import threading
import time
import types

KEYS = {"count": "build_seconds"}   # span name -> stats key, where it is not name_seconds

_lock = threading.Lock()
_tls = threading.local()
_recording = False
_sink = None          # the running job's stats dict
_spans = []           # (name, thread ident, start ns, end ns, parent, track), while recording
_counts = []          # (name, thread ident, ns, total, track), while recording
_loose = {}           # totals of counters counted with no stats dict, while recording
_tracks = []          # the name of each thread that recorded, by track - 1 (an ident
                      # can be reused by a later thread; a track cannot)


def key(name: str) -> str:
    """The stats key that a span's durations add up under."""
    return KEYS.get(name, name + "_seconds")


def record(on: bool = True) -> bool:
    """Turn recording on or off; returns whether it was on."""
    global _recording
    was, _recording = _recording, bool(on)
    return was


def recording() -> bool:
    return _recording


def clear():
    """Drop every record."""
    with _lock:
        _spans.clear()
        _counts.clear()
        _loose.clear()


def records() -> list:
    """The span records, in the order the spans ended."""
    return [r[:5] for r in _spans]


def counter_records() -> list:
    """The counter records, in the order they were counted."""
    return [r[:4] for r in _counts]


def mark() -> tuple:
    """A position in the records, for ``write_chrome(since=...)``."""
    return len(_spans), len(_counts)


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def _track() -> int:
    """This thread's track in the Chrome trace, numbered from 1."""
    try:
        return _tls.track
    except AttributeError:
        with _lock:
            _tracks.append(f"{threading.current_thread().name} ({threading.get_ident()})")
            _tls.track = len(_tracks)
        return _tls.track


class span:
    """A timed block (module docstring).  ``seconds`` holds its duration
    once it has ended."""

    __slots__ = ("name", "stats", "parent", "bound", "prev", "t0", "seconds")

    def __init__(self, name: str, stats: "dict | None" = None):
        self.name = name
        self.stats = stats
        self.seconds = None

    def __enter__(self):
        global _sink
        st = _stack()
        self.parent = st[-1] if st else None
        st.append(self.name)
        self.bound = self.stats is not None
        if self.bound:
            self.prev, _sink = _sink, self.stats
        else:
            self.stats = _sink
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _sink
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self.t0) / 1e9
        _stack().pop()
        if self.bound:
            _sink = self.prev
        if self.stats is not None:
            k = key(self.name)
            with _lock:
                self.stats[k] = self.stats.get(k, 0.0) + self.seconds
        if _recording:
            _spans.append((self.name, threading.get_ident(), self.t0, t1, self.parent,
                           _track()))
        return False


def count(name: str, n: int = 1, stats: "dict | None" = None):
    """Add ``n`` to the counter ``name`` of ``stats``, or of the running
    job's stats dict when None."""
    st = _sink if stats is None else stats
    total = None
    if st is not None:
        with _lock:
            total = st[name] = st.get(name, 0) + n
    if _recording:
        if total is None:
            with _lock:
                total = _loose[name] = _loose.get(name, 0) + n
        _counts.append((name, threading.get_ident(), time.perf_counter_ns(), total, _track()))


def program_spans(recs=None, main: "int | None" = None):
    """Span records (``records()`` when None) in the shape of the
    benchmark's span records: ``.records``, (name, thread ident, start
    ns, end ns), and ``.main``, the thread whose innermost span names the
    card's idle time (this thread when None)."""
    return types.SimpleNamespace(
        records=[r[:4] for r in (records() if recs is None else recs)],
        main=threading.get_ident() if main is None else main)


def self_ns(recs) -> list:
    """Each span record's self time in ns: its duration less that of its
    direct children (the spans nested in it on its thread)."""
    out = [r[3] - r[2] for r in recs]
    by_thread = {}
    for i, r in enumerate(recs):
        by_thread.setdefault(r[1], []).append(i)
    for idx in by_thread.values():
        idx.sort(key=lambda i: (recs[i][2], -recs[i][3]))
        open_ = []
        for i in idx:
            while open_ and recs[open_[-1]][3] <= recs[i][2]:
                open_.pop()
            if open_:
                out[open_[-1]] -= recs[i][3] - recs[i][2]
            open_.append(i)
    return out


def write_chrome(path: str, since: tuple = (0, 0)) -> int:
    """Write the records past ``since`` (a ``mark()``) to ``path`` as a
    Chrome trace-event JSON object, one track per thread, named by the
    thread's name and ident; returns the number of events."""
    spans, counts = _spans[since[0]:], _counts[since[1]:]
    pid = os.getpid()
    ev = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
           "args": {"name": "kaarme_tpu_torch"}}]
    for tid in sorted({r[5] for r in spans} | {r[4] for r in counts}):
        ev.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"name": _tracks[tid - 1]}})
        ev.append({"name": "thread_sort_index", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"sort_index": tid}})
    for name, _, t0, t1, parent, tid in spans:
        ev.append({"name": name, "cat": "span", "ph": "X", "ts": t0 / 1e3,
                   "dur": (t1 - t0) / 1e3, "pid": pid, "tid": tid, "args": {"parent": parent}})
    for name, _, t, total, tid in counts:
        ev.append({"name": name, "cat": "counter", "ph": "C", "ts": t / 1e3, "pid": pid,
                   "tid": tid, "args": {name: total}})
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "displayTimeUnit": "ms",
                   "otherData": {"clock": "time.perf_counter_ns / 1000 (microseconds)"}}, f)
    return len(ev)
