"""FASTA and plain text parsed and packed on the device: the raw bytes of
the file go to the card, and P1 (``ops/cuda_parse.py``) writes the
transfer chunks that the one-card sort-route counters' supersteps read.

- ``RawBlockReader`` reads the file (gzipped or not) in raw blocks into
  a ring of reused host buffers, pinned for a card: a slot is read into
  again only after the device copy from it has completed.
- ``CodeStream`` copies each block to the device on its own io stream
  and appends its codes to the device code stream there (P1).  Superstep
  s's chunk holds the codes at positions [s sb, s sb + sb + k - 1), as
  ``sort_counter.pack_chunk`` makes it of those codes.  The host
  learns that a chunk is complete only from the stream's code offset,
  read with a copy and an event on the io stream (a counted host sync,
  in the ``pack_wait`` span), and reads it only when the raw bytes
  launched so far could have completed the next chunk: a byte emits at
  most one code.  A complete chunk is handed out for dispatch on the
  compute stream, behind the io stream's work up to that read.

FASTQ, whose parser carries quality lengths, stays on the host path
(``reader.CodeChunkReader``), as do the sharded counters.
"""

from __future__ import annotations

import contextlib
import gzip
import queue

import numpy as np
import torch

from ..ops import cuda_parse
from ..utils import trace

_BASES = np.frombuffer(b"ACGTN", np.uint8)


def _fill(f, view) -> int:
    """Read into ``view`` until it is full or the file ends; bytes read."""
    got = 0
    while got < len(view):
        n = f.readinto(view[got:])
        if not n:
            break
        got += n
    return got


class RawBlockReader:
    """Raw blocks of ``path`` in a ring of ``slots`` host buffers of
    ``block_bytes`` (pinned when ``pin``).  Iterating yields (slot, bytes
    read); ``block(slot, n)`` is the slot's buffer as a uint8 tensor, and
    ``release(slot, event)`` hands the slot back once the copy from it is
    enqueued (``event`` marks the copy's end; None where nothing is
    pending).  Wrap it in ``reader.PrefetchingReader`` to read on a
    thread of its own."""

    def __init__(self, path: str, gzipped: bool, block_bytes: int, slots: int, pin: bool):
        self.path, self.gzipped = path, gzipped
        self._bufs = [torch.empty(int(block_bytes), dtype=torch.uint8, pin_memory=pin)
                      for _ in range(max(2, slots))]
        self._free = queue.Queue()
        for i in range(len(self._bufs)):
            self._free.put((i, None))

    def block(self, slot: int, n: int) -> torch.Tensor:
        return self._bufs[slot][:n]

    def release(self, slot: int, event=None):
        self._free.put((slot, event))

    def __iter__(self):
        opener = gzip.open if self.gzipped else open
        with opener(self.path, "rb") as f:
            while True:
                slot, event = self._free.get()
                if event is not None:
                    event.synchronize()       # the copy out of this slot has ended
                with trace.span("read"):
                    n = _fill(f, memoryview(self._bufs[slot].numpy()))
                if not n:
                    self.release(slot)
                    return
                yield slot, n


class CodeStream:
    """The device code stream of one pass over a file (module docstring)
    on ``device``: ``feed`` each raw block, then ``close``; both return the
    chunks completed so far as (2-bit words, bitmap, windows) for the
    compute stream, the stream that is current when it is made."""

    def __init__(self, device, k: int, sb: int, kernels: str):
        self.dev, self.k, self.sb, self.span = device, k, sb, sb + k - 1
        self.kernels = kernels
        cuda = device.type == "cuda"
        self.compute = torch.cuda.current_stream(device) if cuda else None
        self.io = torch.cuda.Stream(device) if cuda else None
        self._chunks = {}      # superstep -> (words, bitmap), zeroed at allocation
        self._first = 0        # the lowest superstep not yet handed out
        self._known = 0        # the code offset read last (exact then)
        self._ub = 0           # a bound of the code offset: _known + bytes launched since
        # the most supersteps a launch may write to: at least the window
        # that a read leaves open (see _room)
        self._cap = max(8, 2 + -(-(k - 1) // sb))
        self._ready = []
        self._raw = None
        self._event = None     # on the io stream, after the last read
        with self._on_io():
            self.state = cuda_parse.ParseState(device)
            self._host = (torch.zeros(5, dtype=torch.int64, pin_memory=True)
                          if self.io is not None else None)

    def _on_io(self):
        return torch.cuda.stream(self.io) if self.io is not None else contextlib.nullcontext()

    def _end(self, s: int) -> int:
        """The code offset at which superstep s's chunk is complete."""
        return s * self.sb + self.span

    def feed(self, block: torch.Tensor, fasta: bool, release=None) -> list:
        """Append a block of raw bytes (a host uint8 tensor); ``release``
        is called with the event that ends its copy (None off a card) once
        the block is no longer read from the host."""
        nb = block.shape[0]
        with self._on_io():
            with trace.span("to_device"):
                if self.io is None:
                    raw, copied = block.clone(), None
                else:
                    if self._raw is None or self._raw.shape[0] < nb:
                        self._raw = torch.empty(nb, dtype=torch.uint8, device=self.dev)
                    raw = self._raw[:nb]
                    raw.copy_(block, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(self.io)
            if release is not None:
                release(copied)
            pos = 0
            while pos < nb:
                take = self._room(nb - pos)
                self._launch(raw[pos:pos + take], fasta)
                pos += take
        self._collect()
        ready, self._ready = self._ready, []
        return ready

    def feed_codes(self, codes: np.ndarray) -> list:
        """Append codes (a restored checkpoint's tail, ahead of the file):
        as the bytes ACGTN of plain text, which emit those codes."""
        ready = []
        for i in range(0, codes.shape[0], 1 << 23):
            ready += self.feed(torch.from_numpy(_BASES[codes[i:i + (1 << 23)]]), fasta=False)
        return ready

    def _room(self, want: int) -> int:
        """Bytes of the next launch: at most ``want``, and few enough that
        the supersteps it may write to, [_first, (_ub + bytes - 1) / sb],
        number at most _cap.  Reads the offset first where that is needed:
        after a read the offset is below _end(_first), so a launch of at
        least (_cap - 1) sb - (k - 1) >= sb bytes fits."""
        if (self._ub + want - 1) // self.sb - self._first < self._cap:
            return want
        if self._ub > self._known:
            self._read()
        return min(want, (self._first + self._cap) * self.sb - self._ub)

    def _launch(self, raw: torch.Tensor, fasta: bool):
        hi = (self._ub + raw.shape[0] - 1) // self.sb
        for s in range(self._first, hi + 1):
            if s not in self._chunks:
                self._chunks[s] = (
                    torch.zeros(-(-self.span // 16), dtype=torch.int32, device=self.dev),
                    torch.zeros(-(-self.span // 32), dtype=torch.int32, device=self.dev))
        with trace.span("parse"):
            cuda_parse.parse_pack(raw, fasta=fasta, state=self.state,
                                  chunks=[self._chunks[s] for s in range(self._first, hi + 1)],
                                  base=self._first, sb=self.sb, span=self.span,
                                  kernels=self.kernels)
        self._ub += raw.shape[0]

    def _read(self):
        """Read the code offset (a host sync) and hand out every chunk that
        it completes."""
        trace.count("host_syncs")
        with trace.span("pack_wait"):
            if self.io is not None:
                with self._on_io():
                    self._host.copy_(self.state.buf, non_blocking=True)
                    self._event = torch.cuda.Event()
                    self._event.record(self.io)
                self._event.synchronize()
                vals = self._host.tolist()
            else:
                vals = self.state.buf.tolist()
        off, _, err = self.state.host_view(vals)
        if err:
            raise RuntimeError("P1 met a code outside its chunk table")
        self._known = self._ub = off
        while self._end(self._first) <= off:
            self._hand(self._first, self.sb)

    def _collect(self):
        """Read the offset if the bytes launched could have completed the
        next chunk (a byte emits at most one code)."""
        if self._ub >= self._end(self._first):
            self._read()

    def _hand(self, s: int, n: int):
        """Superstep s's chunk, cut to its n + k - 1 codes, to the ready
        list; the compute stream waits for the io stream's work up to the
        last read."""
        words, bits = self._chunks.pop(s)
        m = n + self.k - 1
        words, bits = words[:-(-m // 16)], bits[:-(-m // 32)]
        if self.io is not None:
            self.compute.wait_event(self._event)
            words.record_stream(self.compute)
            bits.record_stream(self.compute)
        self._ready.append((words, bits, n))
        self._first = s + 1

    def close(self) -> list:
        """Read the final offset and hand out what is left: the complete
        chunks, then the last superstep's n = codes - k + 1 windows (none
        where fewer than k codes remain).  Frees the stream's buffers."""
        self._read()
        tail = self._known - self._first * self.sb
        if tail >= self.k:
            self._hand(self._first, tail - self.k + 1)
        self._chunks.clear()
        self._raw = self.state = self._host = None
        ready, self._ready = self._ready, []
        return ready
