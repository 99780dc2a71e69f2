"""Zero-copy FIFO buffer over appended code chunks (the port's copy of
``kaarme_tpu/io/codebuf.py``).

The streaming counters consume the encoded stream in fixed
``superstep_windows + k - 1``-code slices that overlap by k-1 codes
(window halo; the reference reader's k-1 backseek — reference:
include/text_reader.h:206-213).  Re-concatenating carry + every pending
chunk per superstep is quadratic host memcpy.  This buffer keeps chunks
intact behind a cursor: a take() that one chunk covers is a zero-copy
view (the common case — the readers feed large arrays), and the k-1
overlap is plain cursor arithmetic instead of a carry copy.
"""

from __future__ import annotations

import collections

import numpy as np


class CodeBuffer:
    """FIFO of uint8 code chunks with an overlap-aware cursor."""

    def __init__(self):
        self._chunks = collections.deque()
        self._off = 0    # consumed codes within chunks[0]
        self._n = 0      # available codes at/after the cursor

    def append(self, arr: np.ndarray):
        arr = np.asarray(arr, np.uint8)
        if arr.shape[0]:
            self._chunks.append(arr)
            self._n += arr.shape[0]

    def __len__(self) -> int:
        return self._n

    def take(self, need: int, advance: int) -> np.ndarray:
        """Return ``need`` contiguous codes from the cursor (a view when
        the leading chunk covers them) and advance the cursor by
        ``advance`` <= need; the difference (the k-1 window overlap)
        stays buffered and is re-served by the next take."""
        if not 0 <= advance <= need <= self._n:
            raise ValueError(f"take({need}, {advance}) with {self._n} buffered")
        first = self._chunks[0]
        if self._off + need <= first.shape[0]:
            out = first[self._off: self._off + need]
        else:
            parts, got, off = [], 0, self._off
            for c in self._chunks:
                seg = c[off: off + (need - got)]
                parts.append(seg)
                got += seg.shape[0]
                off = 0
                if got == need:
                    break
            out = np.concatenate(parts)
        self._n -= advance
        self._off += advance
        while self._chunks and self._off >= self._chunks[0].shape[0]:
            self._off -= self._chunks[0].shape[0]
            self._chunks.popleft()
        return out

    def take_all(self) -> np.ndarray:
        """Drain the buffer (zero-copy when a single chunk remains)."""
        if not self._n:
            return np.empty(0, np.uint8)
        return self.take(self._n, self._n)
