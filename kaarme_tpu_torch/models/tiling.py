"""Host-side cutting of the code stream into fixed device batches — the
counterpart of ``kaarme_tpu/models/tiling.py``.

A batch is ``batch_tiles`` tiles of ``tile`` window positions; tile rows
are ``tile + k - 1`` codes, consecutive rows overlapping by k - 1 (the
halo), so every window of the stream appears in exactly one tile
position; the last batch is padded with code 4.  The JAX package yields
each batch as its (batch_tiles, tile + k - 1) tile view; here
``add_flat`` and ``finish_flat`` yield the batch's flat ``batch_tiles *
tile + k - 1`` codes, whose windows are the tile view's windows in the
same order (window t of the batch is position t % tile of tile t //
tile), so no halo crosses the bus twice.  The counters pack them into
the transfer chunk (``sort_counter.pack_chunk``).
"""

from __future__ import annotations

import numpy as np


class TileBatcher:
    def __init__(self, k: int, tile: int, batch_tiles: int):
        self.k = k
        self.tile = tile
        self.batch_tiles = batch_tiles
        self._buf = np.empty(0, np.uint8)

    def add_flat(self, codes: np.ndarray):
        """Yields every full batch as its flat codes."""
        if codes.shape[0] == 0:
            return
        self._buf = (
            codes if self._buf.shape[0] == 0 else np.concatenate([self._buf, codes])
        )
        per_batch = self.batch_tiles * self.tile
        while self._buf.shape[0] - (self.k - 1) >= per_batch:
            yield self._buf[: per_batch + self.k - 1]
            self._buf = self._buf[per_batch:].copy()

    def finish_flat(self):
        """Yields the final padded batch (same length), if anything remains."""
        if self._buf.shape[0] > 0:
            per_batch = self.batch_tiles * self.tile
            padded = np.full(per_batch + self.k - 1, 4, np.uint8)
            padded[: self._buf.shape[0]] = self._buf
            yield padded
        self._buf = np.empty(0, np.uint8)
