"""State carried across between the JAX package and the port.

Store columns are numpy arrays on the JAX side (uint32 key columns, an
int32 count column — the ``.npz`` checkpoint fields ``col0..colW``) and
int32 bit-pattern tensors in the port.  These helpers convert both
ways, so a run store or k-mer store, or a checkpoint, moves in either
direction.
"""

from __future__ import annotations

import numpy as np
import torch


def columns_to_torch(cols, device) -> tuple:
    """numpy/JAX store columns (key columns uint32, count column last)
    -> int32 tensors on ``device``, bit patterns unchanged."""
    out = []
    for i, c in enumerate(cols):
        a = np.asarray(c)
        if i < len(cols) - 1:
            a = a.astype(np.uint32, copy=False).view(np.int32)
        else:
            a = a.astype(np.int32)
        out.append(torch.from_numpy(np.require(a, requirements=['C', 'W'])).to(device))
    return tuple(out)


def columns_to_numpy(cols) -> tuple:
    """Port store columns -> numpy (key columns uint32, count int32)."""
    out = [c.cpu().numpy().view(np.uint32) for c in cols[:-1]]
    return tuple(out) + (cols[-1].cpu().numpy().astype(np.int32),)


def store_from_numpy(cols, cap: int, device) -> tuple:
    """Checkpoint columns (nd rows, the JAX package's .npz layout) -> a
    store of ``cap`` rows on ``device``: the rows, then sentinel keys
    with count 0.  Counts are re-clamped as the JAX loader does, so
    checkpoints written before the stored-count invariant still hold
    counts below 2^21."""
    nd = int(np.asarray(cols[0]).shape[0])
    big = 1 << 20
    cnt = np.asarray(cols[-1]).astype(np.int64)
    cnt = np.where(cnt > big, big + (cnt & (big - 1)), cnt)
    full = []
    for c in cols[:-1]:
        f = np.full(cap, 0xFFFFFFFF, np.uint32)
        f[:nd] = np.asarray(c)
        full.append(f)
    fc = np.zeros(cap, np.int32)
    fc[:nd] = cnt
    return columns_to_torch(full + [fc], device)
