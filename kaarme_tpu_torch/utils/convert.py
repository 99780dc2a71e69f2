"""State carried across between the JAX package and the port.

Store columns are numpy arrays on the JAX side (uint32 key columns, an
int32 count column — the ``.npz`` checkpoint fields ``col0..colW``) and
int32 bit-pattern tensors in the port, and so are the probe table's
key rows and counts.  These helpers convert both ways, so a run store,
k-mer store, probe table or checkpoint moves in either direction.
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


def bloom_to_torch(words, device) -> torch.Tensor:
    """A JAX package Bloom filter stage (uint32 words, numpy or JAX)
    -> the port's int32 word tensor on ``device``, bits unchanged."""
    a = np.asarray(words).astype(np.uint32, copy=False).view(np.int32)
    return torch.from_numpy(np.require(a, requirements=['C', 'W'])).to(device)


def table_to_torch(tkeys, counts, device) -> tuple:
    """A JAX package table ((C, W) uint32 keys, (C,) int32 counts, numpy
    or JAX) -> the port's (int32 (C, W), int32 (C,)) tensors on
    ``device``, bit patterns unchanged."""
    tk = np.asarray(tkeys).astype(np.uint32, copy=False).view(np.int32)
    cn = np.asarray(counts).astype(np.int32)
    return (torch.from_numpy(np.require(tk, requirements=['C', 'W'])).to(device),
            torch.from_numpy(np.require(cn, requirements=['C', 'W'])).to(device))


def table_to_numpy(tkeys, counts) -> tuple:
    """The port's table -> numpy ((C, W) uint32 keys, (C,) int32 counts),
    the JAX package's layout."""
    return tkeys.cpu().numpy().view(np.uint32), counts.cpu().numpy().astype(np.int32)
