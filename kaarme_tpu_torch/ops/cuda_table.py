"""T1: batched insert into the open-addressing count table — the
counterpart of ``kaarme_tpu/ops/table.py::insert`` (XLA ops in the JAX
package, not a Pallas kernel).

``table_insert`` launches the hand-written kernel
(``csrc/table_insert.cu``: one thread per window claims empty slots with
``atomicCAS``) on CUDA tensors and runs the plain PyTorch version,
``table_insert_plain``, on CPU tensors.  The plain version is the JAX
package's batched probe rounds ("CAS by write-then-verify"), round for
round, with one change that a GPU needs: the JAX scatter of key rows
into empty slots lets the writers of one slot collide, and on a CUDA
tensor an indexed assignment with repeated indices writes each ELEMENT
from an unspecified writer, so a row could be torn between two keys.
Then no writer verifies, all of them move on, and the slot stays empty
on their probe chains: a later batch holding one of those keys would
claim that slot too and store the key twice, and a lookup would stop
there.  So each round first elects one writer per slot (the highest
window index, the last writer of a sequential scatter) and only the
elected rows are written; everything else is the JAX round.

Contract (both versions): ``tkeys`` (C, W) int32 key rows holding u32
bit patterns, ``counts`` (C,) int32 with 0 meaning empty, C a power of
two; ``keys`` a sequence of W columns of N values (int32 bit patterns
or int64 in [0, 2^32)), ``valid`` (N,) bool, ``h`` (N,) slot hashes
(int64 in [0, 2^32) or int32 bit patterns), ``amount`` (N,) positive
int32 or None (1 each).  Every valid window's amount is added to its
key's slot along the probe chain (h + i(i+1)/2) & (C - 1), i <
``max_probes``; ``tkeys`` and ``counts`` are updated in place.  Returns
(pending (N,) bool: the valid windows that found neither their key nor
an empty slot, n_pending: their number as a 0-d int32 tensor on the
table's device).  Slot placement may differ between the versions (and
from the JAX package's); the multiset of occupied (key row, count)
pairs does not when nothing is pending.
"""

from __future__ import annotations

import torch

from . import _build
from .sortcount import M32, i32


def _tri(i: torch.Tensor) -> torch.Tensor:
    """Triangular probe offset i(i+1)/2 as u32 arithmetic (int64 values
    in [0, 2^32)): a full cycle modulo 2^m."""
    return ((i * (i + 1)) & M32) >> 1


def _check(tkeys, counts, keys, valid, h, amount, max_probes):
    if tkeys.dim() != 2 or tkeys.dtype != torch.int32 or not tkeys.is_contiguous():
        raise ValueError("tkeys must be a contiguous (C, W) int32 tensor")
    C, W = tkeys.shape
    if C < 1 or C & (C - 1) or C > (1 << 32):
        raise ValueError(f"the table's capacity must be a power of two <= 2^32, got {C}")
    if counts.shape != (C,) or counts.dtype != torch.int32 or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous (C,) int32 tensor")
    if len(keys) != W:
        raise ValueError(f"{len(keys)} key columns for a table of {W} words")
    n = valid.shape[0]
    tensors = list(keys) + [valid, h] + ([] if amount is None else [amount])
    if any(t.shape != (n,) for t in tensors):
        raise ValueError("keys, valid, h and amount must be (N,) tensors")
    if valid.dtype != torch.bool:
        raise ValueError("valid must be a bool tensor")
    if any(t.device != tkeys.device for t in tensors + [counts]):
        raise ValueError("the table and the batch must be on one device")
    if max_probes < 0:
        raise ValueError("max_probes must be >= 0")
    return C, W, n


def table_insert(tkeys: torch.Tensor, counts: torch.Tensor, keys, valid: torch.Tensor,
                 h: torch.Tensor, amount: "torch.Tensor | None" = None, *,
                 max_probes: int = 64):
    """Insert a batch of keys (see the module docstring); returns
    (pending, n_pending)."""
    C, W, n = _check(tkeys, counts, keys, valid, h, amount, max_probes)
    if tkeys.device.type == "cpu":
        return table_insert_plain(tkeys, counts, keys, valid, h, amount, max_probes=max_probes)
    if tkeys.device.type != "cuda":
        raise ValueError(f"unsupported device {tkeys.device}")
    dev = tkeys.device
    kmat = torch.stack([i32(k) for k in keys])
    hv = i32(h).contiguous()
    amt = None if amount is None else amount.to(torch.int32).contiguous()
    valid = valid.contiguous()
    pending = torch.empty(n, dtype=torch.bool, device=dev)
    npend = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().kt_table_insert(
            tkeys.data_ptr(), counts.data_ptr(), C, W, kmat.data_ptr(), kmat.stride(0),
            valid.data_ptr(), hv.data_ptr(), None if amt is None else amt.data_ptr(), n,
            max_probes, pending.data_ptr(), npend.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_table_insert")
    table_insert.launches += 1
    return pending, npend


table_insert.launches = 0


def table_insert_plain(tkeys: torch.Tensor, counts: torch.Tensor, keys, valid: torch.Tensor,
                       h: torch.Tensor, amount: "torch.Tensor | None" = None, *,
                       max_probes: int = 64):
    """Plain PyTorch version of ``table_insert``: the JAX package's probe
    rounds with one elected writer per claimed slot (module docstring)."""
    C, _, n = _check(tkeys, counts, keys, valid, h, amount, max_probes)
    dev = tkeys.device
    kmat = torch.stack([i32(k) for k in keys], 1)
    amt = (torch.ones(n, dtype=torch.int32, device=dev) if amount is None
           else amount.to(torch.int32))
    hv = h.to(torch.int64) & M32
    idx = torch.arange(n, device=dev)
    pending = valid.clone()
    probe = torch.zeros(n, dtype=torch.int64, device=dev)
    elect = None
    for _ in range(max_probes):
        if not bool(pending.any()):
            break
        slot = (hv + _tri(probe)) & (C - 1)
        occupied = counts[slot] > 0
        key_eq = (tkeys[slot] == kmat).all(1)
        hit = pending & occupied & key_eq
        counts.index_add_(0, slot[hit], amt[hit])
        attempt = pending & ~occupied
        a_slot, a_idx = slot[attempt], idx[attempt]
        if elect is None:
            elect = torch.full((C,), -1, dtype=torch.int64, device=dev)
        elect.scatter_reduce_(0, a_slot, a_idx, "amax")
        writer = a_idx[elect[a_slot] == a_idx]
        tkeys[slot[writer]] = kmat[writer]
        elect[a_slot] = -1
        mine = (tkeys[slot] == kmat).all(1)
        success = attempt & mine
        counts.index_add_(0, slot[success], amt[success])
        pending &= ~(hit | success)
        probe += pending
    return pending, pending.sum(dtype=torch.int32)
