"""T1: batched insert into the open-addressing count table — the
counterpart of ``kaarme_tpu/ops/table.py::insert`` (XLA ops in the JAX
package, not a Pallas kernel) together with what feeds it there: the
validity mask and the slot hash ``hashing.hash_words``.

``table_insert`` launches the hand-written kernel
(``csrc/table_insert.cu``: from the key columns, validity and the
murmur3 hash in registers, equal keys of a warp aggregated with
``__match_any_sync``, one group leader per key down the probe chain,
empty slots claimed with ``atomicCAS``) on CUDA tensors and runs the
plain PyTorch version, ``table_insert_plain``, on CPU tensors.  The
plain version derives what the caller left out with the torch
functions (``sortcount._is_sentinel_i32``, ``hashing.hash_words``),
then runs the JAX package's batched probe rounds ("CAS by
write-then-verify"), round for round, with one change that a GPU needs:
the JAX scatter of key rows into empty slots lets the writers of one
slot collide, and on a CUDA tensor an indexed assignment with repeated
indices writes each ELEMENT from an unspecified writer, so a row could
be torn between two keys.  Then no writer verifies, all of them move
on, and the slot stays empty on their probe chains: a later batch
holding one of those keys would claim that slot too and store the key
twice, and a lookup would stop there.  So each round first elects one
writer per slot (the highest window index, the last writer of a
sequential scatter) and only the elected rows are written; everything
else is the JAX round.

Contract (both versions): ``tkeys`` (C, W) int32 key rows holding u32
bit patterns, ``counts`` (C,) int32 with 0 meaning empty, C a power of
two; ``keys`` a sequence of W columns of N values (int32 bit patterns
or int64 in [0, 2^32)); ``valid`` (N,) bool or None: None means every
window whose key words are not ALL all-ones (K3's invalid key, and the
``-b`` gate's missed key); ``h`` (N,) slot hashes (int64 in [0, 2^32)
or int32 bit patterns) or None: None means ``hashing.hash_words(keys)``;
``amount`` (N,) positive int32 or None (1 each).  Every valid window's
amount is added to its key's slot along the probe chain (h + i(i+1)/2)
& (C - 1), i < ``max_probes``; ``tkeys`` and ``counts`` are updated in
place.  Returns (pending (N,) bool: the valid windows that found
neither their key nor an empty slot, n_pending: their number as a 0-d
int32 tensor on the table's device).  Slot placement may differ between
the versions (and from the JAX package's); the multiset of occupied
(key row, count) pairs does not when nothing is pending.  The kernel
reads key columns that are views of one int32 buffer (K3's ``(W, N)``
output, or a table's ``tk[:, w]``) where they lie, and stacks others.
"""

from __future__ import annotations

import torch

from . import _build
from .hashing import hash_words
from .sortcount import M32, _is_sentinel_i32, i32


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
    n = keys[0].shape[0] if keys[0].dim() == 1 else -1
    tensors = list(keys) + [t for t in (valid, h, amount) if t is not None]
    if any(t.shape != (n,) for t in tensors):
        raise ValueError("keys, valid, h and amount must be (N,) tensors")
    if valid is not None and valid.dtype != torch.bool:
        raise ValueError("valid must be a bool tensor")
    if any(t.device != tkeys.device for t in tensors + [counts]):
        raise ValueError("the table and the batch must be on one device")
    if max_probes < 0:
        raise ValueError("max_probes must be >= 0")
    return C, W, n


def _key_columns(keys):
    """(tensor, lw, li): word w of window i at element w * lw + i * li of
    the tensor's storage.  Columns that are int32 views of one buffer at
    a common spacing (K3's ``(W, N)`` output, a table's ``tk[:, w]``) are
    passed as they lie; any others are stacked into a ``(W, N)`` copy."""
    k0 = keys[0]
    n = k0.shape[0]
    if n > 1 and all(k.dtype == torch.int32 for k in keys):
        li = k0.stride(0)
        lw = (keys[1].data_ptr() - k0.data_ptr()) // 4 if len(keys) > 1 else 0
        if li >= 1 and all(k.stride(0) == li and
                           k.untyped_storage().data_ptr() == k0.untyped_storage().data_ptr() and
                           k.data_ptr() - k0.data_ptr() == 4 * w * lw
                           for w, k in enumerate(keys)):
            return k0, lw, li
    kmat = torch.stack([i32(k) for k in keys])
    return kmat, kmat.stride(0), 1


def table_insert(tkeys: torch.Tensor, counts: torch.Tensor, keys,
                 valid: "torch.Tensor | None" = None, h: "torch.Tensor | None" = None,
                 amount: "torch.Tensor | None" = None, *, max_probes: int = 64):
    """Insert a batch of keys (see the module docstring); returns
    (pending, n_pending)."""
    C, W, n = _check(tkeys, counts, keys, valid, h, amount, max_probes)
    if tkeys.device.type == "cpu":
        return table_insert_plain(tkeys, counts, keys, valid, h, amount, max_probes=max_probes)
    if tkeys.device.type != "cuda":
        raise ValueError(f"unsupported device {tkeys.device}")
    dev = tkeys.device
    kbuf, lw, li = _key_columns(keys)
    hv = None if h is None else i32(h).contiguous()
    amt = None if amount is None else amount.to(torch.int32).contiguous()
    valid = None if valid is None else valid.contiguous()
    ptr = lambda t: None if t is None else t.data_ptr()
    pending = torch.empty(n, dtype=torch.bool, device=dev)
    npend = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().kt_table_insert(
            tkeys.data_ptr(), counts.data_ptr(), C, W, kbuf.data_ptr(), lw, li, ptr(valid),
            ptr(hv), ptr(amt), n, max_probes, pending.data_ptr(), npend.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_table_insert")
    table_insert.launches += 1
    return pending, npend


table_insert.launches = 0


def table_insert_plain(tkeys: torch.Tensor, counts: torch.Tensor, keys,
                       valid: "torch.Tensor | None" = None, h: "torch.Tensor | None" = None,
                       amount: "torch.Tensor | None" = None, *, max_probes: int = 64):
    """Plain PyTorch version of ``table_insert``: ``valid`` and ``h``
    derived with the torch functions where None, then the JAX package's
    probe rounds with one elected writer per claimed slot (module
    docstring)."""
    C, _, n = _check(tkeys, counts, keys, valid, h, amount, max_probes)
    dev = tkeys.device
    kmat = torch.stack([i32(k) for k in keys], 1)
    if valid is None:
        valid = _is_sentinel_i32(kmat.unbind(1)) == 0
    if h is None:
        h = hash_words(keys)
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
