"""K2: fused segment-sum + compaction over sorted rows — the counterpart
of ``kaarme_tpu/ops/pallas_compact.py::segsum_compact``.

``segsum_compact`` launches the hand-written kernel
(``csrc/segsum_compact.cu``) on CUDA tensors and runs the plain PyTorch
version, ``segsum_compact_torch``, on CPU tensors.  Both modes of the
main path:

- embedded (``cnt is None``): the count is the low ``ebits`` of the last
  key word; a segment's total is c_last + (len - 1), clamped — the
  run-store merge;
- full_sum (``cnt`` given): the clamped sum of every row's count in the
  segment — the finalize.

Output is dense: one record per live (non-sentinel) segment in key
order, then sentinel keys with count 0 up to ``out_len``;
nd_used == nd_exact.
"""

from __future__ import annotations

import torch

from . import _build
from .sortcount import _clamp_count, i32, u32

_TILE = 2048   # rows per block of the kernel (segsum_compact.cu)


def _check_inputs(keys, cnt, ebits, out_len):
    if keys.dim() != 2 or keys.dtype != torch.int32:
        raise ValueError("keys must be a (W, N) int32 tensor")
    W, N = keys.shape
    if W < 1:
        raise ValueError("keys needs at least one column")
    if cnt is None:
        if not 1 <= ebits <= 31:
            raise ValueError("embedded mode needs 1 <= ebits <= 31")
    else:
        if ebits:
            raise ValueError("full_sum mode takes a count column and ebits=0")
        if cnt.dtype != torch.int32 or cnt.shape != (N,) or cnt.device != keys.device:
            raise ValueError("cnt must be an int32 (N,) tensor on the keys' device")
    out_len = N if out_len is None else int(out_len)
    if out_len < 0:
        raise ValueError("out_len must be >= 0")
    return W, N, out_len


def segsum_compact(keys: torch.Tensor, cnt: "torch.Tensor | None" = None, *,
                   ebits: int = 0, out_len: "int | None" = None):
    """Sorted (W, N) int32 key columns [+ int32 count column] ->
    (keys (W, out_len), counts (out_len,), int32 [nd_exact, nd_used]).
    ``out_len`` defaults to N; records past it are counted in nd but not
    written (nd > out_len means the caller's capacity overflowed)."""
    W, N, out_len = _check_inputs(keys, cnt, ebits, out_len)
    if keys.device.type == "cpu":
        return segsum_compact_torch(keys, cnt, ebits=ebits, out_len=out_len)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    keys = keys.contiguous()
    cnt = None if cnt is None else cnt.contiguous()
    dev = keys.device
    with torch.cuda.device(dev):
        out = torch.empty((W + 1, out_len), dtype=torch.int32, device=dev)
        nt = -(-N // _TILE)
        scratch = torch.empty(2 * nt + 1, dtype=torch.int64, device=dev)
        nd = torch.empty(2, dtype=torch.int32, device=dev)
        err = _build.lib().kt_segsum_compact(
            keys.data_ptr(), None if cnt is None else cnt.data_ptr(), N, W,
            ebits if cnt is None else 0, int(cnt is not None), out.data_ptr(),
            out.stride(0), out_len, scratch.data_ptr(), nd.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_segsum_compact")
    segsum_compact.launches += 1
    return out[:W], out[W], nd


segsum_compact.launches = 0


def segsum_compact_torch(keys: torch.Tensor, cnt: "torch.Tensor | None" = None, *,
                         ebits: int = 0, out_len: "int | None" = None):
    """Plain PyTorch version of ``segsum_compact`` (same contract)."""
    W, N, out_len = _check_inputs(keys, cnt, ebits, out_len)
    dev = keys.device
    kk = u32(keys)
    cmask = (1 << ebits) - 1 if cnt is None else 0
    if cnt is None:
        c_last = kk[-1] & cmask
        kk[-1] &= 0xFFFFFFFF ^ cmask
    acc = kk[-1] | cmask
    for w in range(W - 1):
        acc = acc & kk[w]
    sent = acc == 0xFFFFFFFF
    if N:
        diff = (kk[:, 1:] != kk[:, :-1]).any(0)
        one = torch.ones(1, dtype=torch.bool, device=dev)
        first = torch.cat([one, diff])
        last = torch.cat([diff, one])
    else:
        first = last = sent
    alive = last & ~sent
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    start = torch.cummax(torch.where(first, idx, 0), 0).values if N else idx
    if cnt is None:
        total = _clamp_count(c_last + (idx - start))
    else:
        # the clamped running sum equals the clamp of the exact sum
        # (sortcount._clamp_count keeps c mod 2^20 and c >= 2^20)
        cs = torch.cumsum(_clamp_count(cnt.to(torch.int64)), 0)
        before = torch.where(start > 0, cs[start - 1], 0) if N else cs
        total = _clamp_count(cs - before)
    sel = torch.nonzero(alive).flatten()
    nd = int(sel.numel())
    m = min(nd, out_len)
    sel = sel[:m]
    okeys = torch.full((W, out_len), -1, dtype=torch.int32, device=dev)
    ocnt = torch.zeros(out_len, dtype=torch.int32, device=dev)
    okeys[:, :m] = i32(kk[:, sel])
    ocnt[:m] = i32(total[sel])
    return okeys, ocnt, torch.tensor([nd, nd], dtype=torch.int32, device=dev)
