"""K4: linear merge of the sorted store prefix with a sorted batch, with
K2's segment sum and dense compaction — the counterpart of
``kaarme_tpu/ops/pallas_merge.py::merge_compact_dense``.

``merge_compact`` launches the hand-written kernel
(``csrc/merge_compact.cu``) on CUDA tensors and runs the plain PyTorch
version, ``merge_compact_torch``, on CPU tensors.

Contract (both): ``a`` holds W key columns (``embedded``: the count in
the last word's low ``ebits``) or W key columns + an int32 count column
(separate count), Na rows sorted ascending by the key words, sentinel
rows last; ``b`` holds W key columns, Nb rows sorted ascending
(``embedded``: every row carries |1, a count of one; separate count: the
unit counts are implicit).  Each is one (C, N) int32 tensor of u32 bit
patterns, one row per column.
Returns (keys (W, out_len), counts (out_len,), int32 [nd_exact,
nd_used]) with K2's contract: one record per live key in key order, the
summed count clamped, sentinel keys with count 0 after them; nd_used ==
nd_exact, and nd > out_len means the capacity overflowed (nothing is
written at or past ``out_len``).  Both runs ascend, so the TPU kernel's
bitwise-NOT-ed descending batch is not carried over.  The kernel merges
each tile in shared memory and compacts it there: the merged rows never
reach device memory, and a call allocates only the output, the verdict
and a few words of scratch per tile.
"""

from __future__ import annotations

import torch

from . import _build, cuda_compact
from .sortcount import lexsort


def _check_inputs(a, b, embedded, ebits, out_len):
    if a.dim() != 2 or b.dim() != 2 or a.dtype != torch.int32 or b.dtype != torch.int32:
        raise ValueError("a and b must be (C, N) int32 tensors")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    W = b.shape[0]
    if W < 1:
        raise ValueError("b needs at least one key column")
    if a.shape[0] != W + (0 if embedded else 1):
        raise ValueError(f"a must have {W if embedded else W + 1} columns, has {a.shape[0]}")
    if embedded and not 1 <= ebits <= 31:
        raise ValueError("the embedded layout needs 1 <= ebits <= 31")
    if not embedded and ebits:
        raise ValueError("the separate-count layout takes ebits=0")
    n = a.shape[1] + b.shape[1]
    out_len = n if out_len is None else int(out_len)
    if out_len < 0:
        raise ValueError("out_len must be >= 0")
    return W, out_len


def merge_compact(a, b, *, embedded: bool, ebits: int = 0, out_len: "int | None" = None):
    """Merge two sorted runs and compact them (see the module docstring)."""
    W, out_len = _check_inputs(a, b, embedded, ebits, out_len)
    if a.device.type == "cpu":
        return merge_compact_torch(a, b, embedded=embedded, ebits=ebits, out_len=out_len)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.empty((W + 1, out_len), dtype=torch.int32, device=a.device)
    return launch_merge(a, b, out, out_len, embedded=embedded, ebits=ebits)


merge_compact.launches = 0


def launch_merge(a, b, out: torch.Tensor, out_len: int, *, embedded: bool, ebits: int = 0):
    """Launch K4 into ``out`` ((W+1, ld) int32 on the card, ld >= out_len):
    rows [0, out_len) of every column are written, columns past
    ``out_len`` are not touched.  Returns (keys, counts, nd) as
    ``merge_compact`` does."""
    W, out_len = _check_inputs(a, b, embedded, ebits, out_len)
    if (out.dtype != torch.int32 or out.dim() != 2 or out.shape[0] != W + 1
            or out.shape[1] < out_len or out.stride(1) != 1 or out.device != a.device):
        raise ValueError("out must be an int32 (W+1, >= out_len) row-major tensor "
                         "on the runs' device")
    a = a if a.stride(1) == 1 else a.contiguous()
    b = b if b.stride(1) == 1 else b.contiguous()
    dev = a.device
    na, nb = a.shape[1], b.shape[1]
    with torch.cuda.device(dev):
        lib = _build.lib()
        scratch = torch.empty(lib.kt_merge_compact_scratch(na, nb, W), dtype=torch.int64,
                              device=dev)
        nd = torch.empty(2, dtype=torch.int32, device=dev)
        err = lib.kt_merge_compact(
            a.data_ptr(), a.stride(0), na, None if embedded else a[W].data_ptr(),
            b.data_ptr(), b.stride(0), nb, W, ebits if embedded else 0,
            out.data_ptr(), out.stride(0), out_len, scratch.data_ptr(), nd.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_merge_compact")
    merge_compact.launches += 1
    return out[:W, :out_len], out[W, :out_len], nd


def merge_compact_torch(a, b, *, embedded: bool, ebits: int = 0,
                        out_len: "int | None" = None):
    """Plain PyTorch version of ``merge_compact``: concatenate, ``lexsort``
    (stable, so A's rows precede B's equal rows, as in the merge), then
    the plain K2."""
    W, out_len = _check_inputs(a, b, embedded, ebits, out_len)
    cols = [torch.cat([a[w], b[w]]) for w in range(W)]
    if embedded:
        s = lexsort(cols, num_keys=W)
        return cuda_compact.segsum_compact_torch(s, None, ebits=ebits, out_len=out_len)
    ones = torch.ones(b.shape[1], dtype=torch.int32, device=b.device)
    s = lexsort(cols + [torch.cat([a[W], ones])], num_keys=W)
    return cuda_compact.segsum_compact_torch(s[:W], s[W].contiguous(), out_len=out_len)
