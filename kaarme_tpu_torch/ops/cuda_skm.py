"""K1: dense super-k-mer run segmentation — the counterpart of
``kaarme_tpu/ops/pallas_skm.py::run_rows_dense_pallas``.

``run_rows_dense`` launches the hand-written kernel
(``csrc/skm_dense.cu``) on CUDA tensors and runs the plain PyTorch
version, ``run_rows_dense_torch``, on CPU tensors.

Contract (both): codes int32 [L >= n + k - 1] (bits 0-1 base, bit 2
invalid; positions past L read as invalid) -> (Wc + 1 int32 columns of
``cap`` rows: the span-masked content words and the meta word
(ell-1) << 26 | 1 of every live run start, in stream order, then
sentinels; int32 [rows_exact, rows_used]).  rows_used == rows_exact;
rows_used > cap means the capacity overflowed: the first ``cap`` rows
are written, nothing past them, and the caller replays larger.
"""

from __future__ import annotations

import torch

from . import _build
from .sortcount import i32

M = 16          # minimizer m-mer length (one word)
LMAX = 16       # run length cap (windows)
EBITS = 26      # meta layout: (ell-1) << 26 | count
_TILE = 1024    # windows per block of the kernel (skm_dense.cu)


def content_words(k: int) -> int:
    """Wc: words covering a maximal run's LMAX + k - 1 bases."""
    return (LMAX + k - 1 + 15) // 16


def _check_inputs(codes, k, n, cap):
    if k < M:
        raise ValueError(f"skm segmentation requires k >= {M}")
    if codes.dim() != 1 or codes.dtype != torch.int32:
        raise ValueError("codes must be a 1-D int32 tensor")
    if n < 1 or codes.shape[0] < n + k - 1:
        raise ValueError(f"codes must hold n + k - 1 = {n + k - 1} positions")
    if cap < 0:
        raise ValueError("cap must be >= 0")


def run_rows_dense(codes: torch.Tensor, *, k: int, n: int, cap: int):
    """Dense run rows of an n-window stream (see the module docstring)."""
    _check_inputs(codes, k, n, cap)
    if codes.device.type == "cpu":
        return run_rows_dense_torch(codes, k=k, n=n, cap=cap)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    out = torch.empty((content_words(k) + 1, cap), dtype=torch.int32,
                      device=codes.device)
    return launch_dense(codes, k, n, out, cap)


def launch_dense(codes: torch.Tensor, k: int, n: int, out: torch.Tensor, cap: int):
    """Launch K1 into ``out`` ((Wc+1, ld) int32 on the card, ld >= cap):
    rows [0, cap) of every column are written, columns past ``cap`` are
    not touched.  Returns (the Wc+1 columns [:cap], rows)."""
    _check_inputs(codes, k, n, cap)
    if (out.dtype != torch.int32 or out.dim() != 2
            or out.shape[0] != content_words(k) + 1 or out.shape[1] < cap
            or out.stride(1) != 1 or out.device != codes.device):
        raise ValueError("out must be an int32 (Wc+1, >= cap) row-major tensor "
                         "on the codes' device")
    codes = codes.contiguous()
    dev = codes.device
    with torch.cuda.device(dev):
        nt = -(-n // _TILE)
        scratch = torch.empty(2 * nt + 1, dtype=torch.int64, device=dev)
        rows = torch.empty(2, dtype=torch.int32, device=dev)
        err = _build.lib().kt_skm_dense(
            codes.data_ptr(), codes.shape[0], n, k, out.data_ptr(), cap,
            out.stride(0), scratch.data_ptr(), rows.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_skm_dense")
    run_rows_dense.launches += 1
    return tuple(out[:, :cap].unbind(0)), rows


run_rows_dense.launches = 0


def _sliding_min(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[i] = min(x[i .. i+w-1]) by log-shift; len(y) = len(x) - w + 1."""
    y, s = x, 1
    while s < w:
        step = min(s, w - s)
        y = torch.minimum(y[:-step], y[step:])
        s += step
    return y


def run_rows_dense_torch(codes: torch.Tensor, *, k: int, n: int, cap: int):
    """Plain PyTorch version of ``run_rows_dense`` (``skm.segment_runs`` +
    ``run_rows`` of the reference, span-masked as the Pallas kernel does,
    plus a stable live-row compaction in stream order)."""
    _check_inputs(codes, k, n, cap)
    dev = codes.device
    Wc = content_words(k)
    w = k - M + 1
    nwin = n + LMAX + 1                      # windows 0 .. n + LMAX
    n_raw = nwin + max(w, 16 * Wc)           # m-words needed
    ext = max(n_raw + 15, nwin + k)          # positions needed
    c = torch.full((ext,), 4, dtype=torch.int64, device=dev)
    m = min(ext, codes.shape[0])
    c[:m] = codes[:m].to(torch.int64) & 7
    base, inv = c & 3, (c >> 2) & 1

    raw = torch.zeros(n_raw, dtype=torch.int64, device=dev)
    for j in range(M):
        raw = (raw << 2) | base[j: j + n_raw]
    cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(inv, 0)])
    valid = (cs[k: k + nwin] - cs[:nwin]) == 0
    minv = _sliding_min(raw[: nwin + w - 1], w)
    minv = torch.where(valid, minv, 0xFFFFFFFF)

    idx = torch.arange(nwin, dtype=torch.int64, device=dev)
    true_b = (idx == 0) | (minv != minv.roll(1)) | (valid != valid.roll(1))
    lts = torch.cummax(torch.where(true_b, idx, 0), 0).values
    pos1 = idx - lts
    b = true_b | (valid & (pos1 > 0) & ((pos1 & (LMAX - 1)) == 0)) | (idx >= n)
    cand = torch.where(b, idx, 1 << 40)
    nxt = torch.cummin(cand.flip(0), 0).values.flip(0)     # first start >= i
    ell = (nxt[1: n + 1] - idx[:n]).clamp(1, LMAX)         # first start > i

    starts = torch.nonzero((b & valid)[:n]).flatten()
    rows_exact = int(starts.numel())
    sel = starts[:cap]
    e = ell[sel]
    span = e + (k - 1)
    out = torch.full((Wc + 1, cap), -1, dtype=torch.int32, device=dev)
    for j in range(Wc):
        sh = 32 - 2 * (span - 16 * j).clamp(0, 16)      # keep the top 2*nb bits
        mask = (torch.full_like(sh, 0xFFFFFFFF) >> sh) << sh
        out[j, : sel.numel()] = i32(raw[sel + 16 * j] & mask)
    out[Wc, : sel.numel()] = i32(((e - 1) << EBITS) | 1)
    rows = torch.tensor([rows_exact, rows_exact], dtype=torch.int32, device=dev)
    return tuple(out.unbind(0)), rows
