"""K1 and K5: super-k-mer run segmentation — the counterparts of
``kaarme_tpu/ops/pallas_skm.py::run_rows_dense_pallas`` (K1, dense run
rows) and ``run_rows_slotted_pallas`` (K5, slotted run rows).

``run_rows_dense`` and ``run_rows_slotted`` launch the hand-written
kernels (``csrc/skm_dense.cu`` and ``csrc/skm_slotted.cu``, both on the
one-pass segmentation ``csrc/skm_seg.cuh``) on CUDA tensors and run the
plain PyTorch versions, ``run_rows_dense_plain`` and
``run_rows_slotted_plain``, on CPU tensors.  Both read the transfer
chunk; their plain versions unpack it (``codes_from_chunk``) and call
the definitions from codes, ``run_rows_dense_torch`` and
``run_rows_slotted_torch`` (which share ``_segment``).

Dense contract (K1): the transfer chunk of an n-window superstep —
``packed`` int32 [>= ceil(L / 16)] 2-bit bases (base i at bits 2*(i%16)
of word i/16) and ``sep``, the invalid positions as an int32
[>= ceil(L / 32)] bitmap (bit i%32 of word i/32), L = n + k - 1;
positions at or past L are invalid whatever the chunk holds — to (Wc + 1
int32 columns of ``cap`` rows: the span-masked content words and the
meta word (ell-1) << 26 | 1 of every live run start, in stream order,
then sentinels; int32 [rows_exact, rows_used]).  Its definition is
``run_rows_dense_torch(codes_from_chunk(packed, sep, ...))``, whose codes
are int32 [L] (bits 0-1 base, bit 2 invalid).  rows_used == rows_exact;
rows_used > cap means the capacity overflowed: the first ``cap`` rows
are written, nothing past them, and the caller replays larger.

Slotted contract (K5): the chunk as K1 takes it (its definition,
``run_rows_slotted_torch``, takes codes as ``run_rows_dense_torch``
does) and the same run rows, laid out by slot tile: the windows fall
into tiles of 512 numbered from the first window, and slot s of tile t
(row t*S + s) holds the row of the tile's (s+1)-th run start.  Every start counts, dead (invalid) ones too, and a dead
start's row is all-ones; slots past the tile's start count are all-ones
and starts past S are dropped.  Returns (Wc + 1 int32 columns of
ceil(n / 512) * S rows, int32 max_tile_runs); max_tile_runs > S means
rows were dropped and the caller replays with a larger S.  Where n is a
multiple of 512 this is the reference's ``run_rows`` + ``pack_slots``
bit for bit.  Any n >= 1 is taken: the last tile is then partial, and
no window at or past n is a start (the reference instead pads the tail
superstep with invalid windows up to whole tiles, which adds one dead
start to its last tile; the live rows are the same).
"""

from __future__ import annotations

import torch

from . import _build
from .sortcount import codes_from_chunk, i32

M = 16          # minimizer m-mer length (one word)
LMAX = 16       # run length cap (windows)
EBITS = 26      # meta layout: (ell-1) << 26 | count
SLOT_TILE = 512 # windows per slot tile (K5)


def content_words(k: int) -> int:
    """Wc: words covering a maximal run's LMAX + k - 1 bases."""
    return (LMAX + k - 1 + 15) // 16


def slot_rows(n: int, S: int) -> int:
    """K5's output rows for an n-window stream: S per slot tile."""
    return -(-n // SLOT_TILE) * S


def _check_inputs(codes, k, n, cap):
    if k < M:
        raise ValueError(f"skm segmentation requires k >= {M}")
    if codes.dim() != 1 or codes.dtype != torch.int32:
        raise ValueError("codes must be a 1-D int32 tensor")
    if n < 1 or codes.shape[0] < n + k - 1:
        raise ValueError(f"codes must hold n + k - 1 = {n + k - 1} positions")
    if cap < 0:
        raise ValueError("cap must be >= 0")


def _check_chunk(packed, sep, k, n, cap):
    if k < M:
        raise ValueError(f"skm segmentation requires k >= {M}")
    for name, t in (("packed", packed), ("sep", sep)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if packed.device != sep.device:
        raise ValueError("packed and sep must be on one device")
    L = n + k - 1
    if n < 1 or packed.shape[0] * 16 < L:
        raise ValueError(f"packed must hold n + k - 1 = {L} bases")
    if sep.shape[0] * 32 < L:
        raise ValueError(f"the separator bitmap must cover n + k - 1 = {L} positions")
    if cap < 0:
        raise ValueError("cap must be >= 0")


def run_rows_dense(packed: torch.Tensor, sep: torch.Tensor, *, k: int, n: int, cap: int):
    """Dense run rows of an n-window stream straight from its transfer
    chunk (see the module docstring)."""
    _check_chunk(packed, sep, k, n, cap)
    if packed.device.type == "cpu":
        return run_rows_dense_plain(packed, sep, k=k, n=n, cap=cap)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    out = torch.empty((content_words(k) + 1, cap), dtype=torch.int32, device=packed.device)
    return launch_dense(packed, sep, k, n, out, cap)


def launch_dense(packed: torch.Tensor, sep: torch.Tensor, k: int, n: int, out: torch.Tensor,
                 cap: int):
    """Launch K1 into ``out`` ((Wc+1, ld) int32 on the card, ld >= cap):
    rows [0, cap) of every column are written, columns past ``cap`` are
    not touched.  Returns (the Wc+1 columns [:cap], rows)."""
    _check_chunk(packed, sep, k, n, cap)
    if (out.dtype != torch.int32 or out.dim() != 2
            or out.shape[0] != content_words(k) + 1 or out.shape[1] < cap
            or out.stride(1) != 1 or out.device != packed.device):
        raise ValueError("out must be an int32 (Wc+1, >= cap) row-major tensor "
                         "on the chunk's device")
    packed, sep = packed.contiguous(), sep.contiguous()
    dev = packed.device
    with torch.cuda.device(dev):
        lib = _build.lib()
        scratch = torch.empty(lib.kt_skm_dense_scratch(n), dtype=torch.int64, device=dev)
        rows = torch.empty(2, dtype=torch.int32, device=dev)
        err = lib.kt_skm_dense(
            packed.data_ptr(), packed.shape[0], sep.data_ptr(), sep.shape[0], n, k,
            out.data_ptr(), cap, out.stride(0), scratch.data_ptr(), rows.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_skm_dense")
    run_rows_dense.launches += 1
    return tuple(out[:, :cap].unbind(0)), rows


run_rows_dense.launches = 0


def run_rows_dense_plain(packed: torch.Tensor, sep: torch.Tensor, *, k: int, n: int, cap: int):
    """Plain PyTorch version of ``run_rows_dense``: the function's
    definition, ``codes_from_chunk`` then ``run_rows_dense_torch``."""
    _check_chunk(packed, sep, k, n, cap)
    return run_rows_dense_torch(codes_from_chunk(packed, sep, k=k, n=n), k=k, n=n, cap=cap)


def _sliding_min(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[i] = min(x[i .. i+w-1]) by log-shift; len(y) = len(x) - w + 1."""
    y, s = x, 1
    while s < w:
        step = min(s, w - s)
        y = torch.minimum(y[:-step], y[step:])
        s += step
    return y


def _segment(codes: torch.Tensor, k: int, n: int):
    """The reference's ``skm.segment_runs`` over windows 0 .. n + LMAX
    (windows at or past n are starts: the stream end closes every run).
    Returns (b, ell, valid, raw): bool run starts, int64 run length at
    windows 0 .. n-1, bool validity, and int64 16-base m-words at every
    position the content words read."""
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
    return b, ell, valid, raw


def _live_rows(raw, ell, sel, k: int) -> torch.Tensor:
    """(Wc + 1, len(sel)) int32 run rows of the live starts ``sel``: the
    span-masked content words, then the meta word (ell-1) << 26 | 1."""
    Wc = content_words(k)
    e = ell[sel]
    span = e + (k - 1)
    out = torch.empty((Wc + 1, sel.numel()), dtype=torch.int32, device=raw.device)
    for j in range(Wc):
        sh = 32 - 2 * (span - 16 * j).clamp(0, 16)      # keep the top 2*nb bits
        mask = (torch.full_like(sh, 0xFFFFFFFF) >> sh) << sh
        out[j] = i32(raw[sel + 16 * j] & mask)
    out[Wc] = i32(((e - 1) << EBITS) | 1)
    return out


def run_rows_dense_torch(codes: torch.Tensor, *, k: int, n: int, cap: int):
    """Plain PyTorch version of ``run_rows_dense`` (``skm.segment_runs`` +
    ``run_rows`` of the reference, span-masked as the Pallas kernel does,
    plus a stable live-row compaction in stream order)."""
    _check_inputs(codes, k, n, cap)
    b, ell, valid, raw = _segment(codes, k, n)
    starts = torch.nonzero((b & valid)[:n]).flatten()
    rows_exact = int(starts.numel())
    sel = starts[:cap]
    out = torch.full((content_words(k) + 1, cap), -1, dtype=torch.int32, device=codes.device)
    out[:, : sel.numel()] = _live_rows(raw, ell, sel, k)
    rows = torch.tensor([rows_exact, rows_exact], dtype=torch.int32, device=codes.device)
    return tuple(out.unbind(0)), rows


def _check_slots(S: int):
    if not 1 <= S <= SLOT_TILE:
        raise ValueError(f"S must be in [1, {SLOT_TILE}], got {S}")


def run_rows_slotted(packed: torch.Tensor, sep: torch.Tensor, *, k: int, n: int, S: int):
    """Slotted run rows of an n-window stream straight from its transfer
    chunk (see the module docstring)."""
    _check_chunk(packed, sep, k, n, 0)
    _check_slots(S)
    if packed.device.type == "cpu":
        return run_rows_slotted_plain(packed, sep, k=k, n=n, S=S)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    packed, sep = packed.contiguous(), sep.contiguous()
    dev = packed.device
    R = slot_rows(n, S)
    with torch.cuda.device(dev):
        lib = _build.lib()
        out = torch.empty((content_words(k) + 1, R), dtype=torch.int32, device=dev)
        scratch = torch.empty(lib.kt_skm_slotted_scratch(n), dtype=torch.int64, device=dev)
        maxruns = torch.empty(1, dtype=torch.int32, device=dev)
        err = lib.kt_skm_slotted(
            packed.data_ptr(), packed.shape[0], sep.data_ptr(), sep.shape[0], n, k,
            S, out.data_ptr(), out.stride(0), scratch.data_ptr(), maxruns.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_skm_slotted")
    run_rows_slotted.launches += 1
    return tuple(out.unbind(0)), maxruns[0]


run_rows_slotted.launches = 0


def run_rows_slotted_plain(packed: torch.Tensor, sep: torch.Tensor, *, k: int, n: int, S: int):
    """Plain PyTorch version of ``run_rows_slotted``: the function's
    definition, ``codes_from_chunk`` then ``run_rows_slotted_torch``."""
    _check_chunk(packed, sep, k, n, 0)
    return run_rows_slotted_torch(codes_from_chunk(packed, sep, k=k, n=n), k=k, n=n, S=S)


def run_rows_slotted_torch(codes: torch.Tensor, *, k: int, n: int, S: int):
    """``run_rows_slotted``'s definition, from codes: the segmentation of
    ``run_rows_dense_torch``, each start's ordinal in its tile by a
    cumulative sum, and a scatter of the kept start rows into their
    slots (the reference's ``pack_slots`` semantics, without its one-hot
    matrix product)."""
    _check_inputs(codes, k, n, 0)
    _check_slots(S)
    dev = codes.device
    b, ell, valid, raw = _segment(codes, k, n)
    starts = b[:n]
    tile = torch.arange(n, device=dev) // SLOT_TILE
    before = torch.cumsum(starts, 0) - starts.to(torch.int64)     # starts before each window
    slot = before - before[::SLOT_TILE][tile]
    runs = torch.bincount(tile[starts], minlength=-(-n // SLOT_TILE))
    out = torch.full((content_words(k) + 1, slot_rows(n, S)), -1, dtype=torch.int32,
                     device=dev)
    sel = torch.nonzero(starts & valid[:n] & (slot < S)).flatten()
    out[:, tile[sel] * S + slot[sel]] = _live_rows(raw, ell, sel, k)
    return tuple(out.unbind(0)), runs.max().to(torch.int32)
