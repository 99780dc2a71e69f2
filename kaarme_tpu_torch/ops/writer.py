"""W1: the count file's ``KMER COUNT`` lines, assembled where the dump
lies — the counterpart of the JAX package's host writers
(``kaarme_tpu/models/sort_counter.py::SortKmerCounter.write_output``
and its copies in ``models/counter.py`` and ``parallel/sharded_sort.py``),
which build the text in numpy and have no Pallas kernel.

``format_lines`` launches the hand-written kernel
(``csrc/format_lines.cu``) on CUDA tensors and runs the plain PyTorch
version, ``format_lines_plain``, on CPU tensors.  Contract (both): one
part of a dump — ``keys``, a sequence of W = ceil(k/16) int32 key
columns holding u32 bit patterns (the kernel reads columns that are
views of one buffer, a store's rows or a table's ``tk[:, w]``, where
they lie), and ``counts``, an int32 or int64 column, both before
filtering and clipping — gives the bytes ``write_output`` writes for
those rows, in row order: a row is live when its raw count is > 0; its
count is clipped (``c & 0xFFFF`` in mode 0, else ``min(c, 16383)``);
it is kept when the clipped count is >= ``min_abundance``; a kept row
writes its k bases ("ACGT"[(word[i // 16] >> (30 - 2 * (i % 16))) & 3]),
a space, the clipped count in decimal and ``\\n``.  Returns (the text as
a uint8 tensor on the part's device, the number of lines).

``write_lines`` writes a list of parts, in order, to one file: each part
is formatted on its own device, in row chunks whose text stays under a
byte budget, and each chunk goes to the file through one pinned host
buffer.  ``kernels="plain"`` runs the plain version everywhere.
"""

from __future__ import annotations

import torch

from ..utils import trace
from ..utils.codec import words_per_kmer
from . import _build
from .cuda_table import _key_columns
from .sortcount import check_kernels, u32

CHUNK_BYTES = 256 << 20    # text per chunk: bounds the device and pinned buffers
MAX_DIGITS = 5             # a clipped count is at most 65535
PLAIN_ROWS = 1 << 16       # rows per byte matrix of the plain version (bounds its memory)


def clip_max(mode: int) -> int:
    """The largest clipped count of ``mode`` (``CountOutput._clip``)."""
    return 0xFFFF if mode == 0 else 16383


def line_bytes(k: int) -> int:
    """The longest line: k bases, a space, MAX_DIGITS digits, a newline."""
    return k + 2 + MAX_DIGITS


def _check(keys, counts, k: int, mode: int) -> int:
    if len(str(clip_max(mode))) > MAX_DIGITS:
        raise AssertionError(f"mode {mode}: clipped counts need more than {MAX_DIGITS} digits")
    if counts.dim() != 1 or counts.dtype not in (torch.int32, torch.int64):
        raise ValueError("counts must be an int32 or int64 (N,) tensor")
    n = counts.shape[0]
    if len(keys) != words_per_kmer(k):
        raise ValueError(f"{len(keys)} key columns for k={k}")
    if any(c.shape != (n,) or c.dtype != torch.int32 or c.device != counts.device
           for c in keys):
        raise ValueError("keys must be int32 (N,) columns on the counts' device")
    return n


def format_lines(keys, counts: torch.Tensor, *, k: int, mode: int, min_abundance: int,
                 out: "torch.Tensor | None" = None):
    """One part's lines (module docstring); on a card into ``out`` (a
    uint8 buffer of at least N * ``line_bytes(k)`` bytes, allocated when
    None).  Returns (text, lines)."""
    n = _check(keys, counts, k, mode)
    if counts.device.type == "cpu":
        return format_lines_plain(keys, counts, k=k, mode=mode, min_abundance=min_abundance)
    if counts.device.type != "cuda":
        raise ValueError(f"unsupported device {counts.device}")
    dev = counts.device
    need = n * line_bytes(k)
    if out is None:
        out = torch.empty(need, dtype=torch.uint8, device=dev)
    elif (out.dtype != torch.uint8 or out.dim() != 1 or out.numel() < need
          or out.device != dev or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, 16-byte aligned uint8 tensor of >= {need} "
                         f"bytes on {dev}")
    if n == 0:
        return out[:0], 0
    kbuf, lw, li = _key_columns(keys)
    cnt = counts.contiguous()
    with torch.cuda.device(dev):
        lib = _build.lib()
        scratch = torch.empty(lib.kt_format_lines_scratch(n), dtype=torch.int64, device=dev)
        res = torch.empty(2, dtype=torch.int64, device=dev)
        err = lib.kt_format_lines(
            kbuf.data_ptr(), lw, li, cnt.data_ptr(), int(cnt.dtype == torch.int64), n, k, mode,
            min_abundance, out.data_ptr(), scratch.data_ptr(), res.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_format_lines")
        format_lines.launches += 1
        trace.count("host_syncs")
        nbytes, lines = res.tolist()
    return out[:nbytes], lines


format_lines.launches = 0


def format_lines_plain(keys, counts: torch.Tensor, *, k: int, mode: int, min_abundance: int):
    """Plain PyTorch version of ``format_lines``: the kept rows, PLAIN_ROWS
    at a time, as an (M, ``line_bytes(k)``) byte matrix (the count
    right-aligned in MAX_DIGITS cells), from which the mask that drops
    each row's unused leading digit cells selects the text.  Key words are
    carried as int64."""
    _check(keys, counts, k, mode)
    dev = counts.device
    c = counts.to(torch.int64)
    v = c & 0xFFFF if mode == 0 else c.clamp(max=clip_max(mode))
    rows = torch.nonzero((c > 0) & (v >= min_abundance)).flatten()
    m = rows.numel()
    if m == 0:
        return torch.empty(0, dtype=torch.uint8, device=dev), 0
    words = [u32(col.index_select(0, rows)) for col in keys]
    v = v.index_select(0, rows)
    return torch.cat([_line_matrix([w[r:r + PLAIN_ROWS] for w in words], v[r:r + PLAIN_ROWS], k)
                      for r in range(0, m, PLAIN_ROWS)]), m


def _line_matrix(words, v, k: int) -> torch.Tensor:
    """The lines of rows with key words ``words`` and clipped counts ``v``."""
    dev, L = v.device, line_bytes(k)
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    text = torch.empty((v.shape[0], L), dtype=torch.uint8, device=dev)
    for i in range(k):
        text[:, i] = acgt[(words[i // 16] >> (30 - 2 * (i % 16))) & 3]
    text[:, k] = ord(" ")
    v = v[:, None]
    pow10 = 10 ** torch.arange(MAX_DIGITS - 1, -1, -1, device=dev)      # 10^4 .. 1
    text[:, k + 1:k + 1 + MAX_DIGITS] = (ord("0") + v // pow10 % 10).to(torch.uint8)
    text[:, L - 1] = ord("\n")
    ndig = 1 + (v >= pow10[:-1]).sum(1, keepdim=True)
    cell = torch.arange(L, device=dev) - (k + 1)           # digit cell t = 0 .. MAX_DIGITS - 1
    lead = (cell >= 0) & (cell < MAX_DIGITS - ndig)
    return text[~lead]


def write_lines(path: str, parts, *, k: int, mode: int, min_abundance: int,
                kernels: str = "cuda", chunk_bytes: int = CHUNK_BYTES) -> int:
    """Write ``parts`` ((key columns, counts) on their devices) in order
    as ``KMER COUNT`` lines to ``path``, in row chunks of at most
    ``chunk_bytes`` of text; returns the lines written.  A chunk on a
    card is formatted under its device on its current stream, copied
    into one pinned host buffer and written from it."""
    check_kernels(kernels)
    rows = max(1, chunk_bytes // line_bytes(k))
    kw = dict(k=k, mode=mode, min_abundance=min_abundance)
    lines, host = 0, None
    with open(path, "wb") as f:
        for keys, counts in parts:
            n, dev = counts.shape[0], counts.device
            buf = text = None
            if kernels == "cuda" and dev.type == "cuda" and n:
                buf = torch.empty(min(n, rows) * line_bytes(k), dtype=torch.uint8, device=dev)
            for r0 in range(0, n, rows):
                chunk = ([c[r0:r0 + rows] for c in keys], counts[r0:r0 + rows])
                with trace.span("format"):
                    if buf is None:
                        text, m = format_lines_plain(*chunk, **kw)
                    else:
                        text, m = format_lines(*chunk, out=buf, **kw)
                lines += m
                nb = text.numel()
                if nb == 0:
                    continue
                if dev.type == "cpu":
                    with trace.span("file_write"):
                        f.write(memoryview(text.numpy()))
                    continue
                with trace.span("d2h"):
                    if host is None or host.numel() < nb:
                        host = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
                    with torch.cuda.device(dev):
                        host[:nb].copy_(text, non_blocking=True)
                        trace.count("host_syncs")
                        torch.cuda.current_stream(dev).synchronize()
                with trace.span("file_write"):
                    f.write(memoryview(host.numpy())[:nb])
    return lines
