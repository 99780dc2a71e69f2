"""E1: the skm finalize's expansion of distinct run rows into canonical
k-mer keys — the counterpart of the part of
``kaarme_tpu/ops/skm.py::expand_chunk`` in front of its Bloom gate
(``_expand_keys``, the dead-run mask and the count column: jnp that XLA
fuses into one loop, not a Pallas kernel).

``expand_runs`` launches the hand-written kernel (``csrc/expand_runs.cu``)
on CUDA tensors and runs the plain PyTorch version,
``skm.expand_runs_plain``, on CPU tensors.

Contract (both versions): ``run_cols`` is Wc + 2 int32 columns of R rows
on one device — the Wc = ``cuda_skm.content_words(k)`` content words,
the meta word and the count of each run, a run store's layout — and
k >= 16.  Returns W = ceil(k / 16) int32 key columns and the int32 count
column over R * LMAX rows: row r * LMAX + e is window e of run r, its
big-endian 2-bit canonical key (min of the forward and reverse-complement
words, most significant word first, ties to forward; the trailing word
left-aligned with zero low bits) and the run's count; all-ones keys with
count 0 where e >= ell or the run's count is <= 0.  On the card the key
columns are views of one buffer (B2 gates them in place); the call
allocates that buffer, and a stacked copy of run columns that are not
views of one buffer at one spacing (``cuda_table._key_columns``), and
makes no host synchronisation.
"""

from __future__ import annotations

import torch

from ..utils import trace
from ..utils.codec import words_per_kmer
from . import _build
from .cuda_skm import LMAX, content_words
from .cuda_table import _key_columns


def _check(run_cols, k: int):
    if k < 16:
        raise ValueError("the skm expansion needs k >= 16")
    want = content_words(k) + 2
    if len(run_cols) != want:
        raise ValueError(f"k={k} takes {want} run columns (Wc content, meta, count), "
                         f"got {len(run_cols)}")
    c0 = run_cols[0]
    for c in run_cols:
        if c.dtype != torch.int32 or c.dim() != 1:
            raise ValueError("run columns must be 1-d int32 tensors")
        if c.shape != c0.shape:
            raise ValueError("run columns must have one length")
        if c.device != c0.device:
            raise ValueError("run columns must be on one device")
    return c0.device, c0.shape[0]


def expand_runs(run_cols, k: int) -> tuple:
    """Run rows -> (W key columns, count column) over R * LMAX rows (see
    the module docstring): E1 on the card, the plain version on the CPU."""
    dev, R = _check(run_cols, k)
    if dev.type == "cpu":
        from .skm import expand_runs_plain

        return expand_runs_plain(run_cols, k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    W = words_per_kmer(k)
    out = torch.empty((W + 1, R * LMAX), dtype=torch.int32, device=dev)
    if R:
        cbuf, lc, li = _key_columns(run_cols)
        with torch.cuda.device(dev):
            err = _build.lib().kt_expand_runs(cbuf.data_ptr(), lc, li, k, R, out.data_ptr(),
                                              out.stride(0),
                                              torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "kt_expand_runs")
        expand_runs.launches += 1
        trace.count("expand_launches")
    return tuple(out.unbind(0))


expand_runs.launches = 0
