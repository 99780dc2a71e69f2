"""K3: canonical window keys — the counterpart of
``kaarme_tpu/ops/pallas_winkeys.py::window_keys_pallas``.

``window_keys`` launches the hand-written kernel (``csrc/winkeys.cu``)
on CUDA tensors and runs the plain PyTorch version,
``window_keys_plain``, on CPU tensors.  The kernel reads the transfer
chunk; its plain version unpacks it (``sortcount.codes_from_chunk``) and
calls the definition from codes, ``window_keys_torch``.

Chunk contract (``window_keys`` and ``window_keys_plain``): the transfer
chunk of an n-window superstep — ``packed`` int32 [>= ceil(L / 16)]
2-bit bases (base i at bits 2*(i%16) of word i/16) and ``sep``, the
invalid positions as an int32 [>= ceil(L / 32)] bitmap (bit i%32 of
word i/32), L = n + k - 1; positions at or past L are invalid whatever
the chunk holds.

Codes contract (``window_keys_torch``): codes int32 [L >= n + k - 1]
(bits 0-1 the base, any higher bit marks the position invalid, as
``sortcount.unpack_codes`` makes them).

Both give W = ceil(k / 16) int32 columns of n rows holding u32 bit
patterns: the big-endian 2-bit canonical key of every window (the
lexicographic min of the forward and reverse-complement words, ties to
forward; the trailing word left-aligned with zero low bits), all-ones in
every word where any of the window's k positions is invalid.  Any n >= 0
and k >= 2.
"""

from __future__ import annotations

import torch

from ..utils.codec import words_per_kmer
from . import _build, sortcount
from .sortcount import M32, i32


def _check_inputs(codes, k, n):
    if k < 2:
        raise ValueError("k must be >= 2")
    if codes.dim() != 1 or codes.dtype != torch.int32:
        raise ValueError("codes must be a 1-D int32 tensor")
    if n < 0 or codes.shape[0] < n + k - 1:
        raise ValueError(f"codes must hold n + k - 1 = {n + k - 1} positions")


def _check_chunk(packed, sep, k, n):
    if k < 2:
        raise ValueError("k must be >= 2")
    for name, t in (("packed", packed), ("sep", sep)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if packed.device != sep.device:
        raise ValueError("packed and sep must be on one device")
    L = n + k - 1
    if n < 0 or packed.shape[0] * 16 < L:
        raise ValueError(f"packed must hold n + k - 1 = {L} bases")
    if sep.shape[0] * 32 < L:
        raise ValueError(f"the separator bitmap must cover n + k - 1 = {L} positions")


def window_keys(packed: torch.Tensor, sep: torch.Tensor, *, k: int, n: int) -> tuple:
    """Canonical window keys of an n-window superstep straight from its
    transfer chunk (see the module docstring)."""
    _check_chunk(packed, sep, k, n)
    if packed.device.type == "cpu":
        return window_keys_plain(packed, sep, k=k, n=n)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    packed, sep = packed.contiguous(), sep.contiguous()
    dev = packed.device
    with torch.cuda.device(dev):
        lib = _build.lib()
        out = torch.empty((words_per_kmer(k), n), dtype=torch.int32, device=dev)
        err = lib.kt_window_keys(
            packed.data_ptr(), packed.shape[0], sep.data_ptr(), sep.shape[0], n, k,
            out.data_ptr(), out.stride(0), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "kt_window_keys")
    window_keys.launches += 1
    return tuple(out.unbind(0))


window_keys.launches = 0


def window_keys_plain(packed: torch.Tensor, sep: torch.Tensor, *, k: int, n: int) -> tuple:
    """Plain PyTorch version of ``window_keys``: the function's
    definition, ``codes_from_chunk`` then ``window_keys_torch``."""
    _check_chunk(packed, sep, k, n)
    return window_keys_torch(sortcount.codes_from_chunk(packed, sep, k=k, n=n), k, n)


def window_keys_torch(codes: torch.Tensor, k: int, n: int) -> tuple:
    """``window_keys``' definition, from codes: the reference's
    ``sortcount.window_keys_from_codes`` plus its sentinel mask."""
    _check_inputs(codes, k, n)
    dev = codes.device
    c = codes[: n + k - 1].to(torch.int64) & M32
    base = c & 3
    fwd, rcw = [], []
    for w in range(words_per_kmer(k)):
        f = torch.zeros(n, dtype=torch.int64, device=dev)
        r = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in range(min(16, k - 16 * w)):
            i, sh = 16 * w + j, 2 * (15 - j)
            f |= base[i: i + n] << sh
            r |= (base[k - 1 - i: k - 1 - i + n] ^ 3) << sh
        fwd.append(f)
        rcw.append(r)
    carry = torch.zeros(n, dtype=torch.int64, device=dev)
    for f, r in zip(reversed(fwd), reversed(rcw)):
        carry = torch.where(f < r, -1, torch.where(f > r, 1, carry))
    inv = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum((c >> 2) != 0, 0)])
    smask = torch.where(inv[k: k + n] > inv[:n], M32, 0)
    return tuple(i32(torch.where(carry <= 0, f, r) | smask) for f, r in zip(fwd, rcw))
