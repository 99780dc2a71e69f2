"""Host-side 2-bit stream packing for device transfer.

The native path calls the JAX package's C++ library
(``kaarme_tpu.io.fastio.get_lib``, which pulls in no JAX); when that
library cannot be built, ``pack_stream_np`` packs in NumPy with the same
bits as ``kaarme_tpu.ops.sortcount.pack_stream_np``.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from kaarme_tpu.io.fastio import get_lib


def pack_stream_np(codes: np.ndarray):
    """Pack a {0..4} code stream: 16 bases per uint32 word (base i at bits
    2*(i%16) of word i//16) plus a bitmap with bit i%32 of word i//32 set
    where position i is invalid (code >= 4).  Invalid positions carry
    base 0.  Returns (packed uint32, maskwords uint32)."""
    codes = np.asarray(codes, np.uint8)
    n = codes.shape[0]
    bad = codes >= 4
    c = np.where(bad, np.uint8(0), codes).astype(np.uint32)
    c = np.concatenate([c, np.zeros((-n) % 16, np.uint32)])
    shifts = np.arange(16, dtype=np.uint32) * np.uint32(2)
    packed = np.bitwise_or.reduce(c.reshape(-1, 16) << shifts[None, :], axis=1)
    b = np.concatenate([bad.astype(np.uint32), np.zeros((-n) % 32, np.uint32)])
    bshifts = np.arange(32, dtype=np.uint32)
    mask = np.bitwise_or.reduce(b.reshape(-1, 32) << bshifts[None, :], axis=1)
    return packed.astype(np.uint32), mask.astype(np.uint32)


def pack_stream(codes: np.ndarray, threads: int = 0):
    """Same result as ``pack_stream_np``; the native library packs slices
    of 32-code-aligned spans on ``threads`` threads (0 = one per 2M codes,
    at most one per core; ctypes releases the GIL)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lib = get_lib()
    if lib is None:
        return pack_stream_np(codes)
    n = codes.shape[0]
    packed = np.empty((n + 15) // 16, np.uint32)
    mask = np.empty((n + 31) // 32, np.uint32)
    if not n:
        return packed, mask
    u8p, u32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)
    nt = threads or min(os.cpu_count() or 1, max(1, n // (1 << 21)))
    step = ((n // nt) // 32) * 32
    if nt <= 1 or step == 0:
        lib.kt_pack_codes(codes.ctypes.data_as(u8p), n,
                          packed.ctypes.data_as(u32p), mask.ctypes.data_as(u32p))
        return packed, mask

    def work(t):
        lo = t * step
        hi = n if t == nt - 1 else (t + 1) * step
        lib.kt_pack_codes(
            ctypes.cast(codes.ctypes.data + lo, u8p), hi - lo,
            ctypes.cast(packed.ctypes.data + (lo // 16) * 4, u32p),
            ctypes.cast(mask.ctypes.data + (lo // 32) * 4, u32p))

    with ThreadPoolExecutor(max_workers=nt) as pool:
        list(pool.map(work, range(nt)))
    return packed, mask
