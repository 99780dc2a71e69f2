"""Host-side encoding and 2-bit stream packing, with a NumPy fallback
(the port's copy of ``kaarme_tpu/io/fastio.py``).

The native piece of the host input runtime — the counterpart of the
reference's C++ byte-level parsing loops (reference:
include/parallel_parser.hpp hash_kmers character handling,
source/functions_strings.cpp:56-70 char2int) — is the port's own
``csrc/host/_fastio.cpp``.  g++ compiles it at first use into
``build/kaarme_tpu_torch/``, named by a hash of the source, as
``ops/_build.py`` names the kernel library.  Where g++ is missing or
fails, the NumPy encoders in ``utils.codec`` and ``pack_stream_np`` take
over: same bytes, tested for equality.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops._build import BUILD_DIR
from ..utils import codec

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "host", "_fastio.cpp")
_GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def lib_path() -> str:
    """Where the native encoder is built: a hash of its source and flags."""
    h = hashlib.sha256(" ".join(_GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkaarme_fastio_{h.hexdigest()[:16]}.so")


def _build_and_load():
    so = lib_path()
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so[:-3]}.{os.getpid()}.tmp.so"
        subprocess.run(["g++", *_GXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.kt_encode_plain.argtypes = [u8p, ctypes.c_size_t, u8p]
    lib.kt_encode_plain.restype = None
    lib.kt_encode_fasta.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.POINTER(ctypes.c_int)]
    lib.kt_encode_fasta.restype = ctypes.c_size_t
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.kt_pack_codes.argtypes = [u8p, ctypes.c_size_t, u32p, u32p]
    lib.kt_pack_codes.restype = None
    lib.kt_encode_fastq.argtypes = [
        u8p, ctypes.c_size_t, u8p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.kt_encode_fastq.restype = ctypes.c_size_t
    return lib


def get_lib():
    """The native library, or None if it cannot be built."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _TRIED:
            try:
                _LIB = _build_and_load()
            except Exception:
                _LIB = None
            _TRIED = True
    return _LIB


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_plain(buf) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return codec.encode_plain(buf)
    a = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    out = np.empty(a.shape[0], np.uint8)
    if a.shape[0]:
        lib.kt_encode_plain(_u8ptr(np.ascontiguousarray(a)), a.shape[0], _u8ptr(out))
    return out


def encode_fasta(buf, prev_in_header: bool = False):
    lib = get_lib()
    if lib is None:
        return codec.encode_fasta(buf, prev_in_header)
    a = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    out = np.empty(a.shape[0], np.uint8)
    state = ctypes.c_int(1 if prev_in_header else 0)
    n = 0
    if a.shape[0]:
        n = lib.kt_encode_fasta(
            _u8ptr(np.ascontiguousarray(a)), a.shape[0], _u8ptr(out), ctypes.byref(state)
        )
    return out[:n], bool(state.value)


def encode_fastq(buf, state=None):
    """FASTQ chunk -> codes; ``state`` carries the parser across chunks."""
    if state is None:
        state = codec.FASTQ_STATE0
    lib = get_lib()
    if lib is None:
        return codec.encode_fastq(buf, state)
    a = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    out = np.empty(a.shape[0] + 1, np.uint8)
    st = ctypes.c_int(state[0])
    sl = ctypes.c_longlong(state[1])
    ql = ctypes.c_longlong(state[2])
    n = 0
    if a.shape[0]:
        n = lib.kt_encode_fastq(
            _u8ptr(np.ascontiguousarray(a)), a.shape[0], _u8ptr(out),
            ctypes.byref(st), ctypes.byref(sl), ctypes.byref(ql),
        )
    return out[:n], (st.value, sl.value, ql.value)


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
