"""Build and load the package's CUDA kernels (K1-K5, T1, W1, B1, B2, E1, P1) at first use.

``nvcc`` compiles every ``csrc/*.cu`` file into an object, one process
per file, all started together, and links them into ONE shared library
with a plain C interface (no PyTorch headers, so the build takes
seconds), loaded with ctypes.  The library lands in ``build/kaarme_tpu_torch/``
beside the package, named by a hash of the sources, so an edited
source is never served from a stale build.  Tensors are passed as
``data_ptr()`` integers and the stream as
``torch.cuda.current_stream().cuda_stream``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from ..utils import trace

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kaarme_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIB = None
# what the first build in this process reported (chip_smoke prints it)
BUILD_INFO = {"seconds": None, "log": "", "path": None}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    heads = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for p in srcs + heads:
        with open(p, "rb") as f:
            h.update(f.read())
    return srcs, h.hexdigest()[:16]


def _compile(out: str, srcs) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out[:-3]}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)[:-3]}.o" for src in srcs]
    with trace.span("kernel_build") as sp:
        try:
            procs = [subprocess.Popen([nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                                       "-Xcompiler", "-fPIC", "-c", "-o", obj, src],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(srcs, objs)]
            logs = [p.communicate()[0] for p in procs]
            BUILD_INFO["log"] = "".join(logs)
            bad = [(src, p.returncode, log) for src, p, log in zip(srcs, procs, logs)
                   if p.returncode]
            if bad:
                raise RuntimeError("nvcc failed:\n" + "\n".join(
                    f"{src} ({rc}):\n{log}" for src, rc, log in bad))
            tmp = f"{tag}.tmp.so"
            res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True)
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
    BUILD_INFO["seconds"] = sp.seconds
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)


def _bind(lib):
    lib.kt_skm_dense.argtypes = [_P, _I64, _P, _I64, _I32, _I64, _I32, _P, _I64, _I64, _P,
                                 _P, _P]
    lib.kt_skm_dense.restype = _I32
    lib.kt_skm_dense_scratch.argtypes = [_I64, _I64, _I32]
    lib.kt_skm_dense_scratch.restype = _I64
    lib.kt_skm_slotted.argtypes = [_P, _I64, _P, _I64, _I32, _I64, _I32, _I32, _P, _I64, _P,
                                   _P, _P]
    lib.kt_skm_slotted.restype = _I32
    lib.kt_skm_slotted_scratch.argtypes = [_I64, _I64, _I32]
    lib.kt_skm_slotted_scratch.restype = _I64
    lib.kt_segsum_compact.argtypes = [_P, _P, _I64, _I32, _I32, _I32, _P, _I64,
                                      _I64, _P, _P, _P]
    lib.kt_segsum_compact.restype = _I32
    lib.kt_segsum_compact_scratch.argtypes = [_I64]
    lib.kt_segsum_compact_scratch.restype = _I64
    lib.kt_window_keys.argtypes = [_P, _I64, _P, _I64, _I32, _I64, _I32, _P, _I64, _P, _P]
    lib.kt_window_keys.restype = _I32
    lib.kt_window_keys_scratch.argtypes = [_I64, _I32]
    lib.kt_window_keys_scratch.restype = _I64
    lib.kt_merge_compact.argtypes = [_P, _I64, _I64, _P, _P, _I64, _I64, _I32, _I32,
                                     _P, _I64, _I64, _P, _P, _P]
    lib.kt_merge_compact.restype = _I32
    lib.kt_merge_compact_scratch.argtypes = [_I64, _I64, _I32]
    lib.kt_merge_compact_scratch.restype = _I64
    lib.kt_table_insert.argtypes = [_P, _P, _I64, _I32, _P, _I64, _I64, _P, _P, _P, _I64, _I32,
                                    _P, _P, _P]
    lib.kt_table_insert.restype = _I32
    lib.kt_format_lines.argtypes = [_P, _I64, _I64, _P, _I32, _I64, _I32, _I32, _I64, _P, _P, _P,
                                    _P]
    lib.kt_format_lines.restype = _I32
    lib.kt_format_lines_scratch.argtypes = [_I64]
    lib.kt_format_lines_scratch.restype = _I64
    lib.kt_bloom_insert.argtypes = [_P, _P, _I64, _I32, _P, _I64, _I64, _I32, _I64, _P, _I64,
                                    _I64, _I32, _P, _P, _P]
    lib.kt_bloom_insert.restype = _I32
    lib.kt_bloom_gate.argtypes = [_P, _I64, _I32, _P, _I64, _I64, _I32, _I64, _P]
    lib.kt_bloom_gate.restype = _I32
    lib.kt_expand_runs.argtypes = [_P, _I64, _I64, _I32, _I64, _P, _I64, _P]
    lib.kt_expand_runs.restype = _I32
    lib.kt_parse_pack.argtypes = [_P, _I64, _I32, _P, _P, _P, _P, _P, _I64, _I32, _I64, _I64, _P]
    lib.kt_parse_pack.restype = _I32
    lib.kt_parse_pack_scratch.argtypes = [_I64]
    lib.kt_parse_pack_scratch.restype = _I64
    return lib


def lib():
    """The kernel library, built on first call (raises if it cannot be)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            srcs, digest = _sources()
            path = os.path.join(BUILD_DIR, f"libkaarme_kernels_{digest}.so")
            if not os.path.isfile(path):
                _compile(path, srcs)
            BUILD_INFO["path"] = path
            _LIB = _bind(ctypes.CDLL(path))
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: cudaError_t {err}")
