"""Build and load the port's CUDA kernels (``csrc/``) with nvcc + ctypes.

The sources are compiled on first use into a shared library with a plain
C interface, under ``kernels/_build/`` (listed in ``.gitignore``), named
by a hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.  Nothing is built or loaded when the
module is imported: the CPU tests import every module, and this machine
may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("posit_gemm.cu",)
HEADERS = ("posit_codec.cuh",)
# sm_90a: Hopper.  No --use_fast_math: the kernels rely on IEEE f32 adds
# (TwoSum) and on subnormals being kept.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc's output (ptxas register/spill report)
build_seconds = 0.0     # 0.0 when a cached library was loaded


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from kernels/csrc/ at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``SOURCES`` into one shared library (cached by content)."""
    global build_log, build_seconds
    out = BUILD_DIR / f"libposit_kernels-{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        handle.posit_gemm_launch.argtypes = [p, p, p, i, i, i, i64, i64, i64,
                                             i, i, i, i, i, p]
        handle.posit_decode_split_launch.argtypes = [p, p, p, i64, i, p]
        handle.posit_encode_launch.argtypes = [p, p, i64, i, p]
        for fn in (handle.posit_gemm_launch, handle.posit_decode_split_launch,
                   handle.posit_encode_launch):
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib
