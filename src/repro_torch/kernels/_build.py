"""Build and load the port's CUDA kernels (``csrc/``) with nvcc + ctypes.

The sources are compiled on first use, one ``nvcc`` process per source,
all started together, and linked into one shared library with a plain C
interface, under ``kernels/_build/`` (listed in ``.gitignore``), named by
a hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.  Nothing is built or loaded when the
module is imported: the CPU tests import every module, and this machine
may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("posit_gemm.cu", "posit_gemm_simple.cu", "posit_codec.cu",
           "posit_gemm_skinny.cu")
HEADERS = ("posit_codec.cuh", "launch.cuh")
# sm_90a: Hopper.  No --use_fast_math: the kernels rely on IEEE f32 adds
# (TwoSum) and on subnormals being kept.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(CSRC / src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [src for src, p in zip(SOURCES, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def bind(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded library (the
    card's, or the host build of the same sources that the CPU tests
    make)."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sigs = {
        "posit_decode_planes_launch": [p, p, i, i, i, i, i64, i64, i64,
                                       i64, i64, i64, p, p, p, p, i, i, i,
                                       i, p],
        "posit_gemm_launch": [p, p, p, p, p, i, i, i, i, i, i, i, i64, i64,
                              i, i, i, i, i, p],
        "posit_gemm_simple_launch": [p, p, p, i, i, i, i64, i64, i64, i, i,
                                     i, i, i, p],
        "posit_decode_split_launch": [p, p, p, i64, i, p],
        "posit_encode_launch": [p, p, i64, i, p],
        "posit_gemm_skinny_launch": [p, p, p, p, i, i, i, i, i, p],
    }
    for name, args in sigs.items():
        fn = getattr(handle, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return handle


_KERNEL = re.compile(r"(posit_gemm_kernel|posit_gemm_simple_kernel|"
                     r"posit_gemm_skinny_kernel|"
                     r"decode_planes_kernel|decode_split_kernel|"
                     r"encode_posit_kernel)I((?:L[a-z]+\d+E)+)E")


def kernel_name(mangled: str) -> str:
    """``posit_gemm_kernel<32,2,0,1,0,0>`` for a mangled kernel symbol (its
    template arguments in order; bools as 0/1)."""
    m = _KERNEL.search(mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[a-z]+(\d+)E", m[2])
    return f"{m[1]}<{','.join(args)}>"


def ptxas_report(log: str | None = None) -> dict[str, dict[str, int]]:
    """Registers, spills and stack of every kernel in ``nvcc -Xptxas -v``
    output (``build_log`` by default), by ``kernel_name``."""
    report: dict[str, dict[str, int]] = {}
    entry = props = None
    for line in (build_log if log is None else log).splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = kernel_name(m[1])
            report[entry] = {}
        elif m := re.search(r"Function properties for (\S+)", line):
            props = kernel_name(m[1])
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            if props in report:
                report[props].update(stack=int(m[1]), spill_stores=int(m[2]),
                                     spill_loads=int(m[3]))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            report[entry]["registers"] = int(m[1])
            if s := re.search(r"(\d+) bytes smem", line):
                report[entry]["static_smem"] = int(s[1])
    return report


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib
