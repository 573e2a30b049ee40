"""The port's kernel sources built for the host, for the CPU tests.

``csrc/posit_gemm.cu``, ``csrc/posit_gemm_simple.cu``,
``csrc/posit_gemm_skinny.cu`` and ``csrc/posit_codec.cu`` (the elementwise
codec kernels) compile with g++ and ``-DPOSIT_CODEC_HOST``:
``csrc/launch.cuh`` then runs each block's CUDA threads (a cluster's
blocks together) as fibers that yield at ``__syncthreads()`` and at the
cluster barrier, and ``cp.async`` as a copy, so the kernels' indexing,
masking, fold order, batch offsets and cluster reads run here, through
the same C entry points the card's library has.  Slow, and only for small
shapes.  It imports neither jax nor the JAX package.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import _build
from repro_torch.kernels import posit_gemm as TG

CSRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
        / "kernels" / "csrc")


GEMM_SOURCES = ("posit_gemm", "posit_gemm_simple", "posit_gemm_skinny",
                "posit_codec")


def build_host_gemm_lib(out: Path) -> ctypes.CDLL:
    """Build the kernel sources into ``out``, one g++ process each,
    all started together (skips the calling test when g++ is missing),
    and bind the kernel library's C entry points."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the kernels for the host")
    flags = ["-x", "c++", "-std=c++20", "-O1", "-fPIC", "-ffp-contract=off",
             "-DPOSIT_CODEC_HOST", f"-I{CSRC}", "-Wall", "-Werror",
             "-Wno-unknown-pragmas"]
    objs = [out / f"{src}.o" for src in GEMM_SOURCES]
    procs = [subprocess.Popen([gxx, *flags, "-c", "-o", str(obj),
                               str(CSRC / f"{obj.stem}.cu")],
                              stderr=subprocess.PIPE, text=True)
             for obj in objs]
    for p in procs:                  # communicate: a full pipe cannot stall
        err = p.communicate(timeout=300)[1]
        assert p.returncode == 0, err[-3000:]
    lib_path = out / "libhost_gemm.so"
    subprocess.run([gxx, "-shared", "-o", str(lib_path), *map(str, objs)],
                   check=True, timeout=120)
    return _build.bind(ctypes.CDLL(str(lib_path)))


def _np_ptr(x):
    return None if x is None else x.ctypes.data


def _batch_strides(x):
    """(batch, batch stride, row stride, column stride) in elements."""
    if x.ndim == 2:
        return (1, 0, *(s // 4 for s in x.strides))
    return (x.shape[0], *(s // 4 for s in x.strides))


def host_tiled(lib, a, b, fmt, kc, mode, emit, negate):
    """The pre-pass and the tiled kernel on numpy operands: 2-D, or a
    (B, m, k) @ (B, k, n) batch in one launch each, any strides."""
    (m, k), n = a.shape[-2:], b.shape[-1]
    batch, saz, sa0, sa1 = _batch_strides(a)
    _, sbz, sb0, sb1 = _batch_strides(b)
    lead = a.shape[:-2]
    k_pad, lda, ldb = TG.plane_layout(m, k, n)
    lo = fmt.nbits > 16
    planes = [np.full((*lead, k_pad, ld), np.nan, np.float32)
              if lo or i % 2 == 0 else None
              for i, ld in enumerate((lda, lda, ldb, ldb))]
    assert lib.posit_decode_planes_launch(
        _np_ptr(a), _np_ptr(b), batch, m, n, k, saz, sa0, sa1, sbz, sb0,
        sb1, *map(_np_ptr, planes), k_pad, lda, ldb, TG.FMT_IDS[fmt.name],
        None) == 0
    out = np.full((*lead, m, n), -1, np.int32 if emit else np.float32)
    assert lib.posit_gemm_launch(
        *map(_np_ptr, planes), out.ctypes.data, batch, m, n, k, k_pad, lda,
        ldb, m * n, n, TG.FMT_IDS[fmt.name], int(mode == "split3_comp"),
        int(emit), int(negate), kc, None) == 0
    return out, planes


def host_simple(lib, a, b, fmt, kc, mode, emit, negate):
    """The simple kernel on 2-D numpy operands."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    (m, k), n = a.shape, b.shape[1]
    out = np.full((m, n), -1, np.int32 if emit else np.float32)
    assert lib.posit_gemm_simple_launch(
        a.ctypes.data, b.ctypes.data, out.ctypes.data, m, n, k, k, n, n,
        TG.FMT_IDS[fmt.name], int(mode == "split3_comp"), int(emit),
        int(negate), kc, None) == 0
    return out


def host_skinny(lib, x, words, sexp, fmt, kc=32):
    """The skinny kernel on numpy operands: f32 activations (m, k), the
    stored words (k, n) (int16 / int8) and int8 exponents (n,)."""
    x = np.ascontiguousarray(x, np.float32)
    words, sexp = np.ascontiguousarray(words), np.ascontiguousarray(sexp)
    (m, k), n = x.shape, words.shape[1]
    out = np.full((m, n), np.nan, np.float32)
    assert lib.posit_gemm_skinny_launch(
        x.ctypes.data, words.ctypes.data, sexp.ctypes.data, out.ctypes.data,
        m, n, k, TG.FMT_IDS[fmt.name], kc, None) == 0
    return out


def host_encode(lib, x, fmt, out_dtype=np.int32):
    """The encode kernel on a numpy f32 array (any alignment; the launcher
    takes the vector loop where both pointers allow it), words of
    ``out_dtype`` (int32, int16 or int8)."""
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    out = np.full(x.shape, -1, out_dtype)
    assert lib.posit_encode_launch(x.ctypes.data, out.ctypes.data, x.size,
                                   TG.FMT_IDS[fmt.name], out.itemsize,
                                   None) == 0
    return out
