"""The port's posit GEMM (repro_torch.kernels) against the JAX package.

* The plain decode/encode versions are integer/IEEE-exact: bit-identical
  to the reference's ``decode_split_f32`` / ``encode_posit_f32``.
* The plain ``posit_gemm_f32`` sums in f32 in the library matmul's order,
  which differs from XLA's, so it is held to the reference's own error
  bound ``sqrt(K) * 8e-8`` against the exact product
  (tests/test_posit_kernel.py), not to its bits.  ``posit_gemm`` must be
  bit-identical to encode(± its own f32 output).
* ``rgemm``: ``faithful`` is bit-identical; ``xla_quire`` and split3 are
  held to the bound of tests/test_perf_paths.py.
* The CUDA device functions (csrc/posit_codec.cuh) are built for the host
  with g++ and checked against the plain versions; the kernels themselves
  run only on a GPU (tests/test_torch_cuda.py).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_inputs as ti
from repro.core import formats as JF
from repro.core import posit as JP
from repro.kernels import posit_gemm as JG
from repro.kernels.ops import rgemm as j_rgemm
from repro_torch.core import formats as TF
from repro_torch.core import posit as TP
from repro_torch.kernels import posit_gemm as TG
from repro_torch.kernels import ref as TR
from repro_torch.kernels.ops import rgemm as t_rgemm

CSRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
        / "kernels" / "csrc")
FMTS = ["p32e2", "p16e1", "p8e2", "p8e0"]


def _posits(rng, shape, lo=-8, hi=8, name="p32e2"):
    """Posit words of numpy-made values (the port's from_float64, which
    test_torch_posit.py pins bit-identical to the reference's)."""
    return ti.posits(rng, shape, lo, hi, TF.FORMATS[name]).numpy()


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_err(got, av, bv, cv=None):
    f64 = [None if x is None else torch.from_numpy(np.array(x, np.float64))
           for x in (got, av, bv, cv)]
    return ti.gemm_rel_err(*f64)


# --------------------------------------------------------------------------
# plain device-function versions vs the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", FMTS)
def test_decode_split_plain_bit_identical(name):
    rng = np.random.default_rng(0)
    w = ti.words(TF.FORMATS[name], rng, 1 << 16)
    jh, jl = JG.decode_split_f32(jnp.asarray(w), JF.FORMATS[name])
    th, tl = TG.decode_split_f32(_t(w), TF.FORMATS[name])
    assert np.array_equal(np.asarray(jh).view(np.int32),
                          th.numpy().view(np.int32))
    assert np.array_equal(np.asarray(jl).view(np.int32),
                          tl.numpy().view(np.int32))


@pytest.mark.parametrize("name", FMTS)
def test_encode_posit_plain_bit_identical(name):
    x = ti.f32_corners(20000)
    want = np.asarray(JG.encode_posit_f32(jnp.asarray(x), JF.FORMATS[name]))
    got = TG.encode_posit_f32(_t(x), TF.FORMATS[name]).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(
        got, TP.from_float32_bits(_t(x), TF.FORMATS[name]).numpy())
    if name in ("p32e2", "p16e1"):
        named = TG.encode_p32_f32 if name == "p32e2" else TG.encode_p16_f32
        assert np.array_equal(named(_t(x)).numpy(), want)


# --------------------------------------------------------------------------
# plain GEMM vs the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("name", ["p32e2", "p16e1"])
def test_posit_gemm_f32_plain_within_reference_bound(mode, name):
    m, k, n = 32, 128, 32
    rng = np.random.default_rng(1)
    a = _posits(rng, (m, k), -4, 4, name)
    b = _posits(rng, (k, n), -4, 4, name)
    jfmt, tfmt = JF.FORMATS[name], TF.FORMATS[name]
    want = np.asarray(JG.posit_gemm_f32(jnp.asarray(a), jnp.asarray(b),
                                        bm=32, bn=32, bk=64, mode=mode,
                                        fmt=jfmt))
    got = TG.posit_gemm_f32(_t(a), _t(b), bk=64, mode=mode, fmt=tfmt).numpy()
    av = np.asarray(JP.to_float64(jnp.asarray(a), jfmt))
    bv = np.asarray(JP.to_float64(jnp.asarray(b), jfmt))
    bound = np.sqrt(k) * 8e-8
    assert _rel_err(got, av, bv) < bound
    assert _rel_err(want, av, bv) < bound
    # both sum the same exact products in f32: within two bounds of each
    # other, whatever order each library chose
    sc = np.outer(np.linalg.norm(av, axis=1), np.linalg.norm(bv, axis=0))
    assert (np.abs(got - want) / sc).max() < 2 * bound


@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
def test_posit_gemm_fused_encode_bit_identical(mode):
    rng = np.random.default_rng(5)
    a, b = _t(_posits(rng, (96, 80), -6, 6)), _t(_posits(rng, (80, 72), -6, 6))
    acc = TG.posit_gemm_f32(a, b, bk=32, mode=mode)
    for neg in (False, True):
        fused = TG.posit_gemm(a, b, bk=32, mode=mode, negate=neg)
        host = TP.from_float32_bits(-acc if neg else acc)
        assert torch.equal(fused, host), (mode, neg)


@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
def test_gemm_chunking_long_k(mode):
    """bk only regroups the f32 sums: every chunking stays within the
    bound on a long K (test_posit_kernel.py's long-K shape)."""
    rng = np.random.default_rng(6)
    a = _posits(rng, (8, 2048), 0, 0)
    b = _posits(rng, (2048, 8), 0, 0)
    av = TP.to_float64(_t(a)).numpy()
    bv = TP.to_float64(_t(b)).numpy()
    for bk in (16, 128, 2048):
        got = TG.posit_gemm_f32(_t(a), _t(b), bk=bk, mode=mode).numpy()
        assert _rel_err(got, av, bv) < np.sqrt(2048) * 8e-8, bk


@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("shape", ti.LO_PLANE_SHAPES)
def test_plain_gemm_uses_lo_planes(mode, shape):
    """Where the lo planes decide the product (one nonzero per row of A),
    sqrt(K)*8e-8 would also pass a GEMM without them.  Here split3 must be
    within two f32 roundings of the exact product, which the hi-only
    control misses."""
    rng = np.random.default_rng(13)
    a, b = ti.lo_plane_operands(rng, *shape)
    assert ti.lo_plane_err(ti.hi_only_product(a, b), a, b) > ti.LO_PLANE_LIMIT
    got = TG.posit_gemm_f32(a, b, mode=mode)
    assert ti.lo_plane_err(got, a, b) <= ti.LO_PLANE_LIMIT


def test_gemm_wrapper_argument_checks():
    a = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        TG.posit_gemm_f32(a, a, bk=24)
    with pytest.raises(ValueError, match="mode"):
        TG.posit_gemm_f32(a, a, mode="split2")
    with pytest.raises(TypeError):
        TG.posit_gemm_f32(a.float(), a)
    with pytest.raises(ValueError, match="shapes"):
        TG.posit_gemm_f32(a, torch.zeros((3, 4), dtype=torch.int32))
    counts = TG.launch_counts()
    TG.posit_gemm_f32(a, a)                 # CPU: plain version, no launch
    assert TG.launch_counts() == counts


# --------------------------------------------------------------------------
# rgemm backends
# --------------------------------------------------------------------------

@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.0, 1.0), (2.0, -0.5)])
def test_rgemm_faithful_bit_identical(alpha, beta):
    rng = np.random.default_rng(7)
    a, b, c = (_posits(rng, (33, 17)), _posits(rng, (17, 9)),
               _posits(rng, (33, 9)))
    want = np.asarray(j_rgemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                              alpha=alpha, beta=beta, backend="faithful"))
    got = t_rgemm(_t(a), _t(b), _t(c), alpha=alpha, beta=beta,
                  backend="faithful")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        TR.rgemm_faithful(_t(a), _t(b)).numpy(),
        np.asarray(j_rgemm(jnp.asarray(a), jnp.asarray(b),
                           backend="faithful")))


@pytest.mark.parametrize("backend", ["pallas_split3", "pallas_split3_comp",
                                     "xla_quire"])
@pytest.mark.parametrize("shape", [(65, 17, 130), (33, 65, 9)])
def test_rgemm_backend_parity_odd_shapes(backend, shape):
    m, k, n = shape
    rng = np.random.default_rng(2)
    a, b = _posits(rng, (m, k), -4, 4), _posits(rng, (k, n), -4, 4)
    got = TP.to_float64(t_rgemm(_t(a), _t(b), backend=backend,
                                block=64)).numpy()
    av, bv = TP.to_float64(_t(a)).numpy(), TP.to_float64(_t(b)).numpy()
    assert _rel_err(got, av, bv) < np.sqrt(k) * 8e-8


@pytest.mark.parametrize("backend", ["pallas_split3", "pallas_split3_comp",
                                     "xla_quire"])
def test_rgemm_trailing_update_form(backend):
    """alpha=-1/beta=1 — the factorizations' trailing-update form."""
    m, k, n = 65, 130, 17
    rng = np.random.default_rng(3)
    a, b, c = (_posits(rng, (m, k), -2, 2), _posits(rng, (k, n), -2, 2),
               _posits(rng, (m, n), -2, 2))
    got = TP.to_float64(t_rgemm(_t(a), _t(b), _t(c), alpha=-1.0, beta=1.0,
                                backend=backend, block=64)).numpy()
    av, bv, cv = (TP.to_float64(_t(x)).numpy() for x in (a, b, c))
    assert _rel_err(got, av, bv, cv) < np.sqrt(k) * 8e-8


def test_rgemm_transposes_and_general_alpha_beta():
    """test_posit_kernel.py's alpha/beta case, on every port backend."""
    rng = np.random.default_rng(8)
    a, b, c = (_posits(rng, (16, 24), 0, 0), _posits(rng, (24, 16), 0, 0),
               _posits(rng, (16, 16), 0, 0))
    av, bv, cv = (TP.to_float64(_t(x)).numpy() for x in (a, b, c))
    want = 2.0 * av @ bv - 0.5 * cv
    for backend in ("xla_quire", "pallas_split3", "faithful"):
        out = TP.to_float64(t_rgemm(_t(a), _t(b), _t(c), alpha=2.0,
                                    beta=-0.5, backend=backend)).numpy()
        assert np.abs(out - want).max() / np.abs(want).max() < 1e-6, backend
    for backend in ("xla_quire", "pallas_split3", "faithful"):
        base = t_rgemm(_t(a), _t(b), backend=backend)
        assert torch.equal(t_rgemm(_t(a).T, _t(b), trans_a=True,
                                   backend=backend), base)
        assert torch.equal(t_rgemm(_t(a), _t(b).T, trans_b=True,
                                   backend=backend), base)


@pytest.mark.parametrize("backend", ["pallas_split3", "xla_quire"])
def test_rgemm_beta_zero_ignores_nar_in_c(backend):
    rng = np.random.default_rng(12)
    a, b = _t(_posits(rng, (8, 8))), _t(_posits(rng, (8, 8)))
    c_nar = torch.full((8, 8), TF.P32E2.nar_pattern, dtype=torch.int32)
    got = t_rgemm(a, b, c_nar, beta=0.0, backend=backend, block=64)
    assert torch.equal(got, t_rgemm(a, b, backend=backend, block=64))
    assert not bool(TP.is_nar(got).any())


def test_rgemm_unported_backends_raise():
    a = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="A2"):
        t_rgemm(a, a, backend="quire_exact")
    with pytest.raises(ValueError):
        t_rgemm(a, a, backend="nope")


# --------------------------------------------------------------------------
# the CUDA sources: device functions on the host, kernels on the card
# --------------------------------------------------------------------------

_HOST_HARNESS = r"""
#define POSIT_CODEC_HOST
#include "posit_codec.cuh"
using namespace posit_codec;
template <int NB, int ES>
static void dec(const int32_t *p, float *h, float *l, long n) {
  for (long i = 0; i < n; ++i) decode_split<NB, ES>(p[i], h[i], l[i]);
}
template <int NB, int ES>
static void enc(const float *x, int32_t *o, long n) {
  for (long i = 0; i < n; ++i) o[i] = encode_posit<NB, ES>(x[i]);
}
extern "C" int host_decode(const int32_t *p, float *h, float *l, long n,
                           int f) {
  switch (f) {
    case 0: dec<32, 2>(p, h, l, n); return 0;
    case 1: dec<16, 1>(p, h, l, n); return 0;
    case 2: dec<8, 2>(p, h, l, n); return 0;
    case 3: dec<8, 0>(p, h, l, n); return 0;
  }
  return 1;
}
extern "C" int host_encode(const float *x, int32_t *o, long n, int f) {
  switch (f) {
    case 0: enc<32, 2>(x, o, n); return 0;
    case 1: enc<16, 1>(x, o, n); return 0;
    case 2: enc<8, 2>(x, o, n); return 0;
    case 3: enc<8, 0>(x, o, n); return 0;
  }
  return 1;
}
"""


def test_device_codec_source_matches_plain_on_host(tmp_path):
    """csrc/posit_codec.cuh built as host C++ (g++, with UBSan so an
    out-of-range shift or signed overflow fails the build's run) gives the
    plain versions' bits on every p8/p16 word, sampled p32 words, and
    random f32 bit patterns (NaN, inf and subnormals included)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the device codec for the "
                    "host")
    src = tmp_path / "host_codec.cpp"
    src.write_text(_HOST_HARNESS)
    lib_path = tmp_path / "libhost_codec.so"
    build = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared", "-fPIC",
         "-fsanitize=undefined", "-fno-sanitize-recover=all",
         f"-I{CSRC}", "-o", str(lib_path), str(src)],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-3000:]
    lib = ctypes.CDLL(str(lib_path))
    ptr, n_t = ctypes.c_void_p, ctypes.c_long
    lib.host_decode.argtypes = [ptr, ptr, ptr, n_t, ctypes.c_int]
    lib.host_encode.argtypes = [ptr, ptr, n_t, ctypes.c_int]
    rng = np.random.default_rng(9)
    xb = rng.integers(0, 2**32, 1 << 18, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    xb = np.concatenate([xb, ti.f32_corners(20000)])
    for name, fid in TG.FMT_IDS.items():
        fmt = TF.FORMATS[name]
        w = ti.words(fmt, rng, 1 << 18)
        hi = np.empty(w.shape, np.float32)
        lo = np.empty_like(hi)
        assert lib.host_decode(w.ctypes.data, hi.ctypes.data,
                               lo.ctypes.data, w.size, fid) == 0
        th, tl = TG.decode_split_f32_plain(_t(w), fmt)
        assert np.array_equal(hi.view(np.int32), th.numpy().view(np.int32))
        assert np.array_equal(lo.view(np.int32), tl.numpy().view(np.int32))
        out = np.empty(xb.shape, np.int32)
        assert lib.host_encode(xb.ctypes.data, out.ctypes.data, xb.size,
                               fid) == 0
        assert np.array_equal(out,
                              TG.encode_posit_f32_plain(_t(xb), fmt).numpy())
