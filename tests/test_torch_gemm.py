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
* The decode pre-pass's plain version lays the reference's decoded planes
  out as the tiled kernel reads them.
* The CUDA sources are built for the host with g++: the device functions
  (csrc/posit_codec.cuh) are checked against the plain versions, the
  encode kernel (csrc/posit_codec.cu) in its three output widths too, and
  the two GEMM kernels (csrc/posit_gemm.cu, csrc/posit_gemm_simple.cu)
  run on the CPU through csrc/launch.cuh's emulation, where the tiled
  kernel must give the simple kernel's bits.  On the card the kernels are
  checked by tests/test_torch_cuda.py.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_tests  # noqa: F401  (one PyTorch thread)
import host_kernels as hk
import torch_inputs as ti
from repro.core import formats as JF
from repro.core import posit as JP
from repro.kernels import posit_gemm as JG
from repro.kernels.ops import rgemm as j_rgemm
from repro_torch.core import formats as TF
from repro_torch.core import posit as TP
from repro_torch.kernels import posit_gemm as TG
from repro_torch.kernels import ops as TO
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


@pytest.mark.parametrize("wrapper", [TG.posit_gemm_f32, TG.posit_gemm,
                                     TG.posit_gemm_f32_simple,
                                     TG.posit_gemm_simple])
def test_gemm_wrapper_argument_checks(wrapper):
    a = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        wrapper(a, a, bk=24)
    with pytest.raises(ValueError, match="mode"):
        wrapper(a, a, mode="split2")
    with pytest.raises(TypeError):
        wrapper(a.float(), a)
    with pytest.raises(ValueError, match="shapes"):
        wrapper(a, torch.zeros((3, 4), dtype=torch.int32))
    counts = TG.launch_counts()
    wrapper(a, a)                           # CPU: plain version, no launch
    assert TG.launch_counts() == counts


def test_simple_wrappers_are_the_plain_versions_on_cpu():
    rng = np.random.default_rng(18)
    a, b = _t(_posits(rng, (33, 40), -3, 3)), _t(_posits(rng, (40, 21), -3, 3))
    for mode in TG.MODES:
        assert torch.equal(TG.posit_gemm_f32_simple(a, b, bk=32, mode=mode),
                           TG.posit_gemm_f32_plain(a, b, bk=32, mode=mode))
        assert torch.equal(TG.posit_gemm_simple(a, b, mode=mode, negate=True),
                           TG.posit_gemm_plain(a, b, mode=mode, negate=True))


# --------------------------------------------------------------------------
# the decode pre-pass's planes
# --------------------------------------------------------------------------

def test_plane_layout():
    assert TG.plane_layout(4032, 64, 4032) == (64, 4032, 4032)
    assert TG.plane_layout(65, 17, 130) == (32, 68, 132)
    assert TG.plane_layout(1, 16, 3) == (16, 4, 4)
    assert TG.plane_layout(0, 0, 0) == (0, 0, 0)


@pytest.mark.parametrize("name", FMTS)
def test_decode_planes_plain_layout(name):
    """A transposed and B, decoded as the reference decodes, K padded to
    16 rows and the leading dimensions to 4 floats with zeros; no lo
    planes for <= 16-bit formats.  Strided and transposed views too."""
    fmt, jfmt = TF.FORMATS[name], JF.FORMATS[name]
    rng = np.random.default_rng(19)
    big = rng.choice(ti.words(fmt, rng, 1 << 16), (90, 90))
    for a, b in ((big[:65, :17], big[17:34, :30]),
                 (big[5:38, 3:68], big[20:29, 3:68].T)):
        planes = TG.decode_planes(_t(a), _t(b), fmt)     # CPU: plain
        (m, k), n = a.shape, b.shape[1]
        k_pad, lda, ldb = TG.plane_layout(m, k, n)
        assert (planes.a_lo is None) == (fmt.nbits <= 16)
        ref = [np.asarray(x) for x in JG.decode_split_f32(jnp.asarray(a), jfmt)
               + JG.decode_split_f32(jnp.asarray(b), jfmt)]
        for got, want, ld in zip(planes, (ref[0].T, ref[1].T, ref[2], ref[3]),
                                 (lda, lda, ldb, ldb)):
            if got is None:
                assert not want.any()
                continue
            assert got.shape == (k_pad, ld)
            g = got.numpy()
            assert np.array_equal(g[:want.shape[0], :want.shape[1]]
                                  .view(np.int32), want.view(np.int32))
            g[:want.shape[0], :want.shape[1]] = 0
            assert not g.view(np.int32).any()


def test_decode_planes_argument_checks():
    a = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        TG.decode_planes(a.float(), a)
    with pytest.raises(ValueError, match="shapes"):
        TG.decode_planes(a, torch.zeros((3, 4), dtype=torch.int32))
    counts = TG.launch_counts()
    TG.decode_planes(a, a)
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
    """Every backend of the reference is ported (quire_exact since the
    quire landed: the reference's words on a small case); an unknown
    backend still raises."""
    assert "quire_exact" in TO.BACKENDS
    rng = np.random.default_rng(13)
    a, b, c = (_posits(rng, s, -4, 4) for s in ((9, 12), (12, 5), (9, 5)))
    got = t_rgemm(_t(a), _t(b), _t(c), alpha=-1.0, beta=1.0,
                  backend="quire_exact")
    want = j_rgemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                   alpha=-1.0, beta=1.0, backend="quire_exact")
    assert np.array_equal(got.numpy(), np.asarray(want))
    z = torch.zeros((2, 2), dtype=torch.int32)
    assert not bool(t_rgemm(z, z, backend="quire_exact").any())
    with pytest.raises(ValueError):
        t_rgemm(z, z, backend="nope")


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


@pytest.fixture(scope="module")
def host_gemm_lib(tmp_path_factory):
    """The kernel sources (csrc/posit_gemm.cu, csrc/posit_gemm_simple.cu,
    csrc/posit_gemm_skinny.cu and csrc/posit_codec.cu) built for the host
    with g++ (tests/host_kernels.py)."""
    return hk.build_host_gemm_lib(tmp_path_factory.mktemp("host_gemm"))


@pytest.mark.parametrize("name", FMTS)
def test_encode_kernel_source_matches_plain_on_host(host_gemm_lib, name):
    """csrc/posit_codec.cu's encode kernel, built for the host, gives the
    plain version's words in every output width that holds the format's
    words (int32, int16, int8): on the f32 corners, every power of two and
    the format's rounding boundaries with their f32 neighbours, and a
    fixed-stride sweep of the 2^32 patterns (~2^20 values); an unaligned
    slice takes the scalar loop, an odd length the vector loop's tail."""
    fmt = TF.FORMATS[name]
    sweep = np.arange(0, 2**32, 4099, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([ti.f32_corners(20000), sweep.view(np.float32),
                        ti.encode_boundaries(fmt, np.random.default_rng(3))])
    want = TG.encode_posit_f32_plain(_t(x), fmt).numpy()
    for dt in (np.int32, np.int16, np.int8):
        if np.dtype(dt).itemsize * 8 < fmt.nbits:
            continue
        assert np.array_equal(hk.host_encode(host_gemm_lib, x, fmt, dt),
                              want.astype(dt)), dt
        want_dt = TG.encode_posit_f32_plain(_t(x[:4099]), fmt,
                                            getattr(torch, dt.__name__))
        assert np.array_equal(want_dt.numpy(), want[:4099].astype(dt))
        for lo, hi in ((1, 4099), (0, 4095)):
            assert np.array_equal(
                hk.host_encode(host_gemm_lib, x[lo:hi], fmt, dt),
                want[lo:hi].astype(dt)), (dt, lo, hi)


@pytest.mark.parametrize("name", FMTS)
def test_tiled_kernel_source_bit_identical_to_simple_on_host(host_gemm_lib,
                                                            name):
    """The tiled kernel's source (pre-pass, cp.async ring, 8x8 / 8x4
    register tiles, folds at every kc, masked epilogue), run on the host,
    gives the simple kernel's bits: ragged shapes, several K chunks, both
    modes, f32 and fused ±encode, a NaR word, strided and transposed
    views; and its planes are the plain version's."""
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(20)
    lib = host_gemm_lib
    cases = []
    for (m, k, n) in ((65, 17, 130), (33, 65, 9), (40, 300, 70)):
        a = _posits(rng, (m, k), -4, 4, name)
        b = _posits(rng, (k, n), -4, 4, name)
        a[0, 0] = fmt.nar_pattern
        cases += [(a, b, kc) for kc in (16, 48, 128)]
    big = _posits(rng, (200, 200), -2, 2, name)
    cases += [(big[70:, 3:67], big[3:67, 70:], 128),
              (big[70:, 3:67], big[70:170, 3:67].T, 32)]
    if name == "p32e2":                 # where the lo planes decide
        cases += [(*(x.numpy() for x in ti.lo_plane_operands(rng, *shape)),
                   16) for shape in ti.LO_PLANE_SHAPES]
    a, b = ti.cancelling_operands(rng, 37, 96, 41, fmt)
    cases += [(a.numpy(), b.numpy(), kc) for kc in (32, 128)]
    for a, b, kc in cases:
        _, planes = hk.host_tiled(lib, a, b, fmt, kc, "split3", False, False)
        for got, want in zip(planes, TG.decode_planes_plain(_t(a), _t(b),
                                                            fmt)):
            assert (got is None) == (want is None)
            if got is not None:
                assert np.array_equal(got.view(np.int32),
                                      want.numpy().view(np.int32))
        for mode in TG.MODES:
            for emit, negate in ((False, False), (True, False), (True, True)):
                got, _ = hk.host_tiled(lib, a, b, fmt, kc, mode, emit, negate)
                want = hk.host_simple(lib, a, b, fmt, kc, mode, emit, negate)
                assert np.array_equal(got.view(np.int32),
                                      want.view(np.int32)), \
                    (a.shape, b.shape, kc, mode, emit, negate)
