"""The skinny-M quantized GEMM (``kernels.posit_gemm.quant_gemm_f32``, the
kernel in ``csrc/posit_gemm_skinny.cu``) on the CPU.

* Its plain version, ``quant_gemm_f32_plain``, is the CPU composition that
  ``quant_matmul(backend="pallas")`` ran before it (the encode, the words
  widened to int32, ``posit_gemm_f32`` at bk=32, ``* scale``) bit for
  bit, at both sides of the dispatch threshold, and the JAX package's
  ``quant_matmul(backend="pallas")`` (its Pallas call in interpret mode)
  bit for bit, NaN where it has NaN: ±inf and NaN activations encode to
  NaR, a NaN weight is a NaR word.
* ``posit_codec.cuh``'s ``decode_hi``, the skinny kernel's decode, built
  for the host with g++ (UBSan on), is ``decode_split``'s hi on every
  pattern of p16e1, p8e2 and p8e0.
* The kernel source built for the host with g++ (``tests/host_kernels.py``)
  gives the bits of the host-built simple kernel on the widened words and
  the encoded activations, times the scales, at small ragged shapes: M = 1
  and several row groups, K over several chunks and ragged, clusters of
  one to eight blocks, reused chunk slots, N ragged and aligned.
"""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpu_tests  # noqa: F401  (one PyTorch thread)
import host_kernels as hk
from repro.serving import quantize as r_q

from repro_torch.core.formats import get_format
from repro_torch.kernels import ops
from repro_torch.kernels import posit_gemm as pg
from repro_torch.serving import QuantConfig
from repro_torch.serving import quantize as t_q

FMTS = ("p16e1", "p8e2")
# The reference's quant_matmul, jitted once: its Pallas GEMM runs in
# interpret mode either way, with the eager call's bits, and its p16e1
# activation encode compiles once instead of dispatching op by op.
R_QUANT_MATMUL = jax.jit(r_q.quant_matmul)
# (M, K, N): one row; a K of three chunks; a ragged K over ten chunks
CASES = ((1, 300, 9), (4, 96, 70), (16, 300, 70))


def _same(got, want) -> bool:
    """Equal f32 bits, or NaN in both."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(got)
    return bool(np.array_equal(nan, np.isnan(want))
                and np.array_equal(got[~nan].view(np.int32),
                                   want[~nan].view(np.int32)))


def _case(fmt, m, k, n, seed=0):
    """Activations with +inf, NaN and -inf in rows 0-2 (M > 3: the other
    rows stay finite), weights with one NaN (a NaR word), quantized by the
    port."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    w[k // 2, n - 1] = np.nan
    x = rng.standard_normal((m, k)).astype(np.float32)
    if m > 3:
        x[0, 5], x[1, 7], x[2, k - 1] = np.inf, np.nan, -np.inf
    leaf = t_q.quantize_leaf({"w": torch.from_numpy(w), "axes": (None, None)},
                             QuantConfig(fmt=fmt, backend="pallas"))
    return torch.from_numpy(x), leaf


def _todays_composition(x, leaf, fmt):
    """The CPU path of quant_matmul(backend="pallas") before the skinny
    kernel: encode, widen, posit_gemm_f32 (split3, bk=32), scale."""
    y = ops.posit_gemm_f32(pg.encode_posit_f32(x, fmt),
                           leaf["qw"].to(torch.int32), bk=32, mode="split3",
                           fmt=fmt)
    return y * t_q._scales(leaf)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", CASES)
def test_plain_equals_todays_cpu_composition(fmt, case, monkeypatch):
    f = get_format(fmt)
    x, leaf = _case(fmt, *case)
    plain = pg.quant_gemm_f32_plain(x, leaf["qw"], leaf["sexp"], f)
    assert _same(plain, _todays_composition(x, leaf, f))
    assert _same(pg.quant_gemm_f32(x, leaf["qw"], leaf["sexp"], f), plain)
    assert _same(t_q.quant_matmul(x, leaf), plain)
    monkeypatch.setattr(pg, "SKINNY_M_MAX", 0)      # the tiled branch
    assert _same(t_q.quant_matmul(x, leaf), plain)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("case", CASES)
def test_plain_equals_reference_pallas(fmt, case):
    """The reference's quant_matmul(backend="pallas") on the port's words
    and exponents (the quantizers' equality is test_torch_serving's)."""
    f = get_format(fmt)
    x, leaf = _case(fmt, *case)
    rq = {"qw": jnp.asarray(leaf["qw"].numpy()),
          "sexp": jnp.asarray(leaf["sexp"].numpy()),
          "qmeta": r_q.QMeta((fmt, "pallas")), "axes": leaf["axes"]}
    ref = np.asarray(R_QUANT_MATMUL(jnp.asarray(x.numpy()), rq))
    got = pg.quant_gemm_f32_plain(x, leaf["qw"], leaf["sexp"], f)
    assert np.isnan(ref).any() and np.isfinite(ref).any()
    assert _same(got, ref)


def test_quant_matmul_dispatch(monkeypatch):
    """quant_matmul's kernel backend: up to SKINNY_M_MAX rows of a <= 16-bit
    format on quant_gemm_f32, more rows or p32e2 on posit_gemm_f32; both
    through kernels.ops."""
    seen = []
    for name in ("quant_gemm_f32", "posit_gemm_f32"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append((_name, tuple(a[0].shape), kw["bk"]))
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    w = np.random.default_rng(3).standard_normal((40, 24)).astype(np.float32)
    for fmt in ("p16e1", "p32e2"):
        leaf = t_q.quantize_leaf({"w": torch.from_numpy(w),
                                  "axes": (None, None)},
                                 QuantConfig(fmt=fmt, backend="pallas"))
        for m in (1, pg.SKINNY_M_MAX, pg.SKINNY_M_MAX + 1):
            t_q.quant_matmul(torch.ones((m, 40)), leaf)
    m_max = pg.SKINNY_M_MAX
    assert seen == [("quant_gemm_f32", (1, 40), 32),
                    ("quant_gemm_f32", (m_max, 40), 32),
                    ("posit_gemm_f32", (m_max + 1, 40), 32),
                    ("posit_gemm_f32", (1, 40), 32),
                    ("posit_gemm_f32", (m_max, 40), 32),
                    ("posit_gemm_f32", (m_max + 1, 40), 32)]


def test_quant_gemm_argument_checks():
    f = get_format("p16e1")
    x = torch.zeros((2, 8))
    w = torch.zeros((8, 4), dtype=torch.int16)
    s = torch.zeros(4, dtype=torch.int8)
    for wrapper in (pg.quant_gemm_f32, pg.quant_gemm_f32_plain):
        with pytest.raises(ValueError, match="<= 16 bits"):
            wrapper(x, w.to(torch.int32), s, get_format("p32e2"))
        with pytest.raises(TypeError):
            wrapper(x, w.to(torch.int8), s, f)          # p16e1 words: int16
        with pytest.raises(TypeError):
            wrapper(x.double(), w, s, f)
        with pytest.raises(ValueError, match="shapes"):
            wrapper(torch.zeros((2, 9)), w, s, f)
        with pytest.raises(ValueError, match="shapes"):
            wrapper(x, w, s[:3], f)
        with pytest.raises(ValueError, match="multiple"):
            wrapper(x, w, s, f, bk=24)
    assert pg.quant_gemm_f32(x[:0], w, s, f).shape == (0, 4)
    assert torch.equal(pg.quant_gemm_f32(x[:, :0], w[:0], s, f),
                       torch.zeros((2, 4)))


_DECODE_HI_HARNESS = r"""
#define POSIT_CODEC_HOST
#include "posit_codec.cuh"
template <int NB, int ES>
static void run(const int32_t *p, float *h, long n) {
  for (long i = 0; i < n; ++i) h[i] = posit_codec::decode_hi<NB, ES>(p[i]);
}
extern "C" int host_decode_hi(const int32_t *p, float *h, long n, int f) {
  switch (f) {
    case 1: run<16, 1>(p, h, n); return 0;
    case 2: run<8, 2>(p, h, n); return 0;
    case 3: run<8, 0>(p, h, n); return 0;
  }
  return 1;
}
"""


def test_decode_hi_is_decode_split_hi_on_every_pattern(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the device codec for the "
                    "host")
    src = tmp_path / "decode_hi.cpp"
    src.write_text(_DECODE_HI_HARNESS)
    lib_path = tmp_path / "libdecode_hi.so"
    build = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-Wall", "-Werror", "-shared", "-fPIC",
         "-fsanitize=undefined", "-fno-sanitize-recover=all",
         f"-I{hk.CSRC}", "-o", str(lib_path), str(src)],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-3000:]
    lib = ctypes.CDLL(str(lib_path))
    lib.host_decode_hi.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_long, ctypes.c_int]
    for name in ("p16e1", "p8e2", "p8e0"):
        f = get_format(name)
        half = 1 << (f.nbits - 1)
        words = np.arange(-half, half, dtype=np.int32)
        hi = np.empty(words.shape, np.float32)
        assert lib.host_decode_hi(words.ctypes.data, hi.ctypes.data,
                                  words.size, pg.FMT_IDS[name]) == 0
        want, _ = pg.decode_split_f32_plain(torch.from_numpy(words), f)
        assert np.array_equal(hi.view(np.int32), want.numpy().view(np.int32))


@pytest.fixture(scope="module")
def host_gemm_lib(tmp_path_factory):
    """The GEMM sources, the skinny kernel's among them, built for the host
    with g++ (tests/host_kernels.py)."""
    return hk.build_host_gemm_lib(tmp_path_factory.mktemp("host_skinny"))


# (M, K, N, bk): M = 1; row groups of 16 (M = 17); one chunk and one block
# (K = 16); a ragged K over ten chunks (a cluster of five blocks of two);
# a K of 70 over two row groups;
# K over 40 and 69 chunks (clusters of eight blocks of five and of nine);
# N ragged (9, 70), aligned
# (64: the words staged by 16-byte copies) and aligned with a ragged last
# tile (72); bk = 48; and chunk slots used twice (bk = 2048, M = 16: one
# slot's activations fill the shared memory).
HOST_CASES = ((1, 300, 9, 32), (3, 64, 70, 32), (4, 96, 64, 32),
              (3, 160, 72, 32), (18, 70, 33, 32),
              (17, 300, 70, 32), (2, 16, 5, 32), (1, 1280, 8, 32),
              (2, 2200, 8, 32), (5, 200, 12, 48), (16, 16400, 4, 2048))


@pytest.mark.parametrize("name", ("p16e1", "p8e2", "p8e0"))
def test_skinny_kernel_source_bit_identical_to_simple_on_host(host_gemm_lib,
                                                              name):
    f = get_format(name)
    rng = np.random.default_rng(17)
    for m, k, n, bk in HOST_CASES:
        x, leaf = _case(name, m, k, n, seed=int(rng.integers(1 << 30)))
        words, sexp = leaf["qw"].numpy(), leaf["sexp"].numpy()
        assert (words == f.nar_pattern).sum() == 1       # a NaR weight word
        got = hk.host_skinny(host_gemm_lib, x.numpy(), words, sexp, f, bk)
        xw = pg.encode_posit_f32_plain(x, f).numpy()
        acc = hk.host_simple(host_gemm_lib, xw, words.astype(np.int32), f,
                             bk, "split3", False, False)
        want = acc * pg.channel_scales(leaf["sexp"]).numpy()
        assert _same(got, want), (name, m, k, n, bk)
        assert np.isfinite(got).any()
