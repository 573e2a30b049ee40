"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode);
without a GPU each one skips.  The file imports neither jax nor the JAX
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the decode/encode kernels and the GEMM's decode pre-pass are
integer/IEEE-exact, so they must equal their plain versions bit for bit;
the GEMM sums in f32 in its own order, so it is held to the reference's
bound sqrt(K) * 8e-8 against the exact product, and its fused encode must
equal encode(± its own f32 output) bit for bit.  The tiled GEMM kernel
keeps the first (simple) kernel's order of operations per output, so its
output must equal the simple kernel's bit for bit.  Where the lo planes decide the product (one nonzero
per row of A), split3 is held to two f32 roundings of the exact product,
which a GEMM without the lo planes misses (tests/torch_inputs.py).
"""
import numpy as np
import pytest
import torch

import torch_inputs as ti
from repro_torch.core import formats as TF
from repro_torch.core import posit as TP
from repro_torch.kernels import posit_gemm as TG

FMTS = ["p32e2", "p16e1", "p8e2", "p8e0"]


def _rel_err(got, a, b):
    return ti.gemm_rel_err(got, TP.to_float64(a), TP.to_float64(b))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
def test_cuda_codec_kernels_match_plain(cuda_device, name):
    rng = np.random.default_rng(10)
    fmt = TF.FORMATS[name]
    w = torch.from_numpy(ti.words(fmt, rng, 1 << 20)).to(cuda_device)
    kh, kl = TG.decode_split_f32(w, fmt)
    ph, pl = TG.decode_split_f32_plain(w, fmt)
    assert torch.equal(kh.view(torch.int32), ph.view(torch.int32))
    assert torch.equal(kl.view(torch.int32), pl.view(torch.int32))
    bits = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(bits.view(np.float32)).to(cuda_device)
    assert torch.equal(TG.encode_posit_f32(x, fmt),
                       TG.encode_posit_f32_plain(x, fmt))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("shape", [(65, 17, 130), (33, 65, 9),
                                   (257, 300, 129)])
def test_cuda_gemm_kernel_within_bound(cuda_device, mode, shape):
    m, k, n = shape
    rng = np.random.default_rng(11)
    a = ti.posits(rng, (m, k), -4, 4, device=cuda_device)
    b = ti.posits(rng, (k, n), -4, 4, device=cuda_device)
    got = TG.posit_gemm_f32(a, b, mode=mode)
    assert _rel_err(got, a, b) < np.sqrt(k) * 8e-8
    assert _rel_err(TG.posit_gemm_f32_plain(a, b, mode=mode), a, b) \
        < np.sqrt(k) * 8e-8
    for neg in (False, True):
        fused = TG.posit_gemm(a, b, mode=mode, negate=neg)
        assert torch.equal(fused,
                           TG.encode_posit_f32_plain(-got if neg else got))


@pytest.mark.cuda
def test_cuda_gemm_strided_operands_and_launch_count(cuda_device):
    """Row-strided views (a factorization's trailing blocks) are read in
    place; each wrapper call is one launch."""
    rng = np.random.default_rng(12)
    big = ti.posits(rng, (200, 200), -2, 2, device=cuda_device)
    a, b = big[70:, 3:67], big[3:67, 70:]
    before = TG.posit_gemm_f32.launches
    got = TG.posit_gemm_f32(a, b)
    assert TG.posit_gemm_f32.launches == before + 1
    assert torch.equal(got, TG.posit_gemm_f32(a.contiguous(),
                                              b.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("shape", ti.LO_PLANE_SHAPES)
def test_cuda_gemm_kernel_uses_lo_planes(cuda_device, mode, shape):
    rng = np.random.default_rng(13)
    a, b = ti.lo_plane_operands(rng, *shape, device=cuda_device)
    assert ti.lo_plane_err(ti.hi_only_product(a, b), a, b) > ti.LO_PLANE_LIMIT
    got = TG.posit_gemm_f32(a, b, mode=mode)
    assert ti.lo_plane_err(got, a, b) <= ti.LO_PLANE_LIMIT


GEMM_SHAPES = [(65, 17, 130), (33, 65, 9), (257, 300, 129), (4032, 64, 4032)]


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("name", FMTS)
def test_cuda_tiled_gemm_bit_identical_to_simple(cuda_device, name, mode,
                                                 shape):
    """Every kc (several chunks where K > kc), both output forms."""
    m, k, n = shape
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(14)
    a = ti.posits(rng, (m, k), -4, 4, fmt, cuda_device)
    b = ti.posits(rng, (k, n), -4, 4, fmt, cuda_device)
    a[0, 0] = fmt.nar_pattern                          # NaN through both
    for kc in (16, 48, 128):
        got = TG.posit_gemm_f32(a, b, bk=kc, mode=mode, fmt=fmt)
        want = TG.posit_gemm_f32_simple(a, b, bk=kc, mode=mode, fmt=fmt)
        assert torch.equal(_bits(got), _bits(want)), kc
        for neg in (False, True):
            fused = TG.posit_gemm(a, b, bk=kc, mode=mode, negate=neg, fmt=fmt)
            assert torch.equal(fused, TG.encode_posit_f32_plain(
                -got if neg else got, fmt)), (kc, neg)
            assert torch.equal(fused, TG.posit_gemm_simple(
                a, b, bk=kc, mode=mode, negate=neg, fmt=fmt)), (kc, neg)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split3", "split3_comp"])
@pytest.mark.parametrize("name", FMTS)
def test_cuda_tiled_gemm_cancelling_bit_identical(cuda_device, name, mode):
    """An exactly zero product: every output is the residue of the
    kernels' roundings, so any reordered product or fold would show."""
    fmt = TF.FORMATS[name]
    a, b = ti.cancelling_operands(np.random.default_rng(18), 257, 96, 129,
                                  fmt, cuda_device)
    for kc in (16, 48, 128):
        got = TG.posit_gemm_f32(a, b, bk=kc, mode=mode, fmt=fmt)
        want = TG.posit_gemm_f32_simple(a, b, bk=kc, mode=mode, fmt=fmt)
        assert torch.equal(_bits(got), _bits(want)), kc


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
def test_cuda_tiled_gemm_views_bit_identical(cuda_device, name):
    """Row-strided views (LU's trailing blocks) and a transposed B
    (Cholesky's trans_b) are read in place, with the simple kernel's
    bits."""
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(15)
    big = ti.posits(rng, (300, 300), -2, 2, fmt, cuda_device)
    a = big[70:, 3:67]
    for b in (big[3:67, 70:], big[70:233, 3:67].T):
        for mode in ("split3", "split3_comp"):
            got = TG.posit_gemm_f32(a, b, mode=mode, fmt=fmt)
            want = TG.posit_gemm_f32_simple(a, b, mode=mode, fmt=fmt)
            assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", FMTS)
def test_cuda_decode_planes_match_plain(cuda_device, name):
    """The pre-pass planes: decode_split_f32_plain of A transposed and of
    B, padded with zeros as the kernel lays them out."""
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(16)
    words = rng.choice(ti.words(fmt, rng, 1 << 16), (300, 300))
    big = torch.from_numpy(words).to(cuda_device)
    for a, b in ((big[:65, :17], big[17:34, :130]),
                 (big[5:38, 3:68], big[100:109, 3:68].T),
                 (big[:257, :300], big[:300, 1:130])):
        got = TG.decode_planes(a, b, fmt)
        want = TG.decode_planes_plain(a, b, fmt)
        assert (want.a_lo is None) == (fmt.nbits <= 16)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                assert g.shape == w.shape
                assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_cuda_rgemm_launches_tiled_kernel_only(cuda_device):
    """rgemm's trailing-update and fused forms go through the pre-pass and
    the tiled kernel; the simple kernel is launched by no rgemm call."""
    from repro_torch.kernels.ops import rgemm
    rng = np.random.default_rng(17)
    a = ti.posits(rng, (200, 64), -2, 2, device=cuda_device)
    b = ti.posits(rng, (64, 150), -2, 2, device=cuda_device)
    c = ti.posits(rng, (200, 150), -2, 2, device=cuda_device)
    TG.reset_launch_counts()
    rgemm(a, b, c, alpha=-1.0, beta=1.0, backend="pallas_split3")
    rgemm(a, b.T.contiguous(), c, alpha=-1.0, beta=1.0, trans_b=True,
          backend="pallas_split3_comp")
    rgemm(a, b, alpha=-1.0, backend="pallas_split3")
    counts = TG.launch_counts()
    assert counts["posit_gemm_f32"] == 2 and counts["posit_gemm"] == 1
    assert counts["decode_planes"] == 3
    assert counts["posit_gemm_f32_simple"] == 0
    assert counts["posit_gemm_simple"] == 0
