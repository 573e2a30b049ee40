"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU and nvcc (the kernels have no CPU mode);
without a GPU each one skips.  The file imports neither jax nor the JAX
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the decode/encode kernels are integer/IEEE-exact, so they
must equal their plain versions bit for bit; the GEMM sums in f32 in its
own order, so it is held to the reference's bound sqrt(K) * 8e-8 against
the exact product, and its fused encode must equal encode(± its own f32
output) bit for bit.  Where the lo planes decide the product (one nonzero
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
