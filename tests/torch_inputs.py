"""Inputs and error measures shared by the port's tests and chip_smoke.py.

It imports neither jax nor the JAX package, so the GPU-only test file and
chip_smoke.py can use it where only PyTorch is installed.  Inputs are made
from numpy generators, so the same seed gives the same words everywhere.
"""
import numpy as np
import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.kernels import posit_gemm as pg

P32_SPECIALS = np.array([0, -2**31, 1, -1, 2**31 - 1, -(2**31 - 1), 1 << 30,
                         -(1 << 30), 0x40000000 + 1, 0x3FFFFFFF], np.int32)

# The lo-plane check: where the lo planes decide the product, split3 is
# the exact product rounded twice to f32 (the hi product, then the sum
# with the cross terms), so within 2^-23 of it relative to its size, with
# 2^-16 of that to spare for the cross terms' own roundings.  A kernel
# that drops a lo plane misses by up to ~2^-22.
LO_PLANE_LIMIT = 2.0 ** -23 * (1 + 2.0 ** -16)
LO_PLANE_SHAPES = ((64, 1, 64), (65, 130, 33))


def words(fmt: PositFormat, rng, count: int) -> np.ndarray:
    """Every word of a format of <= 16 bits; for p32, the specials and
    ``count`` uniformly sampled words."""
    if fmt.nbits <= 16:
        half = 1 << (fmt.nbits - 1)
        return np.arange(-half, half, dtype=np.int32)
    w = rng.integers(-2**31, 2**31, count, dtype=np.int64).astype(np.int32)
    return np.concatenate([P32_SPECIALS, w])


def values(rng, count: int = 50000, lo=-140, hi=140) -> np.ndarray:
    """f64 values over a wide scale range plus specials: the reference's
    chain_round input set (tests/test_perf_paths.py) at the defaults."""
    x = rng.standard_normal(count) * np.exp2(rng.uniform(lo, hi, count))
    return np.concatenate([x, [0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324,
                               -5e-324, 2.0 ** -1022, 2.0 ** 120,
                               2.0 ** -120, 1.5 * 2.0 ** 113, 2.0 ** 113,
                               1.7e308]])


def f32_corners(count: int = 100000) -> np.ndarray:
    """The f32 corner set of the reference's encode test
    (tests/test_perf_paths.py): ``count`` random values over the whole
    exponent range, specials, and every exponent with five mantissa
    patterns, both signs."""
    rng = np.random.default_rng(4)
    with np.errstate(over="ignore"):
        x = (rng.standard_normal(count)
             * np.exp2(rng.uniform(-148, 130, count))).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                         2.0 ** -126, 2.0 ** 119, 2.0 ** -120,
                         1.5 * 2.0 ** 119, 3.4e38], np.float32)
    exps = np.arange(0, 256, dtype=np.int64)
    mans = np.array([0, 1, 0x400000, 0x7FFFFF, 0x2AAAAA], np.int64)
    bits = ((exps[:, None] << 23) | mans[None, :]).reshape(-1)
    bits = bits.astype(np.uint32)
    corners = np.concatenate([bits, bits | np.uint32(1 << 31)]
                             ).view(np.float32)
    return np.concatenate([x, specials, corners])


def posits(rng, shape, lo, hi, fmt: PositFormat = P32E2,
           device="cpu") -> torch.Tensor:
    """Posit words of ``N(0,1) * 2^U(lo, hi)`` values."""
    x = rng.standard_normal(shape) * np.exp2(rng.uniform(lo, hi, shape))
    return posit.from_float64(torch.from_numpy(x).to(device), fmt)


def gemm_rel_err(got, av, bv, cv=None) -> float:
    """max |got - (A@B or C - A@B)| / (|A_i,:| |B_:,j| (+ |C_ij|)) against
    the f64 product of the f64 values ``av``, ``bv`` (and ``cv``): the
    reference's GEMM error measure (tests/test_posit_kernel.py)."""
    scale = torch.outer(av.norm(dim=1), bv.norm(dim=0))
    exact = av @ bv
    if cv is not None:
        scale, exact = scale + cv.abs(), cv - exact
    return float(((got.double() - exact).abs()
                  / scale.clamp_min(1e-300)).max())


def lo_plane_operands(rng, m, k, n, device="cpu"):
    """p32e2 operands on which the lo planes decide the product: A has one
    nonzero per row, at a random column, so every output is one product
    of two words with 26-27 significand bits (values near 1)."""
    a = posits(rng, (m, k), -2, 2)
    keep = torch.zeros((m, k), dtype=torch.bool)
    keep[torch.arange(m), torch.from_numpy(rng.integers(0, k, m))] = True
    a = torch.where(keep, a, torch.zeros_like(a))
    return a.to(device), posits(rng, (k, n), -2, 2).to(device)


def lo_plane_err(got, a, b) -> float:
    """max |got - A@B| / |A@B| elementwise, for ``lo_plane_operands``."""
    exact = posit.to_float64(a) @ posit.to_float64(b)
    return float(((got.double() - exact).abs() / exact.abs()).max())


def hi_only_product(a, b) -> torch.Tensor:
    """What a GEMM without the lo planes gives on ``lo_plane_operands``:
    the hi-plane product (exact in f64), rounded once to f32."""
    ah, _ = pg.decode_split_f32_plain(a)
    bh, _ = pg.decode_split_f32_plain(b)
    return (ah.double() @ bh.double()).float()
