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


def cancelling_operands(rng, m, k, n, fmt: PositFormat = P32E2,
                        device="cpu"):
    """Operands whose exact product is zero (columns 2i and 2i+1 of A are
    both a_i, rows 2i and 2i+1 of B are b_i and -b_i; k even), so every
    f32 output is the residue of the kernel's roundings, which reordering
    any product or fold would change."""
    a = posits(rng, (m, k // 2), -4, 4, fmt).repeat_interleave(2, dim=1)
    half = posits(rng, (k // 2, n), -4, 4, fmt)
    b = torch.stack([half, -half], dim=1).reshape(k, n)
    return a.to(device), b.to(device)


def record_mismatch(got: dict, want: dict, digits_rel: float = 1e-12):
    """The first difference between two positscope ``to_dict()`` records,
    or None: the same keys, counters, gauges and histograms, the same
    series rows (values of the same type and equal, ``digits_gained``
    within ``digits_rel`` relative: log10 may round an ulp apart between
    math libraries), the same number of spans (their times are not
    compared)."""
    for part in ("spans", "counters", "gauges", "hists"):
        if got[part] != want[part]:
            return f"{part}: {got[part]!r} != {want[part]!r}"
    if got["series"].keys() != want["series"].keys():
        return (f"series keys {sorted(got['series'])} != "
                f"{sorted(want['series'])}")
    for key, rows in want["series"].items():
        if len(got["series"][key]) != len(rows):
            return (f"series {key}: {len(got['series'][key])} rows != "
                    f"{len(rows)}")
        for i, (g, w) in enumerate(zip(got["series"][key], rows)):
            if g.keys() != w.keys():
                return f"series {key}[{i}] keys {sorted(g)} != {sorted(w)}"
            for k, wv in w.items():
                gv = g[k]
                same = (type(gv) is type(wv)) and (
                    abs(gv - wv) <= digits_rel * abs(wv)
                    if k == "digits_gained" else gv == wv)
                if not same:
                    return f"series {key}[{i}].{k}: {gv!r} != {wv!r}"
    return None


def cond_matrix(n: int, cond: float, seed: int = 0) -> np.ndarray:
    """Q1 diag(logspace(0, -log10(cond), n)) Q2 with random orthogonal Q1,
    Q2: an (n, n) matrix of 2-norm condition number ``cond`` (the guarded
    solve ladder's cases, tests/test_ft.py)."""
    rng = np.random.default_rng(seed)
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return q1 @ np.diag(np.logspace(0, -np.log10(cond), n)) @ q2


# The guarded ladder's three cases (tests/test_ft.py:249-293): the matrix's
# condition number and seed, the seed of b's generator, and the injected
# faults as Fault keyword sets.
GUARDED_CASES = {
    "benign": dict(cond=1e1, seed=2, rhs_seed=10, faults=()),
    "cond 1e4": dict(cond=1e4, seed=3, rhs_seed=11, faults=()),
    "two faults": dict(cond=1e1, seed=4, rhs_seed=12, faults=(
        dict(site="rgetrf.step", step=0, lane=17, bit=21),
        dict(site="rgetrf.step", step=1, lane=3, bit=5))),
}


def guarded_problem(case: str, n: int, device="cpu"):
    """(A, b) p32e2 words of a guarded-ladder case at size n."""
    c = GUARDED_CASES[case]
    a = posit.from_float64(torch.from_numpy(cond_matrix(n, c["cond"],
                                                        c["seed"])))
    b = posits(np.random.default_rng(c["rhs_seed"]), (n,), -4, 4)
    return a.to(device), b.to(device)
