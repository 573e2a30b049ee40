"""The benchmark's plain reference: its frozen codec against the rational
oracle, its kernel-order product against the host build of the kernel
sources, and its LU against the program's on the CPU."""
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from reference import check, lu, posit

TESTS = Path(__file__).resolve().parent.parent / "tests"
sys.path.insert(0, str(TESTS))
import posit_oracle as oracle  # noqa: E402


def _sample_words(fmt, n, seed):
    rng = np.random.default_rng(seed)
    half = 1 << (fmt.nbits - 1)
    w = rng.integers(-half, half, size=n).tolist()
    edges = [0, fmt.nar_pattern, 1, -1, fmt.maxpos_pattern,
             -fmt.maxpos_pattern, 1 << (fmt.nbits - 2), -(1 << (fmt.nbits - 2))]
    return torch.tensor(w + edges, dtype=torch.int32)


@pytest.mark.parametrize("name", ("p32e2", "p16e1"))
def test_decode_matches_oracle(name):
    fmt = posit.fmt_of(name)
    words = _sample_words(fmt, 3000, 1)
    got = posit.to_float64(words, fmt).tolist()
    for w, v in zip(words.tolist(), got):
        ref = oracle.decode(w, fmt.nbits, fmt.es)
        if ref is None:
            assert np.isnan(v)
        else:
            assert Fraction(v) == ref


@pytest.mark.parametrize("name", ("p32e2", "p16e1"))
def test_encode_and_round_match_oracle(name):
    fmt = posit.fmt_of(name)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(3000) * 10.0 ** rng.integers(-40, 40, 3000)
    # exact ties: midpoints between neighbouring words
    w = _sample_words(fmt, 200, 3)[:200]
    v = posit.to_float64(w, fmt)
    v2 = posit.to_float64(w + 1, fmt)
    ties = ((v + v2) / 2)[torch.isfinite(v + v2)]
    xs = torch.cat([torch.from_numpy(x), ties, torch.tensor([0.0])])
    words = posit.from_float64(xs, fmt)
    vals = posit.round_value(xs, fmt)
    for xi, wi, vi in zip(xs.tolist(), words.tolist(), vals.tolist()):
        ref = oracle.encode(Fraction(xi), fmt.nbits, fmt.es)
        assert wi == ref, xi
        assert Fraction(vi) == oracle.decode(ref, fmt.nbits, fmt.es)


def test_ulp_is_the_spacing():
    fmt = posit.fmt_of("p32e2")
    w = _sample_words(fmt, 2000, 4)[:2000]
    w = w[(w > 0) & (w < fmt.maxpos_pattern)]
    v, v_next = posit.to_float64(w, fmt), posit.to_float64(w + 1, fmt)
    u = posit.ulp(v, fmt)
    # the spacing above a value is its ulp, or twice it at a binade edge
    # where the regime grows
    assert bool(((v_next - v == u) | (v_next - v == 2 * u)).all())


def test_kernel_product_gives_the_kernels_bits(tmp_path):
    """``kernel_product`` against the kernel sources built for the host."""
    import host_kernels as hk
    from repro_torch.core.formats import P32E2
    lib = hk.build_host_gemm_lib(tmp_path)
    fmt = posit.fmt_of("p32e2")
    g = torch.Generator().manual_seed(7)
    for sigma in (1e-2, 1.0, 1e6):
        a = posit.from_float64(
            torch.randn(2, 40, 64, generator=g, dtype=torch.float64) * sigma,
            fmt)
        b = posit.from_float64(
            torch.randn(2, 64, 36, generator=g, dtype=torch.float64) * sigma,
            fmt)
        host = hk.host_tiled(lib, a.numpy(), b.numpy(), P32E2, 128,
                             "split3", False, False)[0]
        mine = lu.kernel_product(posit.to_float64(a, fmt),
                                 posit.to_float64(b, fmt))
        assert np.array_equal(host.astype(np.float64), mine.numpy())


def test_fma32_rounds_once():
    # x * y = 2^6 - 2^-40; acc + x * y lies just below the float32
    # midpoint 2^30 + 2^7 + 2^6, and the f64 sum rounds onto it: fma
    # rounds down to acc, rounding the f64 sum again would round to even
    x = torch.tensor([1.0 + 2.0 ** -23], dtype=torch.float64)
    y = torch.tensor([2.0 ** 6 * (1.0 - 2.0 ** -23)], dtype=torch.float64)
    acc = torch.tensor([2.0 ** 30 + 2.0 ** 7], dtype=torch.float64)
    assert (acc + x * y).item() == 2.0 ** 30 + 2.0 ** 7 + 2.0 ** 6
    assert lu._fma32(x, y, acc).item() == 2.0 ** 30 + 2.0 ** 7
    assert lu._fma32(-x, y, -acc).item() == -(2.0 ** 30 + 2.0 ** 7)


def test_reference_lu_is_the_programs(tiny):
    """At a tiny size the program's LU on the CPU (its plain kernels) and
    the reference give the same backward errors and pivots."""
    import workload as wl
    cell = tiny("lu_p32e2_n1024.factor_b300", n=48, nb=16, batch=5)
    unit = wl.make_unit(cell["config"], cell["traffic"], 11, "cpu")
    words = unit.words
    lu_words, ipiv = unit.run()
    fmt = posit.fmt_of("p32e2")
    a = posit.to_float64(words, fmt)
    ref, ref_piv = lu.getrf(a, 16, lambda v: posit.round_value(v, fmt))
    assert ipiv.to(torch.int64).equal(ref_piv)
    e_prog = check.lu_backward_errors(a, posit.to_float64(lu_words, fmt),
                                      ipiv, 16)
    e_ref = check.lu_backward_errors(a, ref, ref_piv, 16)
    for part in ("whole", "panel0", "trsm0"):
        assert float(check.bwd_dev(e_prog[part], e_ref[part]).max()) < 1e-3


def test_backward_error_flags_bad_pivots():
    a = torch.eye(4, dtype=torch.float64)[None]
    ipiv = torch.tensor([[0, 1, 2, 7]])
    for e in check.lu_backward_errors(a, a, ipiv, 2).values():
        assert e.item() == float("inf")
    ipiv = torch.tensor([[0, 1, 2, 3]])
    for e in check.lu_backward_errors(a, a, ipiv, 2).values():
        assert e.item() == 0.0
