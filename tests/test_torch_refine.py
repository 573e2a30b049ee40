"""The port's quire substitution sweeps and refinement drivers
(repro_torch.lapack.blas/solve/refine) against the JAX package, on the
same numpy-made words.

With the ``faithful`` and ``quire_exact`` GEMMs every op of the
factorization, the sweeps, the residual and the pair update is integer
arithmetic or a separately rounded f64 op, so factors, pivots and the pair
words (x_hi, x_lo) must be bit-identical.  Each of the four drivers runs
once against the reference (its programs take seconds to compile); the
two GEMM backends and the two sizes (n = 33, 48; nb = 16) are spread over
them, with 1-D b, multi-column b and a 3-D batch.

The mixed-precision drivers equilibrate by ``pow2_scale``, which the
reference documents as an exact power of two but computes as
``exp2(floor(log2(.)))``; under XLA on the CPU that is a few ulps off the
power for most scales (ROADMAP.md §C).  The port computes the exact power
from the bits.  To hold everything else of the mp drivers to the
reference's words, their tests substitute the reference's scale function
in the port; ``test_pow2_scale_and_narrowing_are_exact`` pins the port's
own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.lapack import blas as JB
from repro.lapack import decomp as JD
from repro.lapack import refine as JR
from repro.lapack import solve as JS
from repro_torch.core import posit as TP
from repro_torch.core.formats import P16E1, P32E2
from repro_torch.lapack import blas as TB
from repro_torch.lapack import decomp as TD
from repro_torch.lapack import refine as TR
from repro_torch.lapack import solve as TS

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")


def _words(x, fmt=None):
    """Posit words of numpy-made values (the port's from_float64, pinned
    bit-identical to the reference's by test_torch_posit.py)."""
    x = torch.from_numpy(np.asarray(x, np.float64))
    return (TP.from_float64(x) if fmt is None
            else TP.from_float64(x, fmt)).numpy()


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got, want):
    return np.array_equal(np.asarray(got), np.asarray(want))


def _problem(n, spd, seed, nrhs=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    a = x.T @ x if spd else x
    xs = rng.standard_normal(n if nrhs is None else (n, nrhs))
    return _words(a), _words(a @ xs)


# --------------------------------------------------------------------------
# quire substitution sweeps and the solves built on them
# --------------------------------------------------------------------------

def test_rtrsv_quire_sweeps_bit_identical():
    """Lower (unit and non-unit) and upper sweeps; a NaR in the triangle
    a sweep never reads still poisons its row, as the reference's
    full-row dot does."""
    rng = np.random.default_rng(1)
    n = 33
    m = _words(rng.standard_normal((n, n)) * np.exp2(rng.uniform(-4, 4,
                                                                  (n, n)))
               + 6 * np.eye(n))
    b = _words(rng.standard_normal(n))
    for unit in (False, True):
        got = TB.rtrsv_lower_quire(_t(m), _t(b), unit_diag=unit)
        want = JB.rtrsv_lower_quire(jnp.asarray(m), jnp.asarray(b),
                                    unit_diag=unit)
        assert _same(got.numpy(), want), unit
    got = TB.rtrsv_upper_quire(_t(m), _t(b))
    assert _same(got.numpy(), JB.rtrsv_upper_quire(jnp.asarray(m),
                                                   jnp.asarray(b)))
    poisoned = m.copy()
    poisoned[5, 20] = np.int32(-2**31)                  # upper triangle
    got = TB.rtrsv_lower_quire(_t(poisoned), _t(b), unit_diag=True).numpy()
    want = np.asarray(JB.rtrsv_lower_quire(jnp.asarray(poisoned),
                                           jnp.asarray(b), unit_diag=True))
    assert _same(got, want) and TP.is_nar(_t(got[5])).item()


def test_quire_solves_bit_identical():
    """rgetrs / rpotrs / rtrtrs(quire=True) on faithful factors, in p32e2
    and (rgetrs) p16e1: the reference's words."""
    n = 33
    a, b = _problem(n, False, 2)
    lu, piv = TD.rgetrf(_t(a), nb=16, gemm_backend="faithful")
    lu_j, piv_j = JD.rgetrf(jnp.asarray(a), nb=16, gemm_backend="faithful")
    assert _same(lu.numpy(), lu_j)
    x = TS.rgetrs(lu, piv, _t(b), quire=True)
    assert _same(x.numpy(), JS.rgetrs(lu_j, piv_j, jnp.asarray(b),
                                      quire=True))
    for lower in (False, True):
        got = TS.rtrtrs(lu, _t(b), lower=lower, unit_diag=lower, quire=True)
        want = JS.rtrtrs(lu_j, jnp.asarray(b), lower=lower, unit_diag=lower,
                         quire=True)
        assert _same(got.numpy(), want), lower
    s, bs = _problem(n, True, 3)
    l_p = TD.rpotrf(_t(s), nb=16, gemm_backend="faithful")
    got = TS.rpotrs(l_p, _t(bs), quire=True)
    want = JS.rpotrs(jnp.asarray(l_p.numpy()), jnp.asarray(bs), quire=True)
    assert _same(got.numpy(), want)
    a16 = _words(np.random.default_rng(4).standard_normal((n, n)), P16E1)
    b16 = _words(np.random.default_rng(5).standard_normal(n), P16E1)
    lu16, piv16 = TD.rgetrf(_t(a16), nb=16, gemm_backend="faithful",
                            fmt=P16E1)
    got = TS.rgetrs(lu16, piv16, _t(b16), quire=True, fmt=P16E1)
    want = JS.rgetrs(jnp.asarray(lu16.numpy()), jnp.asarray(piv16.numpy()),
                     jnp.asarray(b16), quire=True, fmt=JF.P16E1)
    assert _same(got.numpy(), want)


def test_residual_quire_bit_identical():
    rng = np.random.default_rng(6)
    n = 33
    a = _words(rng.standard_normal((n, n)))
    x_hi, x_lo = _words(rng.standard_normal(n)), _words(
        rng.standard_normal(n) * 2.0 ** -30)
    b = _words(rng.standard_normal(n))
    got = TR.residual_quire(_t(a), _t(x_hi), _t(b), _t(x_lo))
    want = JR.residual_quire(jnp.asarray(a), jnp.asarray(x_hi),
                             jnp.asarray(b), jnp.asarray(x_lo))
    assert _same(got.numpy(), want)
    got = TR.residual_quire(_t(a), _t(x_hi), _t(b))
    assert _same(got.numpy(), JR.residual_quire(jnp.asarray(a),
                                                jnp.asarray(x_hi),
                                                jnp.asarray(b)))


# --------------------------------------------------------------------------
# the four drivers: factors and pair words bit-identical
# --------------------------------------------------------------------------

def _check_pair(got, want):
    (h, lo), (hj, loj) = got, want
    assert h.shape == tuple(hj.shape)
    assert _same(h.numpy(), hj) and _same(lo.numpy(), loj)


def test_rgesv_ir_faithful_bit_identical():
    """n=33, faithful: 1-D b and a 3-column b (each column refined on its
    own, as the reference's vmap does)."""
    a, b = _problem(33, False, 7)
    (pair, (lu, piv)) = TR.rgesv_ir(_t(a), _t(b), nb=16,
                                    gemm_backend="faithful")
    (pair_j, (lu_j, piv_j)) = JR.rgesv_ir(jnp.asarray(a), jnp.asarray(b),
                                          nb=16, gemm_backend="faithful")
    _check_pair(pair, pair_j)
    assert _same(lu.numpy(), lu_j) and _same(piv.numpy(), piv_j)
    _, bm = _problem(33, False, 7, nrhs=3)
    pair, _ = TR.rgesv_ir(_t(a), _t(bm), nb=16, gemm_backend="faithful")
    pair_j, _ = JR.rgesv_ir(jnp.asarray(a), jnp.asarray(bm), nb=16,
                            gemm_backend="faithful")
    _check_pair(pair, pair_j)
    # the pair carries more than x_hi alone: lo is nonzero somewhere
    assert bool(pair[1].any())


def test_rposv_ir_quire_exact_batched_bit_identical():
    """n=33, quire_exact, a 3-D batch of two SPD matrices."""
    (a0, b0), (a1, b1) = _problem(33, True, 8), _problem(33, True, 9)
    a, b = np.stack([a0, a1]), np.stack([b0, b1])
    pair, l_p = TR.rposv_ir(_t(a), _t(b), nb=16, gemm_backend="quire_exact")
    pair_j, l_j = JR.rposv_ir(jnp.asarray(a), jnp.asarray(b), nb=16,
                              gemm_backend="quire_exact")
    _check_pair(pair, pair_j)
    assert l_p.shape == (2, 33, 33) and _same(l_p.numpy(), l_j)


@pytest.fixture
def reference_scale(monkeypatch):
    """The port's mp drivers with the reference's pow2_scale (its values,
    computed by the reference on the same f64 inputs)."""
    def scale(x64):
        s = float(JR.pow2_scale(jnp.asarray(x64.cpu().numpy())))
        return torch.tensor(s, dtype=torch.float64, device=x64.device)
    monkeypatch.setattr(TR, "pow2_scale", scale)


def test_rgesv_mp_faithful_bit_identical(reference_scale):
    """n=48, faithful: p16e1 factors after the equilibration, p32e2
    pair."""
    a, b = _problem(48, False, 10)
    pair, (lu, piv) = TR.rgesv_mp(_t(a), _t(b), nb=16,
                                  gemm_backend="faithful")
    pair_j, (lu_j, piv_j) = JR.rgesv_mp(jnp.asarray(a), jnp.asarray(b),
                                        nb=16, gemm_backend="faithful")
    _check_pair(pair, pair_j)
    assert _same(lu.numpy(), lu_j) and _same(piv.numpy(), piv_j)


def test_rposv_mp_quire_exact_bit_identical(reference_scale):
    a, b = _problem(48, True, 11)
    pair, l_p = TR.rposv_mp(_t(a), _t(b), nb=16, gemm_backend="quire_exact")
    pair_j, l_j = JR.rposv_mp(jnp.asarray(a), jnp.asarray(b), nb=16,
                              gemm_backend="quire_exact")
    _check_pair(pair, pair_j)
    assert _same(l_p.numpy(), l_j)


def _exact_scale(x64):
    """The port's pow2_scale written in jnp: 2^floor(log2(max|x|))."""
    mx = jnp.max(jnp.where(jnp.isnan(x64), 0.0, jnp.abs(x64)))
    _, e = jnp.frexp(mx)
    return jnp.where(mx > 0, jnp.ldexp(jnp.float64(1.0), e - 1), 1.0)


def test_rposv_mp_stalls_with_the_reference_outside_its_envelope(
        monkeypatch):
    """make_spd(48, 1, seed 3) lies outside the mp drivers' envelope
    (cond(A) * eps_p16e1 ~ 190 > 1, against ~0.8 for seed 0): rposv_mp
    does not converge and x_lo stays all zero.  The reference does the
    same, with its own scale and with the port's exact one, and its words
    are the port's: the zero x_lo is the matrix's, not a fault of the
    port."""
    from repro_torch.lapack.error_eval import make_spd
    n = 48
    a64 = make_spd(n, 1.0, 3)
    eps16 = P16E1.eps_at_1
    assert np.linalg.cond(a64) * eps16 > 100
    assert np.linalg.cond(make_spd(n, 1.0, 0)) * eps16 < 1
    a = _words(a64)
    b = _words(a64 @ np.full(n, 1.0 / np.sqrt(n)))
    (h, lo), _ = TR.rposv_mp(_t(a), _t(b), gemm_backend="faithful")
    (hj, loj), _ = JR.rposv_mp(jnp.asarray(a), jnp.asarray(b),
                               gemm_backend="faithful")
    monkeypatch.setattr(JR, "pow2_scale", _exact_scale)
    (hs, los), _ = JR.rposv_mp(jnp.asarray(a), jnp.asarray(b),
                               gemm_backend="faithful")
    assert not lo.any() and not np.asarray(loj).any()
    assert not np.asarray(los).any()
    assert _same(h.numpy(), hs) and _same(lo.numpy(), los)
    assert not TP.is_nar(h).any()
    err = np.abs(TR.pair_to_float64(h, lo).numpy() - 1 / np.sqrt(n)).max()
    assert err * np.sqrt(n) > 1e-2          # no convergence, unlike seed 0


def test_pow2_scale_and_narrowing_are_exact():
    """The port's pow2_scale is the exact power 2^floor(log2(max|x|))
    (1.0 for all-zero or all-NaN input), equal to the reference's wherever
    the reference's is exact; mp_narrow_matrix gives the reference's
    words wherever its scale is exact."""
    rng = np.random.default_rng(12)
    cases = [rng.standard_normal(50) * 2.0 ** e for e in range(-120, 121, 7)]
    cases += [np.array([0.0, -0.0]), np.array([np.nan, 3.0, -5.0]),
              np.array([2.0 ** -120, 0.0]), np.array([np.nan]),
              np.array([1.0 - 2.0 ** -28, 0.5]), np.array([-2.0 ** 40])]
    exact_in_reference = inexact_in_reference = 0
    for x in cases:
        got = TR.pow2_scale(torch.from_numpy(x)).item()
        mx = np.nanmax(np.abs(x)) if not np.isnan(x).all() else 0.0
        want = 1.0 if mx == 0 else np.ldexp(1.0, np.frexp(mx)[1] - 1)
        assert got == want, x
        ref = float(JR.pow2_scale(jnp.asarray(x)))
        if np.frexp(ref)[0] == 0.5:                     # reference exact
            assert got == ref, x
            exact_in_reference += 1
        else:                                   # ROADMAP.md §C
            assert abs(ref / got - 1) < 1e-14, (x, ref, got)
            inexact_in_reference += 1
    assert exact_in_reference >= 5 and inexact_in_reference >= 1
    a = _words(rng.standard_normal((20, 20)) * 3.0)      # scale 2^3: exact
    lo, s = TR.mp_narrow_matrix(_t(a), P16E1, P32E2)
    lo_j, s_j = JR.mp_narrow_matrix(jnp.asarray(a), JF.P16E1, JF.P32E2)
    assert s.item() == float(s_j) and _same(lo.numpy(), lo_j)
