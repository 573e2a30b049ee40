"""The port's exact-ABFT fault tolerance (repro_torch.ft and the protected
and guarded drivers) against the JAX package's, on the same numpy-made
words.

Everything here is integer arithmetic or the unprotected drivers' own
ops, so the contract is equality, never a tolerance:

1. Checksums (canonical quire limbs, NaR flags, raw word sums) equal the
   reference's in every format; any chunking of the sum gives the same
   limbs; a flip in a p16e1 word's sign extension is caught by the raw
   word sums.
2. ``make_plan`` draws the reference's ``Fault`` tuples from the same
   seed, and ``FaultPlan.words`` / ``.limbs`` corrupt the same words.
3. Fault-free, the protected drivers give the unprotected words with no
   detection; with seeded faults every fault is detected and the
   recovered words are the unprotected ones; the ``FtReport`` fields
   (detections, retries, sites, failed) equal the reference's.
4. The monitored refinement equals ``refine_pair`` over the sweeps it
   took; the guarded ladder's pair words and ``SolveReport`` equal the
   reference's in its three cases, with the same observability record.

One shape throughout (n = 32, nb = 16, two block steps), with the reference's
default GEMM backends (``quire_exact`` for the protected GEMM, the f64
``xla_quire`` elsewhere: its words agree between the packages at this
size, and the tests check that they do).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_inputs as ti
from repro import ft as J
from repro import obs as JO
from repro.core import formats as JF
from repro.ft import abft as JA
from repro.lapack import decomp as JD
from repro.lapack import qr as JQ
from repro.lapack import refine as JR
from repro_torch import ft as T
from repro_torch import obs as TO
from repro_torch.core import posit as TP
from repro_torch.core.formats import P8E2, P16E1, P32E2
from repro_torch.ft import abft as TA
from repro_torch.ft.abft import AbftError
from repro_torch.kernels import ops as TK
from repro_torch.lapack import decomp as TD
from repro_torch.lapack import error_eval as TE
from repro_torch.lapack import qr as TQ
from repro_torch.lapack import refine as TR
from repro_torch.lapack import solve as TS
from repro_torch.quire.quire import Quire, q_renorm

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")

N, NB = 32, 16


def _pm(rng, shape, fmt=P32E2, lo=-4, hi=4):
    return ti.posits(rng, shape, lo, hi, fmt).numpy()


def _words(x, fmt=P32E2):
    return TP.from_float64(torch.from_numpy(np.asarray(x, np.float64)),
                           fmt).numpy()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def _jfmt(fmt):
    return JF.get_format(fmt.name)


# --------------------------------------------------------------------------
# 1. checksums
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [P32E2, P16E1, P8E2], ids=lambda f: f.name)
def test_checksums_equal_reference(fmt):
    """Every field of the checksums, with a NaR and zeros among the
    words."""
    rng = np.random.default_rng(0)
    span = 20 if fmt.nbits > 8 else 4
    a = _pm(rng, (24, 17), fmt, -span, span)
    a[3, 5] = fmt.nar_pattern
    a[7, :] = 0
    got = T.checksum(_t(a), fmt)
    want = J.checksum(jnp.asarray(a), _jfmt(fmt))
    for field in ("row", "col", "row_nar", "col_nar", "row_w", "col_w"):
        assert _eq(getattr(got, field), getattr(want, field)), field


def test_word_sums_any_chunking():
    """The port adds deposit terms straight into the sums; the reference
    sums per-word limbs.  Both, and the sum of two chunks' sums, give the
    same canonical limbs: integer adds are associative."""
    rng = np.random.default_rng(1)
    a = _t(_pm(rng, (40, 30), lo=-30, hi=30))
    limbs, nar = TA.word_sums(a, P32E2, axis=1)
    per_word, per_nar = TA._word_limbs(a, P32E2)
    whole = q_renorm(Quire(per_word.sum(dim=1), per_nar.any(dim=1)))
    assert _eq(limbs, whole.limbs) and _eq(nar, whole.nar)
    halves = [TA._word_limbs(a[:, s], P32E2)[0].sum(dim=1)
              for s in (slice(0, 13), slice(13, None))]
    assert _eq(q_renorm(Quire(halves[0] + halves[1], nar)).limbs, limbs)
    want, want_nar = JA.word_sums(jnp.asarray(a.numpy()), JF.P32E2, axis=1)
    assert _eq(limbs, want) and _eq(nar, want_nar)
    lrow, _ = TA.limb_sums(per_word, per_nar, axis=0)
    jrow, _ = JA.limb_sums(jnp.asarray(per_word.numpy()),
                           jnp.asarray(per_nar.numpy()), axis=0)
    assert _eq(lrow, jrow)


def test_checksum_verify_and_locate():
    rng = np.random.default_rng(0)
    a = _pm(rng, (24, 16))
    cks = T.checksum(_t(a))
    ok, _, _ = T.verify(_t(a), cks)
    assert bool(ok)
    bad = a.copy()
    bad[5, 11] ^= 1 << 13
    ok, bad_row, bad_col = T.verify(_t(bad), cks)
    assert not bool(ok)
    assert T.locate(bad_row, bad_col) == (5, 11)
    assert T.locate(bad_row, bad_col, nb=8) == (0, 1)


def test_checksum_detects_sign_extension_bit_flip_p16e1():
    """p16e1 words are sign-extended int32: a flip above bit 15 leaves
    the value, and so the limbs, unchanged; the raw word sums catch it."""
    rng = np.random.default_rng(1)
    a = _pm(rng, (8, 8), P16E1)
    cks = T.checksum(_t(a), P16E1)
    bad = a.copy()
    bad[3, 3] ^= 1 << 20
    assert _eq(TP.to_float64(_t(bad), P16E1), TP.to_float64(_t(a), P16E1))
    got = T.checksum(_t(bad), P16E1)
    assert _eq(got.row, cks.row) and _eq(got.col, cks.col)
    ok, bad_row, bad_col = T.verify(_t(bad), cks, P16E1)
    assert not bool(ok)
    assert T.locate(bad_row, bad_col) == (3, 3)
    jok, _, _ = J.verify(jnp.asarray(bad), J.checksum(jnp.asarray(a),
                                                      JF.P16E1), JF.P16E1)
    assert bool(jok) is bool(ok)


def test_zero_false_positives_sigma_grid():
    """Fault-free over the §5.1 sigma grid: no detection, and the
    unprotected words."""
    for sigma in (1e-2, 1.0, 1e2, 1e4):
        a = _t(_words(TE.make_general(N, sigma, seed=3)))
        s = _t(_words(TE.make_spd(N, sigma, seed=3)))
        c, _, rep = T.rgemm_ft(a, a)
        assert _eq(c, TK.rgemm(a, a, backend="quire_exact"))
        assert rep.detections == 0, sigma
        lu, piv, rep = TD.rgetrf_ft(a, nb=NB)
        lu0, piv0 = TD.rgetrf(a, nb=NB)
        assert _eq(lu, lu0) and _eq(piv, piv0) and rep.detections == 0
        l_p, rep = TD.rpotrf_ft(s, nb=NB)
        assert _eq(l_p, TD.rpotrf(s, nb=NB)) and rep.detections == 0
        q, tau, rep = TQ.rgeqrf_ft(a[:, :N // 2], nb=NB)
        q0, tau0 = TQ.rgeqrf(a[:, :N // 2], nb=NB)
        assert _eq(q, q0) and _eq(tau, tau0) and rep.detections == 0


# --------------------------------------------------------------------------
# 2. seeded plans
# --------------------------------------------------------------------------

PLAN_ARGS = [
    dict(seed=11, site="rgemm.out", size=64, steps=3, n=4,
         kinds=("flip", "nar", "saturate"), devs=4),
    dict(seed=12, site="rgetrf.step", size=N * N, steps=2, n=3,
         kinds=("flip", "nar")),
    dict(seed=14, site="rgemm.limbs", size=80, n=2, nbits=64),
]


@pytest.mark.parametrize("args", PLAN_ARGS, ids=lambda a: a["site"])
def test_make_plan_equals_reference(args):
    got, want = T.make_plan(**args), J.make_plan(**args)
    assert [vars(f) for f in got.faults] == [vars(f) for f in want.faults]
    assert got == T.make_plan(**args) and hash(got) == hash(T.make_plan(
        **args))


@pytest.mark.parametrize("fmt", [P32E2, P16E1, P8E2], ids=lambda f: f.name)
def test_plan_words_and_limbs_equal_reference(fmt):
    rng = np.random.default_rng(7)
    w = _pm(rng, (6, 6), fmt)
    plan = T.make_plan(13, "s", size=36, n=6, kinds=("flip", "nar",
                                                    "saturate"))
    jplan = J.make_plan(13, "s", size=36, n=6, kinds=("flip", "nar",
                                                     "saturate"))
    tw = _t(w.copy())
    got = plan.words("s", 0, tw, fmt)
    assert _eq(got, jplan.words("s", 0, jnp.asarray(w), _jfmt(fmt)))
    assert not _eq(got, w) and _eq(tw, w)           # the input untouched
    assert plan.words("other", 0, tw, fmt) is tw    # no fault: no copy
    limbs = rng.integers(-2**62, 2**62, (5, 16))
    lplan = T.make_plan(14, "rgemm.limbs", size=80, n=2, nbits=64)
    jlplan = J.make_plan(14, "rgemm.limbs", size=80, n=2, nbits=64)
    assert _eq(lplan.limbs("rgemm.limbs", 0, _t(limbs)),
               jlplan.limbs("rgemm.limbs", 0, jnp.asarray(limbs)))


# --------------------------------------------------------------------------
# 3. protected GEMMs and drivers: detection, recovery, reports
# --------------------------------------------------------------------------

def _report(rep):
    return (rep.detections, rep.retries, rep.failed,
            [(s, st, tuple(loc)) for s, st, loc in rep.sites])


def test_rgemm_ft_detects_and_recovers_all_seeds():
    rng = np.random.default_rng(2)
    a, b = _pm(rng, (24, 16)), _pm(rng, (16, 24))
    ref = TK.rgemm(_t(a), _t(b), backend="quire_exact")
    for seed in range(8):
        args = dict(seed=seed, site="rgemm.out", size=24 * 24,
                    kinds=("flip", "nar", "saturate"))
        got, cks, rep = T.rgemm_ft(_t(a), _t(b), plan=T.make_plan(**args))
        _, _, jrep = J.rgemm_ft(jnp.asarray(a), jnp.asarray(b),
                                plan=J.make_plan(**args))
        assert rep.detections == 1 and rep.retries == 1, seed
        assert _report(rep) == _report(jrep), seed
        assert _eq(got, ref), seed
        assert bool(T.verify(got, cks)[0])


def test_quire_gemm_ft_detects_word_and_limb_faults():
    rng = np.random.default_rng(3)
    a, b = _pm(rng, (16, 12)), _pm(rng, (12, 16))
    ref = TK.rgemm(_t(a), _t(b), backend="quire_exact")
    for site, nbits in (("rgemm.out", 32), ("rgemm.limbs", 64)):
        for seed in range(4):
            args = dict(seed=seed, site=site, size=16 * 16, nbits=nbits)
            got, _, rep = T.quire_gemm_ft(_t(a), _t(b),
                                          plan=T.make_plan(**args))
            _, _, jrep = J.quire_gemm_ft(jnp.asarray(a), jnp.asarray(b),
                                         plan=J.make_plan(**args))
            assert rep.detections >= 1, (site, seed)
            assert _report(rep) == _report(jrep), (site, seed)
            assert _eq(got, ref), (site, seed)


def test_abft_error_on_exhausted_budget():
    rng = np.random.default_rng(6)
    a, b = _t(_pm(rng, (8, 8))), _t(_pm(rng, (8, 8)))
    plan = T.FaultPlan((T.Fault(site="rgemm.out", step=0, lane=5, bit=7),))
    with pytest.raises(AbftError):
        T.rgemm_ft(a, b, plan=plan, max_retries=0)
    s = _t(_words(TE.make_spd(N, 1.0, seed=3)))
    plan = T.FaultPlan((T.Fault(site="rpotrf.step", step=1, lane=9, bit=2),))
    with pytest.raises(AbftError, match="rpotrf_ft: step 1"):
        TD.rpotrf_ft(s, nb=NB, plan=plan, max_retries=0)


def _driver_inputs(driver):
    rng = np.random.default_rng(4)
    if driver == "rpotrf":
        x = rng.standard_normal((N, N))
        return _words(x @ x.T + N * np.eye(N))
    return _pm(rng, (N, N))                  # two block steps for QR too


def _run_driver(pkg, driver, a, plan=None):
    """(words tuple, report) of a protected driver of ``pkg``."""
    fn = {"rpotrf": pkg["D"].rpotrf_ft, "rgetrf": pkg["D"].rgetrf_ft,
          "rgeqrf": pkg["Q"].rgeqrf_ft}[driver]
    out = fn(a, nb=NB, plan=plan)
    return tuple(np.asarray(x) for x in out[:-1]), out[-1]


@pytest.mark.parametrize("driver", ["rpotrf", "rgetrf", "rgeqrf"])
def test_protected_drivers_equal_reference(driver):
    """Fault-free: the unprotected words, no detection.  Six seeded
    single faults (flip or NaR, step 0 or 1): detected, recovered to the
    unprotected words, and the reference's report and words."""
    a = _driver_inputs(driver)
    port, ref = dict(D=TD, Q=TQ), dict(D=JD, Q=JQ)
    unprotected = {"rpotrf": lambda: (TD.rpotrf(_t(a), nb=NB),),
                   "rgetrf": lambda: TD.rgetrf(_t(a), nb=NB),
                   "rgeqrf": lambda: TQ.rgeqrf(_t(a), nb=NB)}[driver]()
    words, rep = _run_driver(port, driver, _t(a))
    assert all(_eq(g, w) for g, w in zip(words, unprotected))
    assert (rep.detections, rep.retries) == (0, 0)
    site = f"{driver}.step"
    for seed in range(6):
        args = dict(seed=seed, site=site, size=N * N // 2, steps=2,
                    kinds=("flip", "nar"))
        words, rep = _run_driver(port, driver, _t(a), T.make_plan(**args))
        jwords, jrep = _run_driver(ref, driver, jnp.asarray(a),
                                   J.make_plan(**args))
        assert rep.detections >= 1, seed
        assert _report(rep) == _report(jrep), seed
        assert all(_eq(g, w) for g, w in zip(words, unprotected)), seed
        assert all(_eq(g, w) for g, w in zip(words, jwords)), seed


def test_rgeqrf_ft_detects_tau_fault():
    a = _pm(np.random.default_rng(5), (N, N))
    q0, tau0 = TQ.rgeqrf(_t(a), nb=NB)
    plan = T.FaultPlan((T.Fault(site="rgeqrf.tau", step=1, lane=3, bit=9),))
    q, tau, rep = TQ.rgeqrf_ft(_t(a), nb=NB, plan=plan)
    assert rep.detections == 1 and rep.sites[0][:2] == ("rgeqrf.step", 1)
    assert _eq(q, q0) and _eq(tau, tau0)


# --------------------------------------------------------------------------
# 4. monitored refinement and the guarded ladder
# --------------------------------------------------------------------------

def test_monitored_refinement_matches_refine_pair():
    rng = np.random.default_rng(9)
    a = _t(_words(ti.cond_matrix(N, 1e1, seed=1)))
    b = _t(_pm(rng, (N,)))
    lu, ipiv = TD.rgetrf(a, nb=NB)

    def solve_fn(r):
        return TS.rgetrs(lu, ipiv, r, quire=True)

    def residual_fn(hi, lo, bb):
        return TR.residual_quire(a, hi, bb, lo)
    (hi, lo), info = TR.refine_pair_monitored(solve_fn, residual_fn, b,
                                              max_sweeps=8)
    assert info["outcome"] == "converged" and info["sweeps"] > 0
    hi0, lo0 = TR.refine_pair(solve_fn, residual_fn, b, iters=info["sweeps"])
    assert _eq(hi, hi0) and _eq(lo, lo0)


@pytest.mark.parametrize("case", list(ti.GUARDED_CASES))
def test_guarded_solve_equals_reference(case):
    """The ladder's pair words, its SolveReport field by field and the
    observability record (monitor outcomes, fallbacks, detections) equal
    the reference's; the cases' own outcomes as the reference's tests
    state them."""
    faults = ti.GUARDED_CASES[case]["faults"]
    ta, tb = ti.guarded_problem(case, N)
    a, b = ta.numpy(), tb.numpy()
    plan = jplan = None
    if faults:
        plan = T.FaultPlan(tuple(T.Fault(**f) for f in faults))
        jplan = J.FaultPlan(tuple(J.Fault(**f) for f in faults))
    with TO.scoped() as mt:
        (hi, lo), rep = TR.rgesv_guarded(_t(a), _t(b), nb=NB, plan=plan)
    with JO.scoped() as mj:
        (jhi, jlo), jrep = JR.rgesv_guarded(jnp.asarray(a), jnp.asarray(b),
                                            nb=NB, plan=jplan)
    assert _eq(hi, jhi) and _eq(lo, jlo)
    assert vars(rep) == vars(jrep)
    mismatch = ti.record_mismatch(mt.to_dict(), mj.to_dict())
    assert mismatch is None, mismatch
    if case == "cond 1e4":
        assert rep.solver in ("rgesv_ir", "rgetrs")
        assert rep.fallbacks[0][0] == "rgesv_mp"
        assert rep.fallbacks[0][1] in ("stalled", "diverged")
    else:
        assert rep.outcome == "converged" and rep.solver == "rgesv_mp"
        assert rep.fallbacks == ()
        assert (rep.detections, rep.retries) == ((2, 2) if faults
                                                 else (0, 0))
        x = TR.pair_to_float64(hi, lo).numpy()
        r = TP.to_float64(_t(b)).numpy() - TP.to_float64(_t(a)).numpy() @ x
        bmax = np.abs(TP.to_float64(_t(b)).numpy()).max()
        assert np.abs(r).max() < 1e-8 * bmax


def test_guarded_faults_leave_the_fault_free_answer():
    a, b = ti.guarded_problem("two faults", N)
    pair0, rep0 = TR.rgesv_guarded(a, b, nb=NB)
    plan = T.FaultPlan(tuple(T.Fault(**f) for f in
                             ti.GUARDED_CASES["two faults"]["faults"]))
    pair, rep = TR.rgesv_guarded(a, b, nb=NB, plan=plan)
    assert _eq(pair[0], pair0[0]) and _eq(pair[1], pair0[1])
    assert rep.outcome == rep0.outcome and rep.detections == 2
