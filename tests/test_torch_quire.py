"""The port's quire (repro_torch.quire) and rgemm's quire_exact backend
against the JAX package's and the rational oracle, on numpy-made words.

The quire is integer arithmetic, so every test here is bit-identity — of
the rounded words, and where both packages expose it, of the unrounded
int64 limbs — never a tolerance.  Mirrors tests/test_quire.py:36-157 in
all four formats.  The reference's results are computed once per module
(its jitted programs compile once per static argument).
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posit_oracle as O
import torch_inputs as ti
from repro import quire as JQ
from repro.core import formats as JF
from repro.core import posit as JP
from repro.kernels.ops import rgemm as j_rgemm
from repro_torch import interop
from repro_torch import quire as TQ
from repro_torch.core import formats as TF
from repro_torch.core import posit as TP
from repro_torch.kernels.ops import rgemm as t_rgemm

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")

FMTS = ["p32e2", "p16e1", "p8e2", "p8e0"]

# The reference's quire ops, jitted here so that each compiles once
# (eagerly, every op of them compiles on its own).
j_q_to_posit = jax.jit(JQ.q_to_posit, static_argnames=("fmt",))
j_quire_dot = jax.jit(JQ.quire_dot, static_argnames=("fmt", "negate"))
j_qma = jax.jit(JQ.qma, static_argnames=("fmt",))


def _words(rng, shape, name, lo=-20, hi=20):
    return ti.posits(rng, shape, lo, hi, TF.FORMATS[name]).numpy()


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _val(p, fmt):
    return O.decode(int(p), fmt.nbits, fmt.es)


def _oracle_dot(a, b, fmt, init=None, negate=False):
    """Oracle word of round(init + (-1)^negate * sum a*b), NaR-aware."""
    terms = [(_val(x, fmt), _val(y, fmt)) for x, y in zip(a, b)]
    if any(x is None or y is None for x, y in terms):
        return fmt.nar_pattern
    s = sum((x * y for x, y in terms), Fraction(0))
    s = -s if negate else s
    if init is not None:
        iv = _val(init, fmt)
        if iv is None:
            return fmt.nar_pattern
        s += iv
    return O.encode(s, fmt.nbits, fmt.es)


# --------------------------------------------------------------------------
# fdp / quire_dot
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", FMTS)
def test_fdp_matches_oracle_and_jax(name):
    """Mixed magnitudes stress alignment across the whole quire."""
    fmt, jfmt = TF.FORMATS[name], JF.FORMATS[name]
    rng = np.random.default_rng(0)
    span = (-40, 40) if fmt.nbits > 8 else (-6, 6)
    for trial in range(6):
        a = _words(rng, (25,), name, *span)
        b = _words(rng, (25,), name, *(span if trial % 2 else (0, 1)))
        got = int(TQ.fdp(_t(a), _t(b), fmt))
        assert got == _oracle_dot(a, b, fmt), (name, trial)
        assert got == int(np.asarray(j_quire_dot(_j(a), _j(b), fmt=jfmt)))


@pytest.fixture(scope="module")
def dot_case():
    """Per format: a batch of dots with init and negate, and the
    reference's words for it (one reference run per format)."""
    out = {}
    rng = np.random.default_rng(1)
    for name in FMTS:
        fmt = TF.FORMATS[name]
        a = _words(rng, (6, 40), name, -12, 12)
        b = _words(rng, (6, 40), name, -12, 12)
        c = _words(rng, (6,), name, -3, 3)
        a[5, 7] = fmt.nar_pattern                        # poisons row 5
        want = np.asarray(j_quire_dot(_j(a), _j(b), fmt=JF.FORMATS[name],
                                      init_p=_j(c), negate=True))
        out[name] = (a, b, c, want)
    return out


@pytest.mark.parametrize("kc", [None, 1, 7, 40])
@pytest.mark.parametrize("name", FMTS)
def test_quire_dot_init_negate_every_chunking(dot_case, name, kc):
    """Every K chunking (1, 7, K and the default) gives the reference's
    words; rows checked against the oracle too."""
    fmt = TF.FORMATS[name]
    a, b, c, want = dot_case[name]
    got = TQ.quire_dot(_t(a), _t(b), fmt, init_p=_t(c), negate=True,
                       kc=kc).numpy()
    assert np.array_equal(got, want)
    for i in (0, 3, 5):
        assert got[i] == _oracle_dot(a[i], b[i], fmt, c[i], True), i


# --------------------------------------------------------------------------
# qma / qadd_posit / qneg / q_renorm / limb planes: limbs equal too
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", FMTS)
def test_accumulate_ops_limbs_match_jax(name):
    fmt, jfmt = TF.FORMATS[name], JF.FORMATS[name]
    rng = np.random.default_rng(2)
    a, b, c = (_words(rng, (64,), name, -30, 30) for _ in range(3))
    a[3] = fmt.nar_pattern
    neg = rng.random(64) < 0.5
    tq = TQ.qma(TQ.quire_zero((64,), fmt, device="cpu"), _t(a), _t(b), fmt,
                negate=_t(neg))
    tq = TQ.qadd_posit(tq, _t(c), fmt, negate=True)
    jq = j_qma(JQ.quire_zero((64,), jfmt), _j(a), _j(b), fmt=jfmt,
               negate=_j(neg))
    jq = JQ.qadd_posit(jq, _j(c), jfmt, negate=True)
    assert np.array_equal(tq.limbs.numpy(), np.asarray(jq.limbs))
    assert np.array_equal(tq.nar.numpy(), np.asarray(jq.nar))
    want = np.asarray(j_q_to_posit(jq, fmt=jfmt))
    assert np.array_equal(TQ.q_to_posit(tq, fmt).numpy(), want)
    # qneg is exact; q_renorm keeps the value and gives canonical limbs
    assert np.array_equal(TQ.q_to_posit(TQ.qneg(tq), fmt).numpy(),
                          np.asarray(j_q_to_posit(JQ.qneg(jq), fmt=jfmt)))
    tr, jr = TQ.q_renorm(tq), JQ.q_renorm(jq)
    assert np.array_equal(tr.limbs.numpy(), np.asarray(jr.limbs))
    assert np.array_equal(TQ.q_to_posit(tr, fmt).numpy(), want)
    # int32 (lo, hi) planes: the reference's layout, and a round trip
    planes, nar = TQ.to_limbs32(tq)
    jplanes, _ = JQ.to_limbs32(jq)
    assert planes.dtype == torch.int32
    assert np.array_equal(planes.numpy(), np.asarray(jplanes))
    back = TQ.from_limbs32(planes, nar)
    assert torch.equal(back.limbs, tq.limbs) and torch.equal(back.nar,
                                                             tq.nar)
    assert np.array_equal(TQ.quire_from_posit(_t(c), fmt).limbs.numpy(),
                          np.asarray(JQ.quire_from_posit(_j(c), jfmt).limbs))


def test_negative_limbs_use_arithmetic_shift():
    """Limbs that go negative (qneg, negate=True, exact cancellation)
    propagate with a signed >> and round as the reference does."""
    fmt, jfmt = TF.P32E2, JF.P32E2
    rng = np.random.default_rng(3)
    a = _words(rng, (200,), "p32e2", -60, 60)
    b = _words(rng, (200,), "p32e2", -60, 60)
    tq = TQ.qneg(TQ.qma(TQ.quire_zero((200,), fmt, "cpu"), _t(a), _t(b)))
    tq = TQ.qma(tq, _t(a[::-1].copy()), _t(b), negate=True)
    assert bool((tq.limbs < 0).any())
    jq = JQ.qneg(j_qma(JQ.quire_zero((200,), jfmt), _j(a), _j(b),
                       fmt=jfmt))
    jq = j_qma(jq, _j(a[::-1].copy()), _j(b), fmt=jfmt, negate=True)
    assert np.array_equal(tq.limbs.numpy(), np.asarray(jq.limbs))
    assert np.array_equal(TQ.q_to_posit(tq).numpy(),
                          np.asarray(j_q_to_posit(jq, fmt=jfmt)))
    assert np.array_equal(TQ.q_renorm(tq).limbs.numpy(),
                          np.asarray(JQ.q_renorm(jq).limbs))
    # exact cancellation of a negative quire -> the zero word
    q0 = TQ.qadd_posit(TQ.qneg(TQ.quire_from_posit(_t(a))), _t(a))
    assert not bool(TQ.q_to_posit(q0).any())


# --------------------------------------------------------------------------
# specials and the ends of the quire
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", FMTS)
def test_quire_specials_and_extremes(name):
    """NaR poisons, exact cancellation gives +0, maxpos^2 saturates,
    minpos^2 (the quire LSB; its low chunks fall below limb 0) rounds to
    minpos, and the top chunks of maxpos^2 stay in range."""
    fmt, jfmt = TF.FORMATS[name], JF.FORMATS[name]
    one = int(TP.from_float64(torch.tensor(1.0), fmt))
    maxp, minp, nar = fmt.maxpos_pattern, fmt.minpos_pattern, fmt.nar_pattern
    z = TQ.quire_zero((1,), fmt, device="cpu")

    def w(*xs):
        return torch.tensor(xs, dtype=torch.int32)

    q = TQ.qadd_posit(TQ.quire_from_posit(w(one), fmt), w(one), fmt,
                      negate=True)
    assert int(TQ.q_to_posit(q, fmt)[0]) == 0
    assert int(TQ.q_to_posit(TQ.qma(z, w(nar), w(one), fmt), fmt)[0]) == nar
    qs = z
    for _ in range(3):
        qs = TQ.qma(qs, w(maxp), w(maxp), fmt)
    assert int(TQ.q_to_posit(qs, fmt)[0]) == maxp
    assert int(TQ.q_to_posit(TQ.qma(z, w(minp), w(minp), fmt), fmt)[0]) == 1
    q2 = TQ.qma(z, w(one), w(one), fmt)
    assert int(TQ.q_to_posit(TQ.qneg(q2), fmt)[0]) == -one
    # the extremes in one batch, limbs and words against the reference
    a = np.array([minp, -minp, maxp, -maxp, minp, maxp, 0, nar, one], np.int32)
    b = np.array([minp, minp, maxp, maxp, maxp, minp, maxp, one, -minp],
                 np.int32)
    tq = TQ.qma(TQ.quire_zero((9,), fmt, "cpu"), _t(a), _t(b), fmt)
    jq = j_qma(JQ.quire_zero((9,), jfmt), _j(a), _j(b), fmt=jfmt)
    assert np.array_equal(tq.limbs.numpy(), np.asarray(jq.limbs))
    got = TQ.q_to_posit(tq, fmt).numpy()
    assert np.array_equal(got, np.asarray(j_q_to_posit(jq, fmt=jfmt)))
    for i in range(9):
        assert got[i] == _oracle_dot(a[i:i + 1], b[i:i + 1], fmt), i


@pytest.mark.parametrize("name", ["p32e2", "p16e1"])
def test_q_to_posit_ties_and_sticky_match_oracle(name):
    """q_to_posit rounds at width 30 through the shared encode: exact
    ties (p + ulp/2) go to the even pattern, and bits far below the
    30th (p + tiny, p + ulp/2 + tiny) break them."""
    fmt = TF.FORMATS[name]
    rng = np.random.default_rng(4)
    p = _words(rng, (40,), name, -10, 10)
    tiny = _val(fmt.minpos_pattern, fmt)
    cases = []
    for x in p:
        v = _val(x, fmt)
        half = (_val(int(x) + 1, fmt) - v) / 2           # next pattern up
        for terms in ([v, half], [v, half, tiny], [v, half, -tiny],
                      [v, tiny], [v, -tiny]):
            words = [O.encode(t, fmt.nbits, fmt.es) for t in terms]
            assert [_val(wd, fmt) for wd in words] == terms
            cases.append((words + [0] * (3 - len(words)),
                          sum(terms, Fraction(0))))
    q = TQ.quire_zero((len(cases),), fmt, "cpu")
    for j in range(3):
        q = TQ.qadd_posit(q, torch.tensor([c[0][j] for c in cases],
                                          dtype=torch.int32), fmt)
    got = TQ.q_to_posit(q, fmt).tolist()
    want = [O.encode(s, fmt.nbits, fmt.es) for _, s in cases]
    assert got == want


@pytest.mark.parametrize("name", FMTS)
def test_q_to_posit_rounds_reference_limbs(name):
    """The reference's own unrounded limbs (quire_gemm_limbs), carried
    across with interop.quire_to_torch, round in the port to the
    reference's words; quire_to_numpy gives them back unchanged."""
    jfmt, fmt = JF.FORMATS[name], TF.FORMATS[name]
    rng = np.random.default_rng(5)
    a = _words(rng, (9, 30), name, -15, 15)
    b = _words(rng, (30, 7), name, -15, 15)
    a[2, 4] = fmt.nar_pattern
    limbs, nar = JQ.quire_gemm_limbs(_j(a), _j(b), jfmt, negate=True, kc=1,
                                     unroll=1)
    limbs, nar = np.asarray(limbs), np.asarray(nar)
    q = interop.quire_to_torch(limbs, nar, device="cpu")
    want = np.asarray(j_q_to_posit(JQ.Quire(limbs=jnp.asarray(limbs),
                                            nar=jnp.asarray(nar)), fmt=jfmt))
    assert np.array_equal(TQ.q_to_posit(q, fmt).numpy(), want)
    back_limbs, back_nar = interop.quire_to_numpy(q)
    assert np.array_equal(back_limbs, limbs) and np.array_equal(back_nar, nar)
    with pytest.raises(TypeError):
        interop.quire_to_torch(limbs.astype(np.int32), nar, device="cpu")
    with pytest.raises(ValueError):
        interop.quire_to_torch(limbs, nar[:1], device="cpu")


# --------------------------------------------------------------------------
# quire_gemm / quire_gemv / rgemm(backend="quire_exact")
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gemm_case():
    """Per format: ragged operands, C0, and the reference's quire_gemm
    (the alpha=-1, beta=1 form its rgemm issues) and quire_gemv words, at
    its one-column schedule (every schedule gives the same words; this
    one compiles fastest)."""
    out = {}
    rng = np.random.default_rng(6)
    for name in FMTS:
        jfmt = JF.FORMATS[name]
        a = _words(rng, (17, 23), name)
        b = _words(rng, (23, 9), name)
        c = _words(rng, (17, 9), name, -4, 4)
        a[0, 0] = TF.FORMATS[name].nar_pattern
        want = np.asarray(JQ.quire_gemm(_j(a), _j(b), _j(c), jfmt,
                                        negate=True, kc=1, unroll=1))
        want_v = np.asarray(JQ.quire_gemv(_j(a), _j(b[:, 0]), _j(c[:, 0]),
                                          jfmt, kc=1, unroll=1))
        out[name] = (a, b, c, want, want_v)
    return out


@pytest.mark.parametrize("kc,unroll", [(1, 1), (3, 2), (8, 4), (23, 1)])
@pytest.mark.parametrize("name", FMTS)
def test_quire_gemm_and_gemv_every_schedule(gemm_case, name, kc, unroll):
    fmt = TF.FORMATS[name]
    a, b, c, want, want_v = gemm_case[name]
    got = TQ.quire_gemm(_t(a), _t(b), _t(c), fmt, negate=True, kc=kc,
                        unroll=unroll)
    assert np.array_equal(got.numpy(), want)
    got_v = TQ.quire_gemv(_t(a), _t(b[:, 0]), _t(c[:, 0]), fmt, kc=kc,
                          unroll=unroll)
    assert np.array_equal(got_v.numpy(), want_v)


@pytest.mark.parametrize("name", FMTS)
def test_rgemm_quire_exact_trailing_update_fold(gemm_case, name):
    """alpha=-1, beta=1 (every trailing update) is one fused quire op:
    the words of the reference's fused quire_gemm (what its rgemm runs
    for this fold), and each element the oracle's."""
    fmt = TF.FORMATS[name]
    a, b, c, want, _ = gemm_case[name]
    got = t_rgemm(_t(a), _t(b), _t(c), alpha=-1.0, beta=1.0,
                  backend="quire_exact", fmt=fmt).numpy()
    assert np.array_equal(got, want)
    for i in (0, 5, 16):
        for j in (0, 8):
            assert got[i, j] == _oracle_dot(a[i], b[:, j], fmt, c[i, j],
                                            True), (i, j)


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (2.0, -0.5), (-1.0, 0.0),
                                        (0.5, 1.0)])
def test_rgemm_quire_exact_alpha_beta_folds(alpha, beta):
    """The other folds (pre-rounded alpha*A, beta*C; exact negation; C
    unreferenced at beta=0) against the reference, transposes included.
    The reference's rgemm is run for the fold that rounds both scalings;
    the others are its quire_gemm with the operands its rgemm passes."""
    rng = np.random.default_rng(7)
    a, b, c = (_words(rng, s, "p32e2", -6, 6)
               for s in ((11, 14), (14, 7), (11, 7)))
    if (alpha, beta) == (2.0, -0.5):
        want = np.asarray(j_rgemm(_j(a), _j(b), _j(c), alpha=alpha,
                                  beta=beta, backend="quire_exact"))
    else:
        a_in = _j(a)
        if alpha not in (1.0, -1.0):
            a_in = JP.mul(JP.from_float64(jnp.float64(alpha)), a_in,
                          backend="fast")
        want = np.asarray(JQ.quire_gemm(a_in, _j(b),
                                        None if beta == 0.0 else _j(c),
                                        negate=alpha == -1.0, kc=1,
                                        unroll=1))
    got = t_rgemm(_t(a), _t(b), _t(c), alpha=alpha, beta=beta,
                  backend="quire_exact")
    assert np.array_equal(got.numpy(), want)
    got_t = t_rgemm(_t(a.T.copy()), _t(b.T.copy()), _t(c), alpha=alpha,
                    beta=beta, trans_a=True, trans_b=True,
                    backend="quire_exact")
    assert torch.equal(got_t, got)
    if beta == 0.0:
        c_nar = torch.full((11, 7), TF.P32E2.nar_pattern, dtype=torch.int32)
        assert torch.equal(t_rgemm(_t(a), _t(b), c_nar, alpha=alpha,
                                   beta=0.0, backend="quire_exact"), got)


@pytest.mark.parametrize("name", FMTS)
def test_q_to_posit_signed_sums_match_reference(name):
    """q_to_posit on quires of both signs — single products, random sums
    of products and a negated posit, a NaR row and an exact zero — gives
    the reference's words on the same limbs."""
    jfmt, fmt = JF.FORMATS[name], TF.FORMATS[name]
    rng = np.random.default_rng(9)
    span = 30 if fmt.nbits > 8 else 5
    a = _words(rng, (300, 12), name, -span, span)
    b = _words(rng, (300, 12), name, -span, span)
    a[:40, 1:] = 0                                       # single products
    a[40, 0] = fmt.nar_pattern
    q = TQ.qma(TQ.quire_zero((300, 12), fmt, "cpu"), _t(a), _t(b), fmt)
    q = TQ.Quire(limbs=q.limbs.sum(dim=1), nar=q.nar.any(dim=1))
    q = TQ.qadd_posit(q, _t(_words(rng, (300,), name, -span, span)), fmt,
                      negate=_t(rng.random(300) < 0.5))
    q.limbs[41] = 0                                      # exact zero
    got = TQ.q_to_posit(q, fmt).numpy()
    limbs, nar = interop.quire_to_numpy(q)
    want = np.asarray(j_q_to_posit(JQ.Quire(limbs=jnp.asarray(limbs),
                                            nar=jnp.asarray(nar)), fmt=jfmt))
    assert np.array_equal(got, want)
    assert got[40] == fmt.nar_pattern and got[41] == 0
    assert (got < 0).any() and (got > 0).any()
