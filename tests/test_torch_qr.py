"""The port's Householder QR and least-squares solve
(repro_torch.lapack.blas/qr) against the JAX package, on the same
numpy-made words.

Every op of the panels (``rlarfg_chain``, ``geqr2``, ``larft``) and the
sweeps is a separately rounded f64 op, so their words must be
bit-identical.  The blocked drivers are held bit for bit with every GEMM
backend: ``faithful`` and ``quire_exact`` are exact by construction;
``xla_quire`` (one f64 dot, one rounding) and the plain ``pallas_split3``
(f32 accumulation) sum in the library's order, which gives the
reference's words on these inputs.  The batched driver must give each
matrix's 2-D words.  One shape, (20, 12) with nb=8 (a full panel, a
trailing update, and a ragged last panel of 4 columns), keeps the
reference's compiles few: each reference program is traced once and
reused from its cache.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.lapack import blas as JB
from repro.lapack import qr as JQ
from repro_torch.core import posit as TP
from repro_torch.core.formats import P16E1
from repro_torch.lapack import blas as TB
from repro_torch.lapack import qr as TQ

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")


M, N, NB = 20, 12, 8
NAR = np.int32(-2**31)


def _words(x, fmt=None):
    x = torch.from_numpy(np.asarray(x, np.float64))
    return (TP.from_float64(x) if fmt is None
            else TP.from_float64(x, fmt)).numpy()


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    return np.array_equal(np.asarray(got), np.asarray(want))


def _matrix(seed, m=M, n=N, fmt=None):
    return _words(np.random.default_rng(seed).standard_normal((m, n)), fmt)


def test_rlarfg_chain_bit_identical():
    """A random column, an all-zero tail (tau = 0, beta = alpha) and
    alpha == 0 (beta = +norm); batched, each column's reflector."""
    rlarfg = jax.jit(JB.rlarfg_chain, static_argnames=("fmt",))
    col = TP.chain_decode(_t(_matrix(1)[:, 0]))
    rows = torch.arange(M)
    cases = [(2, col), (3, torch.where(rows > 3, 0.0, col)),
             (1, torch.where(rows == 1, 0.0, col))]
    for k, c in cases:
        got = TB.rlarfg_chain(c.clone(), k)
        want = rlarfg(jnp.asarray(c.numpy()), k)
        assert all(_same(g, w) for g, w in zip(got, want)), k
    newcol, v, tau = TB.rlarfg_chain(cases[1][1].clone(), 3)
    assert tau.item() == 0.0 and newcol[3] == cases[1][1][3]
    assert v[3] == 1.0 and not v[4:].any()
    assert TB.rlarfg_chain(cases[2][1].clone(), 1)[0][1] > 0
    stack = torch.stack([cases[0][1], cases[1][1]])
    got = TB.rlarfg_chain(stack.clone(), 2)
    for i in range(2):
        one = TB.rlarfg_chain(stack[i].clone(), 2)
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))


@pytest.mark.parametrize("unit_diag", [False, True])
def test_rtrsm_left_upper_bit_identical(unit_diag):
    """The strict lower triangle (NaR included) is never read."""
    rng = np.random.default_rng(2)
    u = _words(rng.standard_normal((N, N)) + 4 * np.eye(N))
    u[np.tril_indices(N, -1)] = NAR
    b = _words(rng.standard_normal((N, 3)))
    got = TB.rtrsm_left_upper(_t(u), _t(b), unit_diag=unit_diag)
    want = JB.rtrsm_left_upper(jnp.asarray(u), jnp.asarray(b),
                               unit_diag=unit_diag)
    assert _same(got, want) and not TP.is_nar(got).any()
    both = TB.rtrsm_left_upper(_t(np.stack([u, u])), _t(np.stack([b, b])),
                               unit_diag=unit_diag)
    assert _same(both[1], want)


def test_geqr2_and_larft_bit_identical():
    a = _matrix(3)[:, :NB]
    panel, tau = TQ.geqr2(_t(a))
    panel_j, tau_j = JQ.geqr2(jnp.asarray(a))
    assert _same(panel, panel_j) and _same(tau, tau_j)
    v = TQ._v_words(panel, TQ.P32E2)
    t = TQ.larft(v, tau)
    assert _same(t, JQ.larft(jnp.asarray(v.numpy()), jnp.asarray(tau_j)))
    pb, tb = TQ.geqr2(_t(np.stack([a, _matrix(4)[:, :NB]])))
    assert _same(pb[0], panel_j) and _same(tb[0], tau_j)
    assert _same(TQ.larft(TQ._v_words(pb, TQ.P32E2), tb)[0], t)


@pytest.mark.parametrize("backend", ["faithful", "quire_exact", "xla_quire",
                                     "pallas_split3"])
def test_rgeqrf_loop_batched_bit_identical(backend):
    """rgeqrf, rgeqrf_loop and rgeqrf_batched (two matrices) give the
    reference's factor and tau words."""
    a0, a1 = _matrix(5), _matrix(6)
    kw = dict(nb=NB, gemm_backend=backend)
    want = [JQ.rgeqrf(jnp.asarray(a), **kw) for a in (a0, a1)]
    for fn in (TQ.rgeqrf, TQ.rgeqrf_loop):
        q, tau = fn(_t(a0), **kw)
        assert _same(q, want[0][0]) and _same(tau, want[0][1]), fn
    qb, tb = TQ.rgeqrf_batched(_t(np.stack([a0, a1])), **kw)
    for i in range(2):
        assert _same(qb[i], want[i][0]) and _same(tb[i], want[i][1]), i


def test_rormqr_and_rorgqr_bit_identical():
    """Q^T c on a vector c (N=1 GEMMs, the last block's K = 12), Q C on a
    matrix C, and the explicit Q."""
    a = _matrix(7)
    kw = dict(nb=NB, gemm_backend="faithful")
    qr_p, tau = TQ.rgeqrf(_t(a), **kw)
    qr_j, tau_j = JQ.rgeqrf(jnp.asarray(a), **kw)
    assert _same(qr_p, qr_j)
    rng = np.random.default_rng(8)
    c_vec = _words(rng.standard_normal(M))
    c_mat = _words(rng.standard_normal((M, 3)))
    got = TQ.rormqr(qr_p, tau, _t(c_vec), trans=True, **kw)
    assert _same(got, JQ.rormqr(qr_j, tau_j, jnp.asarray(c_vec), trans=True,
                                **kw))
    got = TQ.rormqr(qr_p, tau, _t(c_mat), trans=False, **kw)
    assert _same(got, JQ.rormqr(qr_j, tau_j, jnp.asarray(c_mat),
                                trans=False, **kw))
    q = TQ.rorgqr(qr_p, tau, **kw)
    assert _same(q, JQ.rorgqr(qr_j, tau_j, **kw))
    qv = TP.to_float64(q).numpy()
    assert np.abs(qv.T @ qv - np.eye(N)).max() < 1e-6


def test_rgels_bit_identical():
    """Vector and matrix right-hand sides; rgels_batched gives each
    matrix's words."""
    a0, a1 = _matrix(9), _matrix(10)
    rng = np.random.default_rng(11)
    b_vec = _words(rng.standard_normal(M))
    b_mat = _words(rng.standard_normal((M, 2)))
    kw = dict(nb=NB, gemm_backend="faithful")
    for b in (b_vec, b_mat):
        x, (qr_p, tau) = TQ.rgels(_t(a0), _t(b), **kw)
        x_j, (qr_j, tau_j) = JQ.rgels(jnp.asarray(a0), jnp.asarray(b), **kw)
        assert _same(x, x_j) and _same(qr_p, qr_j) and _same(tau, tau_j)
    xb, _ = TQ.rgels_batched(_t(np.stack([a1, a0])),
                             _t(np.stack([b_mat, b_mat])), **kw)
    assert _same(xb[1], x_j)
    assert _same(xb[0], JQ.rgels(jnp.asarray(a1), jnp.asarray(b_mat),
                                 **kw)[0])
    with pytest.raises(ValueError):
        TQ.rgels(_t(a0.T), _t(b_vec[:N]))


def test_rgeqrf_p16e1_bit_identical():
    a = _matrix(12, fmt=P16E1)
    q, tau = TQ.rgeqrf(_t(a), nb=NB, gemm_backend="faithful", fmt=P16E1)
    q_j, tau_j = JQ.rgeqrf(jnp.asarray(a), nb=NB, gemm_backend="faithful",
                           fmt=JF.P16E1)
    assert _same(q, q_j) and _same(tau, tau_j)


def test_sgels_within_half_digit_of_reference():
    """binary32 least squares is library LAPACK on both sides: its
    backward error within 0.5 decimal digits of the reference's."""
    rng = np.random.default_rng(13)
    a64 = rng.standard_normal((48, 32))
    b64 = a64 @ np.full(32, 1 / np.sqrt(32))

    def err(x):
        return np.linalg.norm(b64 - a64 @ np.asarray(x, np.float64)) \
            / np.linalg.norm(b64)
    got = TQ.sgels(torch.from_numpy(a64).float(), torch.from_numpy(b64)
                   .float())
    want = JQ.sgels(jnp.asarray(a64, jnp.float32),
                    jnp.asarray(b64, jnp.float32))
    assert got.dtype == torch.float32
    assert abs(np.log10(err(got.numpy()) / err(want))) < 0.5
    assert err(got.numpy()) < 1e-5
