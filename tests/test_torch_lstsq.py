"""The port's least-squares refinement (repro_torch.lapack.qr rgels_ir /
rgels_mp) against the JAX package.

The refinement is quire-exact (residuals, A^T r, the sweeps, the pair
update) and the factorizations run with exact GEMM backends here, so the
pair words must be bit-identical.  ``rgels_ir`` and ``rgels_mp``
equilibrate by ``pow2_scale``, which the reference computes inexactly
under XLA on the CPU (ROADMAP.md §C); as in tests/test_torch_refine.py,
the port runs with the reference's scale substituted to be held to the
reference's words.  One shape, (20, 12) with nb=8, keeps the reference's
compiles few; ``least_squares_study`` is held in
tests/test_torch_lstsq_study.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lapack import qr as JQ
from repro.lapack import refine as JR
from repro_torch.core import posit as TP
from repro_torch.lapack import qr as TQ
from repro_torch.lapack import refine as TR

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")


M, N, NB = 20, 12, 8


def _words(x):
    return TP.from_float64(torch.from_numpy(np.asarray(x, np.float64))
                           ).numpy()


def _t(x):
    return torch.from_numpy(np.array(x))


def _same(got, want):
    return np.array_equal(np.asarray(got), np.asarray(want))


def _problem(seed, nrhs=None):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, N))
    x = np.full(N if nrhs is None else (N, nrhs), 1 / np.sqrt(N))
    return _words(a), _words(a @ x)


@pytest.fixture
def reference_scale(monkeypatch):
    """The port's drivers with the reference's pow2_scale (its values,
    computed by the reference on the same f64 inputs)."""
    def scale(x64):
        s = float(JR.pow2_scale(jnp.asarray(x64.cpu().numpy())))
        return torch.tensor(s, dtype=torch.float64, device=x64.device)
    monkeypatch.setattr(TR, "pow2_scale", scale)


def _check_pair(pair, pair_j):
    assert _same(pair[0].numpy(), pair_j[0])
    assert _same(pair[1].numpy(), pair_j[1])


def test_rgels_ir_quire_exact_bit_identical(reference_scale):
    """x_hi, x_lo and the factors of A / s; a 3-D batch solves each
    matrix."""
    a, b = _problem(1)
    pair, (qr_p, tau) = TQ.rgels_ir(_t(a), _t(b), nb=NB,
                                    gemm_backend="quire_exact")
    pair_j, (qr_j, tau_j) = JQ.rgels_ir(jnp.asarray(a), jnp.asarray(b),
                                        nb=NB, gemm_backend="quire_exact")
    _check_pair(pair, pair_j)
    assert _same(qr_p.numpy(), qr_j) and _same(tau.numpy(), tau_j)
    assert bool(pair[1].any())
    a2, b2 = _problem(2)
    (hb, lb), (qb, _) = TQ.rgels_ir(_t(np.stack([a2, a])),
                                    _t(np.stack([b2, b])), nb=NB,
                                    gemm_backend="quire_exact")
    assert torch.equal(hb[1], pair[0]) and torch.equal(lb[1], pair[1])
    assert torch.equal(qb[1], qr_p)


def test_rgels_mp_quire_exact_bit_identical(reference_scale):
    """Two right-hand sides (columns in turn, the reference vmaps them);
    p16e1 factors of A / s."""
    a, b = _problem(3, nrhs=2)
    pair, (qr_p, tau) = TQ.rgels_mp(_t(a), _t(b), nb=NB,
                                    gemm_backend="quire_exact")
    pair_j, (qr_j, tau_j) = JQ.rgels_mp(jnp.asarray(a), jnp.asarray(b),
                                        nb=NB, gemm_backend="quire_exact")
    _check_pair(pair, pair_j)
    assert _same(qr_p.numpy(), qr_j) and _same(tau.numpy(), tau_j)
    assert pair[0].shape == (N, 2) and bool(pair[1].any())
