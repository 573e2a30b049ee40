"""The port's ``least_squares_study`` against the JAX package's, at
(20, 12) with nb=8.

With ``faithful`` every posit word of the three solves is the
reference's (the refinement words are pinned in test_torch_lstsq.py), so
the errors must be equal, given the reference's inexact ``pow2_scale``
substituted in the port (ROADMAP.md §C).  ``xla_quire`` and the plain
``pallas_split3`` accumulate the factorization's GEMMs otherwise: the
refined errors (on the LS optimum whatever the factor) must lie within
0.5 decimal digits of the faithful ones, and the plain QR solve's within
0.5 digits of the reference's plain ``rgels`` with the same backend.
Both also meet the reference's acceptance (benchmarks/bench_qr.py):
digits_from_opt < 0.1 and digits_lost < 0.5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import posit as JP
from repro.lapack import error_eval as JE
from repro.lapack import qr as JQ
from repro.lapack import refine as JR
from repro_torch.lapack import error_eval as TE
from repro_torch.lapack import refine as TR

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")


M, N, NB, SEED = 20, 12, 8, 4


@pytest.fixture
def reference_scale(monkeypatch):
    """The port's drivers with the reference's pow2_scale."""
    def scale(x64):
        s = float(JR.pow2_scale(jnp.asarray(x64.cpu().numpy())))
        return torch.tensor(s, dtype=torch.float64, device=x64.device)
    monkeypatch.setattr(TR, "pow2_scale", scale)


def _reference_rgels_error(backend):
    """e_qr of the reference's plain rgels on the study's cell."""
    a64 = TE.make_rect(M, N, 1.0, SEED)
    b64 = a64 @ np.full(N, 1 / np.sqrt(N))
    a_p, b_p = JP.from_float64(jnp.asarray(a64)), JP.from_float64(
        jnp.asarray(b64))
    x, _ = JQ.rgels(a_p, b_p, nb=NB, gemm_backend=backend)
    a64q, b64q = np.asarray(JP.to_float64(a_p)), np.asarray(
        JP.to_float64(b_p))
    return JE._backward_error(a64q, np.asarray(JP.to_float64(x)), b64q)


def test_least_squares_study_matches_reference(reference_scale):
    want = JE.least_squares_study(M, N, 1.0, seed=SEED, nb=NB,
                                  gemm_backend="faithful")
    got = TE.least_squares_study(M, N, 1.0, seed=SEED, nb=NB,
                                 gemm_backend="faithful", device="cpu")
    for key in ("e_qr", "e_ir", "e_mp", "e_opt"):
        assert getattr(got, key) == getattr(want, key), key
    assert abs(np.log10(got.e_binary32 / want.e_binary32)) < 0.5
    for backend in ("xla_quire", "pallas_split3"):
        r = TE.least_squares_study(M, N, 1.0, seed=SEED, nb=NB,
                                   gemm_backend=backend, device="cpu")
        for key in ("e_ir", "e_mp"):
            gap = abs(np.log10(getattr(r, key) / getattr(want, key)))
            assert gap < 0.5, (backend, key, gap)
        gap = abs(np.log10(r.e_qr / _reference_rgels_error(backend)))
        assert gap < 0.5, (backend, "e_qr", gap)
        assert r.digits_from_opt < 0.1 and r.digits_lost < 0.5, (backend, r)


def test_least_squares_study_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        TE.least_squares_study(M, N)
