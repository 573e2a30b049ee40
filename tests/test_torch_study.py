"""The port's §5.1 backward-error study and its interop helpers against the
JAX package.

``e_posit`` comes from posit words that are bit-identical between the two
packages (faithful GEMM), pushed through the same numpy formula, so it
must be EQUAL.  ``e_binary32`` comes from two different library LAPACKs
in f32 (jax.scipy vs torch.linalg), whose roundings differ, so it is held
to |log10 ratio| < 0.1 — a tenth of a digit, far below the posit-vs-f32
gap the study measures.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import posit as JP
from repro.lapack import error_eval as JE
from repro_torch import interop
from repro_torch.lapack import error_eval as TE

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")


@pytest.mark.parametrize("algo", ["lu", "cholesky"])
def test_backward_error_study_matches_jax(algo):
    want = JE.backward_error_study(48, 1.0, algo)
    got = TE.backward_error_study(48, 1.0, algo, device="cpu")
    assert got.e_posit == want.e_posit
    assert abs(np.log10(got.e_binary32 / want.e_binary32)) < 0.1
    assert (got.n, got.sigma, got.algo, got.fmt) == (48, 1.0, algo, "p32e2")
    assert np.isfinite(got.digits)


def test_matrix_generators_match():
    for make in ("make_spd", "make_general"):
        assert np.array_equal(getattr(TE, make)(20, 3.0, 5),
                              getattr(JE, make)(20, 3.0, 5))


def test_study_wants_a_gpu_by_default():
    """Entry points that build tensors default to CUDA and raise without
    a GPU; they never fall back to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.backward_error_study(8, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.words_to_torch(np.zeros(3, np.int32))
    with pytest.raises(ValueError):
        TE.backward_error_study(8, 1.0, algo="qr", device="cpu")


def test_interop_round_trip():
    """Words and pivots made by the reference load into port tensors and
    come back unchanged (the factorization tests feed both packages this
    way)."""
    rng = np.random.default_rng(4)
    words = np.asarray(JP.from_float64(jnp.asarray(
        rng.standard_normal((20, 20)))))
    t = interop.words_to_torch(words, device="cpu", shape=(20, 20))
    assert t.dtype == torch.int32
    assert np.array_equal(interop.words_to_numpy(t, shape=(20, 20)), words)
    piv = rng.integers(0, 20, 20).astype(np.int32)
    tp = interop.pivots_to_torch(piv, device="cpu", n=20)
    assert np.array_equal(interop.pivots_to_numpy(tp, n=20), piv)


def test_interop_rejects_bad_input():
    with pytest.raises(TypeError):
        interop.words_to_torch(np.zeros(3, np.int64), device="cpu")
    with pytest.raises(ValueError):
        interop.words_to_torch(np.zeros(3, np.int32), device="cpu",
                               shape=(4,))
    with pytest.raises(ValueError):
        interop.pivots_to_torch(np.zeros((2, 2), np.int32), device="cpu")
    with pytest.raises(ValueError):
        interop.pivots_to_torch(np.array([-1], np.int32), device="cpu")
    with pytest.raises(TypeError):
        interop.words_to_numpy(torch.zeros(3))
