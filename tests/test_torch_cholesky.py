"""The port's blocked Cholesky path (repro_torch.lapack.decomp.rpotrf and
solve.rpotrs) against the JAX package, on the same numpy-made words.

With the ``faithful`` GEMM every op is a separately rounded posit op, so
the factor words and the solution words must be bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lapack import decomp as JD
from repro.lapack import solve as JS
from repro_torch import interop
from repro_torch.core import posit as TP
from repro_torch.lapack import decomp as TD
from repro_torch.lapack import solve as TS

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")


def _words(x):
    """Posit words of numpy-made values, fed to both packages (the port's
    from_float64, pinned bit-identical to the reference's by
    test_torch_posit.py)."""
    return TP.from_float64(torch.from_numpy(np.asarray(x, np.float64))).numpy()


@pytest.mark.parametrize("nb", [16, 32])
@pytest.mark.parametrize("n", [33, 65])
def test_rpotrf_faithful_bit_identical(n, nb):
    rng = np.random.default_rng(100 + n + nb)
    x = rng.standard_normal((n, n))
    s = _words(x.T @ x)
    l_j = JD.rpotrf(jnp.asarray(s), nb=nb, gemm_backend="faithful")
    l_t = TD.rpotrf(interop.words_to_torch(s, "cpu", (n, n)), nb=nb,
                    gemm_backend="faithful")
    assert np.array_equal(interop.words_to_numpy(l_t), np.asarray(l_j))
    b = _words(rng.standard_normal(n))
    assert np.array_equal(TS.rpotrs(l_t, interop.words_to_torch(b, "cpu")).numpy(),
                          np.asarray(JS.rpotrs(l_j, jnp.asarray(b))))
