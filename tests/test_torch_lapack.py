"""The port's posit LAPACK path (repro_torch.lapack) against the JAX
package, on the same numpy-made words.

With the ``faithful`` GEMM every op of the factorizations and solves is a
separately rounded posit op, so factor words, pivots and solutions must be
bit-identical.  The split3 path sums in f32 in a library-chosen order, so
it is held to the xla_quire path's accuracy instead.
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


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("nb", [16, 32])
@pytest.mark.parametrize("n", [33, 65])
def test_rgetrf_faithful_bit_identical(n, nb):
    rng = np.random.default_rng(n + nb)
    a = _words(rng.standard_normal((n, n)))
    lu_j, piv_j = JD.rgetrf(jnp.asarray(a), nb=nb, gemm_backend="faithful")
    lu_t, piv_t = TD.rgetrf(interop.words_to_torch(a, "cpu", (n, n)), nb=nb,
                            gemm_backend="faithful")
    assert np.array_equal(interop.words_to_numpy(lu_t), np.asarray(lu_j))
    assert np.array_equal(interop.pivots_to_numpy(piv_t, n),
                          np.asarray(piv_j))
    b = _words(rng.standard_normal(n))
    x_j = JS.rgetrs(lu_j, piv_j, jnp.asarray(b))
    x_t = TS.rgetrs(lu_t, piv_t, _t(b))
    assert np.array_equal(x_t.numpy(), np.asarray(x_j))


def test_panels_bit_identical():
    rng = np.random.default_rng(8)
    g = _words(rng.standard_normal((64, 24))
               * np.exp2(rng.uniform(-6, 6, (64, 24))))
    p_j, iv_j = JD.getf2(jnp.asarray(g), 24)
    p_t, iv_t = TD.getf2(_t(g), 24)
    assert np.array_equal(p_t.numpy(), np.asarray(p_j))
    assert np.array_equal(iv_t.numpy(), np.asarray(iv_j))


def test_getf2_pivots_first_maximum_and_skips_nar():
    """Ties pick the first maximal row (jnp.argmax's rule); NaR never
    pivots."""
    nar = np.int32(-2**31)
    one, two = _words(np.array([1.0, 2.0]))
    col = np.array([[one], [two], [nar], [-two], [two]], np.int32)
    _, piv = TD.getf2(_t(col), 1)
    _, piv_j = JD.getf2(jnp.asarray(col), 1)
    assert piv.tolist() == [1] == np.asarray(piv_j).tolist()
    col2 = np.array([[nar], [one], [-one]], np.int32)
    assert TD.getf2(_t(col2), 1)[1].tolist() == [1]


def test_binary32_baselines_and_pivot_convention():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((12, 12)).astype(np.float32)
    lu, piv = TD.sgetrf(_t(a))
    lu_j, piv_j = JD.sgetrf(jnp.asarray(a))
    assert piv.dtype == torch.int32
    assert np.array_equal(piv.numpy(), np.asarray(piv_j))   # 0-based both
    b = rng.standard_normal(12).astype(np.float32)
    x = TS.sgetrs(lu, piv, _t(b)).numpy()
    # library LAPACKs differ by f32 roundings: compare residuals
    assert np.linalg.norm(a.astype(np.float64) @ x - b) < 1e-4
    spd = a.T @ a + 12 * np.eye(12, dtype=np.float32)
    l32 = TD.spotrf(_t(spd))
    x2 = TS.spotrs(l32, _t(b)).numpy()
    assert np.linalg.norm(spd.astype(np.float64) @ x2 - b) < 1e-4


@pytest.mark.parametrize("backend", ["pallas_split3", "pallas_split3_comp"])
def test_split3_factorization_accuracy(backend):
    """The kernel's GEMM semantics keep LU within the xla_quire path's
    accuracy (f32 accumulation vs an f64 dot: well under a digit)."""
    rng = np.random.default_rng(10)
    n = 64
    a64 = rng.standard_normal((n, n))
    a = _t(_words(a64))
    b64 = a64 @ np.full(n, 1 / np.sqrt(n))
    b = _t(_words(b64))
    errs = {}
    for be in (backend, "xla_quire"):
        lu, piv = TD.rgetrf(a, nb=32, gemm_backend=be)
        x = TP.to_float64(TS.rgetrs(lu, piv, b)).numpy()
        errs[be] = np.linalg.norm(b64 - a64 @ x) / np.linalg.norm(b64)
    assert abs(np.log10(errs[backend] / errs["xla_quire"])) < 1.0, errs


def test_unported_quire_sweeps_raise():
    """The quire sweeps are ported: rpotrs(quire=True) gives the
    reference's words (tests/test_torch_refine.py covers the rest)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((12, 12))
    l_p = _words(np.linalg.cholesky(x.T @ x + 12 * np.eye(12)))
    b = _words(rng.standard_normal(12))
    got = TS.rpotrs(_t(l_p), _t(b), quire=True)
    want = JS.rpotrs(jnp.asarray(l_p), jnp.asarray(b), quire=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
