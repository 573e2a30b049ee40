"""The port's refinement and mixed-precision studies
(repro_torch.lapack.error_eval) against the JAX package's, on the same
numpy-made §5.1 cells.

The xla_quire GEMM is an f64 dot and the split3 GEMM an f32 sum, whose
order the library picks (torch's matmul here, XLA's in the reference; the
reference runs its Pallas kernel in interpret mode), so factor words may
differ in the last bits and the studies are held to accuracy, not bits:

* ``digits_gained >= 2`` on both sides — the reference's own acceptance
  bar (tests/test_quire.py:172-181);
* the port's backward errors within 0.5 decimal digits of the
  reference's — far below the 6-8 digits refinement gains;
* ``digits_lost < 0.5`` for the mixed-precision cells on both sides
  (benchmarks/bench_formats.py:158, tests/test_formats.py:323-328).

Every study runs at n=48, nb=16 (the reference's drivers compile once
per shape, so the studies share most of their programs); refinement
gains ~8 digits there on both sides, far above the bar.
"""
import numpy as np
import pytest
import torch

from repro.lapack import error_eval as JE
from repro_torch.lapack import error_eval as TE

from cpu_tests import jitted_reference_codec  # noqa: F401

pytestmark = pytest.mark.usefixtures("jitted_reference_codec")

DIGITS = 0.5
CELL = dict(n=48, sigma=1.0, nb=16)


def _digits_apart(x, y):
    return abs(np.log10(max(x, 1e-300) / max(y, 1e-300)))


@pytest.mark.parametrize("algo", ["lu", "cholesky"])
def test_refinement_study_gains_two_digits(algo):
    """xla_quire (the studies' default backend)."""
    got = TE.refinement_study(algo=algo, device="cpu", **CELL)
    want = JE.refinement_study(algo=algo, **CELL)
    assert got.digits_gained >= 2.0 and want.digits_gained >= 2.0, (got,
                                                                   want)
    assert got.e_ir < 1e-12, got
    assert _digits_apart(got.e_ir, want.e_ir) < DIGITS, (got, want)
    assert _digits_apart(got.e_plain, want.e_plain) < DIGITS, (got, want)
    assert (got.n, got.algo, got.iters) == (48, algo, 3)


@pytest.mark.parametrize("algo", ["lu", "cholesky"])
def test_refinement_study_split3_matches_reference(algo):
    """pallas_split3: the kernel's plain version here, the reference's
    Pallas kernel in interpret mode."""
    got = TE.refinement_study(algo=algo, gemm_backend="pallas_split3",
                              device="cpu", **CELL)
    want = JE.refinement_study(algo=algo, gemm_backend="pallas_split3",
                               **CELL)
    assert got.digits_gained >= 2.0 and want.digits_gained >= 2.0
    assert _digits_apart(got.e_ir, want.e_ir) < DIGITS, (got, want)
    assert _digits_apart(got.e_plain, want.e_plain) < DIGITS, (got, want)


@pytest.mark.parametrize("algo", ["lu", "cholesky"])
def test_mixed_precision_study_loses_under_half_a_digit(algo):
    """The p16e1-factor drivers reach the full-width drivers' floor on
    both sides."""
    got = TE.mixed_precision_study(algo=algo, device="cpu", **CELL)
    want = JE.mixed_precision_study(algo=algo, **CELL)
    assert got.digits_lost < 0.5 and want.digits_lost < 0.5, (got, want)
    assert _digits_apart(got.e_mp, want.e_mp) < DIGITS, (got, want)
    assert _digits_apart(got.e_ir, want.e_ir) < DIGITS, (got, want)
    assert got.factor_fmt == "p16e1"


def test_refinement_studies_want_a_gpu_by_default():
    """Like backward_error_study, the studies default to CUDA and raise
    without a GPU; they never fall back to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.refinement_study(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.mixed_precision_study(8)
    with pytest.raises(ValueError):
        TE.refinement_study(8, algo="qr", device="cpu")
