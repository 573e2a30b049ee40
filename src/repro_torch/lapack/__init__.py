"""MPLAPACK-style posit linear algebra in PyTorch: Rtrsm/Rtrsv (plain and
quire-exact), Rpotrf/Rpotrs, Rgetrf/Rgetrs (with the word-domain ``_loop``
and the ``_batched`` drivers), Householder QR and least squares
(Rgeqrf/Rormqr/Rorgqr/Rgels and their refined forms), the binary32
baselines, the quire iterative-refinement and mixed-precision drivers,
and the paper's backward-error protocol with its batched ensemble, the
refinement, mixed-precision and least-squares studies."""
from repro_torch.lapack.blas import (rlarfg_chain, rtrsm_left_lower,
                                     rtrsm_left_upper, rtrsm_right_lowerT,
                                     rtrsv_lower, rtrsv_lower_quire,
                                     rtrsv_upper, rtrsv_upper_quire)
from repro_torch.lapack.decomp import (getf2, potf2, rgetrf, rgetrf_batched,
                                       rgetrf_loop, rpotrf, rpotrf_batched,
                                       rpotrf_loop, sgetrf, spotrf)
from repro_torch.lapack.solve import (rgetrs, rpotrs, rtrtrs, sgetrs,
                                      spotrs)
from repro_torch.lapack.refine import (mp_narrow_matrix, pair_to_float64,
                                       pow2_scale, refine_pair,
                                       residual_quire, rgesv_ir, rgesv_mp,
                                       rposv_ir, rposv_mp)
from repro_torch.lapack.qr import (geqr2, larft, rgeqrf, rgeqrf_batched,
                                   rgeqrf_loop, rgels, rgels_batched,
                                   rgels_ir, rgels_mp, rorgqr, rormqr,
                                   sgels)
from repro_torch.lapack.error_eval import (ErrorResult, LeastSquaresResult,
                                           MixedPrecisionResult,
                                           RefineResult,
                                           backward_error_ensemble,
                                           backward_error_study,
                                           least_squares_study,
                                           make_general, make_rect,
                                           make_spd,
                                           mixed_precision_study,
                                           refinement_study)

__all__ = [
    "rtrsm_left_lower", "rtrsm_left_upper", "rtrsm_right_lowerT",
    "rtrsv_lower", "rtrsv_upper", "rtrsv_lower_quire", "rtrsv_upper_quire",
    "rlarfg_chain",
    "potf2", "getf2", "rpotrf", "rgetrf", "rpotrf_loop", "rgetrf_loop",
    "rpotrf_batched", "rgetrf_batched", "spotrf", "sgetrf",
    "rpotrs", "rgetrs", "rtrtrs", "spotrs", "sgetrs",
    "residual_quire", "pair_to_float64", "refine_pair", "rgesv_ir",
    "rposv_ir", "pow2_scale", "mp_narrow_matrix", "rgesv_mp", "rposv_mp",
    "geqr2", "larft", "rgeqrf", "rgeqrf_loop", "rgeqrf_batched", "rormqr",
    "rorgqr", "rgels", "rgels_ir", "rgels_mp", "rgels_batched", "sgels",
    "ErrorResult", "backward_error_study", "backward_error_ensemble",
    "make_spd", "make_general", "make_rect",
    "RefineResult", "refinement_study", "MixedPrecisionResult",
    "mixed_precision_study", "LeastSquaresResult", "least_squares_study",
]
