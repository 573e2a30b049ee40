"""MPLAPACK-style posit linear algebra in PyTorch: Rtrsm/Rtrsv (plain and
quire-exact), Rpotrf/Rpotrs, Rgetrf/Rgetrs, the binary32 baselines, the
quire iterative-refinement and mixed-precision drivers, and the paper's
backward-error protocol with the refinement studies."""
from repro_torch.lapack.blas import (rtrsm_left_lower, rtrsm_right_lowerT,
                                     rtrsv_lower, rtrsv_lower_quire,
                                     rtrsv_upper, rtrsv_upper_quire)
from repro_torch.lapack.decomp import (getf2, potf2, rgetrf, rpotrf, sgetrf,
                                       spotrf)
from repro_torch.lapack.solve import (rgetrs, rpotrs, rtrtrs, sgetrs,
                                      spotrs)
from repro_torch.lapack.refine import (mp_narrow_matrix, pair_to_float64,
                                       pow2_scale, refine_pair,
                                       residual_quire, rgesv_ir, rgesv_mp,
                                       rposv_ir, rposv_mp)
from repro_torch.lapack.error_eval import (ErrorResult, MixedPrecisionResult,
                                           RefineResult,
                                           backward_error_study,
                                           make_general, make_spd,
                                           mixed_precision_study,
                                           refinement_study)

__all__ = [
    "rtrsm_left_lower", "rtrsm_right_lowerT", "rtrsv_lower", "rtrsv_upper",
    "rtrsv_lower_quire", "rtrsv_upper_quire",
    "potf2", "getf2", "rpotrf", "rgetrf", "spotrf", "sgetrf",
    "rpotrs", "rgetrs", "rtrtrs", "spotrs", "sgetrs",
    "residual_quire", "pair_to_float64", "refine_pair", "rgesv_ir",
    "rposv_ir", "pow2_scale", "mp_narrow_matrix", "rgesv_mp", "rposv_mp",
    "ErrorResult", "backward_error_study", "make_spd", "make_general",
    "RefineResult", "refinement_study", "MixedPrecisionResult",
    "mixed_precision_study",
]
