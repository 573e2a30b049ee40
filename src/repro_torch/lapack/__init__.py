"""MPLAPACK-style posit linear algebra in PyTorch (the §5.1 path):
Rtrsm/Rtrsv, Rpotrf/Rpotrs, Rgetrf/Rgetrs, the binary32 baselines and the
paper's backward-error protocol."""
from repro_torch.lapack.blas import (rtrsm_left_lower, rtrsm_right_lowerT,
                                     rtrsv_lower, rtrsv_upper)
from repro_torch.lapack.decomp import (getf2, potf2, rgetrf, rpotrf, sgetrf,
                                       spotrf)
from repro_torch.lapack.solve import (rgetrs, rpotrs, rtrtrs, sgetrs,
                                      spotrs)
from repro_torch.lapack.error_eval import (ErrorResult, backward_error_study,
                                           make_general, make_spd)

__all__ = [
    "rtrsm_left_lower", "rtrsm_right_lowerT", "rtrsv_lower", "rtrsv_upper",
    "potf2", "getf2", "rpotrf", "rgetrf", "spotrf", "sgetrf",
    "rpotrs", "rgetrs", "rtrtrs", "spotrs", "sgetrs",
    "ErrorResult", "backward_error_study", "make_spd", "make_general",
]
