"""Rpotrs / Rgetrs / Rtrtrs — solve A x = b from the posit factorizations,
plus binary32 counterparts (counterpart of ``repro.lapack.solve``).

``quire=True`` switches the substitution sweeps to the quire-exact
variants (one rounding per solved component; lapack/blas.py), the
building block of the iterative-refinement drivers in lapack/refine.py.

The plain solves also take a leading batch axis (factors (B, n, n),
right-hand sides (B, n)), where the reference ``vmap``s them; the quire
sweeps are 2-D (the refinement drivers loop over matrices).
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.lapack.decomp import permute_rows, swap_perm
from repro_torch.lapack.blas import (rtrsv_lower, rtrsv_lower_quire,
                                     rtrsv_upper, rtrsv_upper_quire)


def _sweeps(quire: bool):
    if quire:
        return rtrsv_lower_quire, rtrsv_upper_quire
    return rtrsv_lower, rtrsv_upper


def rtrtrs(t_p: torch.Tensor, b_p: torch.Tensor, lower: bool = False,
           unit_diag: bool = False, quire: bool = False,
           fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve T x = b for triangular T (vector b); the opposite triangle of
    ``t_p`` is never referenced."""
    fwd, bwd = _sweeps(quire)
    return (fwd if lower else bwd)(t_p, b_p, unit_diag=unit_diag, fmt=fmt)


def rpotrs(l_p: torch.Tensor, b_p: torch.Tensor, quire: bool = False,
           fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve (L L^T) x = b in posit: forward then backward substitution."""
    lower, upper = _sweeps(quire)
    y = lower(l_p, b_p, unit_diag=False, fmt=fmt)
    return upper(l_p.mT, y, unit_diag=False, fmt=fmt)


def rgetrs(lu_p: torch.Tensor, ipiv: torch.Tensor, b_p: torch.Tensor,
           quire: bool = False, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve (P L U) x = b in posit; ``ipiv`` 0-based, applied in order."""
    lower, upper = _sweeps(quire)
    b = permute_rows(b_p, swap_perm(ipiv, b_p.shape[-1]))
    y = lower(lu_p, b, unit_diag=True, fmt=fmt)
    return upper(lu_p, y, unit_diag=False, fmt=fmt)


def _as_columns(b32: torch.Tensor) -> torch.Tensor:
    b = b32.to(torch.float32)
    return b[:, None] if b.dim() == 1 else b


def spotrs(l32: torch.Tensor, b32: torch.Tensor) -> torch.Tensor:
    x = torch.cholesky_solve(_as_columns(b32), l32, upper=False)
    return x[:, 0] if b32.dim() == 1 else x


def sgetrs(lu32: torch.Tensor, piv: torch.Tensor,
           b32: torch.Tensor) -> torch.Tensor:
    """``piv`` 0-based, as ``sgetrf`` returns it."""
    x = torch.linalg.lu_solve(lu32, (piv + 1).to(torch.int32),
                              _as_columns(b32))
    return x[:, 0] if b32.dim() == 1 else x
