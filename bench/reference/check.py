"""The numbers that decide ``correct``, computed in float64 by the
benchmark from the program's outputs and the reference's.

* ``lu_backward_errors``: ||P A - L U||_F / ||A||_F of each matrix of a
  stack, from the packed factors and the pivots, with the residual taken
  over the whole matrix and over the first block step's panel (block
  column 0) and block row of U (rows 0..nb, columns nb..n).  No trailing update precedes those
  two blocks, so their residual is the panel's and the triangular
  solve's rounding alone.
* ``bwd_dev``: the largest |e_program / e_reference - 1| over the
  matrices: how far the program's backward errors stray from those of
  the reference's factorization of the same input.
* ``update_err``: the largest error of a trailing update's values
  against the exact ``C - A @ B``, in units of what the format and a
  float32 product may cost there: half a posit spacing at the exact
  value plus 2^-24 of ``|A| @ |B|``.
"""
from __future__ import annotations

import torch

from reference import posit
from reference.lu import swaps_to_perm

_BLOCK = 10           # matrices per f64 block: ~0.1 GB a tensor at n=1024


def lu_backward_errors(a: torch.Tensor, lu: torch.Tensor,
                       ipiv: torch.Tensor, nb: int) -> dict:
    """(B,) backward errors of packed LU factors (f64 values) with 0-based
    pivots against the f64 values ``a``, under ``whole``, ``panel0`` and
    ``trsm0``; inf where a pivot is out of its range or a value is not
    finite."""
    batch, n, _ = a.shape
    out = {k: torch.empty(batch, dtype=torch.float64, device=a.device)
           for k in ("whole", "panel0", "trsm0")}
    k = torch.arange(ipiv.shape[-1], device=ipiv.device)
    ipiv = ipiv.to(torch.int64)
    bad = ((ipiv < k) | (ipiv >= n)).any(dim=-1)
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    for s in range(0, batch, _BLOCK):
        sl = slice(s, s + _BLOCK)
        f = lu[sl]
        lower = torch.tril(f, -1) + eye
        upper = torch.triu(f)
        perm = swaps_to_perm(ipiv[sl].clamp(0, n - 1), n)
        pa = torch.take_along_dim(a[sl], perm[..., None], dim=-2)
        r = pa - lower @ upper
        norm = torch.linalg.matrix_norm
        whole = norm(a[sl])
        out["whole"][sl] = norm(r) / whole
        out["panel0"][sl] = norm(r[..., :nb]) / whole
        out["trsm0"][sl] = norm(r[..., :nb, nb:]) / whole
    return {k: torch.where(bad | ~torch.isfinite(v), float("inf"), v)
            for k, v in out.items()}


def bwd_dev(e_prog: torch.Tensor, e_ref: torch.Tensor) -> torch.Tensor:
    """|e_prog / e_ref - 1| of each matrix (inf where not finite)."""
    d = (e_prog / e_ref - 1.0).abs()
    return torch.where(torch.isfinite(d), d, float("inf"))


def update_err(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               out: torch.Tensor, fmt: posit.Fmt) -> float:
    """Largest |out - (c - a @ b)| / (ulp/2 + 2^-24 |a| @ |b|) over a
    ([B,] m, n) update, all f64 values; inf where ``out`` is NaN."""
    worst = 0.0
    for s in range(0, a.shape[0], _BLOCK):
        sl = slice(s, s + _BLOCK)
        exact = c[sl] - a[sl] @ b[sl]
        den = 0.5 * posit.ulp(exact, fmt) + 2.0 ** -24 * (a[sl].abs()
                                                         @ b[sl].abs())
        r = (out[sl] - exact).abs() / den
        r = torch.where(torch.isnan(r), float("inf"), r)
        worst = max(worst, float(r.max()))
    return worst
