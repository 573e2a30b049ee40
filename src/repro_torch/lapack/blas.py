"""Posit BLAS-2/3 building blocks: triangular solves (counterpart of
``repro.lapack.blas``).

Every scalar operation is a rounded posit op (fast backend) in the working
format ``fmt``, in the operation order of reference-BLAS dtrsm/dtrsv
(rank-1 / axpy form).  The sweeps run in fused-chain form: the operands
decode to f64 once, every op is rounded with ``chain_round``, and words
are encoded once at exit — the same words as per-op fast-backend ops.

The reference computes each step's update over the whole array and masks
the rows (or columns) that are already solved; the port updates only the
unsolved slice, in place in its own f64 working copy.  The rounding is
elementwise, so the words are the same.  The quire sweeps wait for ROADMAP
A2.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat


def rtrsm_left_lower(l_p: torch.Tensor, b_p: torch.Tensor,
                     unit_diag: bool = True,
                     fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve L X = B, L (n,n) lower-triangular posit, B (n, m) posit, by
    forward substitution in rank-1-update order."""
    n = l_p.shape[0]
    lv = posit.chain_decode(l_p, fmt)
    b = posit.chain_decode(b_p, fmt)
    for k in range(n):
        xk = b[k] if unit_diag else posit.chain_div(b[k], lv[k, k], fmt)
        if k + 1 < n:
            b[k + 1:] = posit.chain_sub(
                b[k + 1:], posit.chain_mul(lv[k + 1:, k, None], xk[None, :],
                                           fmt), fmt)
        b[k] = xk
    return posit.chain_encode(b, fmt)


def rtrsm_right_lowerT(b_p: torch.Tensor, l_p: torch.Tensor,
                       fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve X L^T = B (right, lower-transpose, non-unit diag): Cholesky's
    panel update A21 <- A21 * L11^{-T}, right-looking column order."""
    n = l_p.shape[0]
    lv = posit.chain_decode(l_p, fmt)
    b = posit.chain_decode(b_p, fmt)
    for k in range(n):
        xk = posit.chain_div(b[:, k], lv[k, k], fmt)
        if k + 1 < n:
            b[:, k + 1:] = posit.chain_sub(
                b[:, k + 1:], posit.chain_mul(xk[:, None], lv[None, k + 1:, k],
                                              fmt), fmt)
        b[:, k] = xk
    return posit.chain_encode(b, fmt)


def rtrsv_lower(l_p: torch.Tensor, b_p: torch.Tensor,
                unit_diag: bool = False,
                fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve L x = b (vector), forward substitution with posit axpy
    steps."""
    n = l_p.shape[0]
    lv = posit.chain_decode(l_p, fmt)
    b = posit.chain_decode(b_p, fmt)
    for k in range(n):
        xk = b[k] if unit_diag else posit.chain_div(b[k], lv[k, k], fmt)
        if k + 1 < n:
            b[k + 1:] = posit.chain_sub(
                b[k + 1:], posit.chain_mul(lv[k + 1:, k], xk, fmt), fmt)
        b[k] = xk
    return posit.chain_encode(b, fmt)


def rtrsv_upper(u_p: torch.Tensor, b_p: torch.Tensor,
                unit_diag: bool = False,
                fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve U x = b (vector), backward substitution with posit axpy
    steps."""
    n = u_p.shape[0]
    uv = posit.chain_decode(u_p, fmt)
    b = posit.chain_decode(b_p, fmt)
    for k in range(n - 1, -1, -1):
        xk = b[k] if unit_diag else posit.chain_div(b[k], uv[k, k], fmt)
        if k > 0:
            b[:k] = posit.chain_sub(
                b[:k], posit.chain_mul(uv[:k, k], xk, fmt), fmt)
        b[k] = xk
    return posit.chain_encode(b, fmt)
