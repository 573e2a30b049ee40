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
elementwise, so the words are the same.

The quire sweeps (``rtrsv_*_quire``) give each solved component ONE
rounding before the divide: its row's inner product is an exact fused dot
(``repro_torch.quire``), as in the reference.  They are n sequential
steps, each a ``quire_dot`` of the whole row against x (whose unsolved
entries are zero words) and a fast-backend divide, queued without a host
sync.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.quire import quire_dot


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


# --------------------------------------------------------------------------
# quire-backed substitutions: one rounding per solved component before the
# divide (the building block of lapack/refine.py)
# --------------------------------------------------------------------------

def _div(a, b, fmt: PositFormat = P32E2):
    """Word-domain rounded divide, for the quire dots' posit results."""
    return posit.div(a, b, fmt, backend="fast")


def _rtrsv_quire(t_p, b_p, unit_diag, fmt, order):
    t_p = t_p.to(torch.int32)
    b_p = b_p.to(torch.int32)
    x = torch.zeros_like(b_p)
    for k in order:
        # x[j] is the zero word for every unsolved j, so the full-row
        # fused dot picks up only the solved part (and a NaR anywhere in
        # the row, as in the reference).
        rk = quire_dot(t_p[k], x, fmt, init_p=b_p[k], negate=True)
        x[k] = rk if unit_diag else _div(rk, t_p[k, k], fmt)
    return x


def rtrsv_lower_quire(l_p: torch.Tensor, b_p: torch.Tensor,
                      unit_diag: bool = False,
                      fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve L x = b with quire-exact rows:
    x_k = round(b_k - fdp(L[k, :k], x[:k])) / L_kk."""
    return _rtrsv_quire(l_p, b_p, unit_diag, fmt, range(l_p.shape[0]))


def rtrsv_upper_quire(u_p: torch.Tensor, b_p: torch.Tensor,
                      unit_diag: bool = False,
                      fmt: PositFormat = P32E2) -> torch.Tensor:
    """Solve U x = b, backward substitution with quire-exact rows."""
    return _rtrsv_quire(u_p, b_p, unit_diag, fmt,
                        range(u_p.shape[0] - 1, -1, -1))
