"""Blocked Cholesky (Rpotrf) and LU (Rgetrf) in posit arithmetic
(counterpart of ``repro.lapack.decomp``).

Right-looking LAPACK algorithms: the unblocked panels run fully in posit
arithmetic (every scalar op rounded, fused-chain form), and each
trailing-matrix update is ONE ``rgemm(..., alpha=-1, beta=1)`` call, the
paper's offload split.  ``gemm_backend`` selects the accelerator
semantics: 'faithful', 'xla_quire', or 'pallas_split3[_comp]' — the
Hopper kernel for CUDA tensors (kernels/posit_gemm.py).

The reference traces the whole blocked schedule into one XLA program; the
port runs it eagerly, one PyTorch op at a time, on the device of the
input.  The panels are therefore host-bound on a GPU (each chain step is a
few dozen small launches).  The words are the reference's: same ops, same
order, same rounding.  The ``_loop``, ``_batched`` and ``_ft`` drivers
wait (ROADMAP A4, A9).
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.kernels.ops import rgemm
from repro_torch.lapack.blas import rtrsm_left_lower, rtrsm_right_lowerT


# --------------------------------------------------------------------------
# unblocked panel kernels (all-posit, fused-chain form)
# --------------------------------------------------------------------------

def potf2(a_p: torch.Tensor, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Unblocked lower Cholesky of an (n,n) posit matrix, dpotf2 op order.

    The reference runs the inner chain over all rows and all k < n and
    keeps only rows >= j and steps k < j; the port computes just those
    (the other lanes never reach the output), so the words are the same.
    """
    n = a_p.shape[0]
    a = posit.chain_decode(a_p, fmt)
    for j in range(n):
        # col <- A[j:, j] - A[j:, :j] @ A[j, :j]   (chained over k < j)
        col = a[j:, j]
        for k in range(j):
            col = posit.chain_sub(col, posit.chain_mul(a[j:, k], a[j, k],
                                                       fmt), fmt)
        ajj = posit.chain_sqrt(col[0], fmt)
        if j + 1 < n:
            a[j + 1:, j] = posit.chain_div(col[1:], ajj, fmt)
        a[j, j] = ajj
    return posit.chain_encode(a, fmt)


def getf2(a_p: torch.Tensor, nb: int, fmt: PositFormat = P32E2):
    """Unblocked partial-pivot LU of an (m, nb) posit panel (dgetf2 order).

    Returns (panel, ipiv) with L strictly below the diagonal (unit diag)
    and U on/above; ipiv is 0-based, local to the panel, int32.  The pivot
    is the FIRST maximum of |value| over rows >= k (``torch.argmax`` picks
    the first, as ``jnp.argmax`` does); NaR never pivots.
    """
    m = a_p.shape[0]
    rows = torch.arange(m, device=a_p.device)
    a = posit.chain_decode(a_p, fmt)
    ipiv = torch.empty(nb, dtype=torch.int32, device=a_p.device)
    for k in range(nb):
        col = torch.where(rows >= k, a[:, k].abs(), -1.0)
        col = torch.where(torch.isnan(col), -1.0, col)
        piv = torch.argmax(col).view(1)
        ipiv[k] = piv[0]
        rk = a[k].clone()
        a[k] = a.index_select(0, piv)[0]
        a.index_copy_(0, piv, rk[None])
        a[k + 1:, k] = posit.chain_div(a[k + 1:, k], a[k, k], fmt)
        if k + 1 < a.shape[1]:
            a[k + 1:, k + 1:] = posit.chain_sub(
                a[k + 1:, k + 1:],
                posit.chain_mul(a[k + 1:, k, None], a[None, k, k + 1:], fmt),
                fmt)
    return posit.chain_encode(a, fmt), ipiv


# --------------------------------------------------------------------------
# blocked drivers
# --------------------------------------------------------------------------

def rpotrf(a_p: torch.Tensor, nb: int = 64, gemm_backend: str = "xla_quire",
           fmt: PositFormat = P32E2) -> torch.Tensor:
    """Blocked lower Cholesky; returns L (strict upper triangle zero)."""
    n = a_p.shape[0]
    a = a_p.to(torch.int32).clone()
    for j in range(0, n, nb):
        w = min(nb, n - j)
        l11 = potf2(a[j:j + w, j:j + w], fmt=fmt)
        a[j:j + w, j:j + w] = l11
        if j + w < n:
            a21 = rtrsm_right_lowerT(a[j + w:, j:j + w], l11, fmt=fmt)
            a[j + w:, j:j + w] = a21
            a[j + w:, j + w:] = rgemm(a21, a21, a[j + w:, j + w:], alpha=-1.0,
                                      beta=1.0, trans_b=True,
                                      backend=gemm_backend, fmt=fmt)
    return torch.tril(a)


def _swap_perm(piv_loc: torch.Tensor, rows: int) -> torch.Tensor:
    """Row order produced by applying the swaps (k, piv_loc[k]) in turn
    (one host read of the panel's pivots)."""
    perm = list(range(rows))
    for k, p in enumerate(piv_loc.tolist()):
        perm[k], perm[p] = perm[p], perm[k]
    return torch.tensor(perm, device=piv_loc.device)


def rgetrf(a_p: torch.Tensor, nb: int = 64, gemm_backend: str = "xla_quire",
           fmt: PositFormat = P32E2):
    """Blocked partial-pivot LU; returns (LU, ipiv) with 0-based int32
    pivots, as the reference."""
    m, n = a_p.shape
    a = a_p.to(torch.int32).clone()
    ipiv = torch.zeros(min(m, n), dtype=torch.int32, device=a.device)
    for j in range(0, min(m, n), nb):
        w = min(nb, min(m, n) - j)
        panel, piv_loc = getf2(a[j:, j:j + w], w, fmt=fmt)
        # apply the panel's row swaps to the rest of the matrix
        perm = _swap_perm(piv_loc, m - j)
        if j > 0:
            a[j:, :j] = a[j:, :j][perm]
        right = a[j:, j + w:][perm]
        a[j:, j:j + w] = panel
        ipiv[j:j + w] = piv_loc + j
        if j + w < n:
            u12 = rtrsm_left_lower(panel[:w], right[:w], unit_diag=True,
                                   fmt=fmt)
            a[j:j + w, j + w:] = u12
            if j + w < m:
                a[j + w:, j + w:] = rgemm(panel[w:], u12, right[w:],
                                          alpha=-1.0, beta=1.0,
                                          backend=gemm_backend, fmt=fmt)
    return a, ipiv


# --------------------------------------------------------------------------
# binary32 baselines (library LAPACK in f32, as the reference)
# --------------------------------------------------------------------------

def spotrf(a32: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cholesky(a32.to(torch.float32))


def sgetrf(a32: torch.Tensor):
    """LU in f32; pivots 0-based (``jax.scipy``'s convention), where
    ``torch.linalg.lu_factor`` gives 1-based ones."""
    lu, piv = torch.linalg.lu_factor(a32.to(torch.float32))
    return lu, (piv - 1).to(torch.int32)
