"""The plain reference of a blocked, partial-pivot posit LU and of its
trailing update, in plain PyTorch, for the benchmark's check.

The algorithm is the paper's right-looking LU (LAPACK's dgetrf schedule):
an unblocked panel of ``nb`` columns with every scalar operation rounded
to the format, its row swaps applied to the rest of the matrix, a unit
lower triangular solve for the block row of U, and one trailing update
``C - A @ B`` per block step.  The update's product is the split
product of the paper's accelerator: each value is cut into an f32 ``hi``
(its top 24 significand bits) and an f32 ``lo`` (the rest, exact), the
product summed as ``hi@hi + (hi@lo + lo@hi)`` in float32, and ``C`` is
subtracted in float64 before the one rounding to the format.
``kernel_product`` sums in the order that defines the program's kernel
(each fma rounded once, emulated exactly in float64), so a sound program
gives the reference's words; ``f32_product`` and ``tf32_product`` are the
controls' products in float32 and on TF32.

Everything runs in the float64 value domain: a value that has been
rounded to the format is exact in float64.  ``rnd`` is the rounding of
the arithmetic: posit rounding for the reference, float32 rounding for
the control that decides whether the check can fail (``f32_round``).

Nothing here imports the program.
"""
from __future__ import annotations

from typing import Callable

import torch

Round = Callable[[torch.Tensor], torch.Tensor]


def f32_round(x: torch.Tensor) -> torch.Tensor:
    """Round f64 values to float32 and back (the control's arithmetic)."""
    return x.to(torch.float32).to(torch.float64)


def split_hi_lo(v: torch.Tensor):
    """Exact f32 pair (hi, lo) of f64 values with at most 28 significand
    bits: hi keeps the top 24 bits (truncated), lo the rest."""
    bits = v.contiguous().view(torch.int64)
    hi = (bits & ~((1 << 29) - 1)).view(torch.float64)
    return hi.to(torch.float32), (v - hi).to(torch.float32)


def _fma32(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor):
    """float32 fma(x, y, acc) rounded once, on f64 tensors that hold
    float32 values.  x * y is exact in f64; TwoSum gives the exact error
    t of the f64 sum s, and t decides the one case where rounding s to
    float32 would round twice: s exactly halfway between two floats."""
    p = x * y
    s = p + acc
    bp = s - p
    t = (p - (s - bp)) + (acc - bp)
    r = s.to(torch.float32).to(torch.float64)
    bits = s.view(torch.int64)
    fix = ((bits & ((1 << 29) - 1)) == (1 << 28)) & (t != 0)
    if bool(fix.any()):
        down = bits & ~((1 << 29) - 1)
        up = down + (1 << 29)
        away = (t > 0) == (s > 0)
        r = torch.where(fix, torch.where(away, up, down).view(torch.float64),
                        r)
    return r


def kernel_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of f64 values ([B,] m, k) @ ([B,] k, n), k <= 128, summed
    as the paper's split product in the order of the Hopper kernel's
    definition (``posit_gemm_simple.cu``): over k in turn,
    ph = fma(ah, bh, ph) and px = fma(al, bh, fma(ah, bl, px)) in float32,
    then ph + px.  Returns the float32 result as f64."""
    if a.shape[-1] > 128:
        raise ValueError("one K chunk of at most 128 columns")
    ah, al = (t.to(torch.float64) for t in split_hi_lo(a))
    bh, bl = (t.to(torch.float64) for t in split_hi_lo(b))
    shape = (*a.shape[:-1], b.shape[-1])
    ph = torch.zeros(shape, dtype=torch.float64, device=a.device)
    px = torch.zeros_like(ph)
    for k in range(a.shape[-1]):
        ahk, alk = ah[..., :, k, None], al[..., :, k, None]
        bhk, blk = bh[..., k, None, :], bl[..., k, None, :]
        ph = _fma32(ahk, bhk, ph)
        px = _fma32(alk, bhk, _fma32(ahk, blk, px))
    return (ph + px).to(torch.float32).to(torch.float64)


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of f64 values with the operands and the sums in float32
    (TF32 off): the float32 control's product.  Returns float64."""
    return (a.to(torch.float32) @ b.to(torch.float32)).to(torch.float64)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 fraction bits (to nearest,
    ties to even), as the tensor cores take them."""
    bits = x.to(torch.float32).view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def tf32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of f64 values with the operands in TF32 and the sums in
    float32: the control's product.  Returns float64."""
    return (tf32_round(a) @ tf32_round(b)).to(torch.float64)


def update(a, b, c, rnd: Round, product=kernel_product) -> torch.Tensor:
    """One trailing update ``rnd(c - product(a, b))`` on f64 values."""
    return rnd(c - product(a, b))


def swaps_to_perm(piv: torch.Tensor, rows: int) -> torch.Tensor:
    """Row order (B, rows) made by the swaps (k, piv[:, k]) in turn."""
    batch = piv.shape[0]
    perm = torch.arange(rows, device=piv.device).repeat(batch, 1)
    for k in range(piv.shape[1]):
        q = piv[:, k:k + 1].to(torch.int64)
        pk = perm[:, k:k + 1].clone()
        perm[:, k:k + 1] = perm.gather(1, q)
        perm.scatter_(1, q, pk)
    return perm


def _rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(x, perm[..., None], dim=-2)


def getf2(p: torch.Tensor, rnd: Round) -> torch.Tensor:
    """Unblocked partial-pivot LU of a (B, m, w) panel of values, in
    place; returns the (B, w) panel-local pivots.  The pivot is the first
    largest |value| on or below the diagonal; NaN never pivots."""
    m, w = p.shape[-2:]
    rows = torch.arange(m, device=p.device)
    piv = torch.empty((p.shape[0], w), dtype=torch.int64, device=p.device)
    for k in range(w):
        col = torch.where(rows >= k, p[..., k].abs(), -1.0)
        col = torch.where(torch.isnan(col), -1.0, col)
        q = torch.argmax(col, dim=-1)
        piv[:, k] = q
        idx = q[:, None, None].expand(-1, 1, w)
        rk = p[:, k, :].clone()
        p[:, k, :] = torch.take_along_dim(p, idx, dim=-2)[:, 0, :]
        p.scatter_(-2, idx, rk[:, None, :])
        p[:, k + 1:, k] = rnd(p[:, k + 1:, k] / p[:, k, k, None])
        if k + 1 < w:
            p[:, k + 1:, k + 1:] = rnd(
                p[:, k + 1:, k + 1:]
                - rnd(p[:, k + 1:, k, None] * p[:, None, k, k + 1:]))
    return piv


def trsm_unit_lower(lw: torch.Tensor, b: torch.Tensor, rnd: Round):
    """X with L X = B, L (B, w, w) unit lower triangular, by forward
    substitution in rank-1-update order; returns a new tensor."""
    b = b.clone()
    w = lw.shape[-1]
    for k in range(w - 1):
        b[:, k + 1:, :] = rnd(b[:, k + 1:, :]
                              - rnd(lw[:, k + 1:, k, None] * b[:, k, None, :]))
    return b


def getrf(a: torch.Tensor, nb: int, rnd: Round, product=kernel_product,
          update_rnd: Round | None = None):
    """Blocked LU of a (B, n, n) stack of f64 values; returns the packed
    factors (L strictly below the diagonal, unit diagonal implied; U on
    and above) as f64 values and the (B, n) 0-based pivots.  ``rnd``
    rounds the panel's and the solve's operations, ``update_rnd`` (``rnd``
    where None) the trailing updates."""
    update_rnd = update_rnd or rnd
    a = a.clone()
    batch, m, n = a.shape
    ipiv = torch.zeros((batch, min(m, n)), dtype=torch.int64,
                       device=a.device)
    for j in range(0, min(m, n), nb):
        w = min(nb, min(m, n) - j)
        panel = a[:, j:, j:j + w].clone()
        piv = getf2(panel, rnd)
        perm = swaps_to_perm(piv, m - j)
        if j > 0:
            a[:, j:, :j] = _rows(a[:, j:, :j], perm)
        right = _rows(a[:, j:, j + w:], perm)
        a[:, j:, j:j + w] = panel
        ipiv[:, j:j + w] = piv + j
        if j + w < n:
            u12 = trsm_unit_lower(panel[:, :w, :], right[:, :w, :], rnd)
            a[:, j:j + w, j + w:] = u12
            if j + w < m:
                a[:, j + w:, j + w:] = update(panel[:, w:, :], u12,
                                              right[:, w:, :], update_rnd,
                                              product)
    return a, ipiv
