"""Rgesv_ir / Rposv_ir — quire-exact iterative refinement — and
Rgesv_mp / Rposv_mp — mixed-precision IR (counterpart of
``repro.lapack.refine``).

The factorization runs in a posit format (Rgetrf/Rpotrf, any rgemm
backend: on a GPU ``pallas_split3`` is the Hopper GEMM kernel), and the
refinement recovers the digits it rounds away, using the quire:

    x_0 = solve(A ~= LU, b)             (quire-exact substitutions)
    repeat: r_i = b - A x_i             (EXACT fused dot per row, ONE
                                         rounding)
            d_i = solve(LU, r_i)
            x_{i+1} = x_i + d_i         (EXACT compensated update)

The iterate is an unevaluated posit pair x = hi + lo; the residual
b - A*(hi+lo) and the renormalization (hi', lo') = twosum(hi + lo + d) are
exact in the quire.  The mixed-precision drivers factor A in a narrow
format (default Posit(16,1)) after a power-of-two equilibration, and run
the correction solve in that format, while the residual and the pair
update stay quire-exact in the working format (default Posit(32,2)).
The reference's module docstring gives the convergence argument.

Same conventions as the reference: b may be (n,) or (n, nrhs), and a 3-D
``a_p`` (batch, n, n) solves each matrix of the batch.  The reference
``vmap``s both; the port loops over columns and matrices and stacks the
results, which gives the same words (each column's ops are its own).
Everything here runs on the device of ``a_p`` without a host sync inside
the loop.

Not ported yet: the observed branch (``_refine_pair_obs`` and the
collector test in ``refine_pair``/``_driver``) waits for the
observability layer (ROADMAP A8); ``refine_pair_monitored``,
``_guarded_cols`` and ``rgesv_guarded`` wait for fault tolerance (A9).
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P16E1, P32E2, PositFormat
from repro_torch.lapack import decomp, solve
from repro_torch.quire import (q_to_posit, qadd_posit, quire_dot,
                               quire_from_posit)


def residual_quire(a_p: torch.Tensor, x_p: torch.Tensor, b_p: torch.Tensor,
                   x_lo_p: torch.Tensor | None = None,
                   fmt: PositFormat = P32E2) -> torch.Tensor:
    """r = b - A (x + x_lo), each component an exact fused dot product
    rounded once; ``x_lo_p`` extends x to an unevaluated posit pair."""
    if x_lo_p is None:
        aa, xx = a_p, x_p
    else:
        aa = torch.cat([a_p, a_p], dim=1)
        xx = torch.cat([x_p, x_lo_p])
    return quire_dot(aa, xx[None, :], fmt, init_p=b_p, negate=True)


def pair_to_float64(x_p: torch.Tensor, x_lo_p: torch.Tensor,
                    fmt: PositFormat = P32E2) -> torch.Tensor:
    """Evaluate an unevaluated posit pair in binary64."""
    return posit.to_float64(x_p, fmt) + posit.to_float64(x_lo_p, fmt)


def refine_pair(solve_fn, residual_fn, b_col: torch.Tensor, iters: int,
                fmt: PositFormat = P32E2):
    """The Wilkinson loop over an abstract solver/residual pair:

        x = solve_fn(b); repeat iters times:
            r = residual_fn(hi, lo, b)      # must be quire-exact
            d = solve_fn(r)
            (hi, lo) = exact twosum(hi + lo + d)

    Returns the posit pair (x_hi, x_lo), both in ``fmt``.
    """
    x_hi = solve_fn(b_col)
    x_lo = torch.zeros_like(x_hi)
    for _ in range(iters):
        r = residual_fn(x_hi, x_lo, b_col)
        d = solve_fn(r)
        # q = hi + lo + d held exactly; hi' = round(q); lo' = round(q - hi')
        q = quire_from_posit(x_hi, fmt)
        q = qadd_posit(q, x_lo, fmt)
        q = qadd_posit(q, d, fmt)
        hi2 = q_to_posit(q, fmt)
        x_lo = q_to_posit(qadd_posit(q, hi2, fmt, negate=True), fmt)
        x_hi = hi2
    return x_hi, x_lo


def _driver(a_p, b_p, solve_fn, iters, fmt: PositFormat = P32E2):
    b_p = b_p.to(torch.int32)

    def residual_fn(hi, lo, b):
        return residual_quire(a_p, hi, b, lo, fmt=fmt)

    def one(b_col):
        return refine_pair(solve_fn, residual_fn, b_col, iters, fmt)
    if b_p.dim() == 1:
        return one(b_p)
    cols = [one(b_p[:, j]) for j in range(b_p.shape[1])]
    return (torch.stack([hi for hi, _ in cols], dim=1),
            torch.stack([lo for _, lo in cols], dim=1))


def _per_matrix(fn, a_p, b_p):
    """Run a driver on each matrix of a 3-D batch and stack every output
    (the reference's vmap over the whole driver)."""
    outs = [fn(a, b) for a, b in zip(a_p, b_p)]

    def stack(*xs):
        if isinstance(xs[0], tuple):
            return tuple(stack(*parts) for parts in zip(*xs))
        return torch.stack(xs)
    return stack(*outs)


def rgesv_ir(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 3,
             nb: int = 32, gemm_backend: str = "xla_quire",
             fmt: PositFormat = P32E2):
    """LU-based solve of A x = b with quire-exact iterative refinement.

    Returns ((x_hi, x_lo), (lu, ipiv)): the solution is the unevaluated
    posit pair x_hi + x_lo (``pair_to_float64`` for its value)."""
    a_p = a_p.to(torch.int32)
    if a_p.dim() == 3:
        return _per_matrix(lambda a, b: rgesv_ir(a, b, iters, nb,
                                                 gemm_backend, fmt), a_p, b_p)
    lu, ipiv = decomp.rgetrf(a_p, nb=nb, gemm_backend=gemm_backend, fmt=fmt)

    def solve_fn(r):
        return solve.rgetrs(lu, ipiv, r, quire=True, fmt=fmt)
    return _driver(a_p, b_p, solve_fn, iters, fmt), (lu, ipiv)


def rposv_ir(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 3,
             nb: int = 32, gemm_backend: str = "xla_quire",
             fmt: PositFormat = P32E2):
    """Cholesky-based SPD solve with quire-exact iterative refinement.
    Returns ((x_hi, x_lo), l); same conventions as ``rgesv_ir``."""
    a_p = a_p.to(torch.int32)
    if a_p.dim() == 3:
        return _per_matrix(lambda a, b: rposv_ir(a, b, iters, nb,
                                                 gemm_backend, fmt), a_p, b_p)
    l_p = decomp.rpotrf(a_p, nb=nb, gemm_backend=gemm_backend, fmt=fmt)

    def solve_fn(r):
        return solve.rpotrs(l_p, r, quire=True, fmt=fmt)
    return _driver(a_p, b_p, solve_fn, iters, fmt), l_p


# --------------------------------------------------------------------------
# mixed-precision IR: narrow-format factorization, working-format residual
# --------------------------------------------------------------------------

def pow2_scale(x64: torch.Tensor) -> torch.Tensor:
    """2^floor(log2(max|x|)) — the exact-in-f64 equilibration scale
    bringing max|x| into [1, 2) (NaN lanes ignored; 1.0 for all-zero).
    The power is read from the bits of max|x|, which equals the
    reference's ``exp2(floor(log2(.)))`` for the decoded posit values it
    is given (normal f64, <= 28-bit significands), on every device; a
    subnormal maximum counts as zero, as under XLA's denormals-are-zero."""
    mx = torch.where(torch.isnan(x64), 0.0, x64).abs().amax()
    expf = (mx.view(torch.int64) >> 52) & 0x7FF
    s = (expf << 52).view(torch.float64)                # 2^(expf - 1023)
    return torch.where(expf > 0, s, 1.0)


def mp_narrow_matrix(a_p, factor_fmt: PositFormat, fmt: PositFormat):
    """A -> (A/s rounded to factor_fmt, s) with s a power of two placing
    max|A| in [1, 2): the narrow format's golden zone.  Exact: s is a
    power of two applied in the f64 carrier."""
    av = posit.to_float64(a_p, fmt)
    s = pow2_scale(av)
    return posit.from_float64(av / s, factor_fmt), s


def _mp_solve_fn(base_solve, a_scale, factor_fmt: PositFormat,
                 fmt: PositFormat):
    """Wrap a factor-format solve as a working-format correction solve:
    equilibrate r by a power of two, round it down to ``factor_fmt``,
    solve there, lift d back up (with the matrix scale folded in)."""
    def solve_fn(r):
        rv = posit.to_float64(r, fmt)
        s = pow2_scale(rv)
        r_lo = posit.from_float64(rv / s, factor_fmt)
        d_lo = posit.to_float64(base_solve(r_lo), factor_fmt)
        return posit.from_float64(d_lo * (s / a_scale), fmt)
    return solve_fn


def rgesv_mp(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 8,
             nb: int = 32, gemm_backend: str = "xla_quire",
             factor_fmt: PositFormat = P16E1, fmt: PositFormat = P32E2):
    """Mixed-precision LU solve: factor A in ``factor_fmt``, refine with
    ``fmt`` quire-exact residuals.  A, b and the pair are ``fmt`` words;
    the returned (lu, ipiv) are ``factor_fmt`` words."""
    a_p = a_p.to(torch.int32)
    if a_p.dim() == 3:
        return _per_matrix(lambda a, b: rgesv_mp(a, b, iters, nb,
                                                 gemm_backend, factor_fmt,
                                                 fmt), a_p, b_p)
    a_lo, a_scale = mp_narrow_matrix(a_p, factor_fmt, fmt)
    lu, ipiv = decomp.rgetrf(a_lo, nb=nb, gemm_backend=gemm_backend,
                             fmt=factor_fmt)

    def base(r16):
        return solve.rgetrs(lu, ipiv, r16, quire=True, fmt=factor_fmt)
    solve_fn = _mp_solve_fn(base, a_scale, factor_fmt, fmt)
    return _driver(a_p, b_p, solve_fn, iters, fmt), (lu, ipiv)


def rposv_mp(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 16,
             nb: int = 32, gemm_backend: str = "xla_quire",
             factor_fmt: PositFormat = P16E1, fmt: PositFormat = P32E2):
    """Mixed-precision SPD solve: Cholesky in ``factor_fmt``, quire-exact
    ``fmt`` refinement.  Returns ((x_hi, x_lo), l) with l in
    ``factor_fmt``.  A barely-SPD A may lose definiteness in the narrow
    rounding; NaR from sqrt then poisons the factor and the pair."""
    a_p = a_p.to(torch.int32)
    if a_p.dim() == 3:
        return _per_matrix(lambda a, b: rposv_mp(a, b, iters, nb,
                                                 gemm_backend, factor_fmt,
                                                 fmt), a_p, b_p)
    a_lo, a_scale = mp_narrow_matrix(a_p, factor_fmt, fmt)
    l_p = decomp.rpotrf(a_lo, nb=nb, gemm_backend=gemm_backend,
                        fmt=factor_fmt)

    def base(r16):
        return solve.rpotrs(l_p, r16, quire=True, fmt=factor_fmt)
    solve_fn = _mp_solve_fn(base, a_scale, factor_fmt, fmt)
    return _driver(a_p, b_p, solve_fn, iters, fmt), l_p
