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

Observability: with a collector open, ``refine_pair`` runs as
``_refine_pair_obs`` (the same ops, one ``ir.sweep`` series row and span a
sweep: residual norm, digits gained, golden-zone occupancy of r, quire
limb carries; the ``ir.sweeps`` counter), and the drivers factor through
the observed ``rgetrf``/``rpotrf``.  A 3-D batch records nothing, as the
reference's ``vmap`` of the whole driver.

Graceful degradation: ``refine_pair_monitored`` (the same sweeps with a
convergence monitor) and ``rgesv_guarded``, the mp -> ir -> plain ladder
on the checksum-protected ``rgetrf_ft``, reporting a ``SolveReport``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P16E1, P32E2, PositFormat
from repro_torch.ft.report import SolveReport
from repro_torch.lapack import decomp, solve
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import numerics as _obs_numerics
from repro_torch.obs import trace as _obs_trace
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


def _pair_update(x_hi, x_lo, d, fmt):
    """(hi', lo', q): q = hi + lo + d held exactly in the quire,
    hi' = round(q), lo' = round(q - hi') (q - hi' is exact)."""
    q = quire_from_posit(x_hi, fmt)
    q = qadd_posit(q, x_lo, fmt)
    q = qadd_posit(q, d, fmt)
    hi2 = q_to_posit(q, fmt)
    return hi2, q_to_posit(qadd_posit(q, hi2, fmt, negate=True), fmt), q


def refine_pair(solve_fn, residual_fn, b_col: torch.Tensor, iters: int,
                fmt: PositFormat = P32E2):
    """The Wilkinson loop over an abstract solver/residual pair:

        x = solve_fn(b); repeat iters times:
            r = residual_fn(hi, lo, b)      # must be quire-exact
            d = solve_fn(r)
            (hi, lo) = exact twosum(hi + lo + d)

    Returns the posit pair (x_hi, x_lo), both in ``fmt``.  With a
    collector open it runs as ``_refine_pair_obs`` (the same words).
    """
    if _obs_metrics.enabled():
        return _refine_pair_obs(solve_fn, residual_fn, b_col, iters, fmt)
    return _refine_pair(solve_fn, residual_fn, b_col, iters, fmt)


def _refine_pair(solve_fn, residual_fn, b_col, iters, fmt):
    """``refine_pair`` without the observability hook."""
    x_hi = solve_fn(b_col)
    x_lo = torch.zeros_like(x_hi)
    for _ in range(iters):
        r = residual_fn(x_hi, x_lo, b_col)
        x_hi, x_lo, _ = _pair_update(x_hi, x_lo, solve_fn(r), fmt)
    return x_hi, x_lo


def _refine_pair_obs(solve_fn, residual_fn, b_col, iters, fmt):
    """The observed Wilkinson loop: ``_refine_pair``'s ops with one
    ``ir.sweep`` span and series row a sweep,

        {sweep, r_norm, digits_gained, golden_frac, limb_carries}

    (``digits_gained`` = log10(||r_0|| / ||r_i||), ``limb_carries`` the
    nonzero carries the pair-update quire releases on read-out), then the
    ``ir.sweeps`` counter.  Each row reads r back to the host."""
    x_hi = solve_fn(b_col)
    x_lo = torch.zeros_like(x_hi)
    r0_norm = None
    for i in range(iters):
        with _obs_trace.span("ir.sweep", sweep=i):
            r = residual_fn(x_hi, x_lo, b_col)
            hi2, lo2, q = _pair_update(x_hi, x_lo, solve_fn(r), fmt)
            r_norm = float(posit.to_float64(r, fmt).abs().max())
            if r0_norm is None:
                r0_norm = r_norm if r_norm > 0 else 1.0
            digits = math.log10(r0_norm / max(r_norm, 1e-300))
            st = _obs_numerics.step_stats(r, fmt)
            carries = _obs_numerics.quire_carry_stats(q.limbs)
            _obs_metrics.record("ir.sweep", sweep=i, r_norm=r_norm,
                                digits_gained=digits,
                                golden_frac=float(st["golden_frac"]),
                                limb_carries=int(carries["total"]))
        x_hi, x_lo = hi2, lo2
    _obs_metrics.inc("ir.sweeps", iters)
    return x_hi, x_lo


def _driver(a_p, b_p, solve_fn, iters, fmt: PositFormat = P32E2,
            observe: bool = True):
    """Refine each column of b (one (n,) b, or the columns of (n, nrhs)
    in turn) against the quire residual of ``a_p``; ``observe=False``
    runs the sweeps un-hooked, where the reference's are traced."""
    b_p = b_p.to(torch.int32)
    pair = refine_pair if observe else _refine_pair

    def residual_fn(hi, lo, b):
        return residual_quire(a_p, hi, b, lo, fmt=fmt)

    def one(b_col):
        return pair(solve_fn, residual_fn, b_col, iters, fmt)
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


def _solve_each(driver, a_p, b_p, *args):
    """``driver(a, b, *args, observe)`` on one matrix, observed (the
    reference calls its parts eagerly), or on each matrix of a 3-D batch,
    un-hooked (the reference ``vmap``s the whole driver)."""
    a_p = a_p.to(torch.int32)
    if a_p.dim() == 3:
        return _per_matrix(lambda a, b: driver(a, b, *args, observe=False),
                           a_p, b_p)
    return driver(a_p, b_p, *args, observe=True)


def rgesv_ir(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 3,
             nb: int = 32, gemm_backend: str = "xla_quire",
             fmt: PositFormat = P32E2):
    """LU-based solve of A x = b with quire-exact iterative refinement.

    Returns ((x_hi, x_lo), (lu, ipiv)): the solution is the unevaluated
    posit pair x_hi + x_lo (``pair_to_float64`` for its value)."""
    return _solve_each(_rgesv_ir, a_p, b_p, iters, nb, gemm_backend, fmt)


def _rgesv_ir(a_p, b_p, iters, nb, gemm_backend, fmt, observe):
    factor = decomp.rgetrf if observe else decomp._rgetrf
    lu, ipiv = factor(a_p, nb, gemm_backend, fmt)

    def solve_fn(r):
        return solve.rgetrs(lu, ipiv, r, quire=True, fmt=fmt)
    return _driver(a_p, b_p, solve_fn, iters, fmt, observe), (lu, ipiv)


def rposv_ir(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 3,
             nb: int = 32, gemm_backend: str = "xla_quire",
             fmt: PositFormat = P32E2):
    """Cholesky-based SPD solve with quire-exact iterative refinement.
    Returns ((x_hi, x_lo), l); same conventions as ``rgesv_ir``."""
    return _solve_each(_rposv_ir, a_p, b_p, iters, nb, gemm_backend, fmt)


def _rposv_ir(a_p, b_p, iters, nb, gemm_backend, fmt, observe):
    factor = decomp.rpotrf if observe else decomp._rpotrf
    l_p = factor(a_p, nb, gemm_backend, fmt)

    def solve_fn(r):
        return solve.rpotrs(l_p, r, quire=True, fmt=fmt)
    return _driver(a_p, b_p, solve_fn, iters, fmt, observe), l_p


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
    return _solve_each(_rgesv_mp, a_p, b_p, iters, nb, gemm_backend,
                       factor_fmt, fmt)


def _rgesv_mp(a_p, b_p, iters, nb, gemm_backend, factor_fmt, fmt, observe):
    a_lo, a_scale = mp_narrow_matrix(a_p, factor_fmt, fmt)
    factor = decomp.rgetrf if observe else decomp._rgetrf
    lu, ipiv = factor(a_lo, nb, gemm_backend, factor_fmt)

    def base(r16):
        return solve.rgetrs(lu, ipiv, r16, quire=True, fmt=factor_fmt)
    solve_fn = _mp_solve_fn(base, a_scale, factor_fmt, fmt)
    return _driver(a_p, b_p, solve_fn, iters, fmt, observe), (lu, ipiv)


def rposv_mp(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 16,
             nb: int = 32, gemm_backend: str = "xla_quire",
             factor_fmt: PositFormat = P16E1, fmt: PositFormat = P32E2):
    """Mixed-precision SPD solve: Cholesky in ``factor_fmt``, quire-exact
    ``fmt`` refinement.  Returns ((x_hi, x_lo), l) with l in
    ``factor_fmt``.  A barely-SPD A may lose definiteness in the narrow
    rounding; NaR from sqrt then poisons the factor and the pair."""
    return _solve_each(_rposv_mp, a_p, b_p, iters, nb, gemm_backend,
                       factor_fmt, fmt)


def _rposv_mp(a_p, b_p, iters, nb, gemm_backend, factor_fmt, fmt, observe):
    a_lo, a_scale = mp_narrow_matrix(a_p, factor_fmt, fmt)
    factor = decomp.rpotrf if observe else decomp._rpotrf
    l_p = factor(a_lo, nb, gemm_backend, factor_fmt)

    def base(r16):
        return solve.rpotrs(l_p, r16, quire=True, fmt=factor_fmt)
    solve_fn = _mp_solve_fn(base, a_scale, factor_fmt, fmt)
    return _driver(a_p, b_p, solve_fn, iters, fmt, observe), l_p


# --------------------------------------------------------------------------
# graceful degradation: convergence monitor + escalation ladder
# --------------------------------------------------------------------------

def refine_pair_monitored(solve_fn, residual_fn, b_col: torch.Tensor,
                          max_sweeps: int, fmt: PositFormat = P32E2,
                          target: float = 1e-10, patience: int = 2,
                          growth: float = 4.0):
    """``refine_pair`` with a host-side convergence monitor: the same
    sweep ops (a run that converges in k sweeps gives
    ``refine_pair(..., iters=k)``'s pair), with each sweep's residual
    norm read back and judged:

    * ``nar``       — NaR in the residual or the iterate: stop.
    * ``diverged``  — ||r|| grew by more than ``growth`` over a sweep and
      exceeds ||r_0||.
    * ``stalled``   — ``patience`` sweeps in a row without halving the
      best ||r|| while above target (also when the budget runs out).
    * ``converged`` — ||r||_inf <= ``target`` * ||b||_inf.

    Returns ((x_hi, x_lo), info) with info's ``outcome``, ``sweeps`` (the
    correction updates applied), ``r_norm`` and ``r_norm0``; counts
    ``ir.monitor.<outcome>`` in the open collectors.
    """
    b_norm = float(posit.to_float64(b_col, fmt).abs().max())
    tol = target * (b_norm if b_norm > 0 else 1.0)
    x_hi = solve_fn(b_col)
    x_lo = torch.zeros_like(x_hi)
    outcome = "stalled"                    # if the sweep budget runs out
    r0_norm = r_norm = float("inf")
    best = float("inf")
    flat = 0
    sweeps = 0
    for i in range(max_sweeps):
        r = residual_fn(x_hi, x_lo, b_col)
        if bool(posit.is_nar(r, fmt).any() | posit.is_nar(x_hi, fmt).any()):
            outcome = "nar"
            break
        prev = r_norm
        r_norm = float(posit.to_float64(r, fmt).abs().max())
        if i == 0:
            r0_norm = r_norm
        if r_norm <= tol:
            outcome = "converged"
            break
        if r_norm > growth * prev and r_norm > r0_norm:
            outcome = "diverged"
            break
        if r_norm > 0.5 * best:
            flat += 1
            if flat >= patience:
                outcome = "stalled"
                break
        else:
            flat = 0
        best = min(best, r_norm)
        x_hi, x_lo, _ = _pair_update(x_hi, x_lo, solve_fn(r), fmt)
        sweeps = i + 1
    info = {"outcome": outcome, "sweeps": sweeps, "r_norm": r_norm,
            "r_norm0": r0_norm}
    _obs_metrics.inc(f"ir.monitor.{outcome}")
    return (x_hi, x_lo), info


def _guarded_cols(a_p, b_p, solve_fn, max_sweeps, fmt, target):
    """The monitored loop per column of b; the info is the WORST column's
    (a rung counts as converged only if every column converged)."""
    b_p = b_p.to(torch.int32)

    def residual_fn(hi, lo, b):
        return residual_quire(a_p, hi, b, lo, fmt=fmt)
    if b_p.dim() == 1:
        return refine_pair_monitored(solve_fn, residual_fn, b_p, max_sweeps,
                                     fmt, target=target)
    rank = {"converged": 0, "stalled": 1, "diverged": 2, "nar": 3}
    cols, worst = [], None
    for j in range(b_p.shape[1]):
        pair, info = refine_pair_monitored(solve_fn, residual_fn, b_p[:, j],
                                           max_sweeps, fmt, target=target)
        cols.append(pair)
        if worst is None or rank[info["outcome"]] > rank[worst["outcome"]]:
            worst = info
    return (torch.stack([hi for hi, _ in cols], dim=1),
            torch.stack([lo for _, lo in cols], dim=1)), worst


def rgesv_guarded(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 8,
                  nb: int = 32, gemm_backend: str = "xla_quire",
                  factor_fmt: PositFormat = P16E1,
                  fmt: PositFormat = P32E2, target: float = 1e-10,
                  plan=None, max_retries: int = 2):
    """Gracefully-degrading LU solve, the full ladder:

        rgesv_mp (narrow factorization, monitored refinement)
          -> stalls / diverges / NaRs ->
        rgesv_ir (full-width factorization, monitored refinement)
          -> still short of target ->
        plain rgetrs on the protected full-width factors
        (outcome="plain")

    Every factorization is the checksum-protected ``rgetrf_ft``: faults
    injected by ``plan`` (the same plan at both rungs, each on its first
    attempt) are detected and repaired before refinement sees them.
    Returns ((x_hi, x_lo), SolveReport); with several right-hand sides
    the report is the worst column's."""
    a_p = a_p.to(torch.int32)
    detections = retries = 0
    fallbacks = []

    # rung 1: mixed precision
    a_lo, a_scale = mp_narrow_matrix(a_p, factor_fmt, fmt)
    lu16, piv16, ft_rep = decomp.rgetrf_ft(a_lo, nb=nb,
                                           gemm_backend=gemm_backend,
                                           fmt=factor_fmt, plan=plan,
                                           max_retries=max_retries)
    detections += ft_rep.detections
    retries += ft_rep.retries

    def base(r16):
        return solve.rgetrs(lu16, piv16, r16, quire=True, fmt=factor_fmt)
    pair, info = _guarded_cols(a_p, b_p,
                               _mp_solve_fn(base, a_scale, factor_fmt, fmt),
                               iters, fmt, target)
    if info["outcome"] == "converged":
        return pair, SolveReport(outcome="converged", solver="rgesv_mp",
                                 sweeps=info["sweeps"],
                                 r_norm=info["r_norm"],
                                 r_norm0=info["r_norm0"],
                                 detections=detections, retries=retries)
    fallbacks.append(("rgesv_mp", info["outcome"]))
    _obs_metrics.inc("ft.fallbacks")

    # rung 2: full-width iterative refinement
    lu, ipiv, ft_rep = decomp.rgetrf_ft(a_p, nb=nb,
                                        gemm_backend=gemm_backend, fmt=fmt,
                                        plan=plan, max_retries=max_retries)
    detections += ft_rep.detections
    retries += ft_rep.retries

    def solve_fn(r):
        return solve.rgetrs(lu, ipiv, r, quire=True, fmt=fmt)
    pair, info = _guarded_cols(a_p, b_p, solve_fn, iters, fmt, target)
    if info["outcome"] == "converged":
        return pair, SolveReport(outcome="converged", solver="rgesv_ir",
                                 sweeps=info["sweeps"],
                                 r_norm=info["r_norm"],
                                 r_norm0=info["r_norm0"],
                                 detections=detections, retries=retries,
                                 fallbacks=tuple(fallbacks))
    fallbacks.append(("rgesv_ir", info["outcome"]))
    _obs_metrics.inc("ft.fallbacks")

    # rung 3: plain backsolve on the (already protected) full factors
    x = solve.rgetrs(lu, ipiv, b_p.to(torch.int32), quire=True, fmt=fmt)
    return (x, torch.zeros_like(x)), SolveReport(
        outcome="plain", solver="rgetrs", sweeps=info["sweeps"],
        r_norm=info["r_norm"], r_norm0=info["r_norm0"],
        detections=detections, retries=retries, fallbacks=tuple(fallbacks))
