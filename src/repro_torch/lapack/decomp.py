"""Blocked Cholesky (Rpotrf) and LU (Rgetrf) in posit arithmetic
(counterpart of ``repro.lapack.decomp``).

Right-looking LAPACK algorithms: the unblocked panels run fully in posit
arithmetic (every scalar op rounded, fused-chain form), and each
trailing-matrix update is ONE ``rgemm(..., alpha=-1, beta=1)`` call, the
paper's offload split.  ``gemm_backend`` selects the accelerator
semantics: 'faithful', 'xla_quire', 'quire_exact', or
'pallas_split3[_comp]' — the Hopper kernel for CUDA tensors
(kernels/posit_gemm.py).

The reference traces the whole blocked schedule into one XLA program; the
port runs it eagerly, one PyTorch op at a time, on the device of the
input.  The panels are therefore host-bound on a GPU (each chain step is a
few dozen small launches).  The words are the reference's: same ops, same
order, same rounding.

One body serves three dispatch shapes, as in the reference:
``rpotrf``/``rgetrf``; ``rpotrf_loop``/``rgetrf_loop``, the same driver
over the word-domain panels ``_potf2_words``/``_getf2_words`` (per-op
fast-backend ``mul``/``sub``/``div``, every intermediate a word: the
reference's measured baseline, bit-identical); and
``rpotrf_batched``/``rgetrf_batched``, a leading batch axis (B, n, n)
carried through the panels, the sweeps and the GEMM, where the reference
``vmap``s the program: B matrices cost one matrix's launches, and each
trailing update is one batched kernel launch.  Pivots are chosen per
matrix.

Observability: with an ``obs.scoped()`` collector open, ``rpotrf`` and
``rgetrf`` of one matrix run in an ``rpotrf``/``rgetrf`` span and record
each block step's golden-zone/regime telemetry (the ``*.step`` series,
the ``*.last_panel.golden_zone`` gauge, the ``*.calls`` counter), the
reference's collect variant; the words are the same.  Their trailing
updates call the un-hooked ``_rgemm``, as the reference's traced bodies
record no ``rgemm``; the ``_loop`` drivers, which the reference runs
eagerly, call the hooked ``rgemm``; a batch records nothing (the
reference ``vmap``s it).

Fault tolerance: ``rpotrf_ft``/``rgetrf_ft`` are host-stepped: each
block step is the unprotected driver's step, then the checksums of the
whole matrix (``repro_torch.ft.abft``), the injection window of a
``FaultPlan``, and verification; a mismatch retries the step from its
verified predecessor.  Fault-free and after recovery their words are
``rpotrf``/``rgetrf``'s.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.ft import abft
from repro_torch.kernels.ops import _rgemm, rgemm
from repro_torch.lapack.blas import (chain_sum, rtrsm_left_lower,
                                     rtrsm_right_lowerT)
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import numerics as _obs_numerics
from repro_torch.obs import trace as _obs_trace


# --------------------------------------------------------------------------
# unblocked panel kernels (all-posit, fused-chain form)
# --------------------------------------------------------------------------

def potf2(a_p: torch.Tensor, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Unblocked lower Cholesky of a ([B,] n, n) posit matrix, dpotf2 op
    order.

    The reference runs the inner chain over all rows and all k < n and
    keeps only rows >= j and steps k < j; the port computes just those
    (the other lanes never reach the output).  The products of column j's
    chain are independent roundings, so they come from one vectorized
    op and only the subtractions run in sequence (``chain_sum`` of the
    negated products): the same words.
    """
    n = a_p.shape[-1]
    a = posit.chain_decode(a_p, fmt)
    for j in range(n):
        # col <- A[j:, j] - A[j:, :j] @ A[j, :j]   (chained over k < j)
        prods = posit.chain_mul(a[..., j:, :j], a[..., j, None, :j], fmt)
        col = chain_sum(a[..., j:, j], -prods, -1, fmt)
        ajj = posit.chain_sqrt(col[..., 0], fmt)
        if j + 1 < n:
            a[..., j + 1:, j] = posit.chain_div(col[..., 1:], ajj[..., None],
                                                fmt)
        a[..., j, j] = ajj
    return posit.chain_encode(a, fmt)


def _swap_rows(a: torch.Tensor, k: int, piv: torch.Tensor) -> None:
    """Swap row ``k`` with row ``piv`` (per matrix: ``piv`` has the batch
    shape) in place."""
    idx = piv[..., None, None].expand(*a.shape[:-2], 1, a.shape[-1])
    rk = a[..., k, :].clone()
    a[..., k, :] = torch.take_along_dim(a, idx, dim=-2)[..., 0, :]
    a.scatter_(-2, idx, rk[..., None, :])


def getf2(a_p: torch.Tensor, nb: int, fmt: PositFormat = P32E2):
    """Unblocked partial-pivot LU of a ([B,] m, nb) posit panel (dgetf2
    order).

    Returns (panel, ipiv) with L strictly below the diagonal (unit diag)
    and U on/above; ipiv ([B,] nb) is 0-based, local to the panel, int32.
    The pivot is the FIRST maximum of |value| over rows >= k, per matrix
    (``torch.argmax`` picks the first, as ``jnp.argmax`` does); NaR never
    pivots.
    """
    m = a_p.shape[-2]
    rows = torch.arange(m, device=a_p.device)
    a = posit.chain_decode(a_p, fmt)
    ipiv = torch.empty((*a.shape[:-2], nb), dtype=torch.int32,
                       device=a_p.device)
    for k in range(nb):
        col = torch.where(rows >= k, a[..., k].abs(), -1.0)
        col = torch.where(torch.isnan(col), -1.0, col)
        piv = torch.argmax(col, dim=-1)
        ipiv[..., k] = piv
        _swap_rows(a, k, piv)
        a[..., k + 1:, k] = posit.chain_div(a[..., k + 1:, k],
                                            a[..., k, k, None], fmt)
        if k + 1 < a.shape[-1]:
            a[..., k + 1:, k + 1:] = posit.chain_sub(
                a[..., k + 1:, k + 1:],
                posit.chain_mul(a[..., k + 1:, k, None],
                                a[..., None, k, k + 1:], fmt), fmt)
    return posit.chain_encode(a, fmt), ipiv


# --------------------------------------------------------------------------
# word-domain panels: the reference's pre-fused-chain implementations, kept
# as the measured baseline of the loop drivers (bit-identical to the chain
# panels; every intermediate round-trips through a posit word)
# --------------------------------------------------------------------------

def _mul(a, b, fmt):
    return posit.mul(a, b, fmt, backend="fast")


def _sub(a, b, fmt):
    return posit.sub(a, b, fmt, backend="fast")


def _div(a, b, fmt):
    return posit.div(a, b, fmt, backend="fast")


def _potf2_words(a_p: torch.Tensor, fmt: PositFormat = P32E2):
    """potf2 with per-op decode/encode through posit words."""
    n = a_p.shape[-1]
    a = a_p.to(torch.int32).clone()
    for j in range(n):
        col = a[..., j:, j]
        for k in range(j):
            col = _sub(col, _mul(a[..., j:, k], a[..., j, k, None], fmt),
                       fmt)
        ajj = posit.sqrt(col[..., 0], fmt, backend="fast")
        if j + 1 < n:
            a[..., j + 1:, j] = _div(col[..., 1:], ajj[..., None], fmt)
        a[..., j, j] = ajj
    return a


def _getf2_words(a_p: torch.Tensor, nb: int, fmt: PositFormat = P32E2):
    """getf2 with per-op decode/encode, pivoting on the |word| pattern.

    Posit words order like their values, so the first maximum of the
    int32 ``abs`` picks the value pivot.  NaR's abs wraps to -2^31, below
    the -1 of the masked rows, so NaR never pivots; the words are not
    widened first, where NaR would become the largest."""
    m = a_p.shape[-2]
    rows = torch.arange(m, device=a_p.device)
    a = a_p.to(torch.int32).clone()
    ipiv = torch.empty((*a.shape[:-2], nb), dtype=torch.int32,
                       device=a_p.device)
    for k in range(nb):
        piv = torch.argmax(torch.where(rows >= k, a[..., k].abs(), -1),
                           dim=-1)
        ipiv[..., k] = piv
        _swap_rows(a, k, piv)
        a[..., k + 1:, k] = _div(a[..., k + 1:, k], a[..., k, k, None], fmt)
        if k + 1 < a.shape[-1]:
            a[..., k + 1:, k + 1:] = _sub(
                a[..., k + 1:, k + 1:],
                _mul(a[..., k + 1:, k, None], a[..., None, k, k + 1:], fmt),
                fmt)
    return a, ipiv


# --------------------------------------------------------------------------
# blocked drivers — one body, three dispatch shapes
# --------------------------------------------------------------------------

def _potrf_step(a, j, nb, gemm_backend, panel, fmt, gemm):
    """Block step ``j`` of the right-looking Cholesky on ``a`` in place:
    factor the diagonal block, solve the panel below it, update the
    trailing matrix with one ``gemm``.  Returns (diagonal block, update
    words or None)."""
    n = a.shape[-1]
    w = min(nb, n - j)
    l11 = panel(a[..., j:j + w, j:j + w], fmt=fmt)
    a[..., j:j + w, j:j + w] = l11
    upd = None
    if j + w < n:
        a21 = rtrsm_right_lowerT(a[..., j + w:, j:j + w], l11, fmt=fmt)
        a[..., j + w:, j:j + w] = a21
        upd = gemm(a21, a21, a[..., j + w:, j + w:], alpha=-1.0, beta=1.0,
                   trans_b=True, backend=gemm_backend, fmt=fmt)
        a[..., j + w:, j + w:] = upd
    return l11, upd


def _rpotrf_body(a_p, nb, gemm_backend, panel, fmt, gemm=None,
                 collect=False):
    """The blocked Cholesky; ``collect=True`` also returns the per-step
    telemetry list of the observed variant (``step_stats`` of each
    diagonal block and trailing update).  ``gemm`` defaults to the
    un-hooked ``_rgemm``, looked up at call time."""
    gemm = gemm or _rgemm
    n = a_p.shape[-1]
    a = a_p.to(torch.int32).clone()
    tel = []
    for j in range(0, n, nb):
        l11, upd = _potrf_step(a, j, nb, gemm_backend, panel, fmt, gemm)
        if collect:
            tel.append(_obs_numerics.factor_step_stats(l11, upd, fmt))
    out = torch.tril(a)
    return (out, tel) if collect else out


def swap_perm(piv: torch.Tensor, rows: int) -> torch.Tensor:
    """Row order produced by applying the swaps (k, piv[..., k]) in turn,
    per matrix (one host read of the ([B,] w) pivots)."""
    def one(p):
        perm = list(range(rows))
        for k, q in enumerate(p):
            perm[k], perm[q] = perm[q], perm[k]
        return perm
    pv = piv.tolist()
    perm = one(pv) if piv.dim() == 1 else [one(p) for p in pv]
    return torch.tensor(perm, device=piv.device)


def permute_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x`` ([B,] r[, c]) with its rows in the order ``perm`` ([B,] r)."""
    dim = perm.dim() - 1
    if x.dim() > perm.dim():
        perm = perm[..., None]
    return torch.take_along_dim(x, perm, dim=dim)


def _getrf_step(a, ipiv, j, nb, gemm_backend, panel_fn, fmt, gemm):
    """Block step ``j`` of the right-looking partial-pivot LU on ``a`` and
    ``ipiv`` in place: factor the panel, apply its row swaps to the rest,
    solve U12, update the trailing matrix with one ``gemm``.  Returns
    (panel words, update words or None)."""
    m, n = a.shape[-2:]
    w = min(nb, min(m, n) - j)
    panel, piv_loc = panel_fn(a[..., j:, j:j + w], w, fmt=fmt)
    # apply the panel's row swaps to the rest of the matrix
    perm = swap_perm(piv_loc, m - j)
    if j > 0:
        a[..., j:, :j] = permute_rows(a[..., j:, :j], perm)
    right = permute_rows(a[..., j:, j + w:], perm)
    a[..., j:, j:j + w] = panel
    ipiv[..., j:j + w] = piv_loc + j
    upd = None
    if j + w < n:
        u12 = rtrsm_left_lower(panel[..., :w, :], right[..., :w, :],
                               unit_diag=True, fmt=fmt)
        a[..., j:j + w, j + w:] = u12
        if j + w < m:
            upd = gemm(panel[..., w:, :], u12, right[..., w:, :], alpha=-1.0,
                       beta=1.0, backend=gemm_backend, fmt=fmt)
            a[..., j + w:, j + w:] = upd
    return panel, upd


def _rgetrf_body(a_p, nb, gemm_backend, panel_fn, fmt, gemm=None,
                 collect=False):
    """The blocked LU; ``collect`` and ``gemm`` as in ``_rpotrf_body``."""
    gemm = gemm or _rgemm
    m, n = a_p.shape[-2:]
    a = a_p.to(torch.int32).clone()
    ipiv = torch.zeros((*a.shape[:-2], min(m, n)), dtype=torch.int32,
                       device=a.device)
    tel = []
    for j in range(0, min(m, n), nb):
        panel, upd = _getrf_step(a, ipiv, j, nb, gemm_backend, panel_fn, fmt,
                                 gemm)
        if collect:
            tel.append(_obs_numerics.factor_step_stats(panel, upd, fmt))
    return (a, ipiv, tel) if collect else (a, ipiv)


def _rpotrf(a_p, nb, gemm_backend, fmt):
    """``rpotrf`` without the observability hook."""
    return _rpotrf_body(a_p, nb, gemm_backend, potf2, fmt)


def _rgetrf(a_p, nb, gemm_backend, fmt):
    """``rgetrf`` without the observability hook."""
    return _rgetrf_body(a_p, nb, gemm_backend, getf2, fmt)


def rpotrf(a_p: torch.Tensor, nb: int = 64, gemm_backend: str = "xla_quire",
           fmt: PositFormat = P32E2) -> torch.Tensor:
    """Blocked lower Cholesky; returns L (strict upper triangle zero).
    Observed when a collector is open and ``a_p`` is one matrix (module
    docstring)."""
    if not (_obs_metrics.enabled() and a_p.dim() == 2):
        return _rpotrf(a_p, nb, gemm_backend, fmt)
    with _obs_trace.span("rpotrf", n=int(a_p.shape[0]), nb=nb,
                         backend=gemm_backend, fmt=fmt.name):
        out, tel = _rpotrf_body(a_p, nb, gemm_backend, potf2, fmt,
                                collect=True)
    _obs_numerics.emit_factor_steps("rpotrf", tel)
    return out


def rgetrf(a_p: torch.Tensor, nb: int = 64, gemm_backend: str = "xla_quire",
           fmt: PositFormat = P32E2):
    """Blocked partial-pivot LU; returns (LU, ipiv) with 0-based int32
    pivots, as the reference.  Observed as ``rpotrf``."""
    if not (_obs_metrics.enabled() and a_p.dim() == 2):
        return _rgetrf(a_p, nb, gemm_backend, fmt)
    with _obs_trace.span("rgetrf", m=int(a_p.shape[0]),
                         n=int(a_p.shape[1]), nb=nb, backend=gemm_backend,
                         fmt=fmt.name):
        lu, ipiv, tel = _rgetrf_body(a_p, nb, gemm_backend, getf2, fmt,
                                     collect=True)
    _obs_numerics.emit_factor_steps("rgetrf", tel)
    return lu, ipiv


def rpotrf_loop(a_p: torch.Tensor, nb: int = 64,
                gemm_backend: str = "xla_quire",
                fmt: PositFormat = P32E2) -> torch.Tensor:
    """``rpotrf`` over the word-domain panels (the reference's measured
    baseline; bit-identical to ``rpotrf``).  The reference runs it
    eagerly, so its GEMMs are the hooked ``rgemm``."""
    return _rpotrf_body(a_p, nb, gemm_backend, _potf2_words, fmt,
                        gemm=rgemm)


def rgetrf_loop(a_p: torch.Tensor, nb: int = 64,
                gemm_backend: str = "xla_quire",
                fmt: PositFormat = P32E2):
    """``rgetrf`` over the word-domain panels (bit-identical; GEMMs
    hooked, as ``rpotrf_loop``'s)."""
    return _rgetrf_body(a_p, nb, gemm_backend, _getf2_words, fmt,
                        gemm=rgemm)


def check_batched(a_p: torch.Tensor) -> torch.Tensor:
    """``a_p`` if it is a (batch, m, n) stack; raises otherwise."""
    if a_p.dim() != 3:
        raise ValueError(f"expected a (batch, m, n) stack, got "
                         f"{tuple(a_p.shape)}")
    return a_p


def rpotrf_batched(a_p: torch.Tensor, nb: int = 64,
                   gemm_backend: str = "xla_quire",
                   fmt: PositFormat = P32E2) -> torch.Tensor:
    """``rpotrf`` of each matrix of a (batch, n, n) stack, as one batched
    run (the §5.1 ensemble shape)."""
    return _rpotrf(check_batched(a_p), nb, gemm_backend, fmt)


def rgetrf_batched(a_p: torch.Tensor, nb: int = 64,
                   gemm_backend: str = "xla_quire",
                   fmt: PositFormat = P32E2):
    """``rgetrf`` of each matrix of a (batch, m, n) stack; returns
    (LU (batch, m, n), ipiv (batch, min(m, n)))."""
    return _rgetrf(check_batched(a_p), nb, gemm_backend, fmt)


# --------------------------------------------------------------------------
# binary32 baselines (library LAPACK in f32, as the reference)
# --------------------------------------------------------------------------

def spotrf(a32: torch.Tensor) -> torch.Tensor:
    """Cholesky in f32 (a batch of matrices too)."""
    return torch.linalg.cholesky(a32.to(torch.float32))


def sgetrf(a32: torch.Tensor):
    """LU in f32; pivots 0-based (``jax.scipy``'s convention), where
    ``torch.linalg.lu_factor`` gives 1-based ones."""
    lu, piv = torch.linalg.lu_factor(a32.to(torch.float32))
    return lu, (piv - 1).to(torch.int32)


# --------------------------------------------------------------------------
# checksum-protected drivers (exact ABFT, repro_torch.ft)
# --------------------------------------------------------------------------

def rpotrf_ft(a_p: torch.Tensor, nb: int = 64,
              gemm_backend: str = "xla_quire", fmt: PositFormat = P32E2,
              plan=None, max_retries: int = 2):
    """Checksum-protected blocked Cholesky: returns (L, FtReport).

    Each block step is ``rpotrf``'s, followed by the checksums of the
    whole matrix, the injection window and verification; a corrupted step
    recomputes from its verified predecessor, so L is ``rpotrf``'s words
    fault-free and after recovery.  Exhausting ``max_retries`` on one
    step raises ``AbftError``.  Injection site ``"rpotrf.step"`` (step =
    j // nb), first attempt only."""
    def attempt(a, j, inject):
        a = a.clone()
        _potrf_step(a, j, nb, gemm_backend, potf2, fmt, _rgemm)
        cks = abft.checksum(a, fmt)
        if inject and plan is not None:
            a = plan.words("rpotrf.step", j // nb, a, fmt)
        ok, bad_row, bad_col = abft.verify(a, cks, fmt)
        return a, bool(ok), bad_row, bad_col

    a, report = abft.run_steps("rpotrf.step", range(0, a_p.shape[0], nb),
                               nb, a_p.to(torch.int32), attempt, max_retries)
    return torch.tril(a), report


def rgetrf_ft(a_p: torch.Tensor, nb: int = 64,
              gemm_backend: str = "xla_quire", fmt: PositFormat = P32E2,
              plan=None, max_retries: int = 2):
    """Checksum-protected blocked partial-pivot LU: returns
    (LU, ipiv, FtReport), (LU, ipiv) ``rgetrf``'s words fault-free and
    after recovery.  Contract as ``rpotrf_ft``; site ``"rgetrf.step"``."""
    m, n = a_p.shape

    def attempt(state, j, inject):
        a, ipiv = state[0].clone(), state[1].clone()
        _getrf_step(a, ipiv, j, nb, gemm_backend, getf2, fmt, _rgemm)
        cks = abft.checksum(a, fmt)
        if inject and plan is not None:
            a = plan.words("rgetrf.step", j // nb, a, fmt)
        ok, bad_row, bad_col = abft.verify(a, cks, fmt)
        return (a, ipiv), bool(ok), bad_row, bad_col

    ipiv = torch.zeros(min(m, n), dtype=torch.int32, device=a_p.device)
    (a, ipiv), report = abft.run_steps(
        "rgetrf.step", range(0, min(m, n), nb), nb,
        (a_p.to(torch.int32), ipiv), attempt, max_retries)
    return a, ipiv, report
