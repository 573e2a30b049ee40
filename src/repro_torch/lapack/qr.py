"""Rgeqrf / Rormqr / Rorgqr / Rgels — blocked Householder QR and
quire-exact least squares in posit arithmetic (counterpart of
``repro.lapack.qr``).

* ``geqr2``  — unblocked panel in dgeqr2/dlarfg op order, fused-chain
  form (decode once, ``chain_round`` every op, encode once).
* ``larft``  — forward columnwise T of the block reflector
  H_0 ... H_{w-1} = I - V T V^T, in dlarft's op order.
* ``rgeqrf`` — blocked driver: panel, then three ``rgemm`` calls per block
  (larfb: W = V^T C; W = T^T W; C -= V W), so the trailing updates run on
  the ``gemm_backend`` accelerator: on a GPU with ``pallas_split3`` the
  first two (alpha = 1, beta = 0) take the kernel's fused-encode form and
  the third its f32 form.  ``rgeqrf_batched`` carries a leading batch axis
  through the same body (one kernel launch per GEMM for the batch).
* ``rormqr`` / ``rorgqr`` — apply Q / Q^T from the stored reflectors, or
  materialize Q; V and T are rebuilt from the factored words, bit for bit
  the ones ``rgeqrf`` used.
* ``rgels``  — min ||A x - b||, m >= n: x = R^{-1} (Q^T b)[:n].
* ``rgels_ir`` / ``rgels_mp`` — quire-exact refinement of the LS solution
  (corrected semi-normal equations, Björck): the residual b - A(hi+lo) is
  exact per component, the correction solves R^T R d = A^T r with a
  quire-exact A^T r and quire sweeps, under power-of-two equilibrations;
  ``rgels_mp`` factors in a narrow format (default Posit(16,1)).  The
  reference's ``_ls_driver`` is ``refine._driver`` here: the port's
  ``residual_quire`` takes the rectangular A as it is, and the driver
  loops over right-hand-side columns.
* ``sgels``  — the binary32 baseline.

Where the reference scans every row of a panel and masks the rows that
are done (the dlarfg norm, v^T A, the Gram matrix V^T V, the T columns),
the port computes the live lanes only, and it takes the products of a
scan in one vectorized op: each product is its own rounding, so only the
chained adds run in sequence, in ascending order, and the words are the
same.  As in the decompositions, the port runs eagerly, so the panels are
host-bound on a GPU.

Not ported yet: the checksum-protected ``rgeqrf_ft`` (fault tolerance,
ROADMAP A9) and the observed ``collect`` variant of ``rgeqrf``
(observability, A8).

All matrices are int32 posit words of the format ``fmt``.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P16E1, P32E2, PositFormat
from repro_torch.kernels.ops import rgemm
from repro_torch.lapack import refine, solve
from repro_torch.lapack.blas import chain_sum, rlarfg_chain, rtrsm_left_upper
from repro_torch.lapack.decomp import check_batched
from repro_torch.quire import quire_gemv


# --------------------------------------------------------------------------
# unblocked panel (all-posit, fused-chain form)
# --------------------------------------------------------------------------

def geqr2(a_p: torch.Tensor, fmt: PositFormat = P32E2):
    """Unblocked Householder QR of a ([B,] m, w) posit panel (m >= w),
    dgeqr2 op order.  Returns (panel, tau): R on/above the diagonal, the
    reflector tails below it (v_k = 1 implicit), and the ([B,] w) tau
    words."""
    w = a_p.shape[-1]
    a = posit.chain_decode(a_p, fmt)
    taus = a.new_zeros((*a.shape[:-2], w))
    for k in range(w):
        newcol, v, tau = rlarfg_chain(a[..., k], k, fmt)
        if k + 1 < w:
            # wvec = v^T A over the columns > k, chained down the rows > k
            # from A[k, :] (v_k = 1 contributes it exactly); then
            # A -= v (tau wvec) on rows >= k.
            prods = posit.chain_mul(v[..., k + 1:, None],
                                    a[..., k + 1:, k + 1:], fmt)
            wvec = chain_sum(a[..., k, k + 1:], prods, -2, fmt)
            t = posit.chain_mul(tau[..., None], wvec, fmt)
            a[..., k:, k + 1:] = posit.chain_sub(
                a[..., k:, k + 1:],
                posit.chain_mul(v[..., k:, None], t[..., None, :], fmt), fmt)
        a[..., k] = newcol
        taus[..., k] = tau
    return posit.chain_encode(a, fmt), posit.chain_encode(taus, fmt)


def larft(v_p: torch.Tensor, tau_p: torch.Tensor,
          fmt: PositFormat = P32E2) -> torch.Tensor:
    """Forward columnwise T ([B,] w, w) of the block reflector (dlarft):
    H_0 ... H_{w-1} = I - V T V^T, T upper-triangular.

    G = V^T V by row-ascending chained adds (the unit trapezoid's zeros
    included, as in the reference), then per column j: T[:j, j] =
    T[:j, :j] @ (-tau_j G[:j, j]) as a chained trmv, T[j, j] = tau_j.
    """
    w = v_p.shape[-1]
    v = posit.chain_decode(v_p, fmt)
    tau = posit.chain_decode(tau_p, fmt)
    gram = posit.chain_mul(v[..., :, :, None], v[..., :, None, :], fmt)
    g = chain_sum(v.new_zeros((*v.shape[:-2], w, w)), gram, -3, fmt)
    t = v.new_zeros((*v.shape[:-2], w, w))
    for j in range(w):
        if j:
            h = posit.chain_mul(-tau[..., j, None], g[..., :j, j], fmt)
            t[..., :j, j] = chain_sum(
                v.new_zeros((*v.shape[:-2], j)),
                posit.chain_mul(t[..., :j, :j], h[..., None, :], fmt), -1,
                fmt)
        t[..., j, j] = tau[..., j]
    return posit.chain_encode(t, fmt)


def _v_words(panel_p: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """Unit-lower-trapezoid reflector words V from a factored panel: the
    below-diagonal tails, an exact 1 on the diagonal, exact 0 above."""
    mj, w = panel_p.shape[-2:]
    rows = torch.arange(mj, device=panel_p.device)[:, None]
    cols = torch.arange(w, device=panel_p.device)[None, :]
    one = posit.from_float64(torch.tensor(1.0, dtype=torch.float64,
                                          device=panel_p.device), fmt)
    return torch.where(rows > cols, panel_p,
                       torch.where(rows == cols, one, 0))


def _r_words(qr_p: torch.Tensor, n: int) -> torch.Tensor:
    """Upper-triangular R words from a factored matrix (reflector tails
    zeroed; posit word 0 is the value 0)."""
    return torch.triu(qr_p[..., :n, :n])


def _apply_block(c_p: torch.Tensor, v_w: torch.Tensor, t_w: torch.Tensor,
                 trans: bool, gemm_backend: str,
                 fmt: PositFormat) -> torch.Tensor:
    """larfb: C <- (I - V T V^T) C (T^T for trans=True) as three Rgemm
    calls; V^T and T^T are transposed views, which the kernel's pre-pass
    reads through their strides."""
    w1 = rgemm(v_w, c_p, trans_a=True, backend=gemm_backend, fmt=fmt)
    w2 = rgemm(t_w, w1, trans_a=trans, backend=gemm_backend, fmt=fmt)
    return rgemm(v_w, w2, c_p, alpha=-1.0, beta=1.0, backend=gemm_backend,
                 fmt=fmt)


# --------------------------------------------------------------------------
# blocked drivers
# --------------------------------------------------------------------------

def rgeqrf(a_p: torch.Tensor, nb: int = 32, gemm_backend: str = "xla_quire",
           fmt: PositFormat = P32E2):
    """Blocked Householder QR of a ([B,] m, n) matrix; returns (QR, tau):
    R on/above the diagonal, the reflector tails below it, and the
    ([B,] min(m, n)) tau words."""
    m, n = a_p.shape[-2:]
    kk = min(m, n)
    a = a_p.to(torch.int32).clone()
    taus = torch.zeros((*a.shape[:-2], kk), dtype=torch.int32,
                       device=a.device)
    for j in range(0, kk, nb):
        w = min(nb, kk - j)
        panel, tau = geqr2(a[..., j:, j:j + w], fmt=fmt)
        a[..., j:, j:j + w] = panel
        taus[..., j:j + w] = tau
        if j + w < n:
            v_w = _v_words(panel, fmt)
            t_w = larft(v_w, tau, fmt=fmt)
            a[..., j:, j + w:] = _apply_block(a[..., j:, j + w:], v_w, t_w,
                                              True, gemm_backend, fmt)
    return a, taus


def rgeqrf_loop(a_p: torch.Tensor, nb: int = 32,
                gemm_backend: str = "xla_quire", fmt: PositFormat = P32E2):
    """The reference's dispatch-per-block driver over the same blocks as
    ``rgeqrf``: the port dispatches every op eagerly either way, so it is
    ``rgeqrf`` (bit-identical, as the reference's is)."""
    return rgeqrf(a_p, nb, gemm_backend, fmt)


def rgeqrf_batched(a_p: torch.Tensor, nb: int = 32,
                   gemm_backend: str = "xla_quire",
                   fmt: PositFormat = P32E2):
    """``rgeqrf`` of each matrix of a (batch, m, n) stack, as one batched
    run; returns (QR (batch, m, n), tau (batch, min(m, n)))."""
    return rgeqrf(check_batched(a_p), nb, gemm_backend, fmt)


def rormqr(a_qr: torch.Tensor, tau_p: torch.Tensor, c_p: torch.Tensor,
           trans: bool = False, nb: int = 32,
           gemm_backend: str = "xla_quire",
           fmt: PositFormat = P32E2) -> torch.Tensor:
    """C <- Q C (trans=False) or Q^T C (trans=True), C ([B,] m) or
    ([B,] m, nc).  Q = B_0 ... B_L with B_j = I - V_j T_j V_j^T, so Q^T C
    applies the transposed blocks in forward order and Q C the blocks in
    reverse (dormqr)."""
    kk = tau_p.shape[-1]
    vec = c_p.dim() < a_qr.dim()
    c = c_p.to(torch.int32)
    c = (c[..., None] if vec else c).clone()
    starts = list(range(0, kk, nb))
    for j in (starts if trans else starts[::-1]):
        w = min(nb, kk - j)
        v_w = _v_words(a_qr[..., j:, j:j + w], fmt)
        t_w = larft(v_w, tau_p[..., j:j + w], fmt=fmt)
        c[..., j:, :] = _apply_block(c[..., j:, :], v_w, t_w, trans,
                                     gemm_backend, fmt)
    return c[..., 0] if vec else c


def rorgqr(a_qr: torch.Tensor, tau_p: torch.Tensor,
           ncols: int | None = None, nb: int = 32,
           gemm_backend: str = "xla_quire",
           fmt: PositFormat = P32E2) -> torch.Tensor:
    """The first ``ncols`` (default: all min(m, n)) columns of Q, by
    applying the stored reflectors to the identity (exact words)."""
    m = a_qr.shape[-2]
    nc = tau_p.shape[-1] if ncols is None else ncols
    eye = posit.from_float64(torch.eye(m, nc, dtype=torch.float64,
                                       device=a_qr.device), fmt)
    eye = eye.expand(*a_qr.shape[:-2], m, nc)
    return rormqr(a_qr, tau_p, eye, False, nb, gemm_backend, fmt)


# --------------------------------------------------------------------------
# least squares
# --------------------------------------------------------------------------

def _check_tall(a_p: torch.Tensor, who: str):
    if a_p.shape[-2] < a_p.shape[-1]:
        raise ValueError(f"{who} requires m >= n, got {tuple(a_p.shape)}")


def rgels(a_p: torch.Tensor, b_p: torch.Tensor, nb: int = 32,
          gemm_backend: str = "xla_quire", fmt: PositFormat = P32E2):
    """Over-determined least squares min ||A x - b||_2 (m >= n) through
    Householder QR: x = R^{-1} (Q^T b)[:n].  A ([B,] m, n); b ([B,] m) or
    ([B,] m, nrhs).  Returns (x, (qr, tau))."""
    a_p = a_p.to(torch.int32)
    _check_tall(a_p, "rgels")
    n = a_p.shape[-1]
    qr_p, tau = rgeqrf(a_p, nb, gemm_backend, fmt)
    vec = b_p.dim() < a_p.dim()
    c = rormqr(qr_p, tau, b_p, True, nb, gemm_backend, fmt)
    rhs = c[..., :n, None] if vec else c[..., :n, :]
    x = rtrsm_left_upper(_r_words(qr_p, n), rhs, unit_diag=False, fmt=fmt)
    return (x[..., 0] if vec else x), (qr_p, tau)


def rgels_batched(a_p: torch.Tensor, b_p: torch.Tensor, nb: int = 32,
                  gemm_backend: str = "xla_quire",
                  fmt: PositFormat = P32E2):
    """``rgels`` over a leading (batch, m, n) / (batch, m[, nrhs]) axis."""
    return rgels(check_batched(a_p), b_p, nb, gemm_backend, fmt)


def _snes_solve_fn(a_eq_t: torch.Tensor, r_w: torch.Tensor, inv_scale,
                   solve_fmt: PositFormat, fmt: PositFormat):
    """Correction solve of the LS refinement: d = argmin ||A d - f|| by the
    semi-normal equations R^T R d = A^T f, all quire-backed:

        f_s = f / t              (power-of-two residual equilibration)
        w   = quire_gemv(A_eq^T, f_s)      (exact fused dots, one rounding)
        R^T y = w;  R d = y                (quire sweeps)
        d  <- d * t * inv_scale            (undo both equilibrations)

    ``solve_fmt`` is the factor format (``fmt`` for ``rgels_ir``, the
    narrow one for ``rgels_mp``); ``inv_scale`` folds the matrix
    equilibration A = s * A_eq back in.
    """
    def solve_fn(f):
        fv = posit.to_float64(f, fmt)
        t = refine.pow2_scale(fv)
        f_s = posit.from_float64(fv / t, solve_fmt)
        w = quire_gemv(a_eq_t, f_s, fmt=solve_fmt)
        y = solve.rtrtrs(r_w.mT, w, lower=True, quire=True, fmt=solve_fmt)
        d = solve.rtrtrs(r_w, y, lower=False, quire=True, fmt=solve_fmt)
        dv = posit.to_float64(d, solve_fmt)
        return posit.from_float64(dv * (t * inv_scale), fmt)
    return solve_fn


def rgels_ir(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 3,
             nb: int = 32, gemm_backend: str = "xla_quire",
             fmt: PositFormat = P32E2):
    """QR least squares with quire-exact iterative refinement: factor the
    power-of-two equilibrated A once, then refine the posit pair with
    exact residuals b - A(hi+lo) and semi-normal correction solves.

    Returns ((x_hi, x_lo), (qr, tau)); the factors are of A / s.  b may be
    (m,) or (m, nrhs) (columns in turn); a (batch, m, n) A solves each
    matrix."""
    a_p = a_p.to(torch.int32)
    if a_p.dim() == 3:
        return refine._per_matrix(lambda a, b: rgels_ir(
            a, b, iters, nb, gemm_backend, fmt), a_p, b_p)
    _check_tall(a_p, "rgels_ir")
    av = posit.to_float64(a_p, fmt)
    s = refine.pow2_scale(av)
    a_eq = posit.from_float64(av / s, fmt)      # exact: s is a power of two
    qr_p, tau = rgeqrf(a_eq, nb, gemm_backend, fmt)
    solve_fn = _snes_solve_fn(a_eq.mT, _r_words(qr_p, a_p.shape[1]),
                              1.0 / s, fmt, fmt)
    return refine._driver(a_p, b_p, solve_fn, iters, fmt), (qr_p, tau)


def rgels_mp(a_p: torch.Tensor, b_p: torch.Tensor, iters: int = 10,
             nb: int = 32, gemm_backend: str = "xla_quire",
             factor_fmt: PositFormat = P16E1, fmt: PositFormat = P32E2):
    """Mixed-precision LS solve: QR of the equilibrated A in
    ``factor_fmt`` (default Posit(16,1)), then working-format quire-exact
    refinement.  A, b and the pair are ``fmt`` words; the factors are
    ``factor_fmt`` words of A / s.  The semi-normal correction squares the
    condition number (contraction ~ cond(A)^2 * eps_factor a sweep), hence
    more default sweeps than ``rgesv_mp``.  Same conventions as
    ``rgels_ir``."""
    a_p = a_p.to(torch.int32)
    if a_p.dim() == 3:
        return refine._per_matrix(lambda a, b: rgels_mp(
            a, b, iters, nb, gemm_backend, factor_fmt, fmt), a_p, b_p)
    _check_tall(a_p, "rgels_mp")
    a_lo, s = refine.mp_narrow_matrix(a_p, factor_fmt, fmt)
    qr_p, tau = rgeqrf(a_lo, nb, gemm_backend, factor_fmt)
    solve_fn = _snes_solve_fn(a_lo.mT, _r_words(qr_p, a_p.shape[1]),
                              1.0 / s, factor_fmt, fmt)
    return refine._driver(a_p, b_p, solve_fn, iters, fmt), (qr_p, tau)


# --------------------------------------------------------------------------
# binary32 baseline (the §5.1 comparison column)
# --------------------------------------------------------------------------

def sgels(a32: torch.Tensor, b32: torch.Tensor) -> torch.Tensor:
    """binary32 least squares by library QR: R x = Q^T b.  ``Q^T b`` must
    run in full f32, not TF32: PyTorch's default
    (``torch.backends.cuda.matmul.allow_tf32`` False) does, and a caller
    that turns TF32 on changes this baseline."""
    q, r = torch.linalg.qr(a32.to(torch.float32))
    b = b32.to(torch.float32)
    vec = b.dim() < a32.dim()
    qtb = q.mT @ (b[..., None] if vec else b)
    x = torch.linalg.solve_triangular(r, qtb, upper=True)
    return x[..., 0] if vec else x
