"""PBLAS over posit words: SUMMA-style distributed Rgemm and the quire
residual of the distributed refinement (counterpart of
``repro.dist.pblas``).

``pdgemm`` computes C = alpha * A @ B + beta * C with A (M, K), B (K, N),
C (M, N) block-cyclic over the P x Q grid (dist/layout.py), every rank's
product running through the ordinary ``rgemm`` backends — on a CUDA grid
``pallas_split3`` is the Hopper GEMM kernel, one launch per rank.  Two
schedules, both **bit-identical to single-device rgemm**:

* **owner-computes** (default): one all-gather of A's row strip along
  "col" and of B's column strip along "row", then ONE local ``rgemm``
  over the full K on the C-tile owner.  Every output element comes from
  the same backend on the same full-K row and column, so the words equal
  the single-device call's for every backend, provided an element's sum
  depends only on K and its own row and column (not on the tile's M, N
  or where the element sits in it), which the kernel keeps.
* **k_split** (``quire_exact`` only): each rank deposits its LOCAL K slab
  into int64 quire limb planes for all N output columns in dist column
  order; a reduce-scatter of those integer planes along "col" hands each
  rank its own tile's limbs, and the single rounding comes after it.
  Bit-identical by construction (integer limb adds are associative).  B
  moves by slab exchange (one all-to-all), not replication.

``p_residual_quire`` is the K-split path for the refinement residual
r = b - A (x + x_lo): one exact fused dot per row, deposited across the
grid's column axis, limb-psum-reduced, rounded once.

``pdgemm_ft`` protects the owner-computes gathers with exact checksum
strips (repro_torch.ft): injection sites ``pdgemm.a`` / ``pdgemm.b``
corrupt one rank's gathered copy (``dev`` = r*Q + c).

Observability: ``pdgemm`` and ``p_residual_quire`` open a ``pdgemm`` /
``p_residual`` span and count their collectives' result bytes as
``dist.pdgemm.*`` / ``dist.p_residual.*`` (equal to the static plans
below); ``pdgemm`` also records the word telemetry of its output dist
array under ``dist.pdgemm.out``.  With no collector open none of it runs.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.dist import comm
from repro_torch.dist.layout import (BlockCyclic, DistMatrix, dist_array,
                                     local_gidx, unshuffle)
from repro_torch.ft import abft
from repro_torch.ft.report import FtReport
from repro_torch.kernels.ops import _rgemm
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import numerics as _obs_numerics
from repro_torch.obs import trace as _obs_trace
from repro_torch.quire import (Quire, q_renorm, q_to_posit, qadd_posit,
                               quire_gemm_limbs, quire_limbs)

_I64 = torch.int64


def _gather_rows_fullK(a_loc, lay_a: BlockCyclic, grid):
    """(lm, lk) local tile of A -> (lm, K) full-K rows of this rank's
    block-cyclic rows: all-gather A's column strip along "col" and
    unpermute the cyclic column order."""
    g = comm.all_gather(a_loc.T, grid, "col")             # (Q, lk, lm)
    return unshuffle(g, lay_a.q, lay_a.nb).T[:, :lay_a.n]


def _gather_cols_fullK(b_loc, lay_b: BlockCyclic, grid):
    """(lk, ln) local tile of B -> (K, ln) full-K columns."""
    g = comm.all_gather(b_loc, grid, "row")               # (P, lk, ln)
    return unshuffle(g, lay_b.p, lay_b.nb)[:lay_b.m]


def _dist_col_order(lay: BlockCyclic, device=None) -> torch.Tensor:
    """Global column index of every dist-order column position
    (c', t, v) -> (c' + Q*t)*nb + v; padding positions map past n."""
    idx = []
    for cp in range(lay.q):
        for t in range(lay.lnb):
            base = (cp + lay.q * t) * lay.nb
            idx.extend(range(base, base + lay.nb))
    return torch.tensor(idx, dtype=_I64, device=device)


def _k_slab_limbs(a_loc, b_loc, lay_a: BlockCyclic, lay_b: BlockCyclic,
                  grid, negate: bool, fmt: PositFormat = P32E2):
    """Split-K deposit: this rank's K slab (A's local columns, global
    k ≡ this grid column mod Q) against ALL N output columns in dist
    column order, reduce-scattered along "col" back to this rank's
    (lm, ln, L) tile of limbs (and (lm, ln) nar flags).

    B: gather my columns' full K along "row", regroup the K rows into the
    Q cyclic slabs (padding rows masked to the zero word, which deposits
    nothing), then one all-to-all along "col" — each rank ends holding
    only its (lk, N) slab."""
    b_full = _gather_cols_fullK(b_loc, lay_b, grid)       # (K, ln)
    kslab = _dist_col_order(lay_a, b_full.device)         # (Q*lk,)
    b_slabs = torch.where((kslab < lay_a.n)[:, None],
                          b_full[kslab.clamp(max=lay_b.m - 1)], 0)
    b_dist = comm.all_to_all(b_slabs, grid, "col", 0, 1)  # (lk, Q*ln)
    limbs, nar = quire_gemm_limbs(a_loc, b_dist, fmt, negate=negate)
    limbs = comm.psum_scatter(limbs, grid, "col", 1)      # (lm, ln, L)
    nar = comm.psum_scatter(nar.to(torch.int32), grid, "col", 1) > 0
    return limbs, nar


def _pdgemm_local(a_loc, b_loc, c_loc, lay_a, lay_b, grid, alpha, beta,
                  backend, k_split, fmt: PositFormat = P32E2):
    if k_split:
        if backend != "quire_exact":
            raise ValueError("k_split pdgemm is the quire limb-plane "
                             "schedule; use backend='quire_exact'")
        dev = a_loc.device
        a_in = a_loc
        if alpha not in (1.0, -1.0):
            alpha_p = posit.from_float64(
                torch.tensor(float(alpha), dtype=torch.float64,
                             device=dev), fmt)
            a_in = posit.mul(alpha_p, a_loc, fmt, backend="fast")
        limbs, nar = _k_slab_limbs(a_in, b_loc, lay_a, lay_b, grid,
                                   negate=alpha == -1.0, fmt=fmt)
        q = Quire(limbs=limbs, nar=nar)
        if beta == 1.0:
            q = qadd_posit(q, c_loc, fmt)
        elif beta != 0.0:
            beta_p = posit.from_float64(
                torch.tensor(float(beta), dtype=torch.float64, device=dev),
                fmt)
            q = qadd_posit(q, posit.mul(beta_p, c_loc, fmt, backend="fast"),
                           fmt)
        return q_to_posit(q, fmt)
    a_full = _gather_rows_fullK(a_loc, lay_a, grid)       # (lm, K)
    b_full = _gather_cols_fullK(b_loc, lay_b, grid)       # (K, ln)
    with grid.timed("update"):
        return _rgemm(a_full, b_full, c_loc, alpha, beta, backend=backend,
                      fmt=fmt)


def pdgemm_collective_plan(lay_a: BlockCyclic, lay_b: BlockCyclic,
                           k_split: bool = False,
                           fmt: PositFormat = P32E2) -> dict[str, int]:
    """Static PER-RANK collective byte plan of one ``pdgemm``: {collective
    kind -> result bytes}, from the layouts alone (the reference's
    convention, so the two packages' plans are equal).

    owner-computes: A row strip gathered along "col" ((Q, lk, lm) i32)
    + B column strip along "row" ((P, lk, ln) i32).  k_split: B strip
    gather, the (lk, Q*ln) i32 slab-exchange all-to-all, and the
    (lm, ln, L) i64 + (lm, ln) i32 limb-plane reduce-scatter pair."""
    if not k_split:
        return {"all-gather": 4 * (lay_a.q * lay_a.ln * lay_a.lm
                                   + lay_b.p * lay_b.lm * lay_b.ln)}
    lay_c = BlockCyclic(m=lay_a.m, n=lay_b.n, nb=lay_a.nb,
                        p=lay_a.p, q=lay_a.q)
    L = quire_limbs(fmt)
    return {
        "all-gather": 4 * lay_b.p * lay_b.lm * lay_b.ln,
        "all-to-all": 4 * lay_a.ln * lay_a.q * lay_b.ln,
        "reduce-scatter": lay_c.lm * lay_c.ln * (8 * L + 4),
    }


def p_residual_plan(lay: BlockCyclic, nrhs: int = 1,
                    fmt: PositFormat = P32E2) -> dict[str, int]:
    """Static PER-RANK collective byte plan of one ``p_residual_quire``:
    the (lm, nrhs, L) i64 + (lm, nrhs) i32 limb psum (all-reduce) and the
    (P, lm, nrhs) i32 row gather of the rounded residual."""
    L = quire_limbs(fmt)
    return {
        "all-reduce": lay.lm * nrhs * (8 * L + 4),
        "all-gather": 4 * lay.p * lay.lm * nrhs,
    }


def _check_layouts(a: DistMatrix, b: DistMatrix, c: DistMatrix | None):
    la, lb = a.layout, b.layout
    if (la.n, la.nb, la.p, la.q) != (lb.m, lb.nb, lb.p, lb.q):
        raise ValueError(f"incompatible layouts {la} @ {lb}")
    lay_c = BlockCyclic(m=la.m, n=lb.n, nb=la.nb, p=la.p, q=la.q)
    if c is None:
        return lay_c, torch.zeros((lay_c.lm, lay_c.ln), dtype=torch.int32,
                                  device=a.data.device)
    if c.layout != lay_c:
        raise ValueError(f"C layout {c.layout} != {lay_c}")
    return lay_c, c.data


def pdgemm(a: DistMatrix, b: DistMatrix, c: DistMatrix | None = None,
           alpha=1.0, beta=0.0, backend: str = "xla_quire",
           k_split: bool = False, fmt: PositFormat = P32E2) -> DistMatrix:
    """Distributed C = alpha * A @ B + beta * C (every rank calls it).

    ``backend`` is any ``rgemm`` backend; ``k_split=True`` selects the
    quire limb-plane schedule (quire_exact only).  ``fmt`` is the posit
    format of every word.  The result is bit-identical to single-device
    ``rgemm`` with the same ``fmt`` on the gathered operands in either
    schedule."""
    la, lb, grid = a.layout, b.layout, a.grid
    lay_c, c_loc = _check_layouts(a, b, c)
    with _obs_trace.span("pdgemm", m=la.m, k=la.n, n=lb.n,
                         grid=f"{la.p}x{la.q}", backend=backend,
                         k_split=k_split, fmt=fmt.name), \
            grid.counting("pdgemm"):
        out = _pdgemm_local(a.data, b.data, c_loc, la, lb, grid, alpha,
                            beta, backend, k_split, fmt)
    if _obs_metrics.enabled():
        _obs_numerics.record_numerics("dist.pdgemm.out",
                                      dist_array(out, grid), fmt)
    return DistMatrix(data=out, layout=lay_c, grid=grid)


# --------------------------------------------------------------------------
# distributed quire residual (matrix-vector / multi-RHS K-split)
# --------------------------------------------------------------------------

def _residual_local(a_loc, x, b, x_lo, lay: BlockCyclic, grid,
                    fmt: PositFormat = P32E2):
    """r = b - A (x + x_lo), one exact fused dot per row, K split across
    the grid columns and reduced in limb space; output replicated."""
    dev = a_loc.device
    kidx = local_gidx(lay, 1, grid.c, dev)                # (lk,)
    valid = (kidx < lay.n)[:, None]
    kc = kidx.clamp(max=lay.n - 1)
    x_sel = torch.where(valid, x[kc], 0)                  # (lk, nrhs)
    if x_lo is None:
        a2, x2 = a_loc, x_sel
    else:
        # the pair residual b - A*hi - A*lo as ONE fused reduction: the
        # [A | A] @ [hi; lo] concatenation of residual_quire, both K
        # halves on this rank's slab.
        lo_sel = torch.where(valid, x_lo[kc], 0)
        a2 = torch.cat([a_loc, a_loc], dim=1)
        x2 = torch.cat([x_sel, lo_sel], dim=0)
    limbs, nar = quire_gemm_limbs(a2, x2, fmt, negate=True)
    limbs, nar = comm.limb_psum(limbs, nar, grid, "col")
    gidx = local_gidx(lay, 0, grid.r, dev)                # (lm,)
    rvalid = (gidx < lay.m)[:, None]
    b_my = torch.where(rvalid, b[gidx.clamp(max=lay.m - 1)], 0)
    q = qadd_posit(Quire(limbs=limbs, nar=nar & rvalid), b_my, fmt)
    r_rows = q_to_posit(q, fmt)                           # (lm, nrhs)
    full = unshuffle(comm.all_gather(r_rows, grid, "row"), lay.p, lay.nb)
    return full[:lay.m]


def p_residual_quire(a: DistMatrix, x_p: torch.Tensor, b_p: torch.Tensor,
                     x_lo_p: torch.Tensor | None = None,
                     fmt: PositFormat = P32E2) -> torch.Tensor:
    """Distributed drop-in for ``lapack.refine.residual_quire``: each
    component of r = b - A (x + x_lo) is an exact fused dot product
    rounded ONCE, with the K reduction summed across the grid in int64
    limb planes — bit-identical to the single-device quire residual.
    x/b replicated (n,) or (n, nrhs); returns the replicated residual of
    the same shape, on the grid's device."""
    lay, grid = a.layout, a.grid
    dev = a.data.device
    x_p = torch.as_tensor(x_p).to(device=dev, dtype=torch.int32)
    b_p = torch.as_tensor(b_p).to(device=dev, dtype=torch.int32)
    vec = x_p.dim() == 1
    x2 = x_p[:, None] if vec else x_p
    b2 = b_p[:, None] if vec else b_p
    lo2 = None
    if x_lo_p is not None:
        lo2 = torch.as_tensor(x_lo_p).to(device=dev, dtype=torch.int32)
        lo2 = lo2[:, None] if vec else lo2
    with _obs_trace.span("p_residual", n=lay.n, nrhs=int(x2.shape[1]),
                         grid=f"{lay.p}x{lay.q}", fmt=fmt.name), \
            grid.counting("p_residual"):
        r = _residual_local(a.data, x2, b2, lo2, lay, grid, fmt)
    return r[:, 0] if vec else r


# --------------------------------------------------------------------------
# checksum-protected distributed GEMM (exact ABFT)
# --------------------------------------------------------------------------

def _strip_sums(words, axis: int, grid, grid_axis: str, fmt: PositFormat):
    """Exact value-sum checksum of ``words`` along ``axis`` as the
    gathered operand will have it, from the LOCAL tile: (canonical limbs,
    nar flags, raw int64 word sums), summed over ``grid_axis`` (limb adds
    are associative, so the strip equals the checksum of the gathered
    full-K operand exactly; padding words are 0 and deposit nothing).
    One psum carries all three."""
    limbs, nar = abft._word_limbs(words, fmt)
    packed = torch.cat([limbs.sum(dim=axis),
                        nar.to(_I64).sum(dim=axis)[..., None],
                        words.to(_I64).sum(dim=axis)[..., None]], dim=-1)
    packed = comm.psum(packed, grid, grid_axis)
    q = q_renorm(Quire(limbs=packed[..., :-2], nar=packed[..., -2] > 0))
    return q.limbs, q.nar, packed[..., -1]


def _operands_agree(words, axis: int, strip, fmt: PositFormat):
    """The received operand's checksums equal the strip, exactly."""
    limbs, nar, wsum = strip
    got, got_nar = abft.word_sums(words, fmt, axis=axis)
    return bool(torch.equal(got, limbs) and torch.equal(got_nar, nar)
                and torch.equal(words.to(_I64).sum(dim=axis), wsum))


def _pdgemm_ft_local(a_loc, b_loc, c_loc, lay_a, lay_b, grid, alpha, beta,
                     backend, fmt, plan, active):
    """Owner-computes pdgemm whose two gathers carry exact checksum
    strips: every rank recomputes the checksums of the operands it
    received and compares exactly; the agreeing ranks are counted over
    the world.  Returns (C tile, agreeing-rank count)."""
    astrip = _strip_sums(a_loc, 1, grid, "col", fmt)      # (lm, ...)
    bstrip = _strip_sums(b_loc, 0, grid, "row", fmt)      # (ln, ...)
    a_full = _gather_rows_fullK(a_loc, lay_a, grid)       # (lm, K)
    b_full = _gather_cols_fullK(b_loc, lay_b, grid)       # (K, ln)
    if active and plan is not None:
        a_full = plan.words("pdgemm.a", 0, a_full, fmt, dev=grid.rank)
        b_full = plan.words("pdgemm.b", 0, b_full, fmt, dev=grid.rank)
    ok = (_operands_agree(a_full, 1, astrip, fmt)
          and _operands_agree(b_full, 0, bstrip, fmt))
    okc = comm.psum(torch.tensor([int(ok)], device=a_loc.device), grid,
                    "all")
    with grid.timed("update"):
        out = _rgemm(a_full, b_full, c_loc, alpha, beta, backend=backend,
                     fmt=fmt)
    return out, int(okc)


def pdgemm_ft(a: DistMatrix, b: DistMatrix, c: DistMatrix | None = None,
              alpha=1.0, beta=0.0, backend: str = "xla_quire",
              fmt: PositFormat = P32E2, plan=None, max_retries: int = 2):
    """Checksum-protected owner-computes ``pdgemm``: returns
    (C DistMatrix, FtReport), C bit-identical to ``pdgemm`` fault-free and
    after recovery.  A failed grid-wide verify re-runs the whole GEMM
    with injection off (the gathers are the unit of recovery).
    Exhaustion raises ``AbftError``."""
    la, lb, grid = a.layout, b.layout, a.grid
    lay_c, c_loc = _check_layouts(a, b, c)
    report = FtReport()
    for attempt in range(max_retries + 1):
        out, okc = _pdgemm_ft_local(a.data, b.data, c_loc, la, lb, grid,
                                    alpha, beta, backend, fmt, plan,
                                    active=attempt == 0)
        if okc == la.p * la.q:
            report.retries = attempt
            return DistMatrix(data=out, layout=lay_c, grid=grid), report
        report.detections += 1
        report.sites.append(("pdgemm", 0))
        _obs_metrics.inc("ft.detections")
        _obs_metrics.inc("ft.retries")
    report.failed = True
    raise abft.AbftError(f"pdgemm_ft: gather mismatch persisted across "
                         f"{max_retries + 1} attempts")
