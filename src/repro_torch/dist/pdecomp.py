"""Distributed right-looking Rpotrf / Rgetrf and the refinement solvers
over the grid (counterpart of ``repro.dist.pdecomp``).

ScaLAPACK's pdpotrf/pdgetrf schedule.  The reference traces it into one
``shard_map`` program; here every rank runs the same block loop eagerly
on its own tile, and the block steps meet in the collectives.  Per block
step j (width w = min(nb, n - j)):

  1. **panel broadcast** — the owning grid column's (lm, w) slice is
     summed along "col" (non-owners contribute zero words), then
     all-gathered and unpermuted along "row": every rank holds the
     replicated (m, w) panel column.
  2. **panel factorization, replicated** — ``potf2`` / ``getf2`` run on
     every rank on the same words, so every rank gets the same factors.
  3. (LU) **pivot application** — ``getf2``'s w swaps compose into one
     net row permutation; each rank re-reads its rows from the "row"
     all-gather of its column strip through it: one collective for the
     whole panel's swaps.
  4. **trailing update, distributed** — each rank updates its OWN tile
     with one local ``rgemm(alpha=-1, beta=1)`` over the WHOLE tile (any
     backend; on a CUDA grid ``pallas_split3`` is the Hopper kernel),
     and a mask keeps only the trailing-region elements.  Per element
     this is the single-device trailing update's reduction over the same
     K = w operands, so the words match bit for bit.

The uniform masked update of the whole (lm, ln) tile each step is the
reference's (Σ_j lm*ln*w ≈ n³/(PQ) MACs against Σ (n-j)²w ≈ n³/3 on one
device); its words and its collective plan are the contract, so it is
kept as it is.

``p_rgesv_ir`` / ``p_rposv_ir`` wire the distributed pieces into
``lapack.refine.refine_pair``: distributed factorization, replicated
quire substitution sweeps on the gathered factors, and distributed
residuals (``pblas.p_residual_quire``) — bit-identical end to end to
``rgesv_ir`` / ``rposv_ir``.

**Protected drivers** (``p_rpotrf_ft`` / ``p_rgetrf_ft``): the same step
with the panel broadcast carrying an exact checksum strip, computed from
the pre-broadcast owner slices and summed over the world; every rank
recomputes the checksum of the replica it received and compares exactly,
and the agreeing ranks are counted over the world.  A failed step is
retried from its verified predecessor.  Injection site ``dist.panel``
(gated on the linear id r*Q + c) corrupts one rank's received replica.
With ``checkpoint_dir`` the state is saved after every step in the
reference's form — the (P*lm, Q*ln) dist array and the pivots, as npy
leaves (``repro_torch.checkpoint``), written by rank 0 — so a checkpoint
of either package resumes in the other; ``resume=True`` restarts from the
newest step, bit-identically.

Observability: ``p_rpotrf`` / ``p_rgetrf`` open a span with ``grid=`` and
``backend=``, count their collectives as ``dist.rpotrf.*`` /
``dist.rgetrf.*`` (equal to ``pfactor_collective_plan``) and record the
output's word telemetry, as the reference does; the protected drivers
count the reference's ``ft.*`` counters only.  ``Grid.clock`` splits a
rank's wall into panel, trsm, update, collective and staging stages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import P32E2
from repro_torch.dist import comm
from repro_torch.dist.layout import (BlockCyclic, DistMatrix, dist_array,
                                     local_gidx, select_block_col, unshuffle)
from repro_torch.dist.pblas import _strip_sums, p_residual_quire
from repro_torch.ft import abft
from repro_torch.ft.report import FtReport
from repro_torch.kernels.ops import _rgemm
from repro_torch.lapack import solve
from repro_torch.lapack.blas import rtrsm_left_lower, rtrsm_right_lowerT
from repro_torch.lapack.decomp import getf2, potf2
from repro_torch.lapack.refine import refine_pair
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import numerics as _obs_numerics
from repro_torch.obs import trace as _obs_trace

_FMT = P32E2


def _replicate_panel(a_loc, lay: BlockCyclic, grid, j: int, w: int):
    """Step 1: the (m, w) global column panel [*, j:j+w) replicated on
    every rank (sum-select along "col", gather along "row", unpermute)."""
    mine = select_block_col(a_loc, lay, grid.c, j, w)     # (lm, w) or 0
    rows = comm.psum(mine, grid, "col")                   # (lm, w)
    full = unshuffle(comm.all_gather(rows, grid, "row"), lay.p, lay.nb)
    return full[:lay.m]                                   # (m, w)


def _replicate_panel_ft(a_loc, lay: BlockCyclic, grid, j: int, w: int,
                        plan, active: bool):
    """``_replicate_panel`` with the checksum strip riding the broadcast
    and the ``dist.panel`` injection window on the received replica;
    returns (panel, agreeing-rank count)."""
    mine = select_block_col(a_loc, lay, grid.c, j, w)
    strip = _strip_sums(mine, 0, grid, "all", _FMT)
    colpan = _replicate_panel(a_loc, lay, grid, j, w)
    if active and plan is not None:
        colpan = plan.words("dist.panel", j // lay.nb, colpan, _FMT,
                            dev=grid.rank)
    limbs, nar, wsum = strip
    got, got_nar = abft.word_sums(colpan, _FMT, axis=0)
    ok = (torch.equal(got, limbs) and torch.equal(got_nar, nar)
          and torch.equal(colpan.to(torch.int64).sum(dim=0), wsum))
    okc = comm.psum(torch.tensor([int(ok)], device=a_loc.device), grid,
                    "all")
    return colpan, int(okc)


def _write_panel(a_loc, lay: BlockCyclic, grid, gr, j: int, w: int,
                 col_new, row_lo: int):
    """Masked write of replicated (m, w) ``col_new`` into the owner grid
    column's local tile, rows [row_lo, m); a new tensor."""
    c_star, _, off = lay.col_block_home(j)
    if grid.c != c_star:
        return a_loc
    mine = col_new[gr.clamp(max=lay.m - 1)]               # (lm, w)
    mask = ((gr >= row_lo) & (gr < lay.m))[:, None]
    out = a_loc.clone()
    out[:, off:off + w] = torch.where(mask, mine, a_loc[:, off:off + w])
    return out


def _indices(lay: BlockCyclic, grid, device):
    """(global row index of each local row, of each local column)."""
    return (local_gidx(lay, 0, grid.r, device),
            local_gidx(lay, 1, grid.c, device))


def _potrf_step(a_loc, lay: BlockCyclic, grid, gidx, j: int,
                gemm_backend: str, colpan):
    """Block step j of the Cholesky on the replicated panel ``colpan``;
    returns the new tile (``a_loc`` is not modified)."""
    n, nb = lay.n, lay.nb
    gr, gc = gidx
    w = min(nb, n - j)
    with grid.timed("panel"):
        l11 = potf2(colpan[j:j + w])
    if j + w < n:
        with grid.timed("trsm"):
            a21 = rtrsm_right_lowerT(colpan[j + w:], l11)
        lcol = torch.cat([colpan[:j], l11, a21])
    else:
        lcol = torch.cat([colpan[:j], l11])
    a_loc = _write_panel(a_loc, lay, grid, gr, j, w, lcol, row_lo=j)
    if j + w < n:
        with grid.timed("update"):
            ar = lcol[gr.clamp(max=n - 1)]                # (lm, w)
            ac = lcol[gc.clamp(max=n - 1)]                # (ln, w)
            upd = _rgemm(ar, ac, a_loc, -1.0, 1.0, trans_b=True,
                         backend=gemm_backend)
            tmask = (((gr >= j + w) & (gr < n))[:, None]
                     & ((gc >= j + w) & (gc < n))[None, :])
            a_loc = torch.where(tmask, upd, a_loc)
    return a_loc


def _getrf_step(a_loc, ipiv, lay: BlockCyclic, grid, gidx, j: int,
                gemm_backend: str, colpan):
    """Block step j of the LU on the replicated panel ``colpan``; returns
    (new tile, new ipiv) (the inputs are not modified)."""
    m, n, nb = lay.m, lay.n, lay.nb
    gr, gc = gidx
    w = min(nb, min(m, n) - j)
    with grid.timed("panel"):
        pan, piv_loc = getf2(colpan[j:], w)               # replicated
        piv = piv_loc.tolist()
    ipiv = ipiv.clone()
    ipiv[j:j + w] = piv_loc + j
    # net permutation of the w swaps (rows j..m), applied to the column
    # strip through ONE "row"-axis gather
    idx = list(range(m))
    for k in range(w):
        rk, rp = j + k, j + piv[k]
        idx[rk], idx[rp] = idx[rp], idx[rk]
    strip = unshuffle(comm.all_gather(a_loc, grid, "row"), lay.p,
                      lay.nb)[:m]                         # (m, ln)
    strip = strip[torch.tensor(idx, device=strip.device)]
    swapped = strip[gr.clamp(max=m - 1)]                  # (lm, ln)
    a_loc = torch.where(((gr >= j) & (gr < m))[:, None], swapped, a_loc)
    # the factored panel (already internally swapped) overwrites its column
    pcol = torch.cat([colpan[:j], pan]) if j else pan
    a_loc = _write_panel(a_loc, lay, grid, gr, j, w, pcol, row_lo=j)
    if j + w < n:
        with grid.timed("trsm"):
            # U12 row block: unit-lower solve on MY columns of the
            # post-swap rows [j, j+w)
            u12 = rtrsm_left_lower(pan[:w], strip[j:j + w], unit_diag=True)
            u12_mine = u12[(gr - j).clamp(0, w - 1)]      # (lm, ln)
            rmask = ((gr >= j) & (gr < j + w))[:, None]
            cmask = ((gc >= j + w) & (gc < n))[None, :]
            a_loc = torch.where(rmask & cmask, u12_mine, a_loc)
        if j + w < m:
            with grid.timed("update"):
                l21 = pan[(gr - j).clamp(0, m - j - 1)]   # (lm, w)
                upd = _rgemm(l21, u12, a_loc, -1.0, 1.0,
                             backend=gemm_backend)
                tmask = (((gr >= j + w) & (gr < m))[:, None]
                         & ((gc >= j + w) & (gc < n))[None, :])
                a_loc = torch.where(tmask, upd, a_loc)
    return a_loc, ipiv


def _keep(a_loc, lay: BlockCyclic, gidx, algo: str):
    """Zero the padding (and for the Cholesky the strict upper
    triangle)."""
    gr, gc = gidx
    keep = (gr < lay.m)[:, None] & (gc < lay.n)[None, :]
    if algo == "potrf":
        keep &= gr[:, None] >= gc[None, :]
    return torch.where(keep, a_loc, 0)


def pfactor_collective_plan(lay: BlockCyclic,
                            algo: str = "getrf") -> dict[str, int]:
    """Static PER-RANK collective byte plan of one distributed blocked
    factorization (``pblas.pdgemm_collective_plan``'s convention).  Per
    block step: the (lm, w) i32 panel sum-select (all-reduce) and its
    (P, lm, w) i32 row gather; LU adds the (P, lm, ln) i32 column-strip
    gather the net pivot permutation reads through."""
    if algo not in ("getrf", "potrf"):
        raise ValueError(f"unknown algo {algo!r}")
    mn = min(lay.m, lay.n) if algo == "getrf" else lay.n
    ar = ag = 0
    for j in range(0, mn, lay.nb):
        w = min(lay.nb, mn - j)
        ar += 4 * lay.lm * w
        ag += 4 * lay.p * lay.lm * w
        if algo == "getrf":
            ag += 4 * lay.p * lay.lm * lay.ln
    return {"all-reduce": ar, "all-gather": ag}


def _record_out(name: str, out, grid) -> None:
    if _obs_metrics.enabled():
        _obs_numerics.record_numerics(name, dist_array(out, grid), _FMT)


def p_rpotrf(a: DistMatrix, gemm_backend: str = "xla_quire",
             checkpoint_dir=None, resume: bool = False) -> DistMatrix:
    """Distributed blocked lower Cholesky; bit-identical words to
    ``lapack.rpotrf(gather(a), nb=a.layout.nb, gemm_backend=...)``.  The
    block size IS the layout block size.  With ``checkpoint_dir`` set it
    runs through ``p_rpotrf_ft`` (same words), saving a checkpoint per
    block step; ``resume=True`` restarts from the newest one."""
    lay, grid = a.layout, a.grid
    if lay.m != lay.n:
        raise ValueError(f"Cholesky needs square A, got {a.shape}")
    if checkpoint_dir is not None:
        out, _ = p_rpotrf_ft(a, gemm_backend=gemm_backend,
                             checkpoint_dir=checkpoint_dir, resume=resume)
        return out
    gidx = _indices(lay, grid, a.data.device)
    data = a.data
    with _obs_trace.span("p_rpotrf", n=lay.n, nb=lay.nb,
                         grid=f"{lay.p}x{lay.q}", backend=gemm_backend), \
            grid.counting("rpotrf"):
        for j in range(0, lay.n, lay.nb):
            colpan = _replicate_panel(data, lay, grid, j,
                                      min(lay.nb, lay.n - j))
            data = _potrf_step(data, lay, grid, gidx, j, gemm_backend,
                               colpan)
        data = _keep(data, lay, gidx, "potrf")
    _record_out("dist.rpotrf.out", data, grid)
    return a.with_data(data)


def p_rgetrf(a: DistMatrix, gemm_backend: str = "xla_quire",
             checkpoint_dir=None, resume: bool = False):
    """Distributed blocked partial-pivot LU; returns (LU DistMatrix,
    replicated ipiv) bit-identical to ``lapack.rgetrf`` at nb =
    a.layout.nb.  ``checkpoint_dir``/``resume`` as in ``p_rpotrf``."""
    lay, grid = a.layout, a.grid
    if checkpoint_dir is not None:
        lu, ipiv, _ = p_rgetrf_ft(a, gemm_backend=gemm_backend,
                                  checkpoint_dir=checkpoint_dir,
                                  resume=resume)
        return lu, ipiv
    mn = min(lay.m, lay.n)
    gidx = _indices(lay, grid, a.data.device)
    data = a.data
    ipiv = torch.zeros((mn,), dtype=torch.int32, device=data.device)
    with _obs_trace.span("p_rgetrf", m=lay.m, n=lay.n, nb=lay.nb,
                         grid=f"{lay.p}x{lay.q}", backend=gemm_backend), \
            grid.counting("rgetrf"):
        for j in range(0, mn, lay.nb):
            colpan = _replicate_panel(data, lay, grid, j,
                                      min(lay.nb, mn - j))
            data, ipiv = _getrf_step(data, ipiv, lay, grid, gidx, j,
                                     gemm_backend, colpan)
        data = _keep(data, lay, gidx, "getrf")
    _record_out("dist.rgetrf.out", data, grid)
    return a.with_data(data), ipiv


# --------------------------------------------------------------------------
# distributed iterative-refinement drivers
# --------------------------------------------------------------------------

def _p_driver(a: DistMatrix, b_p, solve_fn, iters: int):
    """refine_pair over columns with DISTRIBUTED residuals (RHS columns
    in turn)."""
    b_p = torch.as_tensor(b_p).to(device=a.data.device, dtype=torch.int32)

    def residual_fn(hi, lo, b):
        return p_residual_quire(a, hi, b, lo)
    if b_p.dim() == 1:
        return refine_pair(solve_fn, residual_fn, b_p, iters)
    cols = [refine_pair(solve_fn, residual_fn, b_p[:, i], iters)
            for i in range(b_p.shape[1])]
    return (torch.stack([h for h, _ in cols], dim=1),
            torch.stack([lo for _, lo in cols], dim=1))


def p_rgesv_ir(a: DistMatrix, b_p, iters: int = 3,
               gemm_backend: str = "xla_quire"):
    """Distributed LU solve of A x = b with quire-exact iterative
    refinement: ``p_rgetrf``, replicated quire substitution sweeps on the
    gathered LU, distributed limb-psum residuals.  Returns ((x_hi, x_lo),
    (lu DistMatrix, ipiv)), the pair words bit-identical to
    ``lapack.rgesv_ir`` at nb = a.layout.nb."""
    lu, ipiv = p_rgetrf(a, gemm_backend=gemm_backend)
    lu_rep = lu.gather()

    def solve_fn(r):
        return solve.rgetrs(lu_rep, ipiv, r, quire=True)
    return _p_driver(a, b_p, solve_fn, iters), (lu, ipiv)


def p_rposv_ir(a: DistMatrix, b_p, iters: int = 3,
               gemm_backend: str = "xla_quire"):
    """Distributed Cholesky SPD solve with quire-exact iterative
    refinement; conventions as ``p_rgesv_ir``.  Returns ((x_hi, x_lo),
    l DistMatrix)."""
    l_d = p_rpotrf(a, gemm_backend=gemm_backend)
    l_rep = l_d.gather()

    def solve_fn(r):
        return solve.rpotrs(l_rep, r, quire=True)
    return _p_driver(a, b_p, solve_fn, iters), l_d


# --------------------------------------------------------------------------
# checksum-protected distributed drivers + per-panel checkpoint/restart
# --------------------------------------------------------------------------

def _ckpt_save(checkpoint_dir, step: int, a_loc, ipiv, grid,
               keep_last: int) -> None:
    """Save the state after ``step`` block steps in the reference's form
    ({"a": (P*lm, Q*ln) dist array, "ipiv": pivots}); rank 0 writes,
    every rank waits for it."""
    from repro_torch.checkpoint.store import save_checkpoint
    full = dist_array(a_loc, grid)
    if grid.rank == 0:
        tree = {"a": full}
        if ipiv is not None:
            tree["ipiv"] = ipiv
        save_checkpoint(checkpoint_dir, step, tree, keep_last=keep_last)
    comm.barrier(grid)


def _ckpt_restore(checkpoint_dir, lay: BlockCyclic, grid, mn):
    """(step, tile, ipiv) of the newest checkpoint — this rank's tile cut
    from the saved dist array — or (0, None, None) when none exist."""
    from repro_torch.checkpoint.store import latest_step, restore_checkpoint
    step = latest_step(checkpoint_dir)
    if step is None:
        return 0, None, None
    like = {"a": np.zeros((lay.p * lay.lm, lay.q * lay.ln), np.int32)}
    if mn is not None:
        like["ipiv"] = np.zeros((mn,), np.int32)
    tree, step, _ = restore_checkpoint(checkpoint_dir, like, step)
    r, c = grid.r, grid.c
    tile = torch.from_numpy(tree["a"][r * lay.lm:(r + 1) * lay.lm,
                                      c * lay.ln:(c + 1) * lay.ln].copy())
    ipiv = None if mn is None else torch.from_numpy(tree["ipiv"])
    return step, tile, ipiv


def _ft_loop(name: str, a: DistMatrix, ipiv, steps, run_step, plan,
             max_retries, checkpoint_dir, resume, keep_last, stop_after):
    """The host-stepped protected loop shared by both drivers: verified
    steps, retries from the verified predecessor, per-step checkpoints,
    resume and the kill hook.  Returns (tile or None, ipiv, FtReport)."""
    lay, grid = a.layout, a.grid
    dev = a.data.device
    mn = None if ipiv is None else ipiv.shape[0]
    data = a.data
    report = FtReport()
    start = 0
    if checkpoint_dir is not None and resume:
        start, tile, saved_ipiv = _ckpt_restore(checkpoint_dir, lay, grid,
                                                mn)
        if tile is not None:
            data = tile.to(dev)
            if saved_ipiv is not None:
                ipiv = saved_ipiv.to(dev)
    for s, j in enumerate(steps):
        if s < start:
            continue
        for attempt in range(max_retries + 1):
            out, okc = run_step(data, ipiv, j, plan, attempt == 0)
            if okc == lay.p * lay.q:
                report.retries += attempt
                break
            report.detections += 1
            report.sites.append(("dist.panel", s))
            _obs_metrics.inc("ft.detections")
            _obs_metrics.inc("ft.retries")
        else:
            report.failed = True
            raise abft.AbftError(f"{name}: step {s} broadcast mismatch "
                                 f"persisted across {max_retries + 1} "
                                 "attempts")
        data, ipiv = out
        if checkpoint_dir is not None:
            _ckpt_save(checkpoint_dir, s + 1, data, ipiv, grid, keep_last)
        if stop_after is not None and stop_after <= s + 1 < len(steps):
            return None, ipiv, report
    return data, ipiv, report


def p_rpotrf_ft(a: DistMatrix, gemm_backend: str = "xla_quire", plan=None,
                max_retries: int = 2, checkpoint_dir=None,
                resume: bool = False, keep_last: int = 2,
                _stop_after=None):
    """Checksum-protected distributed Cholesky: returns (L DistMatrix,
    FtReport), bit-identical to ``p_rpotrf`` fault-free and after
    recovery.  Every panel broadcast carries its exact checksum strip and
    a failed verify retries just that step.  With ``checkpoint_dir`` the
    state is saved after every step and ``resume=True`` restarts from the
    newest one, bit-identically.  ``_stop_after`` (test hook) simulates a
    kill: the driver returns (None, report) after that many steps."""
    lay, grid = a.layout, a.grid
    if lay.m != lay.n:
        raise ValueError(f"Cholesky needs square A, got {a.shape}")
    gidx = _indices(lay, grid, a.data.device)

    def run_step(data, ipiv, j, plan, active):
        colpan, okc = _replicate_panel_ft(data, lay, grid, j,
                                          min(lay.nb, lay.n - j), plan,
                                          active)
        return (_potrf_step(data, lay, grid, gidx, j, gemm_backend, colpan),
                None), okc
    data, _, report = _ft_loop("p_rpotrf_ft", a, None,
                               range(0, lay.n, lay.nb), run_step, plan,
                               max_retries, checkpoint_dir, resume,
                               keep_last, _stop_after)
    if data is None:
        return None, report
    return a.with_data(_keep(data, lay, gidx, "potrf")), report


def p_rgetrf_ft(a: DistMatrix, gemm_backend: str = "xla_quire", plan=None,
                max_retries: int = 2, checkpoint_dir=None,
                resume: bool = False, keep_last: int = 2,
                _stop_after=None):
    """Checksum-protected distributed partial-pivot LU: returns (LU
    DistMatrix, ipiv, FtReport) — contract, checkpointing and the
    ``_stop_after`` kill hook as in ``p_rpotrf_ft``; returns
    (None, None, report) when the kill hook fires."""
    lay, grid = a.layout, a.grid
    mn = min(lay.m, lay.n)
    gidx = _indices(lay, grid, a.data.device)

    def run_step(data, ipiv, j, plan, active):
        colpan, okc = _replicate_panel_ft(data, lay, grid, j,
                                          min(lay.nb, mn - j), plan, active)
        return _getrf_step(data, ipiv, lay, grid, gidx, j, gemm_backend,
                           colpan), okc
    ipiv = torch.zeros((mn,), dtype=torch.int32, device=a.data.device)
    data, ipiv, report = _ft_loop("p_rgetrf_ft", a, ipiv,
                                  range(0, mn, lay.nb), run_step, plan,
                                  max_retries, checkpoint_dir, resume,
                                  keep_last, _stop_after)
    if data is None:
        return None, None, report
    return a.with_data(_keep(data, lay, gidx, "getrf")), ipiv, report
