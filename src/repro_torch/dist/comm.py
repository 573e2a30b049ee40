"""The collectives of the distributed posit stack (the ``jax.lax``
collectives the reference's ``shard_map`` bodies use, and
``repro.launch.collectives.limb_psum``), over ``torch.distributed``.

Every collective of ``repro_torch.dist`` goes through this module.  Each
one

* runs over the grid axis it names ("row": the P ranks of this grid
  column; "col": the Q ranks of this grid row; "all": the world), in
  grid-coordinate order, as the reference's named axes do;
* with ``grid.host_staging``, copies its operand to the host and its
  result back to the grid's device, timed apart as the "staging" stage;
  the collective itself is the "collective" stage (``Grid.timed``);
* inside ``grid.counting(op)`` adds the bytes of its RESULT tensor to
  the counter ``dist.<op>.<kind>.bytes`` — the reference's accounting
  convention (per-device collective result shapes), so the counts equal
  its static plans (``pblas.pdgemm_collective_plan``,
  ``pdecomp.pfactor_collective_plan``).

The reductions are integer sums (posit words with zeros off the owner,
quire limb planes, flags): exact in any order, which is what keeps the
distributed words bit-identical to the single-device ones.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.grid import Grid
from repro_torch.obs import metrics as _obs_metrics


# Moved bytes for bytes under a dtype the backends carry: neither gloo
# nor NCCL has int16, so p16e1 words travel as the float16 of their bits
# (the exchanges only copy).
_CARRIED = {torch.int16: torch.float16}


def _carry(x: torch.Tensor) -> torch.Tensor:
    return x.view(_CARRIED[x.dtype]) if x.dtype in _CARRIED else x


def _stage_in(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    x = x.contiguous()
    if not grid.host_staging:
        return x
    with grid.timed("staging"):
        return x.cpu()


def _stage_out(y: torch.Tensor, grid: Grid, kind: str) -> torch.Tensor:
    if grid.op is not None:
        _obs_metrics.inc(f"dist.{grid.op}.{kind}.bytes",
                         y.numel() * y.element_size())
    if not grid.host_staging:
        return y
    with grid.timed("staging"):
        return y.to(grid.device)


def all_gather(x: torch.Tensor, grid: Grid, axis: str) -> torch.Tensor:
    """(g, *x.shape): every rank's ``x`` along ``axis``, stacked in grid
    order (``jax.lax.all_gather(..., tiled=False)``)."""
    xs = _carry(_stage_in(x, grid))
    parts = [torch.empty_like(xs) for _ in range(grid.axis_size(axis))]
    with grid.timed("collective"):
        dist.all_gather(parts, xs, group=grid.groups[axis])
    return _stage_out(torch.stack(parts).view(x.dtype), grid, "all-gather")


def psum(x: torch.Tensor, grid: Grid, axis: str) -> torch.Tensor:
    """Elementwise sum over ``axis`` (integer tensors: exact)."""
    xs = _stage_in(x, grid)
    if not grid.host_staging:
        xs = xs.clone()                     # all_reduce works in place
    with grid.timed("collective"):
        dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=grid.groups[axis])
    return _stage_out(xs, grid, "all-reduce")


def _exchange(x: torch.Tensor, grid: Grid, axis: str, dim: int):
    """``x`` cut into g equal chunks along ``dim``; chunk i goes to the
    rank at coordinate i of ``axis``.  Returns (g, chunk) received, in
    source order (one ``all_to_all_single``)."""
    g = grid.axis_size(axis)
    if x.shape[dim] % g:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {g} chunks")
    xs = _carry(_stage_in(x.movedim(dim, 0), grid))
    xs = xs.reshape((g, xs.shape[0] // g) + tuple(xs.shape[1:]))
    got = torch.empty_like(xs)
    with grid.timed("collective"):
        dist.all_to_all_single(got, xs, group=grid.groups[axis])
    return got.view(x.dtype)


def psum_scatter(x: torch.Tensor, grid: Grid, axis: str,
                 dim: int) -> torch.Tensor:
    """Sum over ``axis``, then keep this rank's chunk of ``dim``
    (``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``):
    the chunks are exchanged and summed here, in grid order."""
    y = _exchange(x, grid, axis, dim).sum(dim=0, dtype=x.dtype)
    return _stage_out(y.movedim(0, dim), grid, "reduce-scatter")


def all_to_all(x: torch.Tensor, grid: Grid, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: chunk i of ``split_axis``
    to coordinate i; the chunks received concatenated along
    ``concat_axis`` in source order."""
    got = _exchange(x, grid, axis, split_axis).movedim(1, split_axis + 1)
    y = torch.cat(list(got), dim=concat_axis)
    return _stage_out(y, grid, "all-to-all")


def limb_psum(limbs: torch.Tensor, nar: torch.Tensor, grid: Grid,
              axis: str):
    """Cross-rank quire reduction in limb space: the int64 limb planes
    summed (integer adds are associative, so rounding once afterwards is
    bit-identical to accumulating the whole K range on one rank) and NaR
    ORed across ranks."""
    limbs = psum(limbs, grid, axis)
    nar = psum(nar.to(torch.int32), grid, axis) > 0
    return limbs, nar


def barrier(grid: Grid) -> None:
    kw = {"device_ids": [grid.device.index]} if grid.backend == "nccl" else {}
    dist.barrier(group=grid.groups["all"], **kw)
