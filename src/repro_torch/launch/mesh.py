"""Meshes and their collectives (counterpart of ``repro.launch.mesh``).

A ``Mesh`` has named axes and a ``shape`` (axis name -> size), in the
reference's axis order.  Where ranks exist it sits on a ``dist.grid.Grid``
and each mesh axis maps onto one of the grid's process groups: on a P x Q
grid, "data" is the grid's "row" axis (the P ranks of a grid column) and
"model" its "col" axis (the Q ranks of a grid row), so rank ``d*Q + m``
holds mesh coordinate (d, m), the device order of ``jax.make_mesh((P, Q),
("data", "model"))``.  A 1 x PQ or PQ x 1 mesh on the same grid maps its
long axis onto the grid's "all" group.  A mesh without a grid is
abstract: the production meshes (16 x 16, 2 x 16 x 16), which exist only
for the dry run, and the smoke mesh.

The collectives of the sharded launch layer are here, each an autograd
function whose backward is the transposed collective (an all-gather's is
a reduce-scatter, a psum's a psum, an all-to-all's the reverse
all-to-all), so gradients flow across ranks.  Each one, the
reduce-scatter of an all-gather's backward included,

* runs through ``dist.comm`` over the grid group of its mesh axes (over
  axes of size 1 with no group it is the identity, and counts nothing);
* on an abstract mesh runs nothing: a meta tensor in gives a meta tensor
  of the result's shape out (a real tensor raises, except over axes of
  size 1);
* adds the bytes of its result to ``mesh.counts[kind]`` (kinds
  "all-gather", "all-reduce", "reduce-scatter", "all-to-all": the
  reference's per-device accounting of its HLO collectives), the same
  count on a real and on an abstract mesh, so a dry run's counts are the
  plan a run on ranks moves;
* with ``mesh.clock`` set (a ``dist.grid.StageClock``), adds its wall
  time under its kind (a device sync on each side).

Reductions of floating tensors run in f32 and return the input's dtype.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Optional, Sequence, Union

import torch

from repro_torch.dist import comm
from repro_torch.dist.grid import Grid, StageClock

Axes = Union[None, str, Sequence[str]]


class Mesh:
    """Named axes, their sizes, this rank's coordinates and, where ranks
    exist, the grid whose process groups carry each axis."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 grid: Optional[Grid] = None,
                 grid_axes: Optional[dict] = None,
                 coords: Optional[dict] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.grid = grid
        self.grid_axes = dict(grid_axes or {})
        self.coords = {a: 0 for a in self.axis_names}
        self.coords.update(coords or {})
        self.counts: dict[str, int] = {}
        self.clock: Optional[StageClock] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def names(self, axes: Axes) -> tuple[str, ...]:
        if axes is None:
            return ()
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self.names(axes))

    def axis_index(self, axes: Axes) -> int:
        """This rank's coordinate along ``axes`` (a tuple of axes counts
        major to minor, as a ``PartitionSpec`` entry does)."""
        idx = 0
        for a in self.names(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def reset_counts(self) -> None:
        self.counts = {}

    def _count(self, kind: str, y: torch.Tensor) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + \
            y.numel() * y.element_size()

    def group_of(self, axes: Axes) -> Optional[str]:
        """The grid axis that carries ``axes`` (None: every axis of size
        1 without a group, the identity)."""
        names = [a for a in self.names(axes)
                 if self.shape[a] > 1 or a in self.grid_axes]
        if not names:
            return None
        if self.grid is None:
            return "abstract"
        if len(names) == 1:
            return self.grid_axes[names[0]]
        if [a for a in self.axis_names if a in names] == names and \
                math.prod(self.shape[a] for a in names) == \
                self.grid.axis_size("all"):
            return "all"
        raise ValueError(f"mesh axes {names} map onto no process group of "
                         f"this grid")

    @contextlib.contextmanager
    def _timed(self, kind: str, x: torch.Tensor):
        clock = self.clock
        if clock is None or x.is_meta:
            yield
            return
        clock.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            clock.sync()
            clock.add(kind, time.perf_counter() - t0)


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract 16 x 16 ("data", "model") mesh, or 2 x 16 x 16 with a
    leading data-parallel "pod" axis: the dry run's meshes."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_smoke_mesh(model: int = 1) -> Mesh:
    """An abstract 1 x ``model`` mesh (the reference's smoke mesh)."""
    return Mesh(("data", "model"), (1, model))


def make_data_model_mesh(grid: Grid, data: Optional[int] = None,
                         model: Optional[int] = None) -> Mesh:
    """The ("data", "model") mesh on the ranks of ``grid``: by default
    ``grid.p`` x ``grid.q`` ("data" on the grid's "row" axis, "model" on
    its "col" axis); 1 x PQ or PQ x 1 puts the long axis on "all"."""
    data = grid.p if data is None else data
    model = grid.q if model is None else model
    world = grid.axis_size("all")
    if (data, model) == (grid.p, grid.q):
        axes = {"data": "row", "model": "col"}
    elif data * model == world and 1 in (data, model):
        axes = {"model": "all"} if data == 1 else {"data": "all"}
    else:
        raise ValueError(f"a {data} x {model} mesh does not fit a "
                         f"{grid.p} x {grid.q} grid")
    coords = {a: grid.axis_index(g) for a, g in axes.items()}
    return Mesh(("data", "model"), (data, model), grid=grid, grid_axes=axes,
                coords=coords)


def make_grid_mesh(grid: Grid) -> Mesh:
    """The P x Q ("row", "col") mesh of ``grid`` itself (the reference's
    ``make_grid_mesh``: its distributed linear algebra's process grid)."""
    return Mesh(("row", "col"), (grid.p, grid.q), grid=grid,
                grid_axes={"row": "row", "col": "col"},
                coords={"row": grid.r, "col": grid.c})


# --------------------------------------------------------------------------
# the collectives
# --------------------------------------------------------------------------

def _run(kind: str, x: torch.Tensor, mesh: Mesh, axes: Axes, shape,
         real) -> torch.Tensor:
    """One collective: a meta result on an abstract mesh, ``real(grid
    axis)`` on a grid, ``x`` itself over size-1 axes without a group."""
    group = mesh.group_of(axes)
    if group is None:
        return x
    if x.is_meta:
        y = torch.empty(shape, dtype=x.dtype, device="meta")
    elif group == "abstract":
        raise RuntimeError(f"{kind} over {axes!r}: an abstract mesh runs no "
                           "collective on real tensors (pass meta tensors)")
    else:
        with mesh._timed(kind, x):
            y = real(group)
    mesh._count(kind, y)
    return y


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.is_floating_point() else x


def _raw_all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes,
                   dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    shape = list(x.shape)
    shape[dim] *= n

    def real(g):
        return torch.cat(list(comm.all_gather(x, mesh.grid, g)), dim=dim)
    return _run("all-gather", x, mesh, axes, shape, real)


def _raw_psum(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    def real(g):
        return comm.psum(_wide(x), mesh.grid, g).to(x.dtype)
    return _run("all-reduce", x, mesh, axes, list(x.shape), real)


def _raw_psum_scatter(x: torch.Tensor, mesh: Mesh, axes: Axes,
                     dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    shape = list(x.shape)
    shape[dim] //= n

    def real(g):
        return comm.psum_scatter(_wide(x), mesh.grid, g, dim).to(x.dtype)
    return _run("reduce-scatter", x, mesh, axes, shape, real)


def _raw_all_to_all(x: torch.Tensor, mesh: Mesh, axes: Axes,
                   dim: int = 0) -> torch.Tensor:
    def real(g):
        return comm.all_to_all(x, mesh.grid, g, dim, dim)
    return _run("all-to-all", x, mesh, axes, list(x.shape), real)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _raw_all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_psum_scatter(g, *ctx.args), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _raw_psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _raw_psum(g, *ctx.args), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _raw_all_to_all(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_to_all(g, *ctx.args), None, None, None


def all_gather(x, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axes`` concatenated along ``dim`` in
    mesh order (``jax.lax.all_gather(..., tiled=True)``); the backward
    is the reduce-scatter."""
    return _AllGather.apply(x, mesh, axes, dim)


def psum(x, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """The sum over ``axes`` on every rank; the backward is the psum."""
    return _Psum.apply(x, mesh, axes)


def all_to_all(x, mesh: Mesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    """Chunk i of ``dim`` to the rank at coordinate i of ``axes``, the
    chunks received concatenated along ``dim`` in source order; the
    backward is the reverse all-to-all."""
    return _AllToAll.apply(x, mesh, axes, dim)
