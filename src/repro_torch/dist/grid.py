"""The P x Q process grid over ``torch.distributed`` (counterpart of
``repro.launch.mesh.make_grid_mesh`` and ``repro.dist.layout.grid_coords``).

The reference runs its distributed programs as one ``shard_map`` over a
("row", "col") mesh, where a device reads its coordinate with
``axis_index``.  Here every grid position is a process: rank
``r * Q + c`` holds position (r, c) — the reference's linear device id,
so a device-targeted fault (``FaultPlan(dev=...)``) hits the same tile in
both packages.  A collective "along row" runs among the P ranks that
share a grid column (the reference's ``axis_name="row"``), one "along
col" among the Q ranks of a grid row, one along "all" over the world.

Three ways to run, chosen by the caller and never switched on its own:

* ``backend="gloo"`` with ``device="cpu"`` — every tensor on the host
  (the CPU tests);
* ``backend="gloo"`` with a CUDA device and ``host_staging=True`` — the
  tiles and the local products live on the card; each collective copies
  its operand to the host, runs over gloo and copies the result back.
  This is how several ranks share one GPU, which NCCL refuses;
* ``backend="nccl"`` with one GPU per rank — collectives on the card.

``Grid`` also carries two pieces of per-rank bookkeeping that
``dist.comm`` reads: the name under which collectives count their bytes
(``counting``) and an optional ``StageClock`` that times the stages of a
driver (``timed``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch import _device
from repro_torch.obs import metrics as _obs_metrics


class StageClock:
    """Wall seconds by stage on one rank.  Every stage boundary
    synchronises the rank's device, so work queued on a GPU is timed in
    the stage that queued it (costs a synchronisation per boundary; off
    unless a clock is set on the grid)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.secs: dict[str, float] = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def add(self, stage: str, secs: float) -> None:
        self.secs[stage] = self.secs.get(stage, 0.0) + secs


@dataclasses.dataclass(eq=False)
class Grid:
    """This rank's view of the P x Q grid: coordinates, backend, device,
    and the process groups of its grid column ("row"), its grid row
    ("col") and the world ("all")."""
    p: int
    q: int
    rank: int
    backend: str
    device: torch.device
    host_staging: bool
    groups: dict
    op: str | None = None               # counter scope (``counting``)
    clock: StageClock | None = None     # stage timing (``timed``)

    @property
    def r(self) -> int:
        return self.rank // self.q

    @property
    def c(self) -> int:
        return self.rank % self.q

    def axis_size(self, axis: str) -> int:
        return {"row": self.p, "col": self.q, "all": self.p * self.q}[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return {"row": self.r, "col": self.c, "all": self.rank}[axis]

    @contextlib.contextmanager
    def counting(self, op: str):
        """Collectives inside count their result bytes as
        ``dist.<op>.<kind>.bytes``; on exit ``dist.<op>.calls`` gains one
        (the reference's ``_record_collectives`` names).  Counters only
        record under an open ``obs.scoped()`` collector."""
        prev, self.op = self.op, op
        try:
            yield
        finally:
            self.op = prev
        _obs_metrics.inc(f"dist.{op}.calls")

    @contextlib.contextmanager
    def timed(self, stage: str):
        """Add the region's wall time to ``clock.secs[stage]`` (no-op with
        no clock)."""
        clock = self.clock
        if clock is None:
            yield
            return
        clock.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            clock.sync()
            clock.add(stage, time.perf_counter() - t0)


def check_placement(world: int, backend: str, device,
                    host_staging: bool) -> torch.device:
    """``device`` resolved, after checking that ``world`` ranks can run
    ``backend`` there (``make_grid``'s rules; ``launch.spawn`` checks in
    the parent before it starts a rank)."""
    dev = _device.resolve(device)
    if backend == "nccl":
        if dev.type != "cuda" or host_staging:
            raise ValueError("NCCL runs on CUDA tensors without host "
                             "staging")
        if world > torch.cuda.device_count():
            raise ValueError(f"NCCL needs one GPU per rank: {world} ranks, "
                             f"{torch.cuda.device_count()} GPUs (several "
                             "ranks on one GPU run gloo with host_staging)")
    elif backend == "gloo":
        if (dev.type == "cuda") != host_staging:
            raise ValueError("gloo takes CPU tensors, or CUDA tensors with "
                             "host_staging=True")
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return dev


def make_grid(p: int, q: int, backend: str = "nccl", device="cuda",
              host_staging: bool = False) -> Grid:
    """The P x Q grid over the default process group, which the caller
    has initialised with world size P*Q.  Every rank must call it (it
    creates the row and column groups, on every rank in the same order).

    ``device`` is where this rank's tiles live: the card by default,
    raising when no GPU is present (pass ``backend="gloo"``,
    ``device="cpu"`` for the host).  gloo takes CPU tensors, or CUDA
    tensors with ``host_staging=True``; NCCL takes CUDA tensors, one GPU
    per rank (``device="cuda"`` means ``cuda:<rank>``), and raises when
    the ranks outnumber the GPUs."""
    if not dist.is_initialized():
        raise RuntimeError("make_grid: call torch.distributed."
                           "init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != p * q:
        raise ValueError(f"a {p}x{q} grid needs {p * q} ranks, the process "
                         f"group has {world}")
    if dist.get_backend() != backend:
        raise ValueError(f"grid asks for {backend!r}, the process group "
                         f"runs {dist.get_backend()!r}")
    dev = check_placement(world, backend, device, host_staging)
    if backend == "nccl":
        if dev.index is None:
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    groups = {"all": dist.group.WORLD}
    for c in range(q):                     # grid columns: the "row" axis
        g = dist.new_group([r * q + c for r in range(p)])
        if rank % q == c:
            groups["row"] = g
    for r in range(p):                     # grid rows: the "col" axis
        g = dist.new_group([r * q + c for c in range(q)])
        if rank // q == r:
            groups["col"] = g
    return Grid(p=p, q=q, rank=rank, backend=backend, device=dev,
                host_staging=host_staging, groups=groups)
