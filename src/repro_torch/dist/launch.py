"""Start a P x Q grid of ranks on this host and collect what they return.

    ranks = launch.spawn(fn, p, q, workdir, args=(...))
    ...                                   # the parent is free meanwhile
    results = ranks.join(timeout=600)     # [fn(grid, *args) of rank 0, ...]

Each rank is a fresh interpreter (the ``spawn`` start method: a parent
that holds a CUDA context must not fork).  It joins the process group
through a rendezvous file in ``workdir`` (no TCP port to race for),
builds its ``Grid`` with ``make_grid``, runs ``fn(grid, *args)`` and
writes the result to ``workdir/rank<r>.pt``; the parent loads them once
every rank has exited, and raises with the failing rank's traceback if
one did not finish.  ``fn`` must be importable by module path (a
module-level function) and return CPU tensors or plain Python values.

The grid defaults to ``make_grid``'s: NCCL with one GPU per rank.  The
parent checks the placement before it starts a rank (``RuntimeError``
when no GPU is present, ``ValueError`` for NCCL with more ranks than
GPUs, or gloo on the card without host staging).  On one GPU,
several ranks share the card with ``backend="gloo"``, ``device="cuda"``
and ``host_staging=True`` (dist/grid.py); on the host they run
``backend="gloo"``, ``device="cpu"``.  Build the kernel library in the
parent first, so that the ranks load it from the build cache instead of
all compiling it.
"""
from __future__ import annotations

import multiprocessing
import traceback
from pathlib import Path

import torch

from repro_torch.dist.grid import check_placement


def _nccl_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    return dev if dev.index is not None else torch.device("cuda", rank)


def _rank_main(rank, world, fn, args, grid_kw, workdir):
    import torch.distributed as dist
    from repro_torch.dist.grid import make_grid
    out_path = Path(workdir) / f"rank{rank}.pt"
    try:
        # one intra-op thread a rank: the ranks share the host's cores,
        # and a rank's host work is small ops, staging copies and gloo
        torch.set_num_threads(1)
        kw = {}
        if grid_kw["backend"] == "nccl":     # NCCL binds a rank to its GPU
            kw["device_id"] = _nccl_device(grid_kw["device"], rank)
        dist.init_process_group(
            grid_kw["backend"], rank=rank, world_size=world,
            init_method=f"file://{Path(workdir) / 'rendezvous'}", **kw)
        try:
            grid = make_grid(**grid_kw)
            result = fn(grid, *args)
            torch.save(result, out_path)
        finally:
            dist.destroy_process_group()
    except BaseException:
        (Path(workdir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise


class Ranks:
    """The running ranks of one ``spawn``."""

    def __init__(self, procs, workdir: Path):
        self.procs = procs
        self.workdir = workdir

    def join(self, timeout: float | None = None) -> list:
        """Wait for every rank (``timeout`` seconds in all) and return
        their results in rank order; kills the rest and raises if one
        failed or time ran out."""
        import time
        end = None if timeout is None else time.monotonic() + timeout
        for proc in self.procs:
            left = None if end is None else max(0.0, end - time.monotonic())
            proc.join(left)
        bad = [r for r, p in enumerate(self.procs)
               if p.is_alive() or p.exitcode != 0]
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        if bad:
            errs = [(self.workdir / f"rank{r}.err") for r in bad]
            msg = "\n".join(e.read_text() for e in errs if e.exists())
            raise RuntimeError(f"ranks {bad} did not finish (exit codes "
                               f"{[self.procs[r].exitcode for r in bad]})"
                               f"\n{msg[-4000:]}")
        return [torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                for r in range(len(self.procs))]


def spawn(fn, p: int, q: int, workdir, args=(), backend: str = "nccl",
          device="cuda", host_staging: bool = False) -> Ranks:
    """Start P*Q ranks running ``fn(grid, *args)`` (module docstring);
    ``workdir`` must be an empty directory private to this grid.  Each
    rank runs one intra-op thread."""
    check_placement(p * q, backend, device, host_staging)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    if any(workdir.iterdir()):
        raise ValueError(f"{workdir} is not empty")
    grid_kw = dict(p=p, q=q, backend=backend, device=str(device),
                   host_staging=host_staging)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, p * q, fn, args, grid_kw, str(workdir)))
             for r in range(p * q)]
    for proc in procs:
        proc.start()
    return Ranks(procs, workdir)


def run(fn, p: int, q: int, workdir, args=(), timeout: float | None = None,
        **kw) -> list:
    """``spawn(...).join(timeout)``."""
    return spawn(fn, p, q, workdir, args=args, **kw).join(timeout)
