"""Multi-pod dry run on the meta device (counterpart of
``repro.launch.dryrun``).

For each (arch, shape cell, production mesh) it builds one rank's step and
arguments at their local block shapes, as meta tensors, and runs the step
on them: nothing is allocated and nothing is computed, but every op and
every collective of the port's plan runs with its real shapes.  The
record holds

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count over
  the forward (and, for train cells, the backward) at the local shapes:
  the matrix products, the flop counter's ops;
* ``collective_bytes`` by kind: the result bytes of every collective of
  the plan (``launch.mesh``'s counts; on an abstract mesh they return
  meta tensors of their result's shape and run nothing) — the port's own
  plan, the one ``launch.steps`` runs on ranks, not XLA's;
* ``argument_size_bytes`` / ``output_size_bytes``: the bytes of the
  rank's arguments and results; ``bytes_accessed``, ``temp_size_bytes``
  and ``generated_code_size_bytes`` are null (the meta device cannot know
  them).

The plans: a train cell runs ``make_train_step`` with the cell's
``DistContext`` (gather, then compute: ``launch/steps.py``); a prefill
cell gathers the params (the same rule) and the token sequence, then runs
``forward_prefill`` under the context; a decode cell gathers the params
and the rank's cache rows (every axis but the batch's), then runs
``serve_step`` under it.  The reference's ``--compressed`` cells have no
counterpart: the port's compressed step (``make_train_step_compressed``)
is data-parallel over a ``dist`` grid's axis, with no sharded plan, so the
record's ``compressed`` is always false.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --cell train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both      # the full matrix
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as _tree
from repro_torch.configs import (ARCH_IDS, ShapeCell, applicable_cells,
                                 cell_by_name, get_config)
from repro_torch.data.pipeline import input_specs
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh, all_gather, make_production_mesh
from repro_torch.launch.steps import (ParamPlan, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import init_cache, init_params
from repro_torch.models.common import ArchConfig
from repro_torch.optim import adamw_init

META = torch.device("meta")


def _batch(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh):
    """This rank's block of the cell's train/prefill batch, as meta
    tensors."""
    specs = shd.batch_shardings(cfg, cell, mesh)
    return {k: torch.empty(shd.block_shape(shape, specs[k], mesh),
                           dtype=dtype, device=META)
            for k, (shape, dtype) in input_specs(cfg, cell).items()
            if k in specs}


def build_step(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh, *,
               remat: bool = True, lr: float = 3e-4):
    """(fn, args): one rank's step of ``cell`` on ``mesh`` and its
    arguments at their local block shapes on the meta device."""
    dist = shd.dist_for(cfg, cell, mesh)
    full = init_params(0, cfg, device=META)
    if cell.kind == "train":
        step = make_train_step(cfg, remat=remat, lr=lr, dist=dist)
        plan = step.plan
        compress = cfg.get_policy().opt_compression is not None
        opt = adamw_init(full, compress_moments=compress)
        opt = shd.shard_tree(opt, shd.opt_shardings(opt, plan.specs, mesh),
                             mesh)
        return step, (plan.shard(full), opt, _batch(cfg, cell, mesh))

    plan = ParamPlan(cfg, dist)
    if cell.kind == "prefill":
        prefill = make_prefill_step(cfg, dist=dist)

        def prefill_fn(params, batch):
            tokens = batch["tokens"]
            if dist.seq is not None:
                tokens = all_gather(tokens, mesh, dist.seq, 1)
            with torch.no_grad():
                return prefill(plan.gather(params), dict(batch,
                                                         tokens=tokens))
        batch = _batch(cfg, cell, mesh)
        batch.pop("targets")
        return prefill_fn, (plan.shard(full), batch)

    cache = init_cache(cfg, cell.global_batch, cell.seq_len, device=META)
    if cfg.family == "encdec":
        kv = (cell.global_batch, cfg.enc_seq, cfg.n_kv_heads, cfg.d_head)
        cache["cross_kv"] = [
            (torch.empty(kv, dtype=torch.bfloat16, device=META),
             torch.empty(kv, dtype=torch.bfloat16, device=META))
            for _ in range(cfg.n_layers)]
    cache_specs = shd.cache_shardings(cfg, cell, mesh, cache)
    dp = shd._dp_for(cell.global_batch, mesh)
    rows_entry = shd.P(dp)[0]               # the batch dim's spec entry
    serve = make_serve_step(cfg, dist=dist)

    def decode_fn(params, cache, tokens):
        rows = shd.map_with_specs(
            lambda x, s: shd.gather(x, s, mesh, keep=tuple(
                i for i, e in enumerate(s)
                if e is not None and e == rows_entry)),
            cache, cache_specs)
        with torch.no_grad():
            return serve(plan.gather(params), rows, tokens,
                         cell.seq_len - 1)
    tokens = torch.empty(shd.block_shape((cell.global_batch, 1),
                                         shd.P(dp, None), mesh),
                         dtype=torch.int32, device=META)
    return decode_fn, (plan.shard(full),
                       shd.shard_tree(cache, cache_specs, mesh), tokens)


def build_cell(arch: str, cell_name: str, mesh: Mesh, *, policy=None):
    """(fn, args, cfg) for ``fn(*args)`` on the meta device."""
    cfg = get_config(arch, policy)
    fn, args = build_step(cfg, cell_by_name(cell_name), mesh)
    return fn, args, cfg


def _tensor_bytes(tree) -> int:
    flat, _ = _tree.flatten(tree)
    return sum(t.numel() * t.element_size() for t in flat)


def measure(fn, args, mesh: Mesh) -> dict:
    """Run ``fn(*args)`` on the meta device: its flops, collective bytes by
    kind and argument/output bytes."""
    mesh.reset_counts()
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "collective_bytes": dict(mesh.counts),
            "argument_size_bytes": _tensor_bytes(args),
            "output_size_bytes": _tensor_bytes(out)}


def run_cell(arch: str, cell_name: str, mesh_kind: str, *, policy=None,
             outdir: str = "experiments/dryrun",
             verbose: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    t0 = time.time()
    fn, args, _ = build_cell(arch, cell_name, mesh, policy=policy)
    t_build = time.time() - t0
    got = measure(fn, args, mesh)
    t_run = time.time() - t0 - t_build
    rec = {
        "arch": arch, "cell": cell_name, "mesh": mesh_kind,
        "policy": policy or "default", "compressed": False,
        "n_devices": mesh.size, "plan": "port: gather, then compute",
        "build_s": round(t_build, 2), "run_s": round(t_run, 2),
        "flops": got["flops"], "bytes_accessed": None,
        "collective_bytes": got["collective_bytes"],
        "argument_size_bytes": got["argument_size_bytes"],
        "output_size_bytes": got["output_size_bytes"],
        "temp_size_bytes": None, "generated_code_size_bytes": None,
    }
    if verbose:
        print(f"[dryrun] {arch} x {cell_name} x {mesh_kind}")
        print(f"  build {t_build:.2f}s run {t_run:.2f}s (meta device)")
        print(f"  per device: args={rec['argument_size_bytes']} "
              f"out={rec['output_size_bytes']} flops={rec['flops']:.3e}")
        print(f"  collectives: {rec['collective_bytes']}")
    os.makedirs(outdir, exist_ok=True)
    tag = f"{arch}_{cell_name}_{mesh_kind}"
    if policy:
        tag += f"_{policy}"
    with open(os.path.join(outdir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--policy", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        cells = ([cell_by_name(args.cell)] if args.cell
                 else applicable_cells(cfg))
        for cell in cells:
            for mk in meshes:
                try:
                    run_cell(arch, cell.name, mk, policy=args.policy,
                             outdir=args.outdir)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, cell.name, mk, repr(e)[:300]))
                    print(f"[FAIL] {arch} x {cell.name} x {mk}: "
                          f"{repr(e)[:300]}")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        sys.exit(1)
    print("\nall dry-run cells ran OK")


if __name__ == "__main__":
    main()
