"""Logical-axis -> mesh-axis sharding rules (counterpart of
``repro.launch.sharding``), and the per-rank blocks they name.

Params carry logical axes ('mlp', 'heads', 'experts', 'vocab', 'embed',
None) from init; these rules turn them into partition specs:

* TP      — 'mlp'/'heads'/'experts'/'vocab' -> 'model' (column/row
            storage, expert parallelism for MoE, vocab-parallel
            embedding).
* FSDP    — additionally shard the largest unsharded dim of every big
            param over 'data' (required for llama3-405b-class memory).
* DP      — batch dims over ('pod','data'); multi-pod adds pure-DP 'pod'.
* SP      — prefill activations / decode KV caches shard sequence over
            'model'.

A spec is a ``PartitionSpec``: one entry per dimension, ``None``, a mesh
axis or a tuple of mesh axes (major to minor).  The rules are the
reference's, leaf for leaf.  The reference stacks the layers of a period
along a leading axis and decides FSDP on the stacked size; the port keeps
one dict per layer, so ``param_shardings`` applies the rule to the
stacked shape and drops the stack's entry (always ``None``).

``shard_tree`` cuts this rank's block of every leaf out of a full tree
and ``gather_tree`` puts the full leaves back together (all-gathers over
the spec's axes): both move bits only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch.mesh import Mesh, all_gather, dp_axes
from repro_torch.models.common import ArchConfig, is_param
from repro_torch.models.lm import period_of
from repro_torch.tree import Axes

LOGICAL = {"mlp": "model", "heads": "model", "experts": "model",
           "vocab": "model", "embed": None}

# archs whose param+optimizer footprint forces FSDP over 'data'
FSDP_ARCHS = {"llama3-405b", "internvl2-26b", "moonshot-v1-16b-a3b",
              "gemma3-12b", "starcoder2-7b"}
_FSDP_MIN_SIZE = 1 << 22          # only shard params >= 4M elements


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a leaf (``jax.sharding.PartitionSpec``
    as a tuple; a one-axis tuple entry is that axis, as there)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))

    def axes(self) -> tuple[str, ...]:
        """Every mesh axis the spec names."""
        out = []
        for e in self:
            if e is not None:
                out += [e] if isinstance(e, str) else list(e)
        return tuple(out)


P = PartitionSpec


def _spec_for_axes(axes, shape, mesh: Mesh, fsdp: bool) -> P:
    names: list = [LOGICAL.get(a) if a else None for a in axes]
    # stacked layer params carry an extra leading (n_layers/period) dim;
    # those positions never take a mesh axis
    n_stack = len(shape) - len(names)
    while len(names) < len(shape):
        names.insert(0, None)
    # drop assignments that don't divide, and duplicate mesh axes after the
    # first occurrence (e.g. MoE (experts, d, mlp): EP wins, mlp replicates)
    seen: set[str] = set()
    for i, mx in enumerate(names):
        if mx is None:
            continue
        if shape[i] % mesh.shape[mx] != 0 or mx in seen:
            names[i] = None
        else:
            seen.add(mx)
    if fsdp and math.prod(shape) >= _FSDP_MIN_SIZE:
        # shard the largest still-unsharded non-stack dim over the full DP
        # extent ('pod' included on the multi-pod mesh)
        fsdp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
        fsdp_size = math.prod(mesh.shape[a] for a in fsdp_axes)
        cand = [i for i, mx in enumerate(names) if mx is None
                and i >= n_stack and shape[i] % fsdp_size == 0]
        if cand:
            big = max(cand, key=lambda i: shape[i])
            names[big] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return P(*names)


def param_shardings(params, cfg: ArchConfig, mesh: Mesh):
    """The params tree (any device, ``meta`` included) with every leaf's
    tensor replaced by its spec: ``{"w": spec, "axes": axes}``.  Layer
    leaves are judged at the reference's stacked shape."""
    fsdp = cfg.name in FSDP_ARCHS

    def walk(tree, stack: int):
        if isinstance(tree, Axes):
            return tree
        if is_param(tree):
            shape = tuple(tree["w"].shape)
            full = ((stack,) + shape) if stack else shape
            spec = _spec_for_axes(tree["axes"], full, mesh, fsdp)
            return {"w": P(*spec[1:]) if stack else spec,
                    "axes": tree["axes"]}
        if isinstance(tree, dict):
            return {k: walk(v, stack) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, stack) for v in tree)
        return tree

    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = [walk(lp, cfg.n_layers // period_of(cfg)) for lp in v]
        elif k == "enc":
            out[k] = {kk: [walk(lp, cfg.enc_layers) for lp in vv]
                      if kk == "layers" else walk(vv, 0)
                      for kk, vv in v.items()}
        else:
            out[k] = walk(v, 0)
    return out


def opt_shardings(opt_state, param_sh, mesh: Mesh):
    """Optimizer moments inherit their param's spec (compressed int16
    moments share the same layout); the step counter is replicated."""
    def walk(opt, ps):
        if isinstance(opt, Axes):
            return opt
        if isinstance(opt, dict) and set(opt) == {"m", "v"}:
            sh = ps if isinstance(ps, PartitionSpec) else P()
            return {"m": sh, "v": sh}
        if isinstance(opt, dict):
            return {k: walk(v, ps[k] if isinstance(ps, dict) and k in ps
                            else ps) for k, v in opt.items()}
        if isinstance(opt, (list, tuple)):
            return type(opt)(walk(v, ps[i]) for i, v in enumerate(opt))
        return P()

    return {"moments": walk(opt_state["moments"], param_sh), "step": P()}


def _dp_for(batch: int, mesh: Mesh) -> Optional[tuple[str, ...]]:
    dp = dp_axes(mesh)
    size = math.prod(mesh.shape[a] for a in dp)
    if dp and batch % size == 0:
        return dp
    if "data" in dp and batch % mesh.shape["data"] == 0:
        return ("data",)
    return None


def _seq_axis(cell: ShapeCell, mesh: Mesh, seq_shard: bool):
    return "model" if (seq_shard and cell.seq_len % mesh.shape["model"] == 0
                       and cell.kind in ("train", "prefill")) else None


def dist_for(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh,
             seq_shard: bool = True):
    """DistContext matching batch_shardings' choices for this cell."""
    from repro_torch.launch.context import DistContext
    dp = _dp_for(cell.global_batch, mesh) or ()
    return DistContext(mesh=mesh, dp=tuple(dp), ep="model",
                       seq=_seq_axis(cell, mesh, seq_shard))


def batch_shardings(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh,
                    seq_shard: bool = True):
    """Specs of the input batch of a train/prefill step."""
    dp = _dp_for(cell.global_batch, mesh)
    tok = P(dp, _seq_axis(cell, mesh, seq_shard))
    out = {"tokens": tok, "targets": tok}
    if cfg.family == "encdec":
        out["frames"] = P(dp, None, None)
    if cfg.family == "vlm":
        out["vis"] = P(dp, None, None)
    return out


def cache_shardings(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh, cache):
    """Decode-cache specs (the port's per-layer cache): batch over DP
    axes, KV sequence over 'model' (SP), SSM state heads over 'model'."""
    dp = _dp_for(cell.global_batch, mesh)

    def _stacked(spec_tail, ndim):
        spec = list(spec_tail)
        while len(spec) < ndim:
            spec.insert(0, None)
        return P(*spec)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path) for v in tree)
        nd = len(tree.shape)
        msz = mesh.shape["model"]
        if path[-1:] in (("k",), ("v",)):               # (..., B, S, Hkv, Dh)
            if dp is not None and tree.shape[-3] % msz == 0:
                tail = (dp, "model", None, None)
            elif tree.shape[-2] % msz == 0:
                tail = (dp, None, "model", None)
            elif tree.shape[-1] % msz == 0:
                tail = (dp, None, None, "model")
            else:
                tail = (dp, None, None, None)
            return _stacked(tail, nd)
        if path and path[-1] == "conv":                 # (..., B, k-1, C)
            c_ok = tree.shape[-1] % msz == 0
            return _stacked((dp, None, "model" if c_ok else None), nd)
        if path and path[-1] == "h":                    # (..., B, H, N, P)
            h_ok = tree.shape[-3] % msz == 0
            return _stacked((dp, "model" if h_ok else None, None, None), nd)
        if path and path[-1] == "cross_kv":             # (..., B, Se, H, Dh)
            return _stacked((dp, None, None, None), nd)
        return P()
    return walk(cache)


# --------------------------------------------------------------------------
# per-rank blocks
# --------------------------------------------------------------------------

def map_with_specs(fn, tree, specs):
    """``fn(tensor, spec)`` at every tensor of ``tree``, ``specs`` being a
    tree of the same structure with a spec at each tensor's place; names
    (``Axes``) and other values kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, Axes):
        return tree
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_specs(fn, v, s)
                          for v, s in zip(tree, specs))
    return tree


def block(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = mesh.axis_size(entry)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {entry!r} ({n})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(entry) * size, size)
    return x


def block_shape(shape, spec, mesh: Mesh) -> tuple[int, ...]:
    return tuple(s // mesh.axis_size(e) if e is not None else s
                 for s, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def gather(x: torch.Tensor, spec, mesh: Mesh, keep=()) -> torch.Tensor:
    """The full tensor from this rank's block ``x``: one all-gather (with
    the reduce-scatter as its backward) per sharded dimension, in order;
    the dims of ``keep`` stay this rank's block."""
    for dim, entry in enumerate(spec):
        if entry is not None and dim not in keep:
            x = all_gather(x, mesh, entry, dim)
    return x


def shard_tree(tree, specs, mesh: Mesh):
    """Every tensor of ``tree`` cut to this rank's block (a copy)."""
    return map_with_specs(lambda x, s: block(x, s, mesh).clone(), tree,
                          specs)


def gather_tree(tree, specs, mesh: Mesh):
    """The full tensors back from this rank's blocks."""
    with torch.no_grad():
        return map_with_specs(lambda x, s: gather(x, s, mesh), tree, specs)
