"""Step builders (counterpart of ``repro.launch.steps``): the train step
(forward, backward, AdamW), its data-parallel form with the
posit16-compressed gradient sum, and the prefill and serve steps.

``make_train_step`` casts the f32 masters to the compute dtype once a
step, takes the gradient of the loss with respect to those cast leaves
(so a bf16 policy has bf16 gradients, as the reference's), then runs
AdamW on the masters.

With a ``DistContext`` it is the sharded step on this rank of the
context's mesh.  The reference leaves the schedule to XLA's SPMD
partitioner; the port gathers, then computes (ZeRO-3's plan):

* params and AdamW moments live as this rank's blocks
  (``sharding.param_shardings`` / ``opt_shardings``), the batch as its
  block (``batch_shardings``);
* each step casts the blocks to the compute dtype once, then all-gathers
  every leaf over the axes its spec names (autograd all-gathers, so the
  gradients come back reduce-scattered) but the dims the layers take as
  this rank's block (``kept_dims``): the MoE experts along the expert
  axis (``moe_apply_ep``) and the embedding table's rows along "model"
  (the vocab-parallel ``embed``; a tied table is gathered for the
  logits by ``lm._logit_params``);
* with the tokens sequence-sharded they are gathered over "model": the
  layers see the whole sequence of the rank's batch rows, and every
  "model" rank computes them (storage is sharded, the products are not
  split);
* the loss is the rank's share: its targets' summed cross-entropy over
  the global target count and the number of ranks holding the same
  targets, plus the MoE load-balance term (the same on every rank: the
  whole batch's without expert parallelism, the reference's mean over
  the ranks with it) over the world size, so the shares add up to the
  global batch's loss, and so do the gradients, which are then summed
  over the ranks holding the same block (the axes its spec does not
  name);
* AdamW runs on the blocks with the global gradient norm; the metrics
  (loss, ntokens, grad_norm) are global values.

``make_train_step_compressed`` is the reference's manual-DP step
(``shard_map`` over the DP axes) on ranks: every rank of the grid's
``axis`` holds the params and state, runs forward and backward on its
shard of the batch's leading dimension (gradients with respect to the f32
masters, as the reference's per-shard body takes them), sums the
gradients with ``compressed_psum_tree``, divides them by the axis size,
runs AdamW and averages the metrics over the axis.
"""
from __future__ import annotations

import torch

from repro_torch import tree as _tree
from repro_torch.core.policy import torch_dtype
from repro_torch.dist import comm
from repro_torch.dist.grid import Grid
from repro_torch.launch import context as dist_ctx
from repro_torch.launch import sharding as shd
from repro_torch.launch.collectives import compressed_psum_tree
from repro_torch.launch.mesh import all_gather, psum
from repro_torch.models.common import ArchConfig, is_param
from repro_torch.models.lm import (_backbone, chunked_ce_sum,
                                   forward_prefill, forward_train,
                                   init_params, serve_step)
from repro_torch.optim import adamw_update


def _cast_params(params, dtype):
    """The f32 leaves cast to ``dtype``, every leaf a fresh autograd leaf
    that requires a gradient (the reference's one cast a step)."""
    def cast(w):
        w = w.detach()
        if w.dtype == torch.float32:
            w = w.to(dtype)
        return w.requires_grad_(w.dtype.is_floating_point)
    return _tree.map(cast, params)


def _loss_and_grads(params, batch, cfg, remat):
    """(loss, metrics, grads): grads in the structure of ``params``, a
    zero tensor for a leaf the loss does not reach."""
    loss, metrics = forward_train(params, batch, cfg, remat=remat)
    leaves = _tree.leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _tree.unflatten(params, grads)


def make_train_step(cfg: ArchConfig, *, remat: bool = True, lr: float = 3e-4,
                    dist=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ntokens`` and ``grad_norm``.
    With ``dist`` (a ``DistContext``) the sharded step on this rank: the
    arguments and results are the rank's blocks (module docstring)."""
    if dist is not None:
        return _sharded_train_step(cfg, dist, remat=remat, lr=lr)
    policy = cfg.get_policy()
    compress_moments = policy.opt_compression is not None
    compute_dtype = torch_dtype(policy.compute_dtype)

    def train_step(params, opt_state, batch):
        _, metrics, grads = _loss_and_grads(
            _cast_params(params, compute_dtype), batch, cfg, remat)
        params2, opt2, gnorm = adamw_update(
            params, opt_state, grads, lr=lr,
            compress_moments=compress_moments)
        metrics["grad_norm"] = gnorm
        return params2, opt2, metrics

    return train_step


def make_train_step_compressed(cfg: ArchConfig, grid: Grid, *,
                               axis: str = "all", remat: bool = True,
                               lr: float = 3e-4):
    """The data-parallel train step on this rank of ``grid``:
    ``train_step(params, opt_state, batch)`` with the global batch, of
    which this rank takes its shard along ``axis`` (the leading dimension
    split into ``grid.axis_size(axis)`` equal parts)."""
    compress_moments = cfg.get_policy().opt_compression is not None
    size, index = grid.axis_size(axis), grid.axis_index(axis)

    def shard(x):
        if x.shape[0] % size:
            raise ValueError(f"batch dimension {x.shape[0]} does not split "
                             f"over {size} ranks")
        n = x.shape[0] // size
        return x[index * n:(index + 1) * n]

    def train_step(params, opt_state, batch):
        local = {k: shard(v) for k, v in batch.items()}
        _, metrics, grads = _loss_and_grads(
            _cast_params(params, torch.float32), local, cfg, remat)
        grads = compressed_psum_tree(grads, grid, axis)
        grads = _tree.map(lambda g: g / size, grads)
        params2, opt2, gnorm = adamw_update(
            params, opt_state, grads, lr=lr,
            compress_moments=compress_moments)
        metrics["grad_norm"] = gnorm
        metrics = {k: comm.psum(v, grid, axis) / size
                   for k, v in metrics.items()}
        return params2, opt2, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, dist=None):
    def prefill_step(params, batch):
        with dist_ctx.use(dist):
            return forward_prefill(params, batch, cfg)
    return prefill_step


def make_serve_step(cfg: ArchConfig, dist=None):
    def step(params, cache, tokens, pos):
        with dist_ctx.use(dist):
            return serve_step(params, cache, tokens, pos, cfg)
    return step


# --------------------------------------------------------------------------
# the sharded step
# --------------------------------------------------------------------------

class ParamPlan:
    """Where each param leaf of ``cfg`` lives on ``dist``'s mesh and how the
    step gathers it: ``specs`` (``param_shardings``' tree), and per leaf in
    ``tree.leaves`` order its spec and the dims the layers take as this
    rank's block (``kept_dims``)."""

    def __init__(self, cfg: ArchConfig, dist):
        self.mesh = mesh = dist.mesh
        abstract = init_params(0, cfg, device="meta")
        self.specs = shd.param_shardings(abstract, cfg, mesh)
        self.leaf_specs = [(p["w"], kept_dims(p["axes"], p["w"], dist))
                           for p in _params_of(self.specs)]

    def shard(self, params):
        """This rank's blocks of full params (a copy)."""
        return shd.shard_tree(params, self.specs, self.mesh)

    def gather(self, params):
        """The leaves the layers take, from this rank's blocks: autograd
        all-gathers over each spec's axes but the kept dims."""
        leaves = _tree.leaves(params)
        return _tree.unflatten(params, [
            shd.gather(w, spec, self.mesh, kept)
            for w, (spec, kept) in zip(leaves, self.leaf_specs)])


def _params_of(tree) -> list:
    """The param dicts of ``tree`` in ``tree.leaves`` order."""
    if is_param(tree):
        return [tree]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _params_of(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [p for v in tree for p in _params_of(v)]
    return []


def kept_dims(axes, spec, dist) -> tuple[int, ...]:
    """The dims of a leaf (logical ``axes``, ``spec``) that the layers
    take as this rank's block under ``dist``: the "experts" dim where it
    lies along the expert axis (``moe_apply_ep``), and the "vocab" rows of
    the embedding table where they lie along "model" (the vocab-parallel
    ``embed``, ``lm._logit_params``)."""
    if axes[:1] == ("experts",) and spec[0] == dist.ep:
        return (0,)
    if tuple(axes) == ("vocab", "embed") and spec[0] == "model":
        return (0,)
    return ()


def _loss_share(params, batch, cfg: ArchConfig, dist, remat: bool):
    """(this rank's share of the global loss, global metrics) on the
    rank's batch block, under ``dist``."""
    mesh = dist.mesh
    dtype = torch_dtype(cfg.get_policy().compute_dtype)
    tokens, targets = batch["tokens"], batch["targets"]
    if dist.seq is not None:
        tokens = all_gather(tokens, mesh, dist.seq, 1)
    x, aux_total = _backbone(params, dict(batch, tokens=tokens), cfg,
                             remat=remat)
    if dist.seq is not None:
        s_l = targets.shape[1]
        x = x.narrow(1, mesh.axis_index(dist.seq) * s_l, s_l)
    tot, cnt = chunked_ce_sum(params, x, targets, cfg, dtype)
    # ranks holding the same targets: the axes their spec does not name
    held = shd.P(tuple(dist.dp) or None, dist.seq).axes()
    copies = mesh.size // mesh.axis_size(held)
    every = mesh.axis_names
    n_all = psum(cnt, mesh, every) / copies
    share = tot / (torch.clamp(n_all, min=1.0) * copies)
    if cfg.n_experts:
        share = share + 0.01 * aux_total / cfg.n_layers / mesh.size
    loss = psum(share.detach(), mesh, every)
    return share, {"loss": loss, "ntokens": n_all}


def _sharded_train_step(cfg: ArchConfig, dist, *, remat: bool, lr: float):
    policy = cfg.get_policy()
    compress_moments = policy.opt_compression is not None
    compute_dtype = torch_dtype(policy.compute_dtype)
    mesh = dist.mesh
    plan = ParamPlan(cfg, dist)

    def train_step(params, opt_state, batch):
        cast = _cast_params(params, compute_dtype)
        leaves = _tree.leaves(cast)
        with dist_ctx.use(dist):
            share, metrics = _loss_share(plan.gather(cast), batch, cfg, dist,
                                         remat)
            grads = torch.autograd.grad(share, leaves, allow_unused=True)
        summed, sq = [], 0.0
        for w, g, (spec, _) in zip(leaves, grads, plan.leaf_specs):
            g = torch.zeros_like(w) if g is None else g.float()
            held = spec.axes()
            g = psum(g, mesh, tuple(a for a in mesh.axis_names
                                        if a not in held))
            summed.append(g)
            # each block is held by size / |held| ranks
            sq = sq + torch.sum(g * g) / (mesh.size // mesh.axis_size(held))
        gnorm = torch.sqrt(psum(sq, mesh, mesh.axis_names))
        params2, opt2, gnorm = adamw_update(
            params, opt_state, _tree.unflatten(params, summed), lr=lr,
            compress_moments=compress_moments, grad_norm=gnorm)
        metrics["grad_norm"] = gnorm
        return params2, opt2, metrics

    train_step.plan = plan
    return train_step
