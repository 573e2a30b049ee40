"""Step builders (counterpart of ``repro.launch.steps``): the train step
(forward, backward, AdamW), its data-parallel form with the
posit16-compressed gradient sum, and the prefill and serve steps.

``make_train_step`` casts the f32 masters to the compute dtype once a
step, takes the gradient of the loss with respect to those cast leaves
(so a bf16 policy has bf16 gradients, as the reference's), then runs
AdamW on the masters.

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
from repro_torch.launch.collectives import compressed_psum_tree
from repro_torch.models.common import ArchConfig
from repro_torch.models.lm import forward_prefill, forward_train, serve_step
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


def make_train_step(cfg: ArchConfig, *, remat: bool = True, lr: float = 3e-4):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``ntokens`` and ``grad_norm``."""
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


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return forward_prefill(params, batch, cfg)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def step(params, cache, tokens, pos):
        return serve_step(params, cache, tokens, pos, cfg)
    return step
