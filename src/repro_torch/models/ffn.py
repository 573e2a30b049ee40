"""Dense FFN (SwiGLU/GELU) and MoE with sort-based grouped dispatch
(counterpart of ``repro.models.ffn``, single device).

The reference's grouped GEMM is ``jax.lax.ragged_dot`` (an XLA op, no
Pallas kernel): here it is one f32-accumulated matmul per expert over
that expert's contiguous rows of the expert-sorted token list, with
the reference's hand-written VJP (``_GroupedMM``).  The
routed outputs are summed per token in the order the reference's
scatter-add meets them (ascending expert id), starting from zero.  The
expert-parallel form (``moe_apply_ep``, an all_to_all dispatch) comes
with the launch layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ArchConfig, act_fn, leaf, linear,
                                       linear_init, param)


def ffn_init(rng, cfg: ArchConfig, d_ff: int | None = None):
    d_ff = d_ff or cfg.d_ff
    p = {"w_up": linear_init(rng, cfg.d_model, d_ff, (None, "mlp")),
         "w_down": linear_init(rng, d_ff, cfg.d_model, ("mlp", None))}
    if cfg.act == "silu":                      # gated (SwiGLU)
        p["w_gate"] = linear_init(rng, cfg.d_model, d_ff, (None, "mlp"))
    return p


def ffn_apply(params, x, cfg: ArchConfig, policy, compute_dtype):
    up = linear(params["w_up"], x, policy, compute_dtype)
    if "w_gate" in params:
        gate = linear(params["w_gate"], x, policy, compute_dtype)
        h = F.silu(gate) * up
    else:
        h = act_fn(cfg.act)(up)
    return linear(params["w_down"], h, policy, compute_dtype)


def _grouped_forward(x, w, group_sizes):
    out = x.new_zeros((x.shape[0], w.shape[-1]), dtype=torch.float32)
    start = 0
    for e, n in enumerate(group_sizes):
        if n:
            out[start:start + n] = torch.matmul(
                x[start:start + n].float(), w[e].float())
        start += n
    return out


class _GroupedMM(torch.autograd.Function):
    """The grouped GEMM with the reference's hand-written VJP: ``dx`` is
    ``dy @ w[e]^T`` per group, ``dw[e]`` is ``x_g^T @ dy_g`` (zero for an
    empty group), both summed in f32 and cast back to their primal's
    dtype."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w)
        ctx.group_sizes = group_sizes
        return _grouped_forward(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy32 = dy.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        start = 0
        for e, n in enumerate(ctx.group_sizes):
            if n:
                rows = slice(start, start + n)
                dx[rows] = torch.matmul(dy32[rows], w[e].float().T)
                dw[e] = torch.matmul(x[rows].float().T, dy32[rows])
            start += n
        return dx.to(x.dtype), dw.to(w.dtype), None


def _grouped_mm(x, w, group_sizes):
    """(T, d) @ (E, d, f) -> f32 (T, f): rows of x grouped by expert in
    ``group_sizes`` (host ints summing to T), each group against its
    expert's matrix, products summed in f32."""
    return _GroupedMM.apply(x, w, group_sizes)


def moe_init(rng, cfg: ArchConfig):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": linear_init(rng, d, e, (None, None)),
        "w_gate": param(rng, (e, d, f), ("experts", None, "mlp")),
        "w_up": param(rng, (e, d, f), ("experts", None, "mlp")),
        "w_down": param(rng, (e, f, d), ("experts", "mlp", None)),
    }


def moe_apply(params, x, cfg: ArchConfig, policy, compute_dtype):
    """Single-device MoE (the reference's path without a distribution
    context)."""
    return moe_apply_local(params, x, cfg, policy, compute_dtype)


def moe_apply_local(params, x, cfg: ArchConfig, policy, compute_dtype):
    """Returns (y, aux_loss).  x: (B, S, d)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    flat = x.reshape(t, d)

    logits = linear(params["router"], flat, policy, torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                     # (T, k)
    top_w = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance aux loss.
    frac_tokens = F.one_hot(top_e, e).to(torch.float32).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=0)
    aux = float(e) * torch.sum(frac_tokens * frac_probs)

    # sort token-expert pairs by expert id -> grouped GEMMs
    eid = top_e.reshape(t * k)
    order = torch.argsort(eid, stable=True)
    tok = order // k                                                # (T*k,)
    xs = flat[tok].to(compute_dtype)
    group_sizes = torch.bincount(eid, minlength=e).tolist()

    def grouped(w):
        ww = policy.maybe_quantize_weights(leaf(w)).to(compute_dtype)
        return lambda inp: _grouped_mm(inp, ww, group_sizes)

    gate = grouped(params["w_gate"])(xs)
    up = grouped(params["w_up"])(xs)
    h = (F.silu(gate) * up).to(compute_dtype)
    out = grouped(params["w_down"])(h)                              # (T*k, d)

    w_sorted = top_w.reshape(t * k)[order]
    out = out * w_sorted[:, None]
    # per token, its k rows in sorted order (ascending expert id), added
    # to zero one after another as the reference's scatter-add does
    pos = torch.empty_like(order)
    pos[order] = torch.arange(t * k, device=x.device)
    rank = torch.argsort(top_e, dim=-1, stable=True)                # (T, k)
    rows = torch.gather(pos.reshape(t, k), 1, rank)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + out[rows[:, j]]
    return y.reshape(b, s, d).to(compute_dtype), aux
