"""Dense FFN (SwiGLU/GELU) and MoE with sort-based grouped dispatch
(counterpart of ``repro.models.ffn``, single device).

The reference's grouped GEMM is ``jax.lax.ragged_dot`` (an XLA op, no
Pallas kernel): here it is one f32-accumulated matmul per expert over
that expert's contiguous rows of the expert-sorted token list, with
the reference's hand-written VJP (``_GroupedMM``).  The
routed outputs are summed per token in the order the reference's
scatter-add meets them (ascending expert id), starting from zero.

Under a distribution context whose expert axis has more than one rank,
``moe_apply`` runs ``moe_apply_ep``: the reference's expert parallelism,
a capacity-bounded all-to-all dispatch over the launch layer's autograd
collectives (the backward is the reverse all-to-all).
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
    """Dispatch: expert parallelism when a distribution context's expert
    axis has more than one rank, the single-device path otherwise."""
    from repro_torch.launch import context as dist_ctx
    ctx = dist_ctx.current()
    if ctx is not None and ctx.mesh.shape.get(ctx.ep, 1) > 1:
        return moe_apply_ep(params, x, cfg, policy, compute_dtype, ctx)
    return moe_apply_local(params, x, cfg, policy, compute_dtype, ctx)


def moe_apply_local(params, x, cfg: ArchConfig, policy, compute_dtype,
                    ctx=None):
    """Returns (y, aux_loss).  x: (B, S, d).  Under a distribution
    context ``x`` is this rank's rows of the batch, and the load-balance
    fractions are averaged over ``ctx.dp`` before they are multiplied:
    the aux loss of the whole batch, as one process has it."""
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
    if ctx is not None and ctx.mesh.axis_size(ctx.dp) > 1:
        from repro_torch.launch.mesh import psum
        n = ctx.mesh.axis_size(ctx.dp)      # ranks with equal row counts
        frac_tokens = psum(frac_tokens, ctx.mesh, ctx.dp) / n
        frac_probs = psum(frac_probs, ctx.mesh, ctx.dp) / n
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


# --------------------------------------------------------------------------
# expert parallelism (capacity-bounded all_to_all)
# --------------------------------------------------------------------------

def _one_hot(idx, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _bucket_positions(dest, n: int) -> torch.Tensor:
    """Position of each entry among the earlier entries with the same
    destination (one-hot running counts: sort-free, static shapes)."""
    oh = _one_hot(dest, n, torch.int32)                           # (m, n)
    before = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    return torch.gather(before, 1, dest[:, None].long())[:, 0]


def _put(shape, dtype, rows, slots, values, fill=0):
    """A ``shape`` tensor of ``fill`` with ``values`` at (rows, slots); the
    indices one past the last row or slot land in a spare row/column that
    is cut off (the reference's ``mode="drop"`` scatter)."""
    big = torch.full((shape[0] + 1, shape[1] + 1) + tuple(shape[2:]), fill,
                     dtype=dtype, device=values.device)
    out = big.index_put((rows.long(), slots.long()), values)
    return out[:shape[0], :shape[1]]


def moe_apply_ep(params, x, cfg: ArchConfig, policy, compute_dtype, ctx,
                 capacity_factor: float = 2.0):
    """GShard-style expert parallelism on this rank (the reference's
    ``moe_apply_ep``): token-expert pairs go to the expert-axis peer that
    owns their expert through a capacity-bounded all_to_all, each peer runs
    its ``E / P`` experts on dense per-expert capacity blocks, and the
    outputs come back the same way.  Returns (y, aux).

    ``x``: this rank's rows of the batch (its block over ``ctx.dp``) with
    the whole sequence; with ``ctx.seq`` set the rank routes its chunk of
    the sequence and ``y`` is gathered back to the whole sequence.  The
    expert weights are this peer's ``E / P`` experts; the router is
    replicated.  Semantics, as the
    reference's: a pair's slot in its peer's send buffer is its one-hot
    running count, ``cap = max(int(cf * tk / P), 8)`` slots a peer, pairs
    beyond it dropped; received pairs are regrouped into ``cap_e =
    max(int(1.5 * n_recv / E_local), 8)`` slots an expert (invalid id
    ``E``, overflow dropped); ``aux`` is the mean of the per-rank
    load-balance losses over the (dp..., ep) ranks.  Under ``policy`` the
    local experts' weights are rounded (the posit lattice on the codec
    kernels on the card)."""
    from repro_torch.launch import mesh as M
    mesh, dp, ep = ctx.mesh, ctx.dp, ctx.ep
    e, k = cfg.n_experts, cfg.top_k
    p_ep = mesh.shape[ep]
    if e % p_ep:
        raise ValueError(f"{e} experts do not split over {p_ep} ranks")
    e_local = e // p_ep
    my_peer = mesh.axis_index(ep)
    manual = tuple(dp) + (ep,)

    wg, wu, wd = (policy.maybe_quantize_weights(leaf(params[n]))
                  for n in ("w_gate", "w_up", "w_down"))
    router_w = leaf(params["router"]["w"])

    if ctx.seq is not None:
        s_l = x.shape[1] // mesh.axis_size(ctx.seq)
        x = x.narrow(1, mesh.axis_index(ctx.seq) * s_l, s_l)
    b_l, s_l, d = x.shape
    t = b_l * s_l
    flat = x.reshape(t, d)

    logits = torch.matmul(flat.float(), router_w.float())           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                     # (T, k)
    top_w = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    frac_tokens = _one_hot(top_e, e, torch.float32).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=0)
    aux = float(e) * torch.sum(frac_tokens * frac_probs)

    tk = t * k
    eid = top_e.reshape(tk)
    wgt = top_w.reshape(tk)
    tok = torch.arange(tk, device=x.device) // k
    peer = eid // e_local

    cap = max(int(capacity_factor * tk / p_ep), 8)
    pos = _bucket_positions(peer, p_ep)
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    zero = torch.zeros((), dtype=compute_dtype, device=x.device)
    send_x = _put((p_ep, cap, d), compute_dtype, peer, slot,
                  torch.where(keep[:, None], flat[tok].to(compute_dtype),
                              zero))
    send_eid = _put((p_ep, cap), torch.int32, peer, slot,
                    torch.where(keep, eid, e).to(torch.int32), fill=e)

    recv_x = M.all_to_all(send_x, mesh, ep, 0)                  # (P, cap, d)
    recv_eid = M.all_to_all(send_eid, mesh, ep, 0)

    # regroup received tokens into dense per-expert capacity blocks
    n_recv = p_ep * cap
    rx = recv_x.reshape(n_recv, d)
    reid = recv_eid.reshape(n_recv) - my_peer * e_local
    valid = (reid >= 0) & (reid < e_local)
    reid_c = torch.where(valid, reid, e_local)
    pos2 = _bucket_positions(reid_c, e_local + 1)
    cap_e = max(int(1.5 * n_recv / e_local), 8)
    keep2 = valid & (pos2 < cap_e)
    be = torch.where(keep2, reid_c, e_local)
    bp = torch.where(keep2, pos2, cap_e)
    blocks = _put((e_local, cap_e, d), compute_dtype, be, bp,
                  torch.where(keep2[:, None], rx, zero))

    def expert_mm(w_l, inp):                        # (E_l,C,d) @ (E_l,d,f)
        return torch.bmm(inp.float(), w_l.to(compute_dtype).float())

    h = F.silu(expert_mm(wg, blocks)) * expert_mm(wu, blocks)
    hb = expert_mm(wd, h.to(compute_dtype))                     # (E_l,C,d)
    got = hb[be.clamp(max=e_local - 1).long(),
             bp.clamp(max=cap_e - 1).long()].to(compute_dtype)
    out_rows = torch.where(keep2[:, None], got, zero)
    back = M.all_to_all(out_rows.reshape(p_ep, cap, d), mesh, ep, 0)

    contrib = back[peer.long(), slot.clamp(max=cap - 1).long()].float()
    contrib = torch.where(keep[:, None], contrib, 0.0) * wgt[:, None]
    contrib = contrib.reshape(t, k, d)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):                   # the scatter-add's order
        y = y + contrib[:, j]
    y = y.reshape(b_l, s_l, d).to(compute_dtype)
    if ctx.seq is not None:
        y = M.all_gather(y, mesh, ctx.seq, 1)
    aux = M.psum(aux, mesh, manual) / mesh.axis_size(manual)
    return y, aux
