"""Blockwise (flash-style) attention: GQA, causal, sliding-window, cross,
and ring-buffer KV-cache decode (counterpart of
``repro.models.attention``).

The reference's attention is plain XLA, not a Pallas kernel, so this is
plain PyTorch: the prefill path keeps the reference's running (max, sum,
acc) statistics over kv chunks, so the S x S score matrix is never
materialized, and the decode path is one masked softmax over the cache.
Masked scores are the reference's ``-1e30`` in f32, not ``-inf``: a row
with no visible slot averages the values as the reference's does instead
of giving NaN.

The prefill path is ``_Flash``, with the reference's hand-written VJP:
the forward saves only (q, k, v, out, lse), and the backward rescans
the kv chunks and recomputes the probabilities, with the reference's
casts (``p``, ``ds`` and ``dout`` to the compute dtype before each
product, products summed in f32, ``dq`` accumulated in f32, ``dk``/``dv``
in the cache dtype).  Where no gradient is wanted, as in serving, the
scan runs outside ``_Flash`` and neither computes nor keeps lse.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig, linear, linear_init, rope

_NEG = -1e30


def attn_init(rng, cfg: ArchConfig, cross: bool = False):
    return {
        "wq": linear_init(rng, cfg.d_model, cfg.d_q, (None, "heads"),
                          bias=cfg.qkv_bias),
        "wk": linear_init(rng, cfg.d_model, cfg.d_kv, (None, "heads"),
                          bias=cfg.qkv_bias),
        "wv": linear_init(rng, cfg.d_model, cfg.d_kv, (None, "heads"),
                          bias=cfg.qkv_bias),
        "wo": linear_init(rng, cfg.d_q, cfg.d_model, ("heads", None)),
    }


def _scores(qg, k, scale):
    """(B,Sq,Hkv,G,Dh) x (B,C,Hkv,Dh) -> f32 (B,Sq,Hkv,G,C), operands in
    q's dtype, products summed in f32."""
    return torch.einsum("bshgd,bchd->bshgc", qg.float(),
                        k.to(qg.dtype).float()) * scale


def _mix(p, v):
    """f32 weights (rounded to v's dtype) x values -> f32."""
    return torch.einsum("bshgc,bchd->bshgd", p.to(v.dtype).float(),
                        v.float())


def blockwise_attention(q, k, v, *, q_positions, causal: bool,
                        window: int = 0, kv_valid_len=None,
                        kv_positions=None, chunk: int = 512):
    """q: (B,Sq,Hq,Dh); k,v: (B,Sk,Hkv,Dh).  Returns (B,Sq,Hq,Dh).

    ``q_positions``: (Sq,) absolute positions of the queries, or (B,1)
    per row in single-token decode.  ``kv_positions``: (Sk,) or (B,Sk)
    absolute positions of cache slots (default 0..Sk-1; ring caches pass
    their slot -> position map, negative = empty).  ``kv_valid_len``:
    scalar or (B,) — slots at positions >= this are masked out.
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, dh)
    scale = torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32)
    if kv_positions is None:
        kv_positions = torch.arange(sk, dtype=torch.int32, device=dev)

    if sq == 1:
        # decode: one masked softmax over the cache; per-row positions
        # give a (B,Sk) mask, scalar ones a (1,Sk) mask broadcast.
        qpos = torch.as_tensor(q_positions, device=dev).to(torch.int32)
        if qpos.dim() == 1:
            qpos = qpos[None, :]
        kvp = kv_positions if kv_positions.dim() == 2 \
            else kv_positions[None, :]
        s = _scores(qg, k, scale)
        mask = kvp >= 0
        if causal:
            mask = mask & (qpos[:, :1] >= kvp)
        if window:
            mask = mask & (qpos[:, :1] - kvp < window)
        if kv_valid_len is not None:
            vlen = torch.as_tensor(kv_valid_len, device=dev).to(
                torch.int32).reshape(-1, 1)
            mask = mask & (kvp < vlen)
        s = torch.where(mask[:, None, None, None, :], s, _NEG)
        p = torch.softmax(s, dim=-1)
        out = _mix(p, v)
        return out.reshape(b, sq, hq, dh).to(q.dtype)

    # Under a distribution context a chunk never straddles a "model"
    # shard of S (the reference's choice, which fixes the sum order).
    from repro_torch.launch import context as dist_ctx
    ctx = dist_ctx.current()
    n_shards = ctx.mesh.shape.get("model", 1) if ctx is not None else 1
    shard_size = sk // n_shards if sk % n_shards == 0 else sk
    chunk = min(chunk, shard_size, sk)
    if shard_size % chunk:               # largest divisor of shard_size
        chunk = next(c for c in range(chunk, 0, -1) if shard_size % c == 0)
    qpos = torch.as_tensor(q_positions, device=dev).to(torch.int32)
    vlen = 2 ** 30 if kv_valid_len is None else kv_valid_len
    spec = (chunk, vlen, causal, window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _Flash.apply(qg, k, v, kv_positions, qpos, spec)
    else:
        out, _ = _flash_fwd(qg, k, v, kv_positions, qpos, spec, False)
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def _chunk_mask(qpos, pj, vlen, causal, window):
    mask = (pj[None, :] >= 0) & (pj[None, :] < vlen)
    if causal:
        mask = mask & (qpos[:, None] >= pj[None, :])
    if window:
        mask = mask & (qpos[:, None] - pj[None, :] < window)
    return mask                                          # (Sq, C)


def _flash_fwd(qg, k, v, kv_positions, qpos, spec, want_lse):
    """The kv-chunk scan: f32 (out, lse) of (B,Sq,Hkv,G,Dh) queries; lse
    is None unless ``want_lse`` (only the backward reads it)."""
    chunk, vlen, causal, window = spec
    b, sq, hkv, g, dh = qg.shape
    scale = torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32)
    dev = qg.device
    m = torch.full((b, sq, hkv, g), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, g, dh), dtype=torch.float32, device=dev)
    for c0 in range(0, k.shape[1], chunk):
        kj, vj = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        mask = _chunk_mask(qpos, kv_positions[c0:c0 + chunk], vlen, causal,
                           window)
        s = torch.where(mask[None, :, None, None, :],
                        _scores(qg, kj, scale), _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _mix(p, vj)
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    return (acc / l_safe[..., None],
            m + torch.log(l_safe) if want_lse else None)


def _f32(a, dt):
    """``a`` rounded to ``dt``, then widened: the operand of a product
    summed in f32."""
    return a.to(dt).float()


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's hand-written VJP."""

    @staticmethod
    def forward(ctx, qg, k, v, kv_positions, qpos, spec):
        out, lse = _flash_fwd(qg, k, v, kv_positions, qpos, spec, True)
        ctx.save_for_backward(qg, k, v, kv_positions, qpos, out, lse)
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, kv_positions, qpos, out, lse = ctx.saved_tensors
        chunk, vlen, causal, window = ctx.spec
        dh = qg.shape[-1]
        scale = torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32)
        dt = qg.dtype
        dout = dout.float()
        delta = (dout * out).sum(dim=-1)                 # (B,Sq,Hkv,G)
        do_dt = _f32(dout, dt)
        qf = qg.float()
        dq = torch.zeros(qg.shape, dtype=torch.float32, device=qg.device)
        dks, dvs = [], []
        for c0 in range(0, k.shape[1], chunk):
            kj, vj = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
            mask = _chunk_mask(qpos, kv_positions[c0:c0 + chunk], vlen,
                               causal, window)
            s = _scores(qg, kj, scale)
            p = torch.where(mask[None, :, None, None, :],
                            torch.exp(s - lse[..., None]), 0.0)
            dvj = torch.einsum("bshgc,bshgd->bchd", _f32(p, dt), do_dt)
            dp = torch.einsum("bshgd,bchd->bshgc", do_dt, vj.float())
            ds = _f32(p * (dp - delta[..., None]) * scale, dt)
            dq = dq + torch.einsum("bshgc,bchd->bshgd", ds, kj.float())
            dkj = torch.einsum("bshgc,bshgd->bchd", ds, qf)
            dks.append(dkj.to(k.dtype))
            dvs.append(dvj.to(v.dtype))
        return (dq.to(dt), torch.cat(dks, dim=1), torch.cat(dvs, dim=1),
                None, None, None)


def attn_apply(params, x, cfg: ArchConfig, policy, compute_dtype, *,
               positions, causal=True, window=0, kv_cache=None,
               cache_pos=None, cross_kv=None):
    """Self/cross attention with an optional KV cache.

    Prefill: ``kv_cache`` None, full sequence.  Decode: ``kv_cache``
    {'k','v'} (B, Scache, Hkv, Dh) and ``cache_pos`` the absolute
    position of the incoming token, an int (a ring-slot write) or a (B,)
    tensor (the engine's per-row positions: a one-hot write into each
    row's own slot); returns the updated cache.  Cross: ``cross_kv`` =
    (k, v) precomputed from the encoder.
    """
    b, s, _ = x.shape
    q = linear(params["wq"], x, policy, compute_dtype)
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    if cross_kv is None:
        k = linear(params["wk"], x, policy, compute_dtype)
        v = linear(params["wv"], x, policy, compute_dtype)
        k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    else:
        k, v = cross_kv

    new_cache = None
    if kv_cache is not None:
        ck0, cv0 = kv_cache["k"], kv_cache["v"]
        s_cache = ck0.shape[1]
        idx = torch.arange(s_cache, dtype=torch.int32, device=x.device)
        if not torch.is_tensor(cache_pos) or cache_pos.dim() == 0:
            cp = int(cache_pos)
            # the reference's dynamic_update_slice: start clamped so the
            # s new rows fit
            start = min(cp % s_cache, s_cache - s)
            ck, cv = ck0.clone(), cv0.clone()
            ck[:, start:start + s] = k.to(ck.dtype)
            cv[:, start:start + s] = v.to(cv.dtype)
            # slot i holds absolute position p = pos - ((pos - i) mod Sc)
            kv_pos = cp - torch.remainder(cp - idx, s_cache)
            vlen = cp + 1
        else:
            cp = cache_pos.to(torch.int32)
            slot = torch.remainder(cp, s_cache)                   # (B,)
            hit = idx[None, :] == slot[:, None]                   # (B,Sc)
            ck = torch.where(hit[:, :, None, None], k.to(ck0.dtype), ck0)
            cv = torch.where(hit[:, :, None, None], v.to(cv0.dtype), cv0)
            kv_pos = cp[:, None] - torch.remainder(
                cp[:, None] - idx[None, :], s_cache)
            vlen = cp + 1
        new_cache = {"k": ck, "v": cv}
        out = blockwise_attention(
            q, ck, cv, q_positions=positions, causal=causal, window=window,
            kv_valid_len=vlen, kv_positions=kv_pos)
    else:
        out = blockwise_attention(q, k, v, q_positions=positions,
                                  causal=causal, window=window)

    out = out.reshape(b, s, cfg.d_q)
    y = linear(params["wo"], out, policy, compute_dtype)
    return y, new_cache


def cross_kv_init(params, enc_out, cfg: ArchConfig, policy, compute_dtype):
    """Precompute encoder K/V for decoder cross-attention."""
    b, se, _ = enc_out.shape
    k = linear(params["wk"], enc_out, policy, compute_dtype)
    v = linear(params["wv"], enc_out, policy, compute_dtype)
    return (k.reshape(b, se, cfg.n_kv_heads, cfg.d_head),
            v.reshape(b, se, cfg.n_kv_heads, cfg.d_head))
