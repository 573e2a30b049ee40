"""Model assembly for all architecture families (counterpart of
``repro.models.lm``).

families: dense | moe (dense attn + MoE FFN) | ssm (pure Mamba2) |
hybrid (Mamba2 + weight-shared attention block, Zamba2-style) |
encdec (Whisper: bidirectional encoder + cross-attending decoder) |
vlm (stub visual tokens prepended to an LM backbone, InternVL2-style).

The reference groups the layers into *periods* (gemma3: 5 local + 1
global; zamba2: 6 mamba + the shared attention block; else 1) and scans
over their stacked params; that is a compile device, not semantics.
Here ``params["layers"]`` is a list with one dict per layer, layer
``i = period * period_of(cfg) + slot``, and the stack is a Python loop;
the hybrid's shared block runs after every period.  The decode cache is
per layer too: ``cache["layers"][i]`` ({"kv": {"k", "v"}} or {"ssm":
...}), the hybrid's ``cache["shared"][period]``, the encdec's
``cache["cross_kv"][i]`` = (k, v).

Public surface:
    init_params(key, cfg, device)            -> param tree
    forward_train(params, batch, cfg, remat) -> (loss, metrics)
    forward_prefill(params, batch, cfg)      -> last-position logits
    init_cache(cfg, batch, seq_len, ...)     -> decode cache
    serve_step(params, cache, tok, pos, cfg) -> (logits, cache)

Modality frontends are stubs as in the reference: batches carry
precomputed frame/patch embeddings ("frames" / "vis") at d_model.

Training: the loss is the reference's chunked cross-entropy, each
chunk's logits recomputed in the backward (``torch.utils.checkpoint``),
so the (tokens, vocab) logits are never live at full size.  ``remat``
checkpoints each layer (the reference checkpoints its scanned period
bodies): the backward recomputes a layer's activations from its input,
and the loss is the same as without.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _device
from repro_torch.core.policy import torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ArchConfig, Rng, dot_f32, embed,
                                       embed_init, leaf, param, rmsnorm,
                                       rmsnorm_init, unembed,
                                       vocab_parallel)


def period_of(cfg: ArchConfig) -> int:
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        return cfg.hybrid_attn_every
    if cfg.local_ratio:
        return cfg.local_ratio + 1
    return 1


def slot_kinds(cfg: ArchConfig) -> list[str]:
    return cfg.layer_kinds()[:period_of(cfg)]


def _dtype(cfg: ArchConfig):
    policy = cfg.get_policy()
    return policy, torch_dtype(policy.compute_dtype)


# --------------------------------------------------------------------------
# init (the port's own seeded init at the reference's scales)
# --------------------------------------------------------------------------

def _layer_init(rng, cfg: ArchConfig, kind: str, cross: bool = False):
    p: dict[str, Any] = {"ln1": rmsnorm_init(rng, cfg.d_model)}
    if kind == "ssm":
        p["ssm"] = ssm_mod.ssm_init(rng, cfg)
        return p
    p["attn"] = attn_mod.attn_init(rng, cfg)
    p["ln2"] = rmsnorm_init(rng, cfg.d_model)
    if cfg.n_experts and kind != "shared":
        p["moe"] = ffn_mod.moe_init(rng, cfg)
    else:
        p["ffn"] = ffn_mod.ffn_init(rng, cfg)
    if cross:
        p["lnx"] = rmsnorm_init(rng, cfg.d_model)
        p["xattn"] = attn_mod.attn_init(rng, cfg, cross=True)
    return p


def init_params(key, cfg: ArchConfig, device="cuda"):
    """Seeded random params (``key`` an int seed) at the reference's
    init scales, one dict per layer.  The reference's own params load
    through ``repro_torch.interop.params_from_reference``."""
    per = period_of(cfg)
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.n_layers} layers do not divide into "
                         f"periods of {per}")
    rng = Rng(key, device)
    kinds = cfg.layer_kinds()
    cross = cfg.family == "encdec"
    params: dict[str, Any] = {"embed": embed_init(rng, cfg.vocab,
                                                  cfg.d_model)}
    params["layers"] = [_layer_init(rng, cfg, kinds[i], cross=cross)
                        for i in range(cfg.n_layers)]
    params["final_norm"] = rmsnorm_init(rng, cfg.d_model)
    if not cfg.tie_embeddings:
        params["unembed"] = {
            "w": param(rng, (cfg.d_model, cfg.vocab), (None, "vocab"))}
    if cfg.family == "hybrid":
        params["shared_attn"] = _layer_init(rng, cfg, "shared")
    if cfg.family == "encdec":
        params["enc"] = {
            "pos": param(rng, (cfg.enc_seq, cfg.d_model), (None, "embed"),
                         scale=0.02),
            "layers": [_layer_init(rng, cfg, "attn")
                       for _ in range(cfg.enc_layers)],
            "final_norm": rmsnorm_init(rng, cfg.d_model),
        }
    return params


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _block(params, x, cfg, policy, dtype, kind, *, positions, cache=None,
           cache_pos=None, cross_kv=None, causal=True):
    """One residual block; returns (x, new_cache, aux)."""
    aux = 0.0
    new_cache: dict[str, Any] = {}
    if kind == "ssm":
        h, c = ssm_mod.ssm_apply(
            params["ssm"], rmsnorm(params["ln1"], x, cfg.norm_eps), cfg,
            policy, dtype, cache=None if cache is None else cache["ssm"],
            cache_pos=cache_pos)
        if c is not None:
            new_cache["ssm"] = c
        return x + h, new_cache, aux

    window = cfg.local_window if kind == "local" else 0
    h, c = attn_mod.attn_apply(
        params["attn"], rmsnorm(params["ln1"], x, cfg.norm_eps), cfg, policy,
        dtype, positions=positions, causal=causal, window=window,
        kv_cache=None if cache is None else cache["kv"], cache_pos=cache_pos)
    if c is not None:
        new_cache["kv"] = c
    x = x + h
    if "xattn" in params:
        h, _ = attn_mod.attn_apply(
            params["xattn"], rmsnorm(params["lnx"], x, cfg.norm_eps), cfg,
            policy, dtype, positions=positions, causal=False,
            cross_kv=cross_kv)
        x = x + h
    h_in = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if "moe" in params:
        h, aux = ffn_mod.moe_apply(params["moe"], h_in, cfg, policy, dtype)
    else:
        h = ffn_mod.ffn_apply(params["ffn"], h_in, cfg, policy, dtype)
    return x + h, new_cache, aux


def _encoder(params, frames, cfg, policy, dtype):
    """Whisper-style bidirectional encoder over stub embeddings."""
    se = frames.shape[1]
    x = frames.to(dtype) + leaf(params["enc"]["pos"])[:se].to(dtype)
    pos = torch.arange(se, dtype=torch.int32, device=x.device)
    for lp in params["enc"]["layers"]:
        x, _, _ = _block(lp, x, cfg, policy, dtype, "attn", positions=pos,
                         causal=False)
    return rmsnorm(params["enc"]["final_norm"], x, cfg.norm_eps)


def _logit_params(params, cfg: ArchConfig):
    """``params`` as the logits read them: under the vocab-parallel
    embedding (``common.vocab_parallel``) a tied table is this model
    rank's rows, all-gathered here once (the backward reduce-scatters its
    gradient back to the rows)."""
    ctx = vocab_parallel(cfg.vocab) if cfg.tie_embeddings else None
    if ctx is None:
        return params
    from repro_torch.launch.mesh import all_gather
    table = params["embed"]["table"]
    whole = all_gather(leaf(table), ctx.mesh, "model", 0)
    return dict(params, embed=dict(params["embed"],
                                   table=dict(table, w=whole)))


def _logits(params, x, cfg, dtype):
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, dtype)
    return dot_f32(x, leaf(params["unembed"]["w"]), dtype)


def _backbone(params, batch, cfg: ArchConfig, remat: bool = False):
    policy, dtype = _dtype(cfg)
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, dtype, vocab=cfg.vocab)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encoder(params, batch["frames"], cfg, policy, dtype)
    n_vis = 0
    if cfg.family == "vlm" and "vis" in batch:
        vis = batch["vis"].to(dtype)
        n_vis = vis.shape[1]
        x = torch.cat([vis, x], dim=1)

    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    kinds = cfg.layer_kinds()
    shared = params.get("shared_attn")
    per = period_of(cfg)

    def layer(x, i):
        lp = params["layers"][i]
        ck = None
        if cfg.family == "encdec":
            ck = attn_mod.cross_kv_init(lp["xattn"], enc_out, cfg, policy,
                                        dtype)
        x, _, a = _block(lp, x, cfg, policy, dtype, kinds[i],
                         positions=positions, cross_kv=ck)
        if cfg.family == "hybrid" and shared is not None \
                and (i + 1) % per == 0:
            x, _, _ = _block(shared, x, cfg, policy, dtype, "shared",
                             positions=positions)
        return x, a

    aux_total = 0.0
    for i in range(len(params["layers"])):
        if remat:
            x, a = checkpoint(layer, x, i, use_reentrant=False)
        else:
            x, a = layer(x, i)
        aux_total = aux_total + a

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if n_vis:
        x = x[:, n_vis:, :]
    return x, aux_total


def forward_prefill(params, batch, cfg: ArchConfig):
    """Inference prefill: next-token logits for the LAST position only
    (never materializes (B, S, V)).  ``batch``: {"tokens": (B, S) ints,
    and "frames" (encdec) / "vis" (vlm) embeddings}."""
    _, dtype = _dtype(cfg)
    x, _ = _backbone(params, batch, cfg)
    return _logits(_logit_params(params, cfg), x[:, -1:, :], cfg,
                   dtype)[:, 0, :]


def _chunked_ce(params, x, targets, cfg, dtype, max_chunk_elems=2 ** 26):
    """Cross-entropy over sequence chunks of at most ``max_chunk_elems //
    vocab`` tokens (the largest divisor of S below that), each chunk's
    f32 logits recomputed in the backward.  Returns (mean loss over the
    targets >= 0, their count), both f32."""
    tot, cnt = chunked_ce_sum(params, x, targets, cfg, dtype,
                              max_chunk_elems)
    return tot / torch.clamp(cnt, min=1.0), cnt


def chunked_ce_sum(params, x, targets, cfg, dtype, max_chunk_elems=2 ** 26):
    """``_chunked_ce``'s (sum of the losses, count), f32."""
    b, s, _ = x.shape
    params = _logit_params(params, cfg)
    chunk = max(min(s, max_chunk_elems // max(cfg.vocab, 1)), 1)
    while s % chunk:
        chunk -= 1

    def body(xx, tt):
        logits = _logits(params, xx, cfg, dtype)            # (B,c,V) f32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tt[..., None].long().clamp(min=0)
                            )[..., 0]
        mask = (tt >= 0).to(torch.float32)
        return torch.sum((logz - gold) * mask), mask.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        part, n = checkpoint(body, x[:, c0:c0 + chunk],
                             targets[:, c0:c0 + chunk], use_reentrant=False)
        tot, cnt = tot + part, cnt + n
    return tot, cnt


def forward_train(params, batch, cfg: ArchConfig, remat: bool = False):
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "targets":
    (B, S) ints; "frames" (encdec) / "vis" (vlm)}), plus ``0.01 * aux /
    n_layers`` of the MoE load-balance loss.  Returns (loss, {"loss",
    "ntokens"})."""
    _, dtype = _dtype(cfg)
    x, aux_total = _backbone(params, batch, cfg, remat=remat)
    loss, ntok = _chunked_ce(params, x, batch["targets"], cfg, dtype)
    if cfg.n_experts:
        loss = loss + 0.01 * aux_total / cfg.n_layers
    return loss, {"loss": loss, "ntokens": ntok}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _layer_cache(cfg: ArchConfig, kind: str, batch: int, seq_len: int,
                 dtype, device):
    if kind == "ssm":
        return {"ssm": ssm_mod.ssm_cache_init(cfg, batch, dtype, device)}
    s_cache = seq_len
    if kind == "local" and cfg.local_window:
        s_cache = min(seq_len, cfg.local_window)
    shape = (batch, s_cache, cfg.n_kv_heads, cfg.d_head)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Decode cache, one entry per layer (ring caches of the local
    window for local layers), plus the hybrid's per-period shared-block
    caches."""
    dev = _device.resolve(device)
    kinds = cfg.layer_kinds()
    cache: dict[str, Any] = {"layers": [
        _layer_cache(cfg, kinds[i], batch, seq_len, dtype, dev)
        for i in range(cfg.n_layers)]}
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        cache["shared"] = [
            _layer_cache(cfg, "shared", batch, seq_len, dtype, dev)
            for _ in range(cfg.n_layers // period_of(cfg))]
    return cache


def serve_step(params, cache, tokens, pos, cfg: ArchConfig):
    """One decode step.  tokens: (B,1) ints; pos: an int (absolute) or a
    (B,) tensor (per-request absolute positions: the continuous-batching
    engine decodes requests at different depths in one step).
    Returns (logits (B,V) f32, new_cache)."""
    policy, dtype = _dtype(cfg)
    x = embed(params["embed"], tokens, dtype, vocab=cfg.vocab)
    if torch.is_tensor(pos) and pos.dim() == 1:
        pos = pos.to(device=x.device, dtype=torch.int32)
        positions = pos.reshape(-1, 1)
    else:
        pos = int(pos)
        positions = torch.tensor([pos], dtype=torch.int32, device=x.device)
    kinds = cfg.layer_kinds()
    shared = params.get("shared_attn")
    per = period_of(cfg)
    if cfg.family == "encdec" and "cross_kv" not in cache:
        raise ValueError("encdec serve_step needs cache['cross_kv'] (the "
                         "encoder K/V per layer): build it with "
                         "serving.prefill")

    new_layers, new_shared = [], []
    for i, lp in enumerate(params["layers"]):
        ck = cache["cross_kv"][i] if cfg.family == "encdec" else None
        x, nc, _ = _block(lp, x, cfg, policy, dtype, kinds[i],
                          positions=positions, cache=cache["layers"][i],
                          cache_pos=pos, cross_kv=ck)
        new_layers.append(nc if nc else cache["layers"][i])
        if cfg.family == "hybrid" and shared is not None \
                and (i + 1) % per == 0:
            x, nc, _ = _block(shared, x, cfg, policy, dtype, "shared",
                              positions=positions,
                              cache=cache["shared"][i // per],
                              cache_pos=pos)
            new_shared.append(nc)

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _logits(_logit_params(params, cfg), x[:, 0, :], cfg, dtype)
    new_cache = dict(cache)
    new_cache["layers"] = new_layers
    if "shared" in cache:
        new_cache["shared"] = new_shared
    return logits, new_cache
