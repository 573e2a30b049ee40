"""Mamba2 / SSD (state-space duality) block (counterpart of
``repro.models.ssm``).

Chunked SSD: within a chunk the recurrence is computed in its attention
dual form (C B^T with a decay mask, quadratic in the chunk length);
across chunks a linear state recurrence runs, here as a Python loop over
the chunks where the reference scans.  The intra-chunk decay is masked
with ``-inf`` before the ``exp``, as in the reference; autograd takes
the training gradient through it, as ``jax.grad`` does the reference's.

Decode carries a small recurrent cache: the conv tail (k-1 steps) and the
SSM state (B, H, N, P), constant in sequence length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch.models.common import (ArchConfig, leaf, linear, linear_init,
                                       param, rmsnorm, rmsnorm_init)

_CHUNK = 256


def ssm_init(rng, cfg: ArchConfig):
    d, din, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = din + 2 * n
    return {
        # in_proj -> [z (din), xBC (din + 2n), dt (h)]
        "in_proj": linear_init(rng, d, 2 * din + 2 * n + h, (None, "mlp")),
        "conv_w": param(rng, (cfg.ssm_conv, conv_ch), (None, "mlp"),
                        scale=1.0),
        "conv_b": param(rng, (conv_ch,), ("mlp",), init="zeros"),
        "A_log": param(rng, (h,), (None,), init="ones"),
        "D": param(rng, (h,), (None,), init="ones"),
        "dt_bias": param(rng, (h,), (None,), init="zeros"),
        "norm": rmsnorm_init(rng, din, ("mlp",)),
        "out_proj": linear_init(rng, din, d, ("mlp", None)),
    }


def _split_proj(cfg, proj):
    din, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :din]
    xbc = proj[..., din:2 * din + 2 * n]
    dt = proj[..., 2 * din + 2 * n:]
    return z, xbc, dt


def _conv_train(params, xbc, compute_dtype):
    """Causal depthwise conv, kernel k, over (B, S, C)."""
    w = leaf(params["conv_w"]).float()                      # (k, C)
    k = w.shape[0]
    pad = F.pad(xbc.float(), (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    out = out + leaf(params["conv_b"]).float()
    return F.silu(out).to(compute_dtype)


def _ssd_chunked(x, dt, a_log, b_in, c_in):
    """Chunked SSD.

    x: (B,S,H,P)  dt: (B,S,H)  a_log: (H,)  b_in/c_in: (B,S,N).
    Returns y: (B,S,H,P) in f32.
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    l = min(_CHUNK, s)
    if s % l:
        raise ValueError(f"sequence length {s} is not a multiple of {l}")
    nc = s // l

    a = -torch.exp(a_log.float())                            # (H,) < 0
    la = dt.float() * a[None, None, :]                       # (B,S,H) <= 0
    xdt = x.float() * dt.float()[..., None]

    lac = la.reshape(bsz, nc, l, h)
    cum = torch.cumsum(lac, dim=2)                           # (B,nc,L,H)
    total = cum[:, :, -1, :]                                 # (B,nc,H)
    xc = xdt.reshape(bsz, nc, l, h, p)
    bc = b_in.reshape(bsz, nc, l, n).float()
    cc = c_in.reshape(bsz, nc, l, n).float()

    # intra-chunk: scores[i,j] = (C_i . B_j) * exp(cum_i - cum_j), j <= i
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)             # (B,nc,L,L)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,L,L,H)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None], decay,
                        torch.tensor(-float("inf"), device=x.device))
    w = cb[..., None] * torch.exp(decay)                     # (B,nc,L,L,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)

    # chunk states S_c = sum_j exp(total - cum_j) B_j (x dt)_j, then the
    # inter-chunk recurrence over the states entering each chunk
    wts = torch.exp(total[:, :, None, :] - cum)              # (B,nc,L,H)
    s_c = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bc, wts, xc)
    hstate = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(hstate)
        hstate = hstate * torch.exp(total[:, c])[:, :, None, None] \
            + s_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # (B,nc,H,N,P)

    # y_inter[i] = exp(cum_i) * C_i . h_prev(chunk)
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", cc, torch.exp(cum),
                           h_prev)
    return (y_intra + y_inter).reshape(bsz, s, h, p)


def ssm_apply(params, xres, cfg: ArchConfig, policy, compute_dtype, *,
              cache=None, cache_pos=None):
    """Mamba2 block.  Prefill: cache None.  Decode: cache {'conv','h'}."""
    bsz, s, _ = xres.shape
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim

    proj = linear(params["in_proj"], xres, policy, compute_dtype)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    dt = F.softplus(dt_raw.float() + leaf(params["dt_bias"]).float())

    new_cache = None
    if cache is None:
        xbc = _conv_train(params, xbc, compute_dtype)
        xs = xbc[..., :din].reshape(bsz, s, h, p)
        b_in = xbc[..., din:din + n]
        c_in = xbc[..., din + n:]
        y = _ssd_chunked(xs, dt, leaf(params["A_log"]), b_in, c_in)
    else:
        # single-token decode: roll the conv tail, one recurrence step
        conv_tail = cache["conv"]                            # (B, k-1, C)
        window = torch.cat([conv_tail, xbc.to(conv_tail.dtype)], dim=1)
        w = leaf(params["conv_w"]).float()
        out = torch.einsum("bkc,kc->bc", window.float(), w)
        out = F.silu(out + leaf(params["conv_b"]).float())
        xs = out[:, :din].reshape(bsz, h, p)
        b_in = out[:, din:din + n]
        c_in = out[:, din + n:]
        a = -torch.exp(leaf(params["A_log"]).float())
        dt1 = dt[:, 0, :]                                    # (B,H)
        decay = torch.exp(dt1 * a[None, :])                  # (B,H)
        upd = torch.einsum("bn,bhp->bhnp", b_in, xs * dt1[..., None])
        h_new = cache["h"] * decay[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", c_in, h_new)[:, None]  # (B,1,H,P)
        new_cache = {"conv": window[:, 1:, :], "h": h_new}
        xs = xs[:, None]                                     # (B,1,H,P)

    y = y + leaf(params["D"]).float()[None, None, :, None] * xs.float()
    y = y.reshape(bsz, -1, din).to(compute_dtype)
    gated = y * F.silu(z.float()).to(compute_dtype)
    gated = rmsnorm(params["norm"], gated, cfg.norm_eps)
    out = linear(params["out_proj"], gated, policy, compute_dtype)
    return out, new_cache


def ssm_cache_init(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device="cuda"):
    dev = _device.resolve(device)
    din, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * n),
                            dtype=dtype, device=dev),
        "h": torch.zeros((batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
                         dtype=torch.float32, device=dev),
    }
