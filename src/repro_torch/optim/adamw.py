"""AdamW with optional posit16 moment storage (counterpart of
``repro.optim.adamw``).

The moments ``m`` and ``v`` are kept in f32, or with ``compress_moments``
as Posit(16,1) words (int16) after the reference's static re-centering
scales ``_M_SCALE`` and ``_V_SCALE``, which move their typical magnitude
into p16e1's golden zone: half the bytes of f32 moments.  The words go
through ``core.policy.encode_tensor`` / ``decode_tensor``: on the card the
hand-written encode and decode kernels, on the host the plain codec.  The
update math runs in f32, op for op the reference's.

State: ``{"moments": tree of {"m", "v"} in the params' structure, "step":
0-d int32}``.  ``adamw_update`` returns new tensors and leaves its inputs
as they are.
"""
from __future__ import annotations

import torch

from repro_torch import tree as _tree
from repro_torch.core.policy import decode_tensor, encode_tensor

_M_SCALE = 2.0 ** 10
_V_SCALE = 2.0 ** 24


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _compress(x: torch.Tensor, scale: float) -> torch.Tensor:
    return encode_tensor(x.float() * _f32(scale, x), "p16e1")


def _decompress(p: torch.Tensor, scale: float) -> torch.Tensor:
    return decode_tensor(p, "p16e1") * _f32(1.0 / scale, p)


def _moment_like(w: torch.Tensor, compress: bool) -> torch.Tensor:
    z = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    return _compress(z, 1.0) if compress else z


def adamw_init(params, compress_moments: bool = False):
    moments = _tree.map(lambda w: {"m": _moment_like(w, compress_moments),
                                   "v": _moment_like(w, compress_moments)},
                        params)
    dev = next(iter(_tree.leaves(params))).device
    return {"moments": moments,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _moment_leaves(moments, n: int) -> list[tuple]:
    flat = _tree.leaves(moments)
    if len(flat) != 2 * n:
        raise ValueError(f"optimizer state holds {len(flat)} moment "
                         f"tensors for {n} params")
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(n)]


@torch.no_grad()
def adamw_update(params, opt_state, grads, *, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, wd=0.01, clip=1.0, compress_moments=False,
                 grad_norm=None):
    """One AdamW step: (new params, new state, global grad norm before
    the clip).  params/grads: matching trees (f32 params; grads of any
    float dtype, summed in f32).  ``grad_norm``: the global norm when the
    trees are one rank's shards of larger ones (the sharded step's);
    default the norm of ``grads``.

    The bias corrections ``1 - b**t`` are computed on the host in f64 and
    rounded to f32 once, so that the card and the host divide by the
    same numbers (the reference computes them with an f32 ``pow`` on its
    device).  On the meta device (the dry run) the step is taken as 1."""
    step = opt_state["step"] + 1
    t = 1 if step.is_meta else int(step)
    flat_p = _tree.leaves(params)
    flat_g = _tree.leaves(grads)
    if len(flat_g) != len(flat_p):
        raise ValueError(f"{len(flat_g)} grads for {len(flat_p)} params")
    mom = _moment_leaves(opt_state["moments"], len(flat_p))
    like = flat_p[0]

    # global-norm clip
    gnorm = grad_norm if grad_norm is not None else torch.sqrt(
        sum(torch.sum(g.float() ** 2) for g in flat_g))
    scale = torch.minimum(_f32(1.0, like),
                          clip / torch.maximum(gnorm, _f32(1e-12, like)))
    c1, c2 = _f32(1.0 - b1 ** t, like), _f32(1.0 - b2 ** t, like)

    new_p, new_m = [], []
    for w, g, (mo_m, mo_v) in zip(flat_p, flat_g, mom):
        g = g.float() * scale
        m = _decompress(mo_m, _M_SCALE) if compress_moments else mo_m
        v = _decompress(mo_v, _V_SCALE) if compress_moments else mo_v
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mhat = m / c1
        vhat = v / c2
        wf = w.float()
        new_w = wf - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * wf)
        new_p.append(new_w.to(w.dtype))
        if compress_moments:
            new_m += [_compress(m, _M_SCALE), _compress(v, _V_SCALE)]
        else:
            new_m += [m, v]
    moments = _tree.unflatten(opt_state["moments"], new_m)
    return (_tree.unflatten(params, new_p),
            {"moments": moments, "step": step}, gnorm)
