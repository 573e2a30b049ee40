"""Shared model substrate: ArchConfig, the policy-aware linear (with the
posit-quantized branch), norms, rotary embeddings, initializers
(counterpart of ``repro.models.common``, single device).

Functional style as in the reference: every block is ``*_init(rng, ...)
-> params`` and ``*_apply(params, x, ...) -> y`` over plain dicts whose
leaves are ``{"w": tensor, "axes": names}``; ``axes`` keeps the
reference's logical axis names and nothing reads them here.  The
reference stacks the layers of a period along a leading axis for its
``lax.scan``; the port keeps one dict per layer (``models.lm``).

Dtypes follow the reference's policy: operands are rounded to the
compute dtype, products are summed in f32 where the reference asks for
``preferred_element_type=float32`` (``dot_f32``), and ``rmsnorm`` reduces
in f32 and scales in the compute dtype.

Under a distribution context (``launch.context``) ``embed`` is the
reference's vocab-parallel embedding; without one it is the
single-device path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import _device
from repro_torch.core.policy import Policy, get_policy
from repro_torch.tree import Axes  # noqa: F401  (re-exported)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "silu"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # local/global attention pattern (gemma3: 5 local : 1 global)
    local_window: int = 0
    local_ratio: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (Mamba2/SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    hybrid_attn_every: int = 0     # zamba2: shared attn block cadence
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0
    # VLM stub frontend
    vis_tokens: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    policy: str = "bf16"

    @property
    def d_q(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            if self.family in ("ssm", "hybrid"):
                kinds.append("ssm")
            elif self.local_ratio and (i + 1) % (self.local_ratio + 1) != 0:
                kinds.append("local")
            else:
                kinds.append("attn")
        return kinds

    def get_policy(self) -> Policy:
        return get_policy(self.policy)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape."""
        return self.family in ("ssm", "hybrid") or (
            self.local_ratio > 0 and self.local_window > 0)


# --------------------------------------------------------------------------
# param helpers
# --------------------------------------------------------------------------

class Rng:
    """The port's seeded initializer: one ``torch.Generator`` on the
    target device, consumed in the fixed order of the init functions."""

    def __init__(self, seed: int, device="cuda"):
        self.device = _device.resolve(device)
        self.gen = None
        if self.device.type != "meta":        # meta: shapes only
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def normal(self, shape) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(tuple(shape), dtype=torch.float32,
                               device=self.device)
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device, dtype=torch.float32)


def param(rng: Rng, shape, axes: Sequence[Optional[str]], scale: float = 1.0,
          dtype=torch.float32, init: str = "normal"):
    """A param leaf and its logical axis names, at the reference's scales:
    normal / sqrt(fan_in) with fan_in = shape[0] (shape[-1] for a
    vector), zeros or ones."""
    if init == "normal":
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        w = rng.normal(shape) * (scale / math.sqrt(fan_in))
    elif init == "zeros":
        w = torch.zeros(tuple(shape), dtype=torch.float32, device=rng.device)
    elif init == "ones":
        w = torch.ones(tuple(shape), dtype=torch.float32, device=rng.device)
    else:
        raise ValueError(init)
    return {"w": w.to(dtype), "axes": Axes(axes)}


def is_qleaf(x) -> bool:
    """A posit-quantized leaf (``serving.quantize``)."""
    return isinstance(x, dict) and "qw" in x


def leaf(p) -> torch.Tensor:
    if is_qleaf(p):
        from repro_torch.serving.quantize import dequant_leaf
        return dequant_leaf(p)
    return p["w"]


def is_param(x) -> bool:
    return isinstance(x, dict) and set(x) == {"w", "axes"}


def map_params(fn, tree):
    """Map fn(leaf_dict) over all param leaves of a model tree."""
    if is_param(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_params(fn, v) for v in tree)
    return tree


def dot_f32(a: torch.Tensor, b: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``compute_dtype`` and the
    products summed in f32 (the reference's ``jnp.dot(...,
    preferred_element_type=float32)``): bf16 operands widen to f32
    exactly, so an f32 matmul of them is that product."""
    return torch.matmul(a.to(compute_dtype).float(),
                        b.to(compute_dtype).float())


# --------------------------------------------------------------------------
# basic layers
# --------------------------------------------------------------------------

def rmsnorm_init(rng, d, axes=("embed",)):
    return {"scale": param(rng, (d,), axes, init="ones")}


def rmsnorm(params, x, eps):
    """f32 in the reduction, the normalize and scale multiplies in the
    compute dtype (the reference's split)."""
    dt = x.dtype
    xf = x.float()
    var = ((xf * xf).sum(-1) / x.shape[-1])[..., None]
    r = torch.rsqrt(var + torch.tensor(eps, dtype=torch.float32)).to(dt)
    return x * r * leaf(params["scale"]).to(dt)


def linear_init(rng, d_in, d_out, axes, bias=False, scale=1.0):
    p = {"w": param(rng, (d_in, d_out), axes, scale=scale)}
    if bias:
        p["b"] = param(rng, (d_out,), (axes[-1],), init="zeros")
    return p


def linear(params, x, policy: Policy, compute_dtype):
    """Policy-aware dense layer: the policy's weight and activation
    rounding (``core.policy.quantize``, straight-through under autograd),
    then a product summed in f32 whose output is rounded to the compute
    dtype once (what the reference computes with or without its
    ``f32_partials`` flag).  A posit-quantized weight leaf goes through
    ``serving.quantize.quant_matmul`` (its backend decides: decoded f32
    ``torch.matmul``, or the Hopper posit GEMM kernel on the words); the
    policy's weight/activation rounding does not stack on top, the leaf
    is the lattice."""
    if is_qleaf(params["w"]):
        from repro_torch.serving.quantize import quant_matmul
        y = quant_matmul(x, params["w"], compute_dtype)
        if "b" in params:
            y = y + leaf(params["b"]).to(compute_dtype)
        return y
    w = policy.maybe_quantize_weights(leaf(params["w"]))
    x = policy.maybe_quantize_acts(x)
    y = dot_f32(x, w, compute_dtype).to(compute_dtype)
    if "b" in params:
        y = y + leaf(params["b"]).to(compute_dtype)
    return y


def embed_init(rng, vocab, d):
    return {"table": param(rng, (vocab, d), ("vocab", "embed"), scale=1.0)}


def vocab_parallel(vocab: int):
    """The distribution context under which the embedding table is
    vocab-parallel (its "model" axis has n > 1 ranks that divide
    ``vocab``: model rank ``m`` holds the rows ``[m * v_local, (m + 1) *
    v_local)``), else None."""
    from repro_torch.launch import context as dist_ctx
    ctx = dist_ctx.current()
    n = ctx.mesh.shape.get("model", 1) if ctx is not None else 1
    return ctx if n > 1 and vocab % n == 0 else None


def embed(params, ids, compute_dtype, vocab: Optional[int] = None):
    """Embedding lookup.  A quantized table decodes only the rows it
    gathers (the same values as gathering from the decoded table: the
    decode is elementwise and the scales are per column).

    Vocab-parallel under ``vocab_parallel(vocab)`` (``vocab`` the whole
    vocabulary, default the table's rows): the table given is then this
    model rank's rows; it looks up the ids it holds, zero for the others,
    and the rows are summed in f32 over "model" (an autograd psum, so the
    table's gradient lands on the rows each rank holds).  One rank holds
    each id, so the sum is the plain gather's value."""
    t = params["table"]
    if is_qleaf(t):
        from repro_torch.serving.quantize import dequant_rows
        return dequant_rows(t, ids).to(compute_dtype)
    table = leaf(t)
    ctx = vocab_parallel(table.shape[0] if vocab is None else vocab)
    if ctx is None:
        return table[ids].to(compute_dtype)
    from repro_torch.launch import mesh as M
    v_local = table.shape[0]
    adj = ids.long() - ctx.mesh.axis_index("model") * v_local
    valid = (adj >= 0) & (adj < v_local)
    g = table[adj.clamp(0, v_local - 1)].to(compute_dtype)
    g = torch.where(valid[..., None], g,
                    torch.zeros((), dtype=compute_dtype, device=g.device))
    return M.psum(g.float(), ctx.mesh, "model").to(compute_dtype)


def unembed(params, x, compute_dtype):
    t = leaf(params["table"]).to(compute_dtype)
    return dot_f32(x, t.T, compute_dtype)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults."""
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: (..., S) int."""
    dh = x.shape[-1]
    half = dh // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.tensor(theta, dtype=torch.float32, device=x.device) ** -exps
    ang = positions[..., None].to(torch.float32) * freq
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
