"""Numeric-format policy: posit as a framework-level dtype knob
(counterpart of ``repro.core.policy``).

* ``quantize`` — straight-through rounding of a float tensor to the posit
  lattice of a format (simulated quantization: values on the lattice,
  compute in f32/bf16; the gradient passes through unchanged, as the
  reference's ``custom_vjp`` gives it).  Used by ``Policy`` on every
  linear's weights and activations.
* ``encode_tensor``/``decode_tensor`` — bit-pattern (de)serialization in
  the format's wire dtype (int16 for p16e1, int8 for p8e2), used by the
  p16e1 optimizer moments (``optim.adamw``) and the compressed gradient
  collective (``launch.collectives``).
* ``Policy`` — per-subsystem format selection resolved from arch configs,
  with the reference's named policies.

The codec runs where the tensor lives.  On a CUDA tensor it is the
hand-written codec kernels of ``kernels.posit_gemm``: the encode kernel
(``encode_posit_f32``, straight into the wire dtype) and the decode
kernel (``decode_split_f32``), whose exact f32 pair is summed once,
``hi + lo``: one correctly rounded add of the exact value, which is the
reference's ``to_float32_bits`` (``sig`` to f32, then ``ldexp``).  On a
CPU tensor it is the plain codec (``core.posit.from_float32_bits`` /
``to_float32_bits``).  It never falls back from one to the other.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import posit
from repro_torch.core.formats import PositFormat, get_format
from repro_torch.kernels import posit_gemm as _pg

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
WIRE_DTYPES = {8: torch.int8, 16: torch.int16, 32: torch.int32}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a policy names (``"float32"``, ``"bfloat16"``)."""
    return DTYPES[name]


def wire_dtype(fmt: PositFormat) -> torch.dtype:
    """The narrowest integer dtype that holds ``fmt``'s words."""
    return WIRE_DTYPES[8 if fmt.nbits <= 8 else 16 if fmt.nbits <= 16
                       else 32]


def _fmt(fmt) -> PositFormat:
    return get_format(fmt) if isinstance(fmt, str) else fmt


# --------------------------------------------------------------------------
# the codec: kernels on the card, the plain codec on the host
# --------------------------------------------------------------------------

# The decode kernel's pair is exact down to 2^-99 and gives 0 below 2^-103
# (the split the GEMM's semantics fix).  Only p32e2 has words down there:
# the magnitudes 1 .. _TINY_WORDS[fmt] - 1 (scales -120 .. -104).  Their
# f32 values, from the plain codec, complete the decode.
_MIN_PAIR_SCALE = -103


@functools.lru_cache(maxsize=None)
def _tiny_table(fmt: PositFormat, device: torch.device):
    """(T, values of the words 0 .. T-1) for the words the decode kernel's
    pair flushes to zero, or None when the format has none."""
    if -fmt.max_scale >= _MIN_PAIR_SCALE:
        return None
    words = torch.arange(1, 1 << 16, dtype=torch.int32)
    vals = posit.to_float32_bits(words, fmt)
    t = int(torch.nonzero(torch.abs(vals) >= 2.0 ** _MIN_PAIR_SCALE)[0]) + 1
    table = torch.cat([torch.zeros(1), vals[:t - 1]]).to(device)
    return t, table


def _encode(x: torch.Tensor, f: PositFormat, out_dtype) -> torch.Tensor:
    x = x.to(torch.float32)
    if x.is_cuda:
        return _pg.encode_posit_f32(x, f, out_dtype=out_dtype)
    return posit.from_float32_bits(x, f).to(out_dtype)


def _decode(p: torch.Tensor, f: PositFormat) -> torch.Tensor:
    p = p.to(torch.int32)
    if not p.is_cuda:
        return posit.to_float32_bits(p, f)
    return _from_pair(p, f, *_pg.decode_split_f32(p, f))


def _from_pair(p, f, hi, lo) -> torch.Tensor:
    """The f32 values of the words ``p`` from their exact pair (hi, lo):
    ``hi + lo``, the words below the pair's range from their table."""
    out = hi + lo
    tiny = _tiny_table(f, p.device)
    if tiny is not None:
        t, table = tiny
        small = (p > -t) & (p < t)
        mag = table[torch.where(small, torch.abs(p), 0)]
        out = torch.where(small, torch.where(p < 0, -mag, mag), out)
    return out


def _round(x: torch.Tensor, f: PositFormat) -> torch.Tensor:
    return _decode(_encode(x, f, torch.int32), f).to(x.dtype)


class _StraightThrough(torch.autograd.Function):
    """The lattice rounding forward, the identity backward (the
    reference's ``_st_fwd`` / ``_st_bwd``).  Saves nothing: at full width
    the input is every weight of the model."""

    @staticmethod
    def forward(ctx, x, f):
        return _round(x, f)

    @staticmethod
    def backward(ctx, g):
        return g, None


def quantize(x: torch.Tensor, fmt: str | PositFormat = "p32e2"
             ) -> torch.Tensor:
    """Round ``x`` to the posit lattice of ``fmt`` (in ``x``'s dtype),
    with the straight-through gradient."""
    return _StraightThrough.apply(x, _fmt(fmt))


def encode_tensor(x: torch.Tensor, fmt: str | PositFormat = "p16e1"
                  ) -> torch.Tensor:
    """float tensor -> posit words in the narrowest wire dtype."""
    f = _fmt(fmt)
    return _encode(torch.as_tensor(x), f, wire_dtype(f))


def decode_tensor(p: torch.Tensor, fmt: str | PositFormat = "p16e1",
                  dtype=torch.float32) -> torch.Tensor:
    return _decode(p, _fmt(fmt)).to(dtype)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Where posit formats are applied in the training and serving stack.

    ``gemm``: 'bf16' (baseline), 'posit32' (the simulated posit GEMM:
    every linear's weights and activations on the p32e2 lattice) or
    'posit32_split' (the same lattice; the name of the reference's hi/lo
    split path).  ``weights``/``activations``: the lattice ``linear``
    rounds to.  ``grad_compression``: the wire format of the data-parallel
    gradient sum (``launch.steps.make_train_step_compressed``).
    ``opt_compression``: the AdamW moments' storage format.
    ``master_dtype``: the optimizer's master weights; ``compute_dtype``:
    the forward's."""
    gemm: str = "bf16"
    weights: Optional[str] = None
    activations: Optional[str] = None
    grad_compression: Optional[str] = None
    opt_compression: Optional[str] = None
    master_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def maybe_quantize_weights(self, w: torch.Tensor) -> torch.Tensor:
        return quantize(w, self.weights) if self.weights else w

    def maybe_quantize_acts(self, x: torch.Tensor) -> torch.Tensor:
        return quantize(x, self.activations) if self.activations else x


BF16_BASELINE = Policy()
PAPER_POSIT32 = Policy(gemm="posit32", weights="p32e2", activations="p32e2",
                       compute_dtype="float32")
POSIT_SPLIT = Policy(gemm="posit32_split", weights="p32e2",
                     activations="p32e2", compute_dtype="float32")
POSIT_COMPRESSED_DP = Policy(grad_compression="p16e1")
POSIT_OPT16 = Policy(opt_compression="p16e1")

F32_SERVE = Policy(compute_dtype="float32")

POLICIES = {
    "bf16": BF16_BASELINE,
    "f32": F32_SERVE,
    "posit32": PAPER_POSIT32,
    "posit32_split": POSIT_SPLIT,
    "posit_dp": POSIT_COMPRESSED_DP,
    "bf16_opt16": POSIT_OPT16,
}


def get_policy(name: str) -> Policy:
    return POLICIES[name]
