"""Numeric-format policy: posit as a framework-level dtype knob
(counterpart of ``repro.core.policy``, forward only).

* ``quantize`` — round a float tensor to the posit lattice of a format
  (simulated quantization: values on the lattice, compute in f32/bf16).
  The reference's straight-through gradient comes with training; this
  port serves, so ``quantize`` is the forward rounding alone.
* ``encode_tensor``/``decode_tensor`` — bit-pattern (de)serialization in
  the format's wire dtype (int16 for p16e1, int8 for p8e2).
* ``Policy`` — per-subsystem format selection resolved from arch configs,
  with the reference's named policies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import posit
from repro_torch.core.formats import PositFormat, get_format

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


def quantize(x: torch.Tensor, fmt: str | PositFormat = "p32e2"
             ) -> torch.Tensor:
    """Round ``x`` to the posit lattice of ``fmt`` (in ``x``'s dtype)."""
    f = _fmt(fmt)
    p = posit.from_float32_bits(x.to(torch.float32), f)
    return posit.to_float32_bits(p, f).to(x.dtype)


def encode_tensor(x: torch.Tensor, fmt: str | PositFormat = "p16e1"
                  ) -> torch.Tensor:
    """float tensor -> posit words in the narrowest wire dtype."""
    f = _fmt(fmt)
    p = posit.from_float32_bits(torch.as_tensor(x).to(torch.float32), f)
    return p.to(wire_dtype(f))


def decode_tensor(p: torch.Tensor, fmt: str | PositFormat = "p16e1",
                  dtype=torch.float32) -> torch.Tensor:
    f = _fmt(fmt)
    return posit.to_float32_bits(p.to(torch.int32), f).to(dtype)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Where posit formats are applied in the serving stack (the
    reference's fields; ``grad_compression``, ``opt_compression`` and
    ``master_dtype`` are read by training, which this port does not have
    yet)."""
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
