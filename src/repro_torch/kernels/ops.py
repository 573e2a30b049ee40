"""Rgemm — BLAS-3 GEMM over posit words (counterpart of
``repro.kernels.ops``).

    C = alpha * op(A) @ op(B) + beta * C,   op in {identity, transpose}

Backends, under the reference's names:

* ``pallas_split3`` / ``pallas_split3_comp`` — in the port these names
  mean the **Hopper CUDA kernels** (kernels/posit_gemm.py: the decode
  pre-pass, then the tiled GEMM) for CUDA tensors, and their plain
  PyTorch version for CPU tensors: f32
  accumulators, one posit rounding.  For alpha in {1, -1} and beta = 0 the
  rounding is fused into the kernel's epilogue (int32 words straight off
  the kernel, alpha=-1 as an exact sign flip); other alpha/beta use the
  f32 accumulator with an f64 epilogue.  ``block`` is the K chunk of the
  f32 accumulation (a multiple of 16); nothing is padded.
* ``xla_quire`` — decode -> f64 ``torch.matmul`` -> encode (the same
  semantics without the kernel).
* ``faithful`` — per-MAC posit rounding in BLAS chain order (the paper's
  PE behaviour), the ground truth of the accuracy studies.
* ``quire_exact`` is not ported yet (ROADMAP A2) and raises.

Beta semantics: beta == 0 means C is NOT referenced on every backend
except ``faithful``, whose literal per-op chain computes 0 * C first.
The reference's observability hooks wait for ROADMAP A8.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.kernels import ref
from repro_torch.kernels.posit_gemm import posit_gemm, posit_gemm_f32

BACKENDS = ("pallas_split3", "pallas_split3_comp", "xla_quire", "faithful")


def _scalar_posit(x, fmt: PositFormat, device) -> torch.Tensor:
    """alpha/beta are Python scalars -> 0-d posit words on ``device``."""
    if not isinstance(x, (int, float)):
        raise TypeError("alpha/beta must be Python scalars")
    return posit.from_float64(
        torch.tensor(float(x), dtype=torch.float64, device=device), fmt)


def rgemm(a_p: torch.Tensor, b_p: torch.Tensor,
          c_p: torch.Tensor | None = None, alpha=1.0, beta=0.0, *,
          trans_a: bool = False, trans_b: bool = False,
          backend: str = "xla_quire", block: int = 128,
          fmt: PositFormat = P32E2) -> torch.Tensor:
    """Posit GEMM returning int32 posit words in format ``fmt``, on the
    device of ``a_p``."""
    if backend == "quire_exact":
        raise NotImplementedError(
            "the quire_exact backend needs the quire, which is not ported "
            "yet (ROADMAP A2)")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    a_p = a_p.to(torch.int32)
    b_p = b_p.to(torch.int32)
    if trans_a:
        a_p = a_p.T
    if trans_b:
        b_p = b_p.T
    m = a_p.shape[0]
    n = b_p.shape[1]
    dev = a_p.device
    alpha_p = _scalar_posit(alpha, fmt, dev)
    beta_p = _scalar_posit(beta, fmt, dev)
    if c_p is None:
        c_p = torch.zeros((m, n), dtype=torch.int32, device=dev)

    if backend == "faithful":
        # BLAS chain order: C0 = beta*C; accumulate alpha*B(l,j) * A(:,l).
        b_scaled = posit.mul(alpha_p, b_p, fmt, backend="fast")
        c0 = posit.mul(beta_p, c_p, fmt, backend="fast")
        return ref.rgemm_faithful_chain(a_p, b_scaled, c0, fmt)

    if backend == "xla_quire":
        ab = posit.to_float64(a_p, fmt) @ posit.to_float64(b_p, fmt)
    else:
        mode = backend.removeprefix("pallas_")
        if alpha in (1.0, -1.0) and beta == 0:
            # Fused epilogue: the kernel encodes ±accumulator to words.
            return posit_gemm(a_p, b_p, bk=block, mode=mode, fmt=fmt,
                              negate=alpha == -1.0)
        ab = posit_gemm_f32(a_p, b_p, bk=block, mode=mode,
                            fmt=fmt).to(torch.float64)

    if beta == 0:
        out = posit.to_float64(alpha_p, fmt) * ab
    else:
        out = (posit.to_float64(alpha_p, fmt) * ab
               + posit.to_float64(beta_p, fmt) * posit.to_float64(c_p, fmt))
    return posit.from_float64(out, fmt)


def rgemm_f32(a_p, b_p, fmt: PositFormat = P32E2, **kw) -> torch.Tensor:
    """Convenience: decoded-f32 result (no final posit rounding)."""
    return posit.to_float64(rgemm(a_p, b_p, fmt=fmt, **kw),
                            fmt).to(torch.float32)
