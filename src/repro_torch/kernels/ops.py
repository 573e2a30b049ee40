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
* ``quire_exact`` — the posit standard's quire (``repro_torch.quire``):
  exact fixed-point accumulation in int64 limbs, ONE rounding per output.
  |alpha| = 1 is an exact product negation and beta = 1 an exact quire
  add of C, so the trailing update (alpha=-1, beta=1) is a single fused
  op; any other alpha/beta costs one pre-rounded posit scaling.  Plain
  PyTorch on either device: the reference computes it in plain ``jnp``,
  outside any Pallas kernel.

Beta semantics: beta == 0 means C is NOT referenced on every backend
except ``faithful``, whose literal per-op chain computes 0 * C first.

Observability (``repro_torch.obs``): with a collector open, ``rgemm`` wraps
the call in an ``rgemm`` span, counts ``rgemm.calls`` and ``rgemm.macs``
and records the word telemetry of ``a`` and of the output, as the
reference's ``rgemm`` does for concrete operands.  The reference's own
bodies (the factorizations, QR, the protected GEMM) call it traced, where
it records nothing; the port's bodies call ``_rgemm``, the same GEMM
without the hook.  With no collector open ``rgemm`` is ``_rgemm``.

Batches: A (B, M, K) and B (B, K, N) (``trans_*`` transposes the last two
axes, as a view) give (B, M, N), each matrix the 2-D call's words, where
the reference ``vmap``s its program.  ``pallas_split3*`` is one pre-pass
and one kernel launch for the whole batch, ``xla_quire`` one batched f64
matmul (its sums may be ordered otherwise than the 2-D call's, within the
same bound), ``faithful`` broadcasts, and ``quire_exact``, plain
PyTorch, runs the matrices in turn.

``serving.quantize.quant_matmul`` reaches its GEMM wrappers through this
module too (``posit_gemm_f32``, and ``quant_gemm_f32``, the skinny
kernel), so that a recorder patching them here sees every call.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.kernels import ref
from repro_torch.kernels.posit_gemm import posit_gemm, posit_gemm_f32
# re-exported for serving.quantize.quant_matmul (module docstring)
from repro_torch.kernels.posit_gemm import quant_gemm_f32 as quant_gemm_f32
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import numerics as _obs_numerics
from repro_torch.obs import trace as _obs_trace
from repro_torch.quire import quire_gemm

BACKENDS = ("pallas_split3", "pallas_split3_comp", "xla_quire", "faithful",
            "quire_exact")


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
    device of ``a_p``; observed when a collector is open (module
    docstring)."""
    kw = dict(trans_a=trans_a, trans_b=trans_b, backend=backend,
              block=block, fmt=fmt)
    if not _obs_metrics.enabled():
        return _rgemm(a_p, b_p, c_p, alpha, beta, **kw)
    m = a_p.shape[-1] if trans_a else a_p.shape[-2]
    k = a_p.shape[-2] if trans_a else a_p.shape[-1]
    n = b_p.shape[-2] if trans_b else b_p.shape[-1]
    with _obs_trace.span("rgemm", m=int(m), k=int(k), n=int(n),
                         backend=backend, fmt=fmt.name):
        out = _rgemm(a_p, b_p, c_p, alpha, beta, **kw)
        _obs_metrics.inc("rgemm.calls")
        _obs_metrics.inc("rgemm.macs", float(m) * float(k) * float(n))
        _obs_numerics.record_numerics("rgemm.a", a_p, fmt)
        _obs_numerics.record_numerics("rgemm.out", out, fmt)
    return out


def _rgemm(a_p: torch.Tensor, b_p: torch.Tensor,
           c_p: torch.Tensor | None = None, alpha=1.0, beta=0.0, *,
           trans_a: bool = False, trans_b: bool = False,
           backend: str = "xla_quire", block: int = 128,
           fmt: PositFormat = P32E2) -> torch.Tensor:
    """``rgemm`` without the observability hook."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    a_p = a_p.to(torch.int32)
    b_p = b_p.to(torch.int32)
    if trans_a:
        a_p = a_p.mT
    if trans_b:
        b_p = b_p.mT
    dev = a_p.device
    alpha_p = _scalar_posit(alpha, fmt, dev)
    beta_p = _scalar_posit(beta, fmt, dev)
    if c_p is None:
        c_p = torch.zeros((*a_p.shape[:-1], b_p.shape[-1]),
                          dtype=torch.int32, device=dev)

    if backend == "quire_exact" and a_p.dim() == 3:
        return torch.stack([_rgemm(a, b, c, alpha, beta, backend=backend,
                                   fmt=fmt)
                            for a, b, c in zip(a_p, b_p, c_p)])
    if backend == "quire_exact":
        # Fold alpha/beta so the common BLAS-3 updates stay single-rounding:
        # |alpha| == 1 -> exact product negation; beta == 1 -> exact quire
        # add of C; anything else costs one pre-rounded posit scaling.
        a_in = a_p
        if alpha not in (1.0, -1.0):
            a_in = posit.mul(alpha_p, a_p, fmt, backend="fast")
        if beta == 0:
            c_in = None
        elif beta == 1:
            c_in = c_p
        else:
            c_in = posit.mul(beta_p, c_p, fmt, backend="fast")
        return quire_gemm(a_in, b_p, c_in, fmt, negate=alpha == -1.0)

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
