"""Plain PyTorch oracles for the posit GEMM (counterpart of
``repro.kernels.ref``).

* ``rgemm_faithful_chain`` — the paper's PE semantics: every multiply and
  every accumulate rounds to posit, in a fixed K-ordered chain.
* ``rgemm_quire`` — exact products accumulated in float64, rounded to
  posit once (the kernel's semantic target).
* ``gemm_f32_ref`` — the binary32 comparison path.
"""
from __future__ import annotations

import torch

from repro_torch.core import posit
from repro_torch.core.formats import P32E2, PositFormat


def rgemm_faithful_chain(a_p: torch.Tensor, b_p: torch.Tensor,
                         c0_p: torch.Tensor | None = None,
                         fmt: PositFormat = P32E2) -> torch.Tensor:
    """([B,] M,K) x ([B,] K,N) posit-word matmul with per-MAC posit
    rounding, starting from ``c0_p`` (BLAS: beta*C) and running
    k = 0..K-1.

    Runs in fused-chain form: values stay in f64 between ops and every
    op is rounded with ``chain_round``, which gives the same words as the
    reference's per-op fast-backend ``mul``/``add`` (a word round-trip is
    ``chain_round``, pinned in the tests)."""
    k = a_p.shape[-1]
    if k != b_p.shape[-2] or a_p.shape[:-2] != b_p.shape[:-2]:
        raise ValueError(f"bad shapes {tuple(a_p.shape)} @ {tuple(b_p.shape)}")
    if c0_p is None:
        c0_p = torch.zeros((*a_p.shape[:-1], b_p.shape[-1]),
                           dtype=torch.int32, device=a_p.device)
    av = posit.chain_decode(a_p, fmt)
    bv = posit.chain_decode(b_p, fmt)
    c = posit.chain_decode(c0_p, fmt)
    for kk in range(k):
        prod = posit.chain_mul(av[..., :, kk, None], bv[..., None, kk, :],
                               fmt)
        c = posit.chain_add(c, prod, fmt)
    return posit.chain_encode(c, fmt)


def rgemm_faithful(a_p, b_p, fmt: PositFormat = P32E2) -> torch.Tensor:
    return rgemm_faithful_chain(a_p, b_p, None, fmt)


def rgemm_quire(a_p, b_p, fmt: PositFormat = P32E2) -> torch.Tensor:
    """Exact-products f64 accumulation, single posit rounding at the end."""
    return posit.from_float64(
        posit.to_float64(a_p, fmt) @ posit.to_float64(b_p, fmt), fmt)


def gemm_f32_ref(a_p, b_p, fmt: PositFormat = P32E2) -> torch.Tensor:
    """binary32 comparison path: decode to f32, f32 matmul, f32 out."""
    a = posit.to_float64(a_p, fmt).to(torch.float32)
    b = posit.to_float64(b_p, fmt).to(torch.float32)
    return a @ b
