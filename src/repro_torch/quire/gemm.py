"""Quire-exact GEMM: every output element is an exact fused dot product
(counterpart of ``repro.quire.gemm``).

    C[i, j] = round( (-1)^negate * sum_k A[i, k] * B[k, j]  (+ C0[i, j]) )

with ONE posit rounding per element — the ground-truth backend behind
``kernels.ops.rgemm(..., backend="quire_exact")``.

The operands are decoded once; the K reduction then deposits ``kc``
columns' outer products a step into the (M, N, L) int64 limb state with
one ``scatter_add_``.  Deposits are integer limb adds, so every ``kc`` is
bit-identical (associativity), and every product adds < 2^32 per limb,
so K < 2^31 accumulations fit int64 without carrying.  Memory is the
(M, N, L) state plus about fifteen (M, N, kc) int64 temporaries a step.
``unroll`` is accepted so that calls written for the reference run
unchanged; PyTorch runs eagerly and has no scan to unroll, so it changes
nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import P32E2, PositFormat
from repro_torch.quire.quire import (_I64, Quire, _decode_half,
                                     _deposit_terms, _prod_idx0, q_to_posit,
                                     qadd_posit, quire_limbs)

# Columns deposited per step (the reference's default); any kc is
# bit-identical.
_KC_DEFAULT = 8
_UNROLL_DEFAULT = 4


def quire_gemm_limbs(a_p: torch.Tensor, b_p: torch.Tensor,
                     fmt: PositFormat = P32E2, negate: bool = False,
                     kc: int = _KC_DEFAULT, unroll: int = _UNROLL_DEFAULT):
    """The UNROUNDED (M, N, L) int64 redundant limb state and (M, N) nar
    flags of sum_k (-1)^negate * A[i, k] * B[k, j]."""
    del unroll                                  # schedule knob of a scan
    a_p = torch.as_tensor(a_p).to(torch.int32)
    b_p = torch.as_tensor(b_p).to(torch.int32)
    m, k = a_p.shape
    k2, n = b_p.shape
    if k != k2:
        raise ValueError(f"bad shapes {tuple(a_p.shape)} @ {tuple(b_p.shape)}")
    n_limbs = quire_limbs(fmt)
    kc = max(1, min(int(kc), k))

    fa, ca, sga, na = _decode_half(a_p, fmt)             # (M, K) each
    fb, cb, sgb, nb = _decode_half(b_p.T, fmt)           # (N, K)
    if negate:
        sga = -sga
    limbs = torch.zeros((m, n, n_limbs), dtype=_I64, device=a_p.device)
    for k0 in range(0, k, kc):
        sl = slice(k0, k0 + kc)
        prod = fa[:, None, sl] * fb[None, :, sl]         # (M, N, kc) < 2^56
        idx0 = _prod_idx0(ca[:, None, sl], cb[None, :, sl], fmt)
        sgn = sga[:, None, sl] * sgb[None, :, sl]
        idx, src = _deposit_terms(prod, idx0, sgn, n_limbs)
        del prod, idx0, sgn
        limbs.scatter_add_(-1, idx.reshape(m, n, -1), src.reshape(m, n, -1))
    nar = na.any(dim=1)[:, None] | nb.any(dim=1)[None, :]
    return limbs, nar


def quire_gemm(a_p: torch.Tensor, b_p: torch.Tensor,
               c0_p: torch.Tensor | None = None, fmt: PositFormat = P32E2,
               negate: bool = False, kc: int = _KC_DEFAULT,
               unroll: int = _UNROLL_DEFAULT) -> torch.Tensor:
    """(M, K) @ (K, N) posit-word matmul, exact accumulation, one rounding.
    ``c0_p`` (optional (M, N) words) is added into the quire exactly (BLAS
    beta=1); ``negate`` flips every product sign exactly (alpha=-1)."""
    limbs, nar = quire_gemm_limbs(a_p, b_p, fmt, negate, kc, unroll)
    q = Quire(limbs=limbs, nar=nar)
    if c0_p is not None:
        q = qadd_posit(q, torch.as_tensor(c0_p).to(torch.int32), fmt)
    return q_to_posit(q, fmt)


def quire_gemv(a_p: torch.Tensor, x_p: torch.Tensor,
               c0_p: torch.Tensor | None = None, fmt: PositFormat = P32E2,
               negate: bool = False, kc: int = _KC_DEFAULT,
               unroll: int = _UNROLL_DEFAULT) -> torch.Tensor:
    """(M, K) @ (K,) posit-word matvec, one rounding per component:
    ``quire_gemm`` with a single column."""
    x_p = torch.as_tensor(x_p).to(torch.int32)
    limbs, nar = quire_gemm_limbs(a_p, x_p[:, None], fmt, negate, kc, unroll)
    q = Quire(limbs=limbs[:, 0, :], nar=nar[:, 0])
    if c0_p is not None:
        q = qadd_posit(q, torch.as_tensor(c0_p).to(torch.int32), fmt)
    return q_to_posit(q, fmt)
