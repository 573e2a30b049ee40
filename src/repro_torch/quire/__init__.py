"""Quire-exact accumulation (counterpart of ``repro.quire``): the posit
standard's exact fixed-point fused accumulator in PyTorch int64.

    quire_zero / quire_from_posit / qma / qadd_posit / qneg / q_renorm
    q_to_posit                      single-rounding quire -> posit
    fdp / quire_dot                 exact fused dot products (batched)
    quire_gemm / quire_gemv         exact GEMM/GEMV (one rounding per elem)
    quire_gemm_limbs                pre-rounding limb planes
    to_limbs32 / from_limbs32       int32 (lo, hi) limb planes
"""
from repro_torch.quire.quire import (Quire, fdp, from_limbs32, q_renorm,
                                     q_to_posit, qadd_posit, qma, qneg,
                                     quire_dot, quire_from_posit,
                                     quire_limbs, quire_lsb_exp, quire_zero,
                                     to_limbs32)
from repro_torch.quire.gemm import quire_gemm, quire_gemm_limbs, quire_gemv

__all__ = [
    "Quire", "quire_zero", "quire_from_posit", "qma", "qadd_posit", "qneg",
    "q_renorm", "q_to_posit", "fdp", "quire_dot", "quire_gemm",
    "quire_gemm_limbs", "quire_gemv", "quire_limbs", "quire_lsb_exp",
    "to_limbs32", "from_limbs32",
]
