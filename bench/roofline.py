"""Peaks of the card and the work of each measured call, counted from
shapes by the algorithm and never read from the program.

The peaks are the H100 SXM's highest published rates (NVIDIA's data
sheet, dense, 700 W): 1,979 TOP/s (int8 and fp8 tensor cores), the
chip's highest operation rate, and 3.35 TB/s of HBM3.  A share of either
counts the algorithm's work against the most the chip could do, so no
implementation (FFMA, tensor cores, a fused epilogue) reads over 100 %.
"""
from __future__ import annotations

PEAK_OPS = 1979e12            # operations a second
PEAK_BYTES = 3.35e12          # bytes a second
WORD = 4                      # bytes of an int32 posit word
F32 = 4


def lu_flops(n: int, batch: int = 1) -> float:
    """The paper's count for an n x n LU: 2 n^3 / 3 a matrix."""
    return batch * 2.0 * n ** 3 / 3.0


def gemm_flops(batch: int, m: int, k: int, n: int) -> float:
    """2 M K N a matrix: a multiply and an add per term."""
    return 2.0 * batch * m * k * n


def update_min_s(batch: int, m: int, k: int, n: int) -> float:
    """Least time of ``C - A @ B`` on words: its operations at the peak
    rate, or A, B and C read once and the result written once."""
    words = batch * (m * k + k * n + 2 * m * n)
    return max(gemm_flops(batch, m, k, n) / PEAK_OPS,
               words * WORD / PEAK_BYTES)


def product_min_s(batch: int, m: int, k: int, n: int) -> float:
    """Least time of the product alone: A and B words read once, the f32
    product written once."""
    nbytes = batch * ((m * k + k * n) * WORD + m * n * F32)
    return max(gemm_flops(batch, m, k, n) / PEAK_OPS, nbytes / PEAK_BYTES)
