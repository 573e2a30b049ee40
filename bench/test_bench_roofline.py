"""The ops and bytes functions against counts worked by hand."""
import pytest

import roofline as rf


def test_gemm_counts_by_hand():
    # (960, 64, 960): the first trailing update of an n=1024, nb=64 LU
    assert rf.gemm_flops(1, 960, 64, 960) == 117_964_800
    # words: A 61440 + B 61440 + C 921600 read + 921600 written
    assert rf.update_min_s(1, 960, 64, 960) == pytest.approx(
        1_966_080 * 4 / 3.35e12)
    # product alone: 122880 words in, 921600 f32 out
    assert rf.product_min_s(1, 960, 64, 960) == pytest.approx(
        4_177_920 / 3.35e12)


def test_batch_scales_every_count():
    assert rf.gemm_flops(100, 960, 64, 960) == 11_796_480_000
    assert rf.update_min_s(100, 960, 64, 960) == pytest.approx(
        196_608_000 * 4 / 3.35e12)
    assert rf.product_min_s(100, 960, 64, 960) == pytest.approx(
        417_792_000 / 3.35e12)


def test_compute_bound_side():
    # a large K makes the product bound by operations: 2 * 4096^3 at peak
    assert rf.product_min_s(1, 4096, 4096, 4096) == pytest.approx(
        2 * 4096**3 / 1979e12)


def test_paper_flop_counts():
    assert rf.lu_flops(1024) == pytest.approx(2 * 1024**3 / 3)
    assert rf.lu_flops(1024, 100) == pytest.approx(7.158278826666667e10)
    # the Cholesky update stream of n=1024, nb=64, batch 100: M = N in
    # 960, 896, ..., 64, K = 64
    stream = sum(rf.gemm_flops(100, m, 64, m) for m in range(64, 1024, 64))
    assert stream == 2 * 100 * 64 * 64**2 * 1240
