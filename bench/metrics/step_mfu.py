"""step_mfu: a unit's paper flop count (``roofline``: 2 n^3 / 3 a matrix
for a factorization, 2 M K N an update) over the median host-clock time
of the traced window's units, as a share of the chip's highest rate
(1,979 TOP/s), in %."""

import roofline


def read(ctx):
    if not ctx.unit_s:
        return None
    return 100.0 * ctx.flops / ctx.unit_s / roofline.PEAK_OPS
