"""trsm_ms: host-clock milliseconds a unit in the LU's unit lower
triangular solves for U12 (``lapack.blas.rtrsm_left_lower`` as
``lapack.decomp`` calls it), a sync on both sides of each call."""

SPANS = {"trsm": ["repro_torch.lapack.decomp:rtrsm_left_lower"]}


def read(ctx):
    return ctx.span_ms("trsm")
