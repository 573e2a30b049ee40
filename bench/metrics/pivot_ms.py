"""pivot_ms: host-clock milliseconds a unit in the LU's row swaps
(``lapack.decomp.swap_perm``, one host read of the panel's pivots a
block step, and ``permute_rows``), a sync on both sides of each call."""

SPANS = {"pivot": ["repro_torch.lapack.decomp:swap_perm",
                   "repro_torch.lapack.decomp:permute_rows"]}


def read(ctx):
    return ctx.span_ms("pivot")
