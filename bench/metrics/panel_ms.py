"""panel_ms: host-clock milliseconds a unit in the LU's unblocked panels
(``lapack.decomp.getf2`` and its ``core.posit`` chain ops), a sync on
both sides of each call."""

SPANS = {"panel": ["repro_torch.lapack.decomp:getf2"]}


def read(ctx):
    return ctx.span_ms("panel")
