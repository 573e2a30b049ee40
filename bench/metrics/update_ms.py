"""update_ms: host-clock milliseconds a unit in the trailing updates
(``kernels.ops._rgemm`` as the factorizations call it, or
``kernels.ops.rgemm`` as the update stream calls it: the decode
pre-pass, the GEMM kernel, the f64 beta = 1 epilogue and
``from_float64``), a sync on both sides of each call."""

SPANS = {"update": ["repro_torch.lapack.decomp:_rgemm",
                    "repro_torch.kernels.ops:rgemm"]}


def read(ctx):
    return ctx.span_ms("update")
