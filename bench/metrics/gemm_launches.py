"""gemm_launches: launches of the program's GEMM kernels a unit in the
window (``kernels.posit_gemm.launch_counts()``: the decode pre-pass and
the GEMM kernels), a count the program keeps."""

NAMES = ("decode_planes", "posit_gemm")


def read(ctx):
    if not ctx.units:
        return None
    n = sum(v for k, v in ctx.launches.items() if k.startswith(NAMES))
    return n / ctx.units
