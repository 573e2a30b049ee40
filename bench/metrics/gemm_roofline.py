"""gemm_roofline: the least time of the profiled unit's products alone
(``roofline.product_min_s``: A and B words in once, the f32 product out
once) over the device time of the program's GEMM kernels, found by name
(the decode pre-pass and the tiled kernel of
``kernels/csrc/posit_gemm.cu``), in %.  Reads nothing where no kernel
of those names ran."""

import roofline

KERNELS = ("decode_planes_kernel", "posit_gemm_kernel")
SPANS = {"update": ["repro_torch.lapack.decomp:_rgemm",
                    "repro_torch.kernels.ops:rgemm"]}


def read(ctx):
    t = ctx.trace
    if t is None or not t.shapes.get("update"):
        return None
    device_s = t.kernel_s(KERNELS)
    if device_s <= 0:
        return None
    least = sum(roofline.product_min_s(*s) for s in t.shapes["update"])
    return 100.0 * least / device_s
