"""update_roofline: the least time of the profiled unit's trailing
updates (``roofline.update_min_s``: 2 M K N operations at the chip's
highest rate, or A, B and C read once and the words written once)
over the device time of every operation launched inside them, in %."""

import roofline

SPANS = {"update": ["repro_torch.lapack.decomp:_rgemm",
                    "repro_torch.kernels.ops:rgemm"]}


def read(ctx):
    t = ctx.trace
    if t is None or not t.shapes.get("update"):
        return None
    device_s = t.range_device_s("update")
    if device_s <= 0:
        return None
    least = sum(roofline.update_min_s(*s) for s in t.shapes["update"])
    return 100.0 * least / device_s
