"""device_idle: the share of the profiled unit's time in which no
operation ran on the device, in %: 1 - (union of the device operations'
intervals) / (the unit's ``bench.unit`` range), both from the one trace
(``device.busy_s`` and ``device.window_s``).  Under the profiler each
launch costs the host more, so a host-paced unit reads idler here than
it runs unprofiled."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
