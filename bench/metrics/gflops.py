"""gflops (end to end): the paper's flop count of every unit completed
in the window (``unit.flops``, counted by ``roofline`` from the shapes),
over the window's whole host-clock time, in Gflop/s.  It reads
``gflops.<kind>`` too: the same quantity split by kind of cell, each with
a bound of its own."""


def read(ctx):
    if not ctx.units or not ctx.window_s:
        return None
    return ctx.units * ctx.flops / ctx.window_s / 1e9
