"""setup_s (end to end): host-clock seconds from the start of the run to
the end of the warm-up: the imports, the kernel library (built by nvcc on
a checkout's first run), the inputs made on the device from the seed,
and one warm-up unit of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
