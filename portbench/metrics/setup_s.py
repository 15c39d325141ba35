"""setup_s (s, end to end): from the process's start to the first timed
update: imports, the device's start, inputs and weights made from the
seed, the kernels built or loaded, the capture, the checked and the
warm-up updates."""


def read(ctx):
    return ctx.setup_s
