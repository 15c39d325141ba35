"""matmul_ms (ms; model): the device milliseconds an update in kernels of
the matrix-product group (yardstick.GROUPS), from the traced
dispatches."""

from portbench import trace, yardstick


def read(ctx):
    if ctx.trace is None:
        return None
    return trace.device_ms_per_update(
        ctx.trace, lambda name: yardstick.group(name) == "matrix product")
