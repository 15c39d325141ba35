"""opt_tail_roofline (%; kernels): the least time in which the card moves
the bytes of the optimizer tail (global-norm clip, RMSprop and the
learning-rate apply) over the cell's float32 tree, over the device time
an update of the kernels that implement it (the port's fused
rmsprop_tail_kernel)."""

import math

from portbench import trace, yardstick

KERNELS = ("rmsprop_tail_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    ms = trace.device_ms_per_update(
        ctx.trace, lambda name: any(k in name for k in KERNELS))
    if ms is None:
        return None
    params = sum(math.prod(shape) for _, shape in ctx.network.param_shapes(
        ctx.config["net"], ctx.config["frame_shape"],
        ctx.config["num_actions"]))
    return 100.0 * yardstick.bytes_ms(
        yardstick.rmsprop_tail_bytes(params)) / ms
