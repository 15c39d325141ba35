"""pool_bwd_roofline (%; kernels): the least time in which the card
moves the bytes of the trunk's max-pool backwards (x, y and g read once,
gx written once, at every pool's shape), over the device time an update
of the kernels that implement it: the port's pool_bwd_kernel, or the
library's max-pool backward."""

from portbench import trace, yardstick

KERNELS = ("pool_bwd_kernel", "max_pool2d_with_indices_backward")


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.network, "pools"):
        return None
    ms = trace.device_ms_per_update(
        ctx.trace, lambda name: any(k in name for k in KERNELS))
    if ms is None:
        return None
    images = (ctx.traffic["unroll_length"] + 1) * ctx.traffic["batch_size"]
    pools = ctx.network.pools(ctx.config["net"], ctx.config["frame_shape"])
    bound = yardstick.bytes_ms(yardstick.pool_bwd_bytes(images, pools, 4))
    return 100.0 * bound / ms
