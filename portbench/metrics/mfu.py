"""mfu (%; the whole step): 3 x the forward FLOPs a frame x (T+1) x B an
update, at the window's updates a second, over the card's dense TF32
peak (yardstick.TF32_FLOPS_PER_S). The FLOPs are counted from the
configuration's shapes by its reference network (forward_flops), with no
recompute counted."""

from portbench import yardstick


def read(ctx):
    if ctx.peak_window_bytes is None:  # not a card
        return None
    frames = (ctx.traffic["unroll_length"] + 1) * ctx.traffic["batch_size"]
    flops = 3 * frames * ctx.network.forward_flops(
        ctx.config["net"], ctx.config["frame_shape"],
        ctx.config["num_actions"])
    updates_per_s = yardstick.rate(1, ctx.window.completions_ms)
    return 100.0 * flops * updates_per_s / yardstick.TF32_FLOPS_PER_S
