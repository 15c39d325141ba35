"""learn_fps (frames/s, end to end): the env frames that the window's
updates learned from (T x B an update), over the window: from the
completion on the card of the last update before it to the completion
of its last update."""

from portbench import yardstick


def read(ctx):
    frames = ctx.traffic["unroll_length"] * ctx.traffic["batch_size"]
    return yardstick.rate(frames, ctx.window.completions_ms)
