"""step_p95_ms (ms, end to end): the 95th percentile, over every update
of the window, of the interval between one update's completion on the
card and the next one's (the first from the window's start)."""

from portbench import yardstick


def read(ctx):
    return yardstick.percentile(
        yardstick.intervals_ms(ctx.window.completions_ms), 95)
