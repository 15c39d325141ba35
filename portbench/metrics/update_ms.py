"""update_ms (ms; the learner step): the median over the window of one
dispatch's time on the card, between CUDA events recorded before and
after it."""

import statistics


def read(ctx):
    return statistics.median(ctx.window.durations_ms)
