"""device_idle_share (%; device): the share of the untraced window in
which the card held no dispatch: from the completion of one update's end
mark to that of the next one's start mark (the first from the window's
start), over the window, by the CUDA events the window records. It is
the time the card waits for the host between dispatches, one small
stack of each update's loss and norm included. Gaps inside a dispatch's
graph show in update_ms; the traced window's idle share (the result's
busy_s and window_s) carries the profiler's own cost of launching a
graph, so it is not read here."""


def read(ctx):
    win = ctx.window
    if not win.completions_ms or win.completions_ms[-1] <= 0:
        return None
    return 100.0 * (1.0 - sum(win.durations_ms) / win.completions_ms[-1])
