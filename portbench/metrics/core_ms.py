"""core_ms (ms; model): the LSTM core's device time an update, forward
and back, from the program's device marks: the means of the series
learner.device.core_fwd_s and learner.device.core_bwd_s (each its exact
sum over its count), added (regions.py). None where the program has no
marks or no LSTM."""

from portbench import regions


def read(ctx):
    return regions.ms_per_update(("core_fwd", "core_bwd"))
