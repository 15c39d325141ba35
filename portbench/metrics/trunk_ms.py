"""trunk_ms (ms; model): the trunk's device time an update, forward and
back, from the program's device marks: the means of the series
learner.device.trunk_fwd_s and learner.device.trunk_bwd_s (each its exact
sum over its count), added (regions.py). None where the program has no
marks."""

from portbench import regions


def read(ctx):
    return regions.ms_per_update(("trunk_fwd", "trunk_bwd"))
