"""opt_ms (ms; learner step): the optimizer's device time an update (the
gradients' norm, the clip and the RMSprop tail), from the program's
device marks: the mean of the series learner.device.opt_s, its exact sum
over its count (regions.py). None where the program has no marks."""

from portbench import regions


def read(ctx):
    return regions.ms_per_update(("opt",))
