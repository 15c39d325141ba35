"""loss_ms (ms; learner step): the device time an update of the policy
and baseline heads, V-trace and the losses, forward and back, from the
program's device marks: the means of the series learner.device.loss_fwd_s
and learner.device.loss_bwd_s (each its exact sum over its count), added
(regions.py). None where the program has no marks."""

from portbench import regions


def read(ctx):
    return regions.ms_per_update(("loss_fwd", "loss_bwd"))
