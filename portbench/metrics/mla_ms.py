"""mla_ms (ms; model): the latent attention's device time an update,
every layer's, forward and back, from the program's summed device
regions: the means of the series learner.device.mla_fwd_s and
learner.device.mla_bwd_s (each an update's sum over its layers; their
exact sums over their counts), added (regions.py). None where the
program has no such regions (a network without MLA, a program without
summed regions, a run on the CPU)."""

from portbench import regions


def read(ctx):
    return regions.ms_per_update(("mla_fwd", "mla_bwd"))
