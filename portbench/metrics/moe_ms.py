"""moe_ms (ms; model): the MoE layers' device time an update (the norm,
the router, the sorted dispatch, the held experts and the shared
experts, every layer), forward and back, from the program's summed
device regions: the means of the series learner.device.moe_fwd_s and
learner.device.moe_bwd_s, added (regions.py). None where the program
has no such regions."""

from portbench import regions


def read(ctx):
    return regions.ms_per_update(("moe_fwd", "moe_bwd"))
