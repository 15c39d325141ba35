"""Faults planted under the timed path, to show that the output check
catches them. Those of FAULTS wrap the program's learner dispatch
(learner.make_update_dispatch's) the way `harness.build(wrap=...)`
takes it; those of PLANTS are context managers that alter one of the
program's operations while it is built and captured; LR_HIGH is a
learning rate off by a quarter, given to the program as a flag."""

import contextlib

import torch

LR_HIGH = 1.25  # times the configuration's learning rate


def unchanged(dispatch, optimizer, traffic):
    """A step that returns its state unchanged: the update runs, then its
    parameters and optimizer state are put back."""
    from torchbeast_tpu_torch import graphs

    def step(batch, state):
        with graphs.update_state_restored(optimizer):
            return dispatch(batch, state)

    return step


def half_batch(dispatch, optimizer, traffic):
    """Half of the batch left out, the mean taken over the rest: the
    first half of the columns stands in for the second (the losses are
    sums, so this is B times the mean over the half)."""
    half = traffic["batch_size"] // 2

    def doubled(t, dim):
        first = t.narrow(dim, 0, half)
        return torch.cat([first, first], dim)

    def step(batch, state):
        return dispatch({k: doubled(v, 1) for k, v in batch.items()},
                        tuple(doubled(s, 1) for s in state))

    return step


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}


@contextlib.contextmanager
def pool_misrouted():
    """The max-pool backward's answer altered where it is produced: each
    window's gradient credited to the element one column to its right
    (the program's gx rolled by one along the width), its norm kept."""
    from torchbeast_tpu_torch.ops import pool

    right = pool.pool_bwd

    def misrouted(x, y, g):
        return torch.roll(right(x, y, g), 1, dims=3)

    for counter in ("launches", "vector_launches", "bf16_launches"):
        setattr(misrouted, counter, getattr(right, counter))
    pool.pool_bwd = misrouted
    try:
        yield
    finally:
        pool.pool_bwd = right


PLANTS = {"pool_misrouted": pool_misrouted}


def lr_high_argv(config):
    """The flag that runs the program at LR_HIGH times the
    configuration's learning rate."""
    return ("--learning_rate",
            repr(LR_HIGH * config["hparams"]["learning_rate"]))
