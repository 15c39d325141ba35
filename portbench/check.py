"""The comparison that decides `correct`: the program's first updates,
read from its own state, against the plain reference (reference/) run
from the same weights over the same rollouts.

The program's readings come from its own state: each update's loss as
its dispatch returned it; the first update's clipped gradient as the
optimizer got it (RMSprop's nu after one update from zero is
(1 - alpha) g^2, and the sign is that of minus the parameters' step);
each leaf's step in the first update; each leaf's change over the
checked updates, read before the next one.
Leaf by leaf, a gap is taken against the larger of the reference's
norm of that leaf and of the median leaf. The numbers:

- loss_gap: the first update's relative loss gap (loss_gap_any: the
  largest over the checked updates);
- grad_gap: the largest gap between the program's and the reference's
  norms of a leaf of the first gradient (grad_gap_median: the median
  leaf's);
- grad_err: the largest norm of the difference of a leaf of the first
  gradient; grad_err.<group> the same over the leaves whose names start
  with one of the group's prefixes (the configuration's "leaf_groups");
- step_gap: the largest gap between the norms of a leaf's step in the
  first update (step_gap_median: the median leaf's): the learning rate,
  RMSprop's decay and epsilon on a gradient both sides agree on;
- change_gap: the largest gap between the norms of a leaf's change
  (change_gap_median: the median leaf's); step_gap and change_gap over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (RMSprop moves the others by round-off alone).

A configuration's "limits" names the numbers that decide `correct`, each
with its limit; the others are read by controls.py only.
"""

import math
import statistics

import torch

from portbench import generate, reference
from portbench.reference import learner as ref_learner

MOVED = 1e-3  # of the median leaf's gradient norm


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def reference_readings(config, traffic, seed, device):
    """(losses, the first clipped gradient by leaf, first-step norms by
    leaf, change norms by leaf) of the reference's first
    traffic["checked_updates"] updates."""
    net = reference.network(config["reference"])
    shapes = net.param_shapes(config["net"], config["frame_shape"],
                              config["num_actions"])
    params = generate.weights(shapes, seed, device)
    batches = generate.rollouts(traffic, config, seed, device)
    states = generate.states(
        net.state_shapes(config["net"], config["num_actions"],
                         traffic["batch_size"]), traffic, seed, device)
    n = traffic["checked_updates"]
    steps = [(batches[i % len(batches)], states[i % len(states)])
             for i in range(n)]
    with reference.plain_math():
        losses, grad, step, after = ref_learner.train(
            net, config["net"], config["num_actions"], params, steps,
            config["hparams"])
    return (losses, grad, {k: _norm(v) for k, v in step.items()},
            {k: _norm(after[k] - params[k]) for k in params})


def _leaves(program, ref):
    """Leaf by leaf: the gap of the first gradient's norms, the norm of
    its difference, and the gaps of the first step's and of the
    change's norms (of the leaves the reference moves), each over the
    larger of the reference's norm of that leaf and of the median
    leaf."""
    _, p_grad, p_step, p_change = program
    _, r_grad, r_step, r_change = ref
    r_norm = {k: _norm(g) for k, g in r_grad.items()}
    floor = statistics.median(r_norm.values())
    scale = {k: max(n, floor) for k, n in r_norm.items()}
    grad = {k: abs(_norm(p_grad[k]) - r_norm[k]) / scale[k] for k in r_grad}
    err = {k: _norm(p_grad[k].double() - r_grad[k].double()) / scale[k]
           for k in r_grad}
    moved = [k for k in r_grad if r_norm[k] >= MOVED * floor]

    def moved_gaps(p, r):
        least = statistics.median(r[k] for k in moved)
        return {k: abs(p[k] - r[k]) / max(r[k], least) for k in moved}

    return (grad, err, moved_gaps(p_step, r_step),
            moved_gaps(p_change, r_change))


def gaps(program, ref, groups=None):
    """{number: gap} of program readings against reference readings, each
    (losses, the first clipped gradient by leaf, first-step norms by
    leaf, change norms by leaf).
    `groups` ({group: [leaf name prefixes]}) adds grad_err.<group>."""
    p_loss, r_loss = program[0], ref[0]
    grad, err, step, change = _leaves(program, ref)
    found = {"loss_gap": abs(p_loss[0] - r_loss[0]) / abs(r_loss[0]),
             "loss_gap_any": max(abs(p - r) / abs(r)
                                 for p, r in zip(p_loss, r_loss)),
             "grad_gap": max(grad.values()),
             "grad_gap_median": statistics.median(grad.values()),
             "grad_err": max(err.values()),
             "grad_err_median": statistics.median(err.values()),
             "step_gap": max(step.values()),
             "step_gap_median": statistics.median(step.values()),
             "change_gap": max(change.values()),
             "change_gap_median": statistics.median(change.values())}
    for group, prefixes in (groups or {}).items():
        found[f"grad_err.{group}"] = max(
            v for k, v in err.items() if k.startswith(tuple(prefixes)))
    return found


def per_leaf(program, ref):
    """{leaf: [gradient norm gap, gradient difference, first-step gap,
    change gap]}, the steps' None where the reference does not move the
    leaf."""
    grad, err, step, change = _leaves(program, ref)
    return {k: [grad[k], err[k], step.get(k), change.get(k)] for k in grad}


def verdict(found, limits):
    """(correct, {number: {"value", "limit"}}) over the numbers that
    `limits` names: every one finite and within its limit."""
    checks = {k: {"value": found[k], "limit": v} for k, v in limits.items()}
    ok = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
