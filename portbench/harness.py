"""One run of a learner cell: the program's learner built from the
configuration's flags, its first updates read for the output check, the
measured window, the traced dispatches and the check itself.

The program is torchbeast_tpu_torch. The harness builds its model with
`monobeast.make_parser()` and `monobeast.build_model` from the flags in
the configuration's file, loads the weights drawn from the seed
(generate.weights) into it, builds `learner.make_optimizer`'s optimizer,
and dispatches updates through `learner.make_update_dispatch` wrapped by
`learner.instrument_update_step`, as the drivers do, over rollouts
already on the device.
"""

import contextlib
import gc
import os
import time
from typing import NamedTuple, Optional

import torch

from portbench import check, generate, reference, trace


# Dispatches the host keeps in flight in the window and the trace: enough
# that the card's queue never drains while the host launches the next
# update, as polybeast's learner loop keeps it; the host waits on nothing
# else.
IN_FLIGHT = 3


class Program(NamedTuple):
    step: object  # (batch, state) -> stats
    names: list  # the parameters' names, in the optimizer's order
    staged: list  # [(batch, state)] on the device
    readings: dict  # the first updates' losses and leaves, device tensors
    next: int  # the staged pair the window starts from


class Clock:
    """Marks on the device's timeline: CUDA events on a card; on the CPU,
    where every step runs to its end before it returns, the host clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@contextlib.contextmanager
def configured(config):
    """The configuration's environment and math mode for the body."""
    saved_env = {k: os.environ.get(k) for k in config["environment"]}
    saved_math = (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32)
    os.environ.update(config["environment"])
    torch.backends.cudnn.allow_tf32 = config["math"]["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = config["math"][
        "matmul_allow_tf32"]
    try:
        yield
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved_math


def _argv(config, traffic, seed, extra):
    return list(config["argv"]) + [
        "--unroll_length", str(traffic["unroll_length"]),
        "--batch_size", str(traffic["batch_size"]),
        "--superstep_k", str(traffic["superstep_k"]),
        "--replay_reuse", str(traffic["replay_reuse"]),
        "--seed", str(seed % 2 ** 31)] + list(extra)


def _load(model, weights):
    """Copy the benchmark's weights into the program's parameters, which
    must have exactly their names and shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"the program's parameters {sorted(set(params) ^ set(weights))} "
            "are not the reference's")
    with torch.no_grad():
        for name, w in weights.items():
            if tuple(params[name].shape) != tuple(w.shape):
                raise ValueError(f"{name}: the program's shape "
                                 f"{tuple(params[name].shape)}, the "
                                 f"reference's {tuple(w.shape)}")
            params[name].copy_(w)


def build(config, traffic, seed, device, extra_argv=(), wrap=None):
    """The program's learner for a cell, driven through its first
    updates and warmed up. `extra_argv` is added to the configuration's
    flags (the control's precision); `wrap(dispatch, optimizer,
    traffic)` plants a fault under the timed path (faults.py)."""
    from torchbeast_tpu_torch import learner, monobeast, precision

    flags = monobeast.make_parser().parse_args(
        _argv(config, traffic, seed, extra_argv))
    flags.disable_cuda = device.type == "cpu"
    net = reference.network(config["reference"])
    model = monobeast.build_model(flags, config["num_actions"],
                                  tuple(config["frame_shape"]), device)
    _load(model, generate.weights(
        net.param_shapes(config["net"], config["frame_shape"],
                         config["num_actions"]), seed, device))
    hp = monobeast.hparams_from_flags(flags)
    optimizer = learner.make_optimizer(hp, list(model.parameters()))
    names = [name for name, _ in model.named_parameters()]
    batch_dtype = precision.resolve_flags(flags).batch_dtype
    state_shapes = net.state_shapes(config["net"], config["num_actions"],
                                    traffic["batch_size"])
    staged = [(precision.cast_batch(b, batch_dtype),
               precision.cast_batch(s, batch_dtype)) for b, s in zip(
                   generate.rollouts(traffic, config, seed, device),
                   generate.states(state_shapes, traffic, seed, device))]
    dispatch = learner.make_update_dispatch(model, optimizer, hp)
    if device.type == "cuda":
        dispatch.capture(*staged[0])
    if wrap is not None:
        dispatch = wrap(dispatch, optimizer, traffic)
    step = learner.instrument_update_step(dispatch)

    # The first updates, through the window's own call, on distinct
    # rollouts: the output check's readings, taken from the program's
    # own state.
    params = optimizer.params
    with torch.no_grad():
        before = [p.detach().float().clone() for p in params]
    losses, first = [], None
    checked = traffic["checked_updates"]
    for i in range(checked):
        losses.append(step(*staged[i % len(staged)])["total_loss"])
        if i == 0:
            # The clipped gradient the optimizer got: its magnitude from
            # nu = (1 - alpha) g^2, its sign against the parameters' step.
            with torch.no_grad():
                first = [-torch.sign(p.float() - q) * torch.sqrt(
                    nu.float() / (1.0 - config["hparams"]["alpha"]))
                    for p, q, nu in zip(params, before, optimizer.state.nu)]
                step_sq = torch.stack([((p.float() - q) ** 2).sum()
                                       for p, q in zip(params, before)])
    with torch.no_grad():
        change_sq = torch.stack([((p.float() - q) ** 2).sum()
                                 for p, q in zip(params, before)])
    del before
    for i in range(traffic["warmup_updates"]):
        step(*staged[(checked + i) % len(staged)])
    readings = {"losses": torch.stack(losses), "first_grad": first,
                "step_sq": step_sq, "change_sq": change_sq}
    return Program(step, names, staged, readings,
                   checked + traffic["warmup_updates"])


def program_readings(program):
    """(losses, the first clipped gradient by leaf, first-step norms by
    leaf, change norms by leaf) of the program, on the host."""
    r = program.readings

    def norms(key):
        return dict(zip(program.names,
                        r[key].double().sqrt().cpu().tolist()))

    return (r["losses"].double().cpu().tolist(),
            dict(zip(program.names, r["first_grad"])),
            norms("step_sq"), norms("change_sq"))


class Window(NamedTuple):
    completions_ms: list  # each update's completion from the window's start
    durations_ms: list  # each update's time, from its start mark
    failed: int  # updates whose loss or gradient norm is not finite


def _dispatch(program, clock, count, depth, seconds=None, span=False):
    """Dispatch updates back to back, keeping at most `depth` in flight:
    `count` of them, or as many as start within `seconds` (at least
    one)."""
    from torch.profiler import record_function

    start = clock.mark()
    starts, ends, stats = [], [], []
    deadline = None if seconds is None else time.perf_counter() + seconds
    i = program.next
    while not ends or (len(ends) < count if deadline is None
                       else time.perf_counter() < deadline):
        if len(ends) >= depth:
            clock.wait(ends[-depth])
        starts.append(clock.mark())
        batch, state = program.staged[i % len(program.staged)]
        with record_function(trace.SPAN) if span else contextlib.nullcontext():
            out = program.step(batch, state)
        ends.append(clock.mark())
        stats.append(torch.stack([out["total_loss"], out["grad_norm"]]))
        i += 1
    clock.wait(ends[-1])
    bad = int((~torch.isfinite(torch.stack(stats))).any(1).sum())
    return Window([clock.ms(start, e) for e in ends],
                  [clock.ms(s, e) for s, e in zip(starts, ends)], bad)


def window(program, traffic, device, seconds: float) -> Window:
    return _dispatch(program, Clock(device), None, IN_FLIGHT,
                     seconds=seconds)


def traced(program, traffic, device) -> trace.Trace:
    """traffic["trace_updates"] dispatches under torch.profiler, each in a
    span of its own."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    updates = traffic["trace_updates"]
    with trace.profiled(device.type == "cuda") as events:
        _dispatch(program, Clock(device), updates, IN_FLIGHT, span=True)
    return trace.summarize(events, updates)


class Context(NamedTuple):
    """What the metric readers read (metrics/*.py)."""

    config: dict
    traffic: dict
    network: object  # the reference's network module
    setup_s: float
    window: Window
    trace: Optional[trace.Trace]
    peak_window_bytes: Optional[int]


def run(cell, seed: int, seconds: float, traced_run: bool, device,
        t0: float, wrap=None):
    """One run of `cell` from the time origin t0 (time.perf_counter() at
    the process's start): the result's fields but "metrics" as readings,
    and the Context the metric readers take."""
    config, traffic = cell.config, cell.traffic
    on_card = device.type == "cuda"
    with configured(config):
        program = build(config, traffic, seed, device, wrap=wrap)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_reserved() if on_card else None
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        win = window(program, traffic, device, seconds)
        peak_window = torch.cuda.max_memory_reserved() if on_card else None
        tr = traced(program, traffic, device) if traced_run else None
        if on_card:
            peak = max(peak, torch.cuda.max_memory_reserved())
        found = program_readings(program)
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with configured(config):
        ref = check.reference_readings(config, traffic, seed, device)
    correct, checks = check.verdict(
        check.gaps(found, ref, config.get("leaf_groups")),
                                    config.get("limits", {}))
    ctx = Context(config, traffic, reference.network(config["reference"]),
                  setup_s, win, tr, peak_window)
    checks["failed_updates"] = {"value": win.failed, "limit": 0}
    result = {"correct": correct and win.failed == 0,
              "attempted": len(win.completions_ms), "failed": win.failed,
              "peak_bytes": peak, "checks": checks}
    return result, ctx
