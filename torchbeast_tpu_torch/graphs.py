"""CUDA graphs: how the port dispatches its learner updates and acting
forwards on the card.

The reference runs every update, every K-update superstep and every
acting step as one jitted XLA dispatch. The port's counterpart is one
captured `torch.cuda.CUDAGraph` per dispatch shape: its inputs are static
device buffers that each call fills (from pinned host memory or the
device), then one replay launches every kernel of the step, the port's
hand kernels included. On the CPU nothing here runs: the same step
functions run eagerly.

CapturedAct is a CapturedForward with pinned host buffers; a plain
CapturedForward holds the IMPACT target network's forward
(learner.TargetNetwork): a graph of its own, bound to the target params
buffer, whose outputs reach the update graph's static inputs by
device-to-device copies.

CapturedIteration holds a whole Anakin iteration (anakin.py), the
counterpart of the reference's one jitted program: T acting forwards, T
steps of the device envs, the [T+1, B] batch assembly and the update, one
replay with no host in the loop. Its static buffers are the actor carry,
the params and the optimizer's state, which each replay updates in
place; its generator (the envs' resets and the sampled actions) is
registered with the graph.

Each of those captures through CapturedStep, which also holds each part
of a data-parallel step (parallel/dp.py): a shard's forward and backward
on its device (under Anakin, its rollout too), or the lead device's sum
and optimizer update, each a graph of its own on its device.

Capture rules, kept by every class:

- Warm-up first: a few eager runs on a side stream before the capture
  (cuBLAS and cuDNN set themselves up, every kernel is built). What they
  change is undone: a warm-up update applies updates, so CapturedUpdate
  restores the optimizer's state (`update_state_restored`, which the
  remat planner's oracle uses too), and counts the bytes its first
  warm-up run accesses (precision.count_bytes: the
  `learner.hbm_bytes_per_update` gauge); a warm-up acting step draws from the
  generator, whose state CapturedAct puts back (and callers pass acting
  inputs that make a warm-up step harmless: trash slots, a state the
  first call overwrites); CapturedIteration puts back all three: the
  optimizer's state, the generator's and the carry.
- A capture launches nothing, but the port's launch counters
  (`ops.launch_counts()`) tick in the wrappers' Python, which runs only
  at capture. Each graph records what its capture counted, puts the
  counters back, and adds that much per replay, so the counters still
  count launches on the card.
- Outputs of a replay live in the graph's static memory, which the next
  replay overwrites: each call returns clones, made on the stream right
  after the replay.
- A capture in a process whose other threads launch CUDA work fails, so
  the drivers capture before their threads start. A thread that may run
  while a capture is open (a telemetry snapshot on the /metrics server's
  thread, whose collectors copy the device marks to the host) makes its
  CUDA calls inside `outside_capture()`, which tells it whether a
  capture is open and holds every capture off until it is done. A failed
  capture or replay raises; nothing falls back to the eager step on the
  card.
- A model under a remat plan captures its checkpointed regions as they
  are: the recompute is part of the backward, so it is captured with it
  and replays inside the graph (models/layers.checkpointed saves no RNG
  state, which a capture could not read).
- A CapturedUpdate captured while telemetry is enabled records the
  update's device marks (marks.py) in its graph, and only there: its
  warm-ups and every other graph run without them. Each call is a
  `graph.stage_in`, a `graph.replay` and a `graph.outputs` span of the
  global tracer.
"""

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from torchbeast_tpu_torch import marks, nest, ops, precision, telemetry

WARMUP_RUNS = 2  # eager runs on a side stream before each capture

_capture_lock = threading.Lock()
_captures_open = 0  # guarded-by: _capture_lock


@contextlib.contextmanager
def outside_capture():
    """Yields True, and holds every capture off until the body is done,
    where no capture is open in the process; else yields False: in
    torch's capture mode a CUDA call from another thread (a copy, a sync)
    invalidates the capture, so the caller then makes none."""
    with _capture_lock:
        yield _captures_open == 0


@contextlib.contextmanager
def _capture_open():
    global _captures_open
    with _capture_lock:
        _captures_open += 1
    try:
        yield
    finally:
        with _capture_lock:
            _captures_open -= 1


class _LaunchDelta:
    """The port's kernel launches one capture counted, re-added on each
    replay."""

    def __init__(self):
        self._before = ops.read_launch_counters()
        self.amounts = []

    def captured(self):
        after = ops.read_launch_counters()
        self.amounts = [
            (wrapper, name, a - b) for (wrapper, name), a, b in
            zip(ops.launch_counters(), after, self._before) if a != b
        ]
        # The capture itself launched nothing.
        ops.add_counts([(w, name, -n) for w, name, n in self.amounts])

    def replayed(self):
        ops.add_counts(self.amounts)

    def per_replay(self) -> dict:
        """{wrapper name: launches} of the plain launch counters."""
        return {w.__name__: n for w, name, n in self.amounts
                if name == "launches"}


def _warm_up(fn: Callable[[], Any], runs: int, counted=None) -> None:
    """`runs` eager runs of fn on a side stream; the first inside
    `counted` (a context manager) when one is given."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for run in range(runs):
            with (counted if run == 0 and counted is not None
                  else contextlib.nullcontext()):
                fn()
    torch.cuda.current_stream().wait_stream(side)


def update_state_tensors(optimizer) -> list:
    """Everything an update writes: the params (the optimizer holds the
    model's), its moments and masters, and its device count."""
    st = optimizer.state
    return (list(optimizer.params) + nest.flatten((st.nu, st.mom, st.master))
            + [optimizer.device_count])


@contextlib.contextmanager
def update_state_restored(optimizer):
    """Updates run inside leave the params, every optimizer moment, the
    masters and both counts bitwise as they were on entry."""
    tensors = update_state_tensors(optimizer)
    with torch.no_grad():
        saved = [t.detach().clone() for t in tensors]
    count = optimizer.state.count
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        optimizer.set_count(count)


def _capture(fn: Callable[[], Any], generator=None):
    """(graph, static outputs of fn, its launch delta). Each graph is
    captured on a stream of its own: cuBLAS keeps one workspace per
    stream, and a graph bakes in the workspace of the stream it was
    captured on, so two graphs captured on one stream would share it and
    could not replay concurrently (the learner's and the acting graph do,
    under --overlap_collect). The cyclic garbage collector is off for the
    capture: a graph it freed then (a finished run's, held in a reference
    cycle) would be reset mid-capture, which invalidates the capture.
    Meanwhile `outside_capture()` yields False on every thread."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    delta = _LaunchDelta()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with _capture_open(), torch.cuda.graph(graph,
                                               stream=torch.cuda.Stream()):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    delta.captured()
    return graph, out, delta


def _fill(static, value, name: str, pinned=None) -> None:
    """Copy one input leaf into its static buffer. Host leaves bound for
    the card go through pinned memory (`pinned`, or a fresh pinned copy
    the caching host allocator keeps until the copy has run), so the copy
    does not wait for the stream's earlier work."""
    if value is static:
        return
    if isinstance(value, np.ndarray) or np.isscalar(value):
        value = torch.from_numpy(np.asarray(value))
    if tuple(value.shape) != tuple(static.shape):
        raise ValueError(
            f"{name}: input of shape {tuple(value.shape)} for a graph "
            f"captured at {tuple(static.shape)}")
    if value.dtype != static.dtype:
        raise ValueError(
            f"{name}: input of dtype {value.dtype} for a graph captured "
            f"with {static.dtype}")
    if value.device.type == "cpu" and static.device.type == "cuda":
        if pinned is not None:
            pinned.copy_(value)
            value = pinned
        elif not value.is_pinned():
            value = value.pin_memory()
    static.copy_(value, non_blocking=True)


class CapturedUpdate:
    """A learner dispatch as one CUDA graph: `step(batch, state)` (the
    update step, or the K-update superstep over [K, ...] inputs) captured
    once over static input buffers of the dispatch's shape.

    `capture(batch, state)` takes example inputs (their values feed the
    warm-up, which `optimizer` and the params then forget); the first call
    captures from its own inputs when `capture` was not called. Each call
    copies its inputs into the static buffers and replays; it returns the
    dispatch's stats, each an f32 tensor (0-d, or [K] for a superstep),
    copied out of the graph's memory. The optimizer's host count advances
    by `k` per call, as its device count does inside the graph.
    `bytes_accessed` is what the first warm-up run of the capture
    accessed (precision.count_bytes; None before the capture)."""

    def __init__(self, step: Callable, optimizer, k: int = 1):
        self.k = k
        self._step = step
        self._optimizer = optimizer
        self._graph = None
        self.launches_per_replay = {}
        self.bytes_accessed = None

    def capture(self, batch, initial_agent_state) -> None:
        device = self._optimizer.device_count.device
        put = lambda x: torch.as_tensor(x).to(device).clone()  # noqa: E731
        self._batch = nest.map(put, batch)
        self._state = nest.map(put, initial_agent_state)
        self._keys = None
        # The device marks (marks.py), captured with the update while
        # telemetry is on; the warm-ups run without them.
        recorder = (marks.device_recorder(device)
                    if telemetry.is_enabled() else None)

        def packed():
            capturing = torch.cuda.is_current_stream_capturing()
            with marks.recording(recorder if capturing else None):
                stats = self._step(self._batch, self._state)
            self._keys = list(stats)
            return torch.stack([stats[key].float() for key in self._keys],
                               -1)

        self._graph = CapturedStep(packed, device, optimizer=self._optimizer)
        self.bytes_accessed = self._graph.bytes_accessed
        self.launches_per_replay = self._graph.launches_per_replay

    def __call__(self, batch, initial_agent_state):
        if self._graph is None:
            self.capture(batch, initial_agent_state)
        t0 = time.perf_counter()
        for what, static, value in (("batch", self._batch, batch),
                                    ("initial_agent_state", self._state,
                                     initial_agent_state)):
            leaves = nest.flatten(static)
            values = nest.flatten(value)
            if len(values) != len(leaves):
                raise ValueError(f"{what}: {len(values)} leaves for a graph "
                                 f"captured with {len(leaves)}")
            for s, v in zip(leaves, values):
                _fill(s, v, what)
        t1 = time.perf_counter()
        out = self._graph()
        t2 = time.perf_counter()
        row = out.clone()
        self._optimizer.advance_host_count(self.k)
        stats = {key: row[..., j] for j, key in enumerate(self._keys)}
        t3 = time.perf_counter()
        tracer = telemetry.get_tracer()
        tracer.add_complete("graph.stage_in", "learner", t0, t1 - t0)
        tracer.add_complete("graph.replay", "learner", t1, t2 - t1)
        tracer.add_complete("graph.outputs", "learner", t2, t3 - t2)
        return stats


class CapturedForward:
    """A forward as one CUDA graph: `fn(inputs)` captured over static
    device buffers shaped like `example` (a nest of tensors or numpy
    arrays), reading whatever parameters fn closes over (a caller may
    load new values into those same tensors between calls: the IMPACT
    target network's buffer). Each call copies its inputs in (device
    leaves on the device, host leaves through pinned copies; a leaf that
    IS the static buffer is left as it is), replays on the current
    stream, and returns clones of fn's outputs, so nothing crosses to the
    host. Sampling draws from `generator`, registered with the graph: a
    replay draws the numbers an eager call would draw from the
    generator's state, and advances it as far."""

    _what = "graph input"

    def __init__(self, fn: Callable[[Any], Any], example, device,
                 generator: Optional[torch.Generator] = None):
        device = torch.device(device)
        self.inputs = nest.map(
            lambda x: torch.as_tensor(x).to(device).clone(), example)

        def run():
            with torch.no_grad():
                return fn(self.inputs)

        self._graph = CapturedStep(run, device, generator=generator)

    def _load(self, statics, values):
        for static, value in zip(statics, values):
            _fill(static, value, self._what)

    def __call__(self, inputs):
        statics = nest.flatten(self.inputs)
        values = nest.flatten(inputs)
        if len(values) != len(statics):
            raise ValueError(f"{len(values)} input leaves for a graph "
                             f"captured with {len(statics)}")
        self._load(statics, values)
        return nest.map(lambda t: t.clone(), self._graph())


class CapturedAct(CapturedForward):
    """An acting step as one CUDA graph (a CapturedForward whose host
    leaves go through pinned buffers of the graph's own, each rewritten
    only once its last copy ran)."""

    _what = "acting input"

    def __init__(self, fn: Callable[[Any], Any], example, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__(fn, example, device, generator)
        self._pinned = [torch.empty_like(t, device="cpu").pin_memory()
                        for t in nest.flatten(self.inputs)]
        self._copied = None  # event after the last host->device copies

    def _load(self, statics, values):
        if self._copied is not None:
            self._copied.synchronize()
        for static, pinned, value in zip(statics, self._pinned, values):
            _fill(static, value, self._what, pinned)
        self._copied = torch.cuda.Event()
        self._copied.record()


class CapturedIteration:
    """A whole on-device iteration as one CUDA graph: `step(carry)` (the
    Anakin iteration, anakin.make_train_step), which updates the carry
    (a nest of device tensors), the params and the optimizer's state in
    place and returns its stats. The carry is the graph's static input
    and output: each call replays over it and leaves the next carry
    there. Random numbers come from `generator`, registered with the
    graph, so each replay draws the numbers an eager step would draw
    from the generator's state and advances it as far.

    The warm-up before the capture runs real iterations; the carry, the
    generator, the params and the optimizer's state are put back after
    it, so the first replay is the run's first iteration. A call returns
    the stats as f32 device tensors copied out of the graph's memory (a
    host reads them when it needs them) and advances the optimizer's host
    count by one, as the device count advances inside the graph.
    `launches_per_replay` is what one replay launches of the port's
    kernels."""

    def __init__(self, step: Callable, carry, optimizer,
                 generator: torch.Generator):
        self._step = step
        self._carry = carry
        self._optimizer = optimizer
        self._generator = generator
        self._graph = None
        self.launches_per_replay = {}

    def capture(self) -> None:
        self._keys = None

        def packed():
            stats = self._step(self._carry)
            self._keys = list(stats)
            return torch.stack([stats[key].float() for key in self._keys])

        self._graph = CapturedStep(
            packed, self._generator.device, generator=self._generator,
            restore=nest.flatten(self._carry), optimizer=self._optimizer)
        self.launches_per_replay = self._graph.launches_per_replay

    def __call__(self):
        if self._graph is None:
            self.capture()
        row = self._graph().clone()
        self._optimizer.advance_host_count(1)
        return {key: row[j] for j, key in enumerate(self._keys)}


class CapturedStep:
    """`fn()` captured as one CUDA graph on `device`, over the buffers fn
    closes over (the data-parallel learner's parts, parallel/dp.py).

    The warm-up runs on a side stream of `device`, the first run counted
    by precision.count_bytes (`bytes_accessed`). What it changes is put
    back before the capture: the tensors of `restore` (an Anakin shard's
    carry), `generator`'s state (registered with the graph, so a replay
    draws what an eager call would) and, with `optimizer`, its update
    state (update_state_restored). A call replays on the device's
    current stream and returns fn's outputs as the graph's static
    tensors, which the next replay overwrites."""

    def __init__(self, fn: Callable[[], Any], device, generator=None,
                 restore=(), optimizer=None):
        self.device = torch.device(device)
        restore = list(restore)
        counted = precision.count_bytes()
        with torch.cuda.device(self.device):
            with torch.no_grad():
                saved = [t.clone() for t in restore]
            rng = generator.get_state() if generator is not None else None
            with (update_state_restored(optimizer) if optimizer is not None
                  else contextlib.nullcontext()):
                _warm_up(fn, WARMUP_RUNS, counted)
                with torch.no_grad():
                    for t, s in zip(restore, saved):
                        t.copy_(s)
                if generator is not None:
                    generator.set_state(rng)
                self._graph, self.out, self._delta = _capture(fn, generator)
            if generator is not None:
                generator.set_state(rng)
        self.bytes_accessed = float(counted.count.total)
        self.launches_per_replay = self._delta.per_replay()

    def __call__(self):
        with torch.cuda.device(self.device):
            self._graph.replay()
        self._delta.replayed()
        return self.out
