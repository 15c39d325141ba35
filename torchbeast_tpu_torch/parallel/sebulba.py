"""Sebulba serving: per-slice pinned inference for the device split (the
port of torchbeast_tpu/parallel/sebulba.py).

The Podracer Sebulba architecture (arXiv:2104.06272, PAPERS.md) splits
the devices into dedicated inference slices and a learner group. This
module owns the SERVING half for the async driver: given a resolved
`runtime.placement.DeviceSplit` and the learner's `PolicySnapshotStore`,
it builds one serving stack per inference slice:

- a `DynamicBatcher` of its own (telemetry series
  `inference.slice.<i>.*`), so a slow slice backs up its own queue
  instead of head-of-line-blocking the others;
- an acting model of its own on the slice's device, whose parameters
  are the buffer each served snapshot is copied into (allocated once);
- a `DeviceStateTable` PINNED to the slice's device (the table, slot
  ids and env inputs all there, and on a CUDA device every table
  operation on the table's own stream);
- `ReplicaServingHooks` pinned to the same device: every batch serves
  from the latest snapshot placed there by `latest_on` (no host round
  trip), stamps the true `policy_lag` into the reply, and drives the
  health machine per slice (`slice<i>_lag` keys) when the lag exceeds
  --max_policy_lag;
- an `inference_loop` body ready for the InferenceSupervisor, which
  serves on the slice's stream: a slice takes no lock of the learner's
  and never queues behind the learner on the device's default stream.

Routing is the `SliceRouter`: a batcher-shaped facade the actor pool
talks to unchanged. Requests carrying a `slot` id (the device-resident
acting path) route by the split's STATIC hash-by-slot assignment: an
actor's slot lives on one slice for the life of the run, across
reconnects and serving restarts, so slot tables never migrate between
devices. Stateless requests (no slot, nothing resident to migrate)
round-robin for load balance.

Lag semantics under the split: unlike replica serving, there is no
central live-params path to fall back to (the live params live on the
learner devices, and serving from them would put acting batches back
on the learner's devices, which is what the split removes). A slice
whose snapshot exceeds the lag budget therefore keeps serving the
NEWEST snapshot it has while the health machine reports DEGRADED (keyed
per slice) until a fresh publish lands: the same stamping, budget and
recovery transitions as the replica path.

The port's acting function takes the slice's model and its sampling
generator (torch holds params in modules, where the reference passes a
params pytree and a PRNG key): `act_fn(model, generator, env_d,
agent_state)` returns (outputs, new agent state) as tensors on the
slice's device, with or without a state table, so one function serves
both paths where the reference needs two. On a CUDA device
`SliceStack.capture` captures each slice's acting step as one CUDA graph
per bucket before the serving threads start, as the time-shared path
captures its own.
"""

import contextlib
import logging
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from torchbeast_tpu_torch import graphs, nest, telemetry
from torchbeast_tpu_torch.runtime.inference import inference_loop, to_device
from torchbeast_tpu_torch.runtime.placement import DeviceSplit

log = logging.getLogger(__name__)


class SliceStack:
    """One inference slice's serving resources."""

    def __init__(self, index: int, device, batcher, state_table, hooks,
                 loop_fn: Callable[[], None], model=None, stream=None,
                 act=None, act_graphs=None, forward=None):
        self.index = index
        self.device = device
        self.batcher = batcher
        self.state_table = state_table
        self.hooks = hooks
        self.loop_fn = loop_fn
        self.model = model
        # The stream the slice serves on (the table's when it has one);
        # None off CUDA.
        self.stream = stream
        # Without a table: act(env_outputs, agent_state, batch_size, ctx),
        # the slice's loop's act_fn.
        self.act = act
        self._act_graphs = act_graphs if act_graphs is not None else {}
        self._forward = forward

    def capture(self, sizes, env_example: Callable[[int], Any],
                state_example: Optional[Callable[[int], Any]] = None) -> int:
        """Capture the slice's acting step as one CUDA graph per batch
        size in `sizes` (the table's replica graphs, or the forward alone
        without a table, agent state in and out through static buffers),
        before any serving thread starts. Returns the graphs captured."""
        if self.state_table is not None:
            self.state_table.capture_context(sizes, env_example,
                                             self.hooks.generator)
            return len(sizes)
        with torch.cuda.stream(self.stream):
            for n in sizes:
                self._act_graphs[n] = graphs.CapturedAct(
                    lambda static: self._forward(static["env"],
                                                 static["state"]),
                    {"env": env_example(n), "state": state_example(n)},
                    self.device, self.hooks.generator)
        return len(sizes)


class ShardedStateTables:
    """The actor-pool / supervisor / chaos view over per-slice tables.

    The pool reads boundary state (`read_slot`) and resets slots on
    (re)connect; the InferenceSupervisor (and its poison watcher)
    rebuilds on poison; the chaos controller pokes `poison()`. Each call
    routes to (or fans out over) the per-slice tables by the split's
    static slot hash, so callers keep the single-table API they had
    before the split.
    """

    def __init__(self, split: DeviceSplit, tables: List):
        if len(tables) != split.n_slices:
            raise ValueError(
                f"{len(tables)} tables for {split.n_slices} slices"
            )
        self._split = split
        self._tables = list(tables)
        self.num_slots = tables[0].num_slots
        self.initial_state_host = tables[0].initial_state_host

    def table_for_slot(self, slot: int):
        return self._tables[self._split.slice_for_slot(slot)]

    @property
    def trash_slot(self) -> int:
        return self._tables[0].trash_slot

    def read_slot(self, slot: int) -> Any:
        return self.table_for_slot(slot).read_slot(slot)

    def reset(self, slots) -> None:
        # Group by owning slice: one reset dispatch per touched table.
        by_slice = {}
        for slot in np.asarray(slots).reshape(-1):
            by_slice.setdefault(
                self._split.slice_for_slot(int(slot)), []
            ).append(int(slot))
        for idx, group in by_slice.items():
            self._tables[idx].reset(group)

    @property
    def poisoned(self) -> bool:
        """Any slice poisoned: the supervisor rebuilds ALL of them as
        one recovery event (serving threads share one restart
        generation, so per-slice rebuilds would double-count)."""
        return any(t.poisoned for t in self._tables)

    def poison(self) -> None:
        """Chaos hook: one poison event poisons every slice (the
        supervisor's rebuild is all-or-nothing either way)."""
        for t in self._tables:
            t.poison()

    def rebuild(self) -> None:
        for t in self._tables:
            if t.poisoned:
                t.rebuild()


class SliceRouter:
    """Batcher-shaped facade routing actor requests to their slice.

    Shaped like a DynamicBatcher from the actor pool's side
    (compute/size/is_closed), as serving.ReplicaRouter is. Requests
    with a `slot` leaf route by the split's static hash; slot-less
    (stateless-model) requests round-robin: they carry no resident
    state, so there is nothing to keep pinned.
    """

    def __init__(self, split: DeviceSplit, stacks: List[SliceStack],
                 registry=None):
        self._split = split
        self._stacks = stacks
        self._rr_lock = threading.Lock()
        self._rr = 0  # guarded-by: self._rr_lock
        reg = registry if registry is not None else telemetry.get_registry()
        self._c_requests = [
            reg.counter(f"inference.slice.{s.index}.requests")
            for s in stacks
        ]

    def _slice_for(self, inputs) -> int:
        if isinstance(inputs, dict) and "slot" in inputs:
            slot = int(np.asarray(inputs["slot"]).reshape(-1)[0])
            return self._split.slice_for_slot(slot)
        with self._rr_lock:
            self._rr = (self._rr + 1) % len(self._stacks)
            return self._rr

    def compute(self, inputs, trace=None):
        idx = self._slice_for(inputs)
        stack = self._stacks[idx]
        # Per-request lag gate: with a dedicated slice there is no
        # fresher fallback than the newest snapshot, so the return value
        # is advisory: the call drives the health machine's per-slice
        # keyed degradation and recovery transitions.
        if stack.hooks is not None:
            stack.hooks.serving_ok()
        self._c_requests[idx].inc()
        if trace is not None:
            out = stack.batcher.compute(inputs, trace=trace)
        else:
            out = stack.batcher.compute(inputs)
        return out

    def size(self) -> int:
        return sum(s.batcher.size() for s in self._stacks)

    def is_closed(self) -> bool:
        return self._stacks[0].batcher.is_closed()


class SebulbaServing:
    """The assembled serving side of a device split."""

    def __init__(self, split: DeviceSplit, stacks: List[SliceStack],
                 router: SliceRouter,
                 state_tables: Optional[ShardedStateTables]):
        self.split = split
        self.stacks = stacks
        self.router = router
        self.state_tables = state_tables

    @property
    def loop_fns(self) -> List[Callable[[], None]]:
        return [s.loop_fn for s in self.stacks]

    def gauge_tick(self, registry=None) -> Callable[[], None]:
        """A DriverTelemetry tick callback keeping the per-slice depth
        gauges fresh on every exported line."""
        reg = (
            registry if registry is not None else telemetry.get_registry()
        )
        pairs = [
            (reg.gauge(f"inference.slice.{s.index}.depth"), s.batcher)
            for s in self.stacks
        ]

        def tick():
            for gauge, batcher in pairs:
                gauge.set(batcher.size())

        return tick


def slice_gauge_snapshot(registry=None, prefix: str = "inference.slice."):
    """{name: value} of the per-slice serving instruments: the fleet
    heartbeat payload (a remote host ships its `inference.slice.<i>.*`
    gauges and counters to the lead every heartbeat). Histograms are
    skipped: heartbeats carry scalars, not bucket dicts."""
    reg = registry if registry is not None else telemetry.get_registry()
    out = {}
    for name, inst in reg.instruments().items():
        if not name.startswith(prefix):
            continue
        value = getattr(inst, "value", None)
        if callable(value):  # Counter / Gauge; Histogram has no value()
            out[name] = float(value())
    return out


def build_sebulba_serving(
    split: DeviceSplit,
    store,
    *,
    num_slots: int,
    max_batch_size: int,
    timeout_ms: float,
    max_policy_lag: int,
    slice_model: Callable,
    act_fn: Callable,
    rng_seed: int = 0,
    initial_state: Any = None,
    input_filter: Optional[Callable] = None,
    health=None,
    registry=None,
    admission=None,
    throttle_fn: Optional[Callable] = None,
    batcher_factory: Optional[Callable] = None,
) -> SebulbaServing:
    """Assemble one serving stack per inference slice.

    `slice_model(device)` builds a slice's acting model on its device
    (polybeast: a copy of the acting model); its parameters, in
    `parameters()` order, are the buffer each batch's snapshot is copied
    into, so the store must publish the params in that order.

    `batcher_factory(i, name)` overrides per-slice batcher construction:
    the native runtime passes a factory returning the core's
    DynamicBatchers, so the actor pool's C++ SliceRouter fans out without
    touching Python, while the Python serving loops (and the state
    tables, hooks and telemetry prefixes built here) stay identical.

    `act_fn(model, generator, env_d, agent_state)` acts with the slice's
    model. With `initial_state` (a nest of tensors of size 1 along the
    batch dim, 1) it is the device-resident path: one pinned
    DeviceStateTable per slice whose replica step (`bind_context`) runs
    `act_fn`. With `initial_state=None` the legacy path serves instead:
    `act_fn` on the request's state, after the batch's snapshot is loaded
    into the slice's model. Batches stack along dim 1 (time-major) and
    each slice's loop serves one batch at a time.

    One shared `admission` controller gates every slice's batcher (the
    serving.* counters aggregate; the depth bound applies per queue).

    Known trade-off (the reference's): every slice's table allocates the
    FULL `num_slots`+1 rows although the static hash routes only
    ~1/n_slices of the slots to it: slot ids stay GLOBAL, so the pool,
    the facade and the trash-slot padding all share one id space with no
    remap layer. At recurrent-state sizes (KBs a slot) the duplication is
    noise; a model carrying MBs of state a slot would want tables sized
    per owned-slot count with a slice_for_slot-derived row remap (its own
    change: the remap touches every slot-framing consumer).
    """
    from torchbeast_tpu_torch.runtime.queues import DynamicBatcher
    from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable
    from torchbeast_tpu_torch.serving import ReplicaServingHooks

    reg = registry if registry is not None else telemetry.get_registry()
    stateful = initial_state is not None

    stacks = []
    tables = []
    for i, device in enumerate(split.inference_devices):
        device = torch.device(device)
        name = f"inference.slice.{i}"
        if batcher_factory is not None:
            batcher = batcher_factory(i, name)
        else:
            batcher = DynamicBatcher(
                batch_dim=1,
                minimum_batch_size=1,
                maximum_batch_size=max_batch_size,
                timeout_ms=timeout_ms,
                telemetry_name=name,
                admission=admission,
            )
        hooks = ReplicaServingHooks(
            store,
            max_policy_lag=max_policy_lag,
            rng_seed=rng_seed + 7919 * (i + 1),
            health=health,
            registry=reg,
            device=device,
            health_key=f"slice{i}_lag",
        )
        model = slice_model(device)
        params = list(model.parameters())
        forward = (
            lambda env_d, state, model=model, hooks=hooks:
                act_fn(model, hooks.generator, env_d, state))
        table = stream = act = None
        act_graphs = {}
        if stateful:
            table = DeviceStateTable(
                initial_state,
                num_slots=num_slots,
                act_fn=None,  # replica steps only: bind_context's
                input_filter=input_filter,
                device=device,
            )
            table.bind_context(forward, params)
            tables.append(table)
            stream = table.stream
        else:
            if device.type == "cuda":
                stream = torch.cuda.Stream(device)
            act = _legacy_act(model, params, forward, act_graphs,
                              input_filter, device)

        def loop_fn(batcher=batcher, table=table, hooks=hooks, name=name,
                    act=act, device=device, stream=stream):
            if device.type == "cuda":
                torch.cuda.set_device(device)
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                inference_loop(
                    batcher,
                    act,
                    max_batch_size,
                    lock=None,
                    state_table=table,
                    serving_hooks=hooks,
                    throttle_fn=throttle_fn,
                    telemetry_prefix=name,
                )

        stacks.append(SliceStack(
            i, device, batcher, table, hooks, loop_fn, model=model,
            stream=stream, act=act, act_graphs=act_graphs,
            forward=forward))

    state_tables = (
        ShardedStateTables(split, tables) if stateful else None
    )
    router = SliceRouter(split, stacks, registry=reg)
    return SebulbaServing(split, stacks, router, state_tables)


def _legacy_act(model, params, forward, act_graphs, input_filter, device):
    """A stateless slice's act_fn(env_outputs, agent_state, batch_size,
    ctx): the batch's snapshot copied into the slice's model when it
    brings a version the model does not hold yet, then the bucket's graph
    (or the eager forward off CUDA), on the serving thread's stream. One
    lock a slice holds the load and the forward together, since the
    slice's threads share its model and graphs."""
    loaded = [None]  # guarded-by: lock
    lock = threading.Lock()

    def act(env_outputs, agent_state, batch_size, ctx):
        version, snapshot = ctx
        if input_filter is not None:
            env_outputs = input_filter(env_outputs)
        with lock:
            if loaded[0] != version:
                with torch.no_grad():
                    torch._foreach_copy_(params, nest.flatten(snapshot))
                loaded[0] = version
            if act_graphs:
                return act_graphs[batch_size]({"env": env_outputs,
                                               "state": agent_state})
            return forward(to_device(env_outputs, device),
                           to_device(agent_state, device))

    return act
