"""GPU inference server loop: drain the DynamicBatcher with a
bucket-padded forward on the card (the port of
torchbeast_tpu/runtime/inference.py).

Each dynamic batch is padded up to the nearest power-of-two bucket (the
last row repeated, see pad_to), the acting step runs at that shape, and
the outputs are sliced back to the true size before set_outputs
distributes rows to the waiting actors. PyTorch's eager forward would
take any batch size; on the card each bucket's acting step replays one
captured CUDA graph (graphs.CapturedAct), and the padding contract of the
state table is the reference's.

Two state regimes:

- Legacy (state_table=None): requests carry `agent_state`; the loop pads
  it alongside the env nest and the reply materializes the advanced state
  back to the actor.
- Device-resident (state_table=runtime.state_table.DeviceStateTable):
  requests carry a `slot` id and an `advance` flag instead of state; the
  table gathers/advances/scatters state on the card and the reply holds
  outputs only. Padding rows scatter to the table's trash slot so they
  can never race a real slot's update.

Host <-> card traffic: `to_device` stages a numpy nest through pinned
memory (an asynchronous copy that never waits on the stream's earlier
work), and `to_host` brings a nest of tensors back in ONE device->host
copy (every leaf's bytes packed into one buffer on the card first).
"""

# beastlint: hot-module — every function here sits on the per-batch serving path.

import logging
import threading
import time
from typing import Any, Callable, List

import numpy as np
import torch

from torchbeast_tpu_torch import nest
from torchbeast_tpu_torch import telemetry

log = logging.getLogger(__name__)


def to_device(tree: Any, device) -> Any:
    """A nest of numpy arrays -> tensors on `device`, each copied from
    pinned host memory without blocking the host (a pageable source would
    make the copy wait for the stream's earlier work). CPU: plain tensors
    sharing the arrays' memory."""
    device = torch.device(device)

    def put(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cpu":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    return nest.map(put, tree)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def to_host(tree: Any) -> Any:
    """A nest of tensors (and numpy arrays, passed through) -> numpy, all
    tensor leaves in ONE device->host copy: each leaf's bytes are packed
    into one uint8 buffer on its device, copied once and split on the
    host. bfloat16 leaves widen to float32 on the card first (numpy has
    no bfloat16)."""
    leaves = nest.flatten(tree)
    tensors = [i for i, leaf in enumerate(leaves) if torch.is_tensor(leaf)]
    if not tensors:
        return nest.map(np.asarray, tree)
    parts, meta = [], []
    for i in tensors:
        t = leaves[i].detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.contiguous()
        meta.append((i, t.dtype, tuple(t.shape), t.numel() * t.element_size()))
        parts.append(t.reshape(-1).view(torch.uint8))
    raw = torch.cat(parts).cpu().numpy() if len(parts) > 1 else (
        parts[0].cpu().numpy())
    out = [None if torch.is_tensor(leaf) else np.asarray(leaf)
           for leaf in leaves]
    offset = 0
    for i, dtype, shape, nbytes in meta:
        out[i] = raw[offset:offset + nbytes].view(
            _numpy_dtype(dtype)).reshape(shape)
        offset += nbytes
    return nest.pack_as(tree, out)


def bucket_size(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"Batch of {n} exceeds largest bucket {buckets[-1]}")


def default_buckets(max_batch_size: int) -> List[int]:
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return out


def pad_to(tree: Any, size: int, batch_dim: int) -> Any:
    """Pad every leaf to `size` along batch_dim by repeating the edge row
    (valid data, so the padded forward can't produce NaNs that would
    poison batch-norm-style reductions; pad rows are sliced off after)."""

    def pad(arr):
        arr = np.asarray(arr)
        n = arr.shape[batch_dim]
        if n == size:
            return arr
        pad_width = [(0, 0)] * arr.ndim
        pad_width[batch_dim] = (0, size - n)
        return np.pad(arr, pad_width, mode="edge")

    return nest.map(pad, tree)


def slice_to(tree: Any, size: int, batch_dim: int) -> Any:
    def cut(arr):
        arr = np.asarray(arr)
        sl = [slice(None)] * arr.ndim
        sl[batch_dim] = slice(0, size)
        return arr[tuple(sl)]

    return nest.map(cut, tree)


def pad_slots(slots: np.ndarray, size: int, trash_slot: int) -> np.ndarray:
    """Pad a [n] slot-id vector to `size` with the table's trash slot —
    NOT edge-repeated: a repeated real id would make the padded row's
    scatter race the real row's (duplicate-index scatter is last-writer-
    wins, so the real advance could be silently dropped)."""
    slots = np.asarray(slots).reshape(-1)
    if slots.shape[0] == size:
        return slots
    return np.concatenate(
        [slots, np.full(size - slots.shape[0], trash_slot, slots.dtype)]
    )


def pad_advance(advance: np.ndarray, size: int) -> np.ndarray:
    """Pad a [n] advance mask to `size` with False (padding rows must
    never persist a state advance)."""
    advance = np.asarray(advance, bool).reshape(-1)
    if advance.shape[0] == size:
        return advance
    return np.concatenate(
        [advance, np.zeros(size - advance.shape[0], bool)]
    )


def inference_loop(
    inference_batcher,
    act_fn: Callable,
    max_batch_size: int,
    batch_dim: int = 1,
    lock: threading.Lock = None,
    pipelined: bool = False,
    state_table=None,
    serving_hooks=None,
    throttle_fn: Callable = None,
    telemetry_prefix: str = "inference",
):
    """Thread body (run num_inference_threads of these).

    act_fn(env_outputs, agent_state, batch_size) ->
        (agent_outputs, new_agent_state)   # numpy arrays or tensors

    With `state_table` (a runtime.state_table.DeviceStateTable), requests
    carry {"env", "slot", "advance"} instead of {"env", "agent_state"}:
    the table's own step (which owns the acting model and generator via
    its context_fn) gathers/advances/scatters agent state on the card and
    `act_fn` is ignored (pass None). Replies then hold {"outputs"} only —
    no state leaf crosses to the host.

    act_fn owns params access and rng threading (see polybeast.py). Pass
    ONE lock shared by every inference thread to serialize model calls
    (the reference's inference lock, polybeast_learner.py:269, 281-283);
    with lock=None calls run concurrently (the act_fn then guards what it
    shares itself, as polybeast's does).

    `pipelined` keeps a one-deep dispatch pipeline: when more requests
    are already waiting, batch k's host fetch (`to_host`, a full
    device round-trip) happens
    AFTER batch k+1's act is dispatched, so the device always has a
    queued program and never idles on the reply path. The reply to k is
    only ever deferred while k+1 is in hand; when the batcher is empty
    the fetch happens immediately. SINGLE-CONSUMER ONLY: the "more
    requests waiting" check is a racy global size() — with several
    threads draining one batcher, another thread can steal the waiting
    request and leave this one parked on an empty batcher while holding
    finished replies, stalling those actors until new traffic arrives.
    Tail-latency cost: the held reply for batch k is only flushed once
    the batcher YIELDS batch k+1 — if size() > 0 but that next batch is
    still forming (waiting on stragglers to reach min batch size), the
    deferred actors wait up to the batcher's formation timeout (default
    100 ms) beyond the dispatch-side win. Worth it only when the reply
    path is the bottleneck (remote-tunnel round-trips); for local
    devices the default (off) avoids the tail.
    Default OFF: only enable it for a single consumer thread
    (polybeast wires pipelined=num_inference_threads==1; cross-thread
    overlap already comes from the threads themselves).

    A failing act_fn fails only its batch (promises broken with the error
    so producers wake immediately); the loop continues serving. Exception:
    a failed STATE-TABLE step poisons the table (its rows may be half
    written) — the loop fails
    the batch and re-raises to kill the thread rather than serve garbage.

    `serving_hooks` (serving/replica.ReplicaServingHooks, or anything
    with the same `begin_batch() -> (ctx, annotate)` shape) turns this
    loop into a REPLICA serving loop: each batch's ctx overrides the
    state table's own context (snapshot params instead of live ones) —
    or, on the legacy path, rides as a 4th act_fn argument
    (`act_fn(env, state, batch_size, ctx)`) — and `annotate(outputs, n)`
    stamps the matching policy_lag into the reply at flush time, so the
    lag recorded is the lag of the params that actually served.

    `throttle_fn` (resilience/chaos.ChaosController.throttle) is the
    chaos harness's shared-chip stall model: called once per batch
    before dispatch; sleeps while a learner_stall window is active so
    induced overload grows the batcher queue the way a busy chip would.

    `telemetry_prefix` names this loop's instrument series (default
    "inference", today's schema). The Sebulba split runs one loop per
    inference slice with prefix "inference.slice.<i>" so per-slice
    batch/latency/poison series land on every telemetry line instead
    of aggregating into one indistinguishable pile.
    """
    buckets = default_buckets(max_batch_size)

    # Stage attribution for the serving loop: batch-size
    # distribution, lock contention, dispatch latency (async — the time
    # to launch the step, not device compute), reply latency (the
    # device fetch + row slicing actors actually wait on). Instruments
    # resolve once; per-batch cost is a few perf_counter calls.
    _reg = telemetry.get_registry()
    _tracer = telemetry.get_tracer()
    _h_batch = _reg.histogram(f"{telemetry_prefix}.batch_size")
    # Registered only when a lock exists: a permanently-zero histogram
    # reads as "requests never wait", not "not measured".
    _h_lock = (
        _reg.histogram(f"{telemetry_prefix}.lock_wait_s")
        if lock is not None else None
    )
    _h_dispatch = _reg.histogram(f"{telemetry_prefix}.dispatch_s")
    _h_reply = _reg.histogram(f"{telemetry_prefix}.reply_s")
    _c_batches = _reg.counter(f"{telemetry_prefix}.batches")
    _c_rows = _reg.counter(f"{telemetry_prefix}.rows")
    _c_poison = _reg.counter(f"{telemetry_prefix}.poison_exits")
    # A Python DynamicBatcher with a telemetry_name already observes
    # inference.batch_size per dequeued batch — observing here too
    # would double-count it. The loop keeps that role only for
    # un-instrumented batchers (the C++ native runtime).
    _observe_sizes = getattr(inference_batcher, "_tm", None) is None

    def flush(entry):
        batch, outputs, new_state, n, annotate = entry
        t_reply = time.perf_counter()
        try:
            if state_table is not None:
                # One device->host copy, sliced on the host; the
                # reply carries no agent-state leaves.
                fetched = state_table.fetch(outputs, n)
                if annotate is not None:
                    fetched = annotate(fetched, n)
                batch.set_outputs({"outputs": fetched})
                return
            outputs, new_state = to_host((outputs, new_state))
            outputs = slice_to(outputs, n, batch_dim)
            if annotate is not None:
                outputs = annotate(outputs, n)
            batch.set_outputs(
                {
                    "outputs": outputs,
                    "agent_state": slice_to(new_state, n, batch_dim),
                }
            )
        except Exception as e:  # noqa: BLE001
            log.exception("Inference reply failed; continuing")
            batch.fail(e)
        finally:
            _h_reply.observe(time.perf_counter() - t_reply)

    pending = None
    batches = iter(inference_batcher)
    while True:
        # The stall gate runs BEFORE the blocking pull: a stalled chip
        # does not pick work up, so queued requests age toward their
        # deadline and the dequeue-side expiry gate sees the truth. A
        # throttle placed after the pull would grab fresh requests and
        # hold them un-expirable for the whole window.
        if throttle_fn is not None:
            throttle_fn()
        try:
            batch = next(batches)
        except StopIteration:
            break
        try:
            inputs = batch.get_inputs()
            env_outputs = inputs["env"]
            n = len(batch)
            if _observe_sizes:
                _h_batch.observe(n)
            _c_batches.inc()
            _c_rows.inc(n)
            padded = bucket_size(n, buckets)
            env_padded = pad_to(env_outputs, padded, batch_dim)

            def dispatch(fn):
                # inference.dispatch_s times ONLY the act dispatch (the
                # host launching the step) — padding is host prep
                # and the lock wait has its own histogram; folding them
                # in would double-count stages and misattribute a lock
                # bottleneck to the card.
                t0 = time.perf_counter()
                with _tracer.span(
                    f"{telemetry_prefix}.dispatch", cat="inference",
                    rows=n, padded=padded,
                ):
                    result = fn()
                _h_dispatch.observe(time.perf_counter() - t0)
                return result

            # Replica mode: ONE atomic (snapshot ctx, lag annotation)
            # pick per batch, so the lag stamped into the reply is the
            # lag of the params this dispatch actually used.
            ctx = annotate = None
            if serving_hooks is not None:
                ctx, annotate = serving_hooks.begin_batch()

            if state_table is not None:
                slots = pad_slots(
                    inputs["slot"], padded, state_table.trash_slot
                )
                advance = pad_advance(inputs["advance"], padded)
                outputs = dispatch(
                    lambda: state_table.step(
                        slots, advance, env_padded, context=ctx
                    )
                )
                new_state = None
            else:
                state_padded = pad_to(
                    inputs["agent_state"], padded, batch_dim
                )
                act_args = (env_padded, state_padded, padded)
                if serving_hooks is not None:
                    act_args = act_args + (ctx,)
                if lock is not None:
                    t_lock = time.perf_counter()
                    with lock:
                        _h_lock.observe(time.perf_counter() - t_lock)
                        outputs, new_state = dispatch(
                            lambda: act_fn(*act_args)
                        )
                else:
                    outputs, new_state = dispatch(
                        lambda: act_fn(*act_args)
                    )
        except Exception as e:  # noqa: BLE001
            batch.fail(e)
            if pending is not None:
                flush(pending)
                pending = None
            if state_table is not None and state_table.poisoned:
                # The table's rows may be half written;
                # per-batch retry would serve garbage state. Die loudly
                # — with the TYPED error, so a supervising wrapper
                # (resilience.InferenceSupervisor) can distinguish
                # "rebuild the table and restart me" from a real
                # serving bug that must stay fatal.
                from torchbeast_tpu_torch.runtime.errors import (
                    StateTablePoisonedError,
                )

                _c_poison.inc()
                log.exception("State table poisoned; inference thread exiting")
                if isinstance(e, StateTablePoisonedError):
                    raise
                raise StateTablePoisonedError(
                    f"state table poisoned by: {type(e).__name__}: {e}"
                ) from e
            log.exception("Inference batch failed; continuing")
            continue
        # This batch is dispatched (async); NOW reply to the previous one.
        if pending is not None:
            flush(pending)
            pending = None
        if pipelined and inference_batcher.size() > 0:
            pending = (batch, outputs, new_state, n, annotate)
        else:
            flush((batch, outputs, new_state, n, annotate))
    if pending is not None:  # batcher closed with a reply in flight
        flush(pending)
