"""Learner-side batching queue and dynamic inference batcher.

Python re-designs of the reference's C++ runtime pieces (the C++ versions
land under csrc/ for the hot path; these carry the exact semantics and the
test surface):

- BatchingQueue: the reference's `BatchingQueue<T>`
  (torchbeast's src/cc/actorpool.cc:57-222). Bounded producer/consumer
  queue of (nest-of-arrays, payload); `enqueue` blocks when full — the
  backpressure that keeps rollouts on-policy; `dequeue_many` waits for
  min_batch_size items (or timeout) and concatenates up to max_batch_size
  along batch_dim; `close()` drains and wakes waiters; iterating a closed,
  empty queue raises StopIteration.

- DynamicBatcher: the reference's `DynamicBatcher`
  (actorpool.cc:224-340). Producers call `compute(inputs)` and block until
  a consumer picks up the batch via iteration, runs the model, and calls
  `batch.set_outputs(outputs)`; each producer gets its slice back. Dropping
  a batch without outputs breaks the promise -> AsyncError at producers.
  Batch sizes are dynamic in [minimum_batch_size, maximum_batch_size] with
  a timeout — the TPU-side consumer pads to a bucket size before running
  XLA (see runtime/inference.py) because variable shapes would recompile.

The port's copy of torchbeast_tpu/runtime/queues.py, without BatchArena,
DevicePrefetcher's superstep mode and BatchingQueue.dequeue_item (the
arena's intake): they serve --superstep_k > 1 and --replay_reuse > 1,
which the port's drivers refuse until ROADMAP.md Queue 1 items 'overlap
and supersteps' and 'IMPACT' port those flags.
"""

import collections
import queue as stdlib_queue
import threading
import time
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np

from torchbeast_tpu_torch import nest
from torchbeast_tpu_torch import telemetry


class _QueueTelemetry:
    """Instrument bundle for a named queue/batcher (telemetry_name=None
    keeps the queue un-instrumented — a single None check per op).
    request_wait_s is NOT here: only the DynamicBatcher's compute()
    side can observe it, and a plain BatchingQueue registering it would
    export a permanently-zero histogram that reads as "requests never
    wait" instead of "not measured"."""

    __slots__ = ("depth", "items_in", "dequeue_wait_s", "batch_size")

    def __init__(self, name: str):
        reg = telemetry.get_registry()
        self.depth = reg.gauge(f"{name}.depth")
        self.items_in = reg.counter(f"{name}.items_in")
        self.dequeue_wait_s = reg.histogram(f"{name}.dequeue_wait_s")
        self.batch_size = reg.histogram(f"{name}.batch_size")


class ClosedBatchingQueue(RuntimeError):
    pass


class AsyncError(RuntimeError):
    pass


def _concat_nests(items: List[Any], batch_dim: int):
    """Concatenate structurally-equal nests of numpy arrays along
    batch_dim (the reference's batch() helper, actorpool.cc:49-55)."""
    flats = [nest.flatten(item) for item in items]
    out = [
        np.concatenate([f[i] for f in flats], axis=batch_dim)
        for i in range(len(flats[0]))
    ]
    return nest.pack_as(items[0], out)


class BatchingQueue:
    def __init__(
        self,
        batch_dim: int = 0,
        minimum_batch_size: int = 1,
        maximum_batch_size: Optional[int] = None,
        timeout_ms: Optional[float] = None,
        maximum_queue_size: Optional[int] = None,
        check_inputs: bool = True,
        telemetry_name: Optional[str] = None,
    ):
        if minimum_batch_size < 1:
            raise ValueError("Min batch size must be >= 1")
        if maximum_batch_size is not None:
            if maximum_batch_size < minimum_batch_size:
                raise ValueError(
                    "Max batch size must be >= min batch size"
                )
        if maximum_queue_size is not None and maximum_queue_size < 1:
            raise ValueError("Max queue size must be >= 1")
        self._batch_dim = batch_dim
        self._min = minimum_batch_size
        self._max = (
            maximum_batch_size if maximum_batch_size is not None else float("inf")
        )
        # `is not None`, not truthiness: timeout_ms=0 means "time out
        # immediately", never "block forever".
        self._timeout_s = timeout_ms / 1000 if timeout_ms is not None else None
        self._max_queue = (
            maximum_queue_size if maximum_queue_size is not None else float("inf")
        )
        self._check_inputs = check_inputs
        # Queue depth/occupancy + batch-size/wait-time series under
        # `{telemetry_name}.*`. None = no instruments, no overhead.
        self._tm = (
            _QueueTelemetry(telemetry_name) if telemetry_name else None
        )

        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        # (inputs, payload, rows) items  # guarded-by: self._lock
        self._deque = collections.deque()
        self._closed = False  # guarded-by: self._lock
        self._num_enqueued = 0  # guarded-by: self._lock

    def name(self):
        return type(self).__name__

    def size(self) -> int:
        with self._lock:
            return len(self._deque)

    def num_enqueued(self) -> int:
        with self._lock:
            return self._num_enqueued

    # beastlint: hot
    def enqueue(self, inputs: Any, payload: Any = None):
        leaves = nest.flatten(inputs)
        if self._check_inputs:
            if not leaves:
                raise ValueError("Cannot enqueue empty vector of arrays")
            for leaf in leaves:
                arr = np.asarray(leaf)
                if arr.ndim <= self._batch_dim:
                    raise ValueError(
                        f"Enqueued array with {arr.ndim} dims but "
                        f"batch_dim is {self._batch_dim}"
                    )
        # Batch sizes are counted in ROWS along batch_dim (an item may carry
        # several), so dequeue_many's max matches the consumer's bucket
        # contract even for multi-row compute() calls.
        rows = int(np.asarray(leaves[0]).shape[self._batch_dim]) if leaves else 1
        with self._not_full:
            if self._closed:
                raise ClosedBatchingQueue(
                    "Enqueue to closed batching queue"
                )
            while len(self._deque) >= self._max_queue:
                self._not_full.wait()
                if self._closed:
                    raise ClosedBatchingQueue(
                        "Enqueue to closed batching queue"
                    )
            self._deque.append((inputs, payload, rows))
            self._num_enqueued += 1
            if self._tm is not None:
                self._tm.items_in.inc()
                self._tm.depth.set(len(self._deque))
            self._not_empty.notify()

    def close(self):
        with self._lock:
            if self._closed:
                raise RuntimeError("Queue was closed already")
            self._closed = True
            leftover = len(self._deque)
            self._deque.clear()
            self._not_empty.notify_all()
            self._not_full.notify_all()
            return leftover

    def is_closed(self) -> bool:
        with self._lock:
            return self._closed

    # beastlint: hot
    def dequeue_many(self) -> Tuple[Any, List[Any]]:
        """Block for >= minimum_batch_size rows (or any rows after
        timeout); return (batched nest, payloads). Up to
        maximum_batch_size rows are concatenated; the first item is always
        taken so an oversized single item can't deadlock the queue."""
        t_wait = time.perf_counter() if self._tm is not None else 0.0
        with self._not_empty:
            # The timeout bounds how long we hold out for a FULL minimum
            # batch; an empty queue always blocks (there is nothing to
            # return), so an expired deadline must not busy-spin — we fall
            # back to an untimed wait for the first item.
            deadline = (
                None
                if self._timeout_s is None
                else time.monotonic() + self._timeout_s
            )
            while True:
                if sum(r for _, _, r in self._deque) >= self._min:
                    break
                if self._closed:
                    raise StopIteration
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        if self._deque:
                            break
                        remaining = None
                self._not_empty.wait(timeout=remaining)
            items = [self._deque.popleft()]
            rows = items[0][2]
            while self._deque and rows + self._deque[0][2] <= self._max:
                item = self._deque.popleft()
                rows += item[2]
                items.append(item)
            if self._tm is not None:
                self._tm.depth.set(len(self._deque))
                self._tm.dequeue_wait_s.observe(
                    time.perf_counter() - t_wait
                )
                self._tm.batch_size.observe(rows)
            self._not_full.notify_all()
        inputs = [it[0] for it in items]
        payloads = [it[1] for it in items]
        return _concat_nests(inputs, self._batch_dim), payloads

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch, _ = self.dequeue_many()
        except StopIteration:
            raise StopIteration from None
        return batch


class _Promise:
    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None


class Batch:
    """One pending inference batch: inputs + the promises awaiting rows."""

    def __init__(self, batch_dim: int, inputs: Any, promises: List[_Promise],
                 sizes: List[int], traces: Optional[List] = None):
        self._batch_dim = batch_dim
        self._inputs = inputs
        self._promises = promises
        self._sizes = sizes
        self._traces = traces or []
        self._outputs_set = False

    def _finish_traces(self, stage: str):
        for trace in self._traces:
            trace.stamp(stage)
            trace.finish()

    def __len__(self):
        return sum(self._sizes)

    def get_inputs(self) -> Any:
        return self._inputs

    # beastlint: hot
    def set_outputs(self, outputs: Any):
        if self._outputs_set:
            raise RuntimeError("set_outputs called twice")
        leaves = nest.flatten(outputs)
        if not leaves:
            raise ValueError("Empty output")
        expected = len(self)
        for leaf in leaves:
            arr = np.asarray(leaf)
            if arr.ndim <= self._batch_dim:
                raise ValueError(
                    f"With batch_dim {self._batch_dim}, output shape "
                    f"{arr.shape} has too few dims"
                )
            if arr.shape[self._batch_dim] != expected:
                raise ValueError(
                    f"Output shape {arr.shape} must have size {expected} "
                    f"in batch_dim {self._batch_dim}"
                )
        self._outputs_set = True
        offset = 0
        for promise, size in zip(self._promises, self._sizes):
            sl = [slice(None)] * (self._batch_dim + 1)
            sl[self._batch_dim] = slice(offset, offset + size)
            promise.value = nest.map(
                lambda a: np.asarray(a)[tuple(sl)], outputs
            )
            promise.event.set()
            offset += size
        self._finish_traces("reply")

    def fail(self, error: BaseException):
        """Break every waiting promise with `error` (used by consumers
        whose model call failed, so producers fail fast instead of
        timing out)."""
        if self._outputs_set:
            return
        self._outputs_set = True
        for promise in self._promises:
            promise.error = AsyncError(
                f"Inference failed: {type(error).__name__}: {error}"
            )
            promise.event.set()
        self._finish_traces("failed")

    def __del__(self):
        if not self._outputs_set:
            for promise in self._promises:
                promise.error = AsyncError(
                    "Batch died before outputs were set"
                )
                promise.event.set()
            self._finish_traces("dropped")


class DevicePrefetcher:
    """Double-buffered host→device staging between a batch source and
    the learner thread.

    A background thread drains `source` (any iterable — typically the
    learner BatchingQueue) and applies `place_fn` (jax.device_put / the
    DP shard placement — injected so this module stays numpy-only) to
    each item. Because device placement is asynchronous, by the time the
    learner pulls an item its H2D transfer is already riding behind the
    previous update's compute instead of stalling the next dispatch;
    `depth=2` is the classic double buffer (one staging while one is
    consumed). Staging contract: each staged batch is handed to exactly
    one consumer and nothing re-reads it afterwards, so its device
    buffers free as soon as the consuming update drops the reference
    (and a derived update step with batch-shaped outputs may safely
    donate them — learner.donate_argnums_for(donate, donate_batch=True)).

    End-of-stream contract (mirrors the inline prefetch thread this
    replaces, polybeast r05): no end sentinel is enqueued — the internal
    queue may still hold live items when the source closes — consumers
    detect exhaustion by `get()` raising `queue.Empty` while
    `is_alive()` is False. A `place_fn`/source error is logged, recorded
    on `.error`, and ends the stream the same way.

    """

    def __init__(
        self,
        source: Iterable,
        place_fn: Callable[[Any], Any],
        depth: int = 2,
        telemetry_name: Optional[str] = None,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = source
        self._place = place_fn
        # Staging-time series: place_fn (device_put / shard placement)
        # dispatch latency + staged-buffer occupancy.
        self._tm_stage = self._tm_depth = None
        if telemetry_name:
            reg = telemetry.get_registry()
            self._tm_stage = reg.histogram(f"{telemetry_name}.stage_s")
            self._tm_depth = reg.gauge(f"{telemetry_name}.depth")
        self._q = stdlib_queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="device-prefetch"
        )

    def start(self):
        self._thread.start()
        return self

    # beastlint: hot
    def _run(self):
        import logging

        try:
            for item in self._source:
                if self._tm_stage is not None:
                    t0 = time.perf_counter()
                    staged = self._place(item)
                    self._tm_stage.observe(time.perf_counter() - t0)
                else:
                    staged = self._place(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=1.0)
                        break
                    except stdlib_queue.Full:
                        continue
                if self._tm_depth is not None:
                    self._tm_depth.set(self._q.qsize())
                if self._stop.is_set():
                    return
        except StopIteration:
            pass
        except Exception as e:  # noqa: BLE001
            self.error = e
            logging.getLogger(__name__).exception(
                "Device prefetch thread failed"
            )

    def get(self, timeout: Optional[float] = None):
        """One staged item; raises queue.Empty on timeout (the caller
        loops, checking is_alive() to detect exhaustion)."""
        item = self._q.get(timeout=timeout)
        if self._tm_depth is not None:
            self._tm_depth.set(self._q.qsize())
        return item

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def close(self):
        """Stop staging (a blocked put exits within its poll interval).
        Already-staged items stay readable."""
        self._stop.set()

    def join(self, timeout: Optional[float] = None):
        self._thread.join(timeout)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                return self.get(timeout=0.2)
            except stdlib_queue.Empty:
                if not self.is_alive():
                    raise StopIteration from None


class DynamicBatcher:
    def __init__(
        self,
        batch_dim: int = 1,
        minimum_batch_size: int = 1,
        maximum_batch_size: Optional[int] = None,
        timeout_ms: Optional[float] = None,
        check_outputs: bool = True,
        telemetry_name: Optional[str] = None,
        admission=None,
    ):
        self._batch_dim = batch_dim
        self._queue = BatchingQueue(
            batch_dim=batch_dim,
            minimum_batch_size=minimum_batch_size,
            maximum_batch_size=maximum_batch_size,
            timeout_ms=timeout_ms,
            telemetry_name=telemetry_name,
        )
        # The inner queue owns depth/batch-size; the batcher adds the
        # producer-side time-in-queue series ({name}.request_wait_s).
        self._tm = self._queue._tm
        self._tm_request_wait = (
            telemetry.get_registry().histogram(
                f"{telemetry_name}.request_wait_s"
            )
            if telemetry_name else None
        )
        self._check_outputs = check_outputs
        self._compute_timeout_s = 600  # reference: 10-min future timeout
        # Overload gate: when armed,
        # compute() may shed at enqueue (bounded queue depth — the
        # driver sizes it as --admission_depth_factor x the max batch)
        # and __next__ sheds requests whose deadline expired in the
        # queue — both as the typed ShedError the actor retry path
        # re-submits. One AdmissionController may gate SEVERAL
        # batchers (the Sebulba split shares one across its per-slice
        # batchers): the depth bound applies per queue, the counters
        # aggregate.
        self._admission = admission

    def size(self) -> int:
        return self._queue.size()

    def close(self):
        """Close the intake and break every pending promise so blocked
        compute() callers wake with AsyncError instead of hanging on the
        10-minute timeout. Closing and draining happen atomically under
        the queue lock — a concurrent compute() either enqueues before
        (its promise is broken here) or raises ClosedBatchingQueue."""
        q = self._queue
        with q._lock:
            if q._closed:
                raise RuntimeError("Queue was closed already")
            q._closed = True
            pending = [payload for _, payload, _ in q._deque]
            leftover = len(q._deque)
            q._deque.clear()
            q._not_empty.notify_all()
            q._not_full.notify_all()
        for payload in pending:
            promise = payload[0]
            promise.error = AsyncError("Batcher closed with pending requests")
            promise.event.set()
        return leftover

    def is_closed(self) -> bool:
        return self._queue.is_closed()

    # beastlint: hot
    def compute(self, inputs: Any, trace=None) -> Any:
        """Blocking request/response: returns this caller's output rows.

        `trace` (an optional telemetry StageTrace) rides the payload
        through the pipeline: stamped "enqueue" here, "batch" when the
        consumer picks the request up, "reply"/"failed" when its rows
        come back — per-request stage attribution for sampled traffic.

        With an armed admission controller this may raise ShedError
        BEFORE enqueueing (depth gate) — the caller re-submits after
        backoff (runtime/actor_pool.py owns that retry contract).
        """
        size = np.asarray(nest.front(inputs)).shape[self._batch_dim]
        if size > self._queue._max:
            raise ValueError(
                f"compute() input has {size} rows along batch_dim, more "
                f"than maximum_batch_size={self._queue._max}"
            )
        deadline = None
        if self._admission is not None:
            # May raise ShedError; checked before the trace stamps so a
            # shed-at-admission request never emits a half-open trace.
            deadline = self._admission.admit(self._queue.size())
        promise = _Promise()
        t_enq = (
            time.perf_counter()
            if (self._tm is not None or self._admission is not None)
            else 0.0
        )
        if trace is not None:
            trace.stamp("enqueue")
        self._queue.enqueue(inputs, (promise, size, t_enq, trace, deadline))
        if not promise.event.wait(timeout=self._compute_timeout_s):
            raise TimeoutError(
                "Compute response not ready after 10 minutes"
            )
        if promise.error is not None:
            raise promise.error
        return promise.value

    def __iter__(self):
        return self

    def _shed_expired(self, batch_inputs, payloads):
        """Deadline gate at dequeue: fail requests that sat
        in the queue past their deadline with the typed ShedError and
        cut their rows out of the batch. Returns (inputs, payloads)
        restricted to live requests — possibly ([], []) when the whole
        batch expired."""
        live_idx, expired_idx = self._admission.split_expired(
            [p[4] for p in payloads], [p[2] for p in payloads]
        )
        if not expired_idx:
            return batch_inputs, payloads
        for i in expired_idx:
            promise, _, _, trace, _ = payloads[i]
            if trace is not None:
                trace.stamp("shed")
                trace.finish()
            promise.error = self._admission.expired_error()
            promise.event.set()
        if not live_idx:
            return None, []
        offsets = np.cumsum([0] + [p[1] for p in payloads])
        rows = np.concatenate(
            [np.arange(offsets[i], offsets[i + 1]) for i in live_idx]
        )
        bd = self._batch_dim
        batch_inputs = nest.map(
            lambda a: np.take(np.asarray(a), rows, axis=bd), batch_inputs
        )
        return batch_inputs, [payloads[i] for i in live_idx]

    # beastlint: hot
    def __next__(self) -> Batch:
        while True:
            batch_inputs, payloads = self._queue.dequeue_many()
            if self._admission is not None:
                batch_inputs, payloads = self._shed_expired(
                    batch_inputs, payloads
                )
                if not payloads:
                    continue  # the whole batch expired in-queue
            promises = [p[0] for p in payloads]
            sizes = [p[1] for p in payloads]
            traces = [p[3] for p in payloads if p[3] is not None]
            if self._tm_request_wait is not None:
                now = time.perf_counter()
                for p in payloads:
                    self._tm_request_wait.observe(now - p[2])
            for trace in traces:
                trace.stamp("batch")
            return Batch(
                self._batch_dim, batch_inputs, promises, sizes, traces=traces
            )
