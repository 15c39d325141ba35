"""The port's C++ runtime core: loader, readiness gate and telemetry fold.

The port's copy of torchbeast_tpu/runtime/native.py. `import_native()`
returns the `_tbt_core_torch` extension (C++ BatchingQueue /
DynamicBatcher / ActorPool / EnvServer: actor loops, the dynamic batcher
and the learner queue run GIL-free in C++ threads), which
runtime/native_build.py compiles from torchbeast_tpu_torch/csrc/native/
at first use; None when it cannot be built, and `gap_reason()` then says
why. polybeast selects it with `--native_runtime` (auto by default). The
Python implementations in queues.py / actor_pool.py remain the semantic
reference and the fallback.

`NativeTelemetryFolder` folds the core's per-request stage stamps and
its wire / env-step / queue counters into the process registry under the
series names the Python runtime writes (wire.bytes_up/down,
actor.env_steps/connects/request_rtt_s, recovery.actor_reconnects/
batch_retries, inference.request_wait_s, learner_queue.items_in/
dequeue_wait_s/batch_size), so the driver's stats read the same on
either runtime. The port has no DriverTelemetry yet: polybeast calls
`tick()` from its monitor loop and once at shutdown.
"""

import threading
import time
from typing import Optional

from torchbeast_tpu_torch.runtime import native_build

_error: Optional[str] = None


def import_native():
    """The core, built at first use; None when it cannot be built (the
    build's message is then `gap_reason()`'s)."""
    global _error
    try:
        module = native_build.load()
    except Exception as e:  # noqa: BLE001  any build or load failure
        # beastlint: disable=RACE  the last failure's text, read only for the message; each store is GIL-atomic
        _error = f"{type(e).__name__}: {e}"
        return None
    return module


def available() -> bool:
    return import_native() is not None


# The extension API generation this tree requires (csrc/native/
# pymodule.cc sets API_VERSION): 2 = the serving plane (routers,
# continuous batching, record_policy_lag) on top of the shed protocol.
REQUIRED_API_VERSION = 2


def gap_reason(core=None) -> Optional[str]:
    """Why the native runtime can NOT be used (None = usable). The
    driver's default (auto) logs this and falls back to the Python pool;
    an explicit --native_runtime raises with it."""
    if core is None:
        core = import_native()
    if core is None:
        return f"the runtime core could not be built ({_error})"
    have = getattr(core, "API_VERSION", 0)
    if have < REQUIRED_API_VERSION:
        return (
            f"{native_build.MODULE_NAME} is stale: API version {have} < "
            f"required {REQUIRED_API_VERSION}"
        )
    return None


def require(flag: str):
    """The core for an explicit `flag` (--native_runtime,
    --native_server); RuntimeError naming the flag and why when it cannot
    be built."""
    core = import_native()
    reason = gap_reason(core)
    if reason is not None:
        raise RuntimeError(f"{flag} requested but {reason}")
    return core


class NativeTelemetryFolder:
    """Folds the C++ pool/batcher/queue telemetry into the registry.

    `tick()` runs as a DriverTelemetry tick callback (monitor thread,
    plus the final shutdown write): counter series are credited with
    the delta since the previous tick; histogram series fold the C++
    side's interval snapshot (which resets on read, so min/max are the
    interval's true extremes). The lock makes the shutdown-path tick
    safe against a monitor tick still in flight.
    """

    def __init__(self, registry, pool=None, batcher=None, queue=None,
                 tracer=None, slo_target_s=None, slice_batchers=None,
                 slice_router=None, replica_router=None,
                 replica_batcher=None, fleet=None):
        # ISSUE 17 fleet fold: with a FleetCoordinator attached, the
        # lead re-exports every remote host's heartbeat gauges
        # (inference.slice.<i>.* by construction — parallel.sebulba
        # .slice_gauge_snapshot feeds the remote end) prefixed
        # `host<r>.`, so one telemetry.jsonl shows every slice in the
        # fleet. Works with all native sources None — Python-runtime
        # fleet runs construct this folder for the fleet fold alone.
        self._fleet = fleet
        self._registry = registry
        self._fleet_gauges = {}  # name -> Gauge  # guarded-by: self._lock
        self._pool = pool
        self._batcher = batcher
        self._queue = queue
        self._slo_target_s = slo_target_s
        # ISSUE 16 per-slice fold: native per-slice batchers' admission
        # counters aggregate into the same serving.* series the central
        # fold uses (one audit schema either topology), while their
        # depths land on the per-slice "inference.slice.<i>.depth"
        # gauges — the exact series the Python SebulbaServing
        # gauge_tick publishes, so dashboards cannot tell the runtimes
        # apart. The native SliceRouter's routed counts fold onto
        # "inference.slice.<i>.requests" (the Python SliceRouter's
        # series), the ReplicaRouter's onto serving.replica_requests/
        # serving.central_requests (serving/replica.py's series).
        self._slice_batchers = list(slice_batchers or [])
        self._slice_router = slice_router
        self._replica_router = replica_router
        self._replica_batcher = replica_batcher
        self._g_slice_depth = [
            registry.gauge(f"inference.slice.{i}.depth")
            for i in range(len(self._slice_batchers))
        ]
        self._c_slice_requests = []
        if slice_router is not None:
            self._c_slice_requests = [
                registry.counter(f"inference.slice.{i}.requests")
                for i in range(slice_router.n_slices())
            ]
        if replica_router is not None:
            self._c_replica_requests = registry.counter(
                "serving.replica_requests"
            )
            self._c_central_requests = registry.counter(
                "serving.central_requests"
            )
        # Continuous-batching roll-ins (native only; the Python batcher
        # has no dispatch-window top-up).
        self._c_rolled = registry.counter("serving.rolled")
        # Sampled C++ request spans (ISSUE 12) land in the process
        # tracer as the same actor.request.* stage spans the Python
        # pool's StageTraces emit, so a native run's trace export is
        # schema-identical.
        if tracer is None:
            from torchbeast_tpu_torch import telemetry

            tracer = telemetry.get_tracer()
        self._tracer = tracer
        self._lock = threading.Lock()
        self._prev = {}  # counter name -> last cumulative value  # guarded-by: self._lock
        # Same series names the Python runtime's instruments use.
        self._c_bytes_up = registry.counter("wire.bytes_up")
        self._c_bytes_down = registry.counter("wire.bytes_down")
        self._c_steps = registry.counter("actor.env_steps")
        self._c_connects = registry.counter("actor.connects")
        self._c_reconnects = registry.counter("recovery.actor_reconnects")
        self._c_retries = registry.counter("recovery.batch_retries")
        # shm doorbell-wait counters (ISSUE 10): same series names the
        # Python transport increments directly (transport.py
        # _ring_instruments), so mixed-runtime runs aggregate.
        self._c_ring_waits = registry.counter("ring.doorbell_waits")
        self._c_ring_rechecks = registry.counter("ring.recheck_wakeups")
        self._h_rtt = registry.histogram("actor.request_rtt_s")
        self._h_request_wait = registry.histogram("inference.request_wait_s")
        # Serving-tier fold (ISSUE 14): the C++ batcher gates admission
        # and deadline expiry in-process; its counters land on the SAME
        # serving.* series the Python AdmissionController writes, and
        # the C++ pool's shed_resubmits on the actor-side twin — so the
        # chaos harness audits one schema on either runtime.
        self._c_admitted = registry.counter("serving.admitted")
        self._c_shed = registry.counter("serving.shed")
        self._c_expired = registry.counter("serving.expired")
        self._c_resubmits = registry.counter("serving.resubmitted")
        self._c_slo_breaches = registry.counter("slo.rtt_breaches")
        self._h_queue_delay = registry.histogram("serving.queue_delay_s")
        self._g_delay_p99 = registry.gauge("serving.queue_delay_p99_s")
        self._g_slo_ratio = registry.gauge("serving.slo_ratio")
        self._c_queue_in = registry.counter("learner_queue.items_in")
        self._h_queue_wait = registry.histogram(
            "learner_queue.dequeue_wait_s"
        )
        self._h_queue_batch = registry.histogram("learner_queue.batch_size")

    # beastlint: holds self._lock
    def _inc_delta(self, counter, key: str, value: int) -> None:
        prev = self._prev.get(key, 0)
        if value > prev:
            counter.inc(value - prev)
        self._prev[key] = value

    @staticmethod
    def _fold_hist(histogram, snap: dict) -> None:
        histogram.observe_aggregate(
            snap["buckets"], snap["total"], snap["total_sq"],
            snap["min"], snap["max"],
        )

    # beastlint: holds self._lock
    def _fold_traces(self, batcher) -> None:
        """Drain the batcher's sampled (enqueued, batched, replied)
        stamp triples (csrc/queues.h, 1-in-256 computes like the Python
        pool) into tracer spans. Stamps are steady-clock; the payload's
        "now" rebases them onto the tracer's perf_counter timebase
        (both CLOCK_MONOTONIC on Linux — the offset absorbs any epoch
        difference). Always drained, even with tracing disabled, so
        the C++ buffer never sits full."""
        spans_fn = getattr(batcher, "trace_spans", None)
        if spans_fn is None:  # extension built before ISSUE 12
            return
        payload = spans_fn()
        if not payload["spans"] or not self._tracer.enabled():
            return
        offset = time.perf_counter() - payload["now"]
        for enqueued, batched, replied in payload["spans"]:
            self._tracer.add_complete(
                "actor.request.batch", "actor.request",
                enqueued + offset, batched - enqueued,
            )
            self._tracer.add_complete(
                "actor.request.reply", "actor.request",
                batched + offset, replied - batched,
            )
            self._tracer.add_complete(
                "actor.request", "actor.request",
                enqueued + offset, replied - enqueued,
            )

    # beastlint: holds self._lock
    def _batcher_sources(self):
        """Every native batcher feeding the serving-tier fold, keyed
        uniquely so _inc_delta's per-source cursors never collide."""
        sources = []
        if self._batcher is not None:
            sources.append(("central", self._batcher))
        if self._replica_batcher is not None:
            sources.append(("replica", self._replica_batcher))
        sources.extend(
            (f"slice{i}", b)
            for i, b in enumerate(self._slice_batchers)
        )
        return sources

    # beastlint: holds self._lock
    def _fold_batcher(self, key: str, batcher) -> bool:
        """Fold one native batcher's interval telemetry. Returns True
        when a queue-delay snapshot was folded (the caller refreshes
        the p99/SLO gauges once, after every source folded)."""
        b = batcher.telemetry()
        # batches/rows/batch_size stay with the Python serving
        # loop's own inference.* instruments (inference.py
        # observes them for un-instrumented batchers) — folding
        # them here would double-count.
        self._fold_hist(self._h_request_wait, b["request_wait_s"])
        self._fold_hist(self._h_rtt, b["request_rtt_s"])
        # .get: an extension built before ISSUE 14 reports no
        # admission accounting (and the stale gate keeps such a
        # build off the default path anyway).
        self._inc_delta(
            self._c_admitted, f"{key}_serving_admitted",
            b.get("admitted", 0),
        )
        self._inc_delta(
            self._c_shed, f"{key}_serving_shed", b.get("shed", 0)
        )
        self._inc_delta(
            self._c_expired, f"{key}_serving_expired",
            b.get("expired", 0),
        )
        self._inc_delta(
            self._c_slo_breaches, f"{key}_slo_breaches",
            b.get("slo_breaches", 0),
        )
        self._inc_delta(
            self._c_rolled, f"{key}_serving_rolled",
            b.get("rolled", 0),
        )
        self._fold_traces(batcher)
        delay = b.get("queue_delay_s")
        if delay is None:
            return False
        self._fold_hist(self._h_queue_delay, delay)
        return True

    def tick(self) -> None:
        with self._lock:
            if self._pool is not None:
                p = self._pool.telemetry()
                self._inc_delta(self._c_bytes_up, "bytes_up", p["bytes_up"])
                self._inc_delta(
                    self._c_bytes_down, "bytes_down", p["bytes_down"]
                )
                self._inc_delta(self._c_steps, "env_steps", p["env_steps"])
                self._inc_delta(self._c_connects, "connects", p["connects"])
                self._inc_delta(
                    self._c_reconnects, "reconnects", p["reconnects"]
                )
                # .get from here down: an extension built before ISSUE
                # 10/12 reports no ring counters / batch retries; the
                # fold must not KeyError on it.
                self._inc_delta(
                    self._c_retries, "batch_retries",
                    p.get("batch_retries", 0),
                )
                self._inc_delta(
                    self._c_ring_waits, "ring_doorbell_waits",
                    p.get("ring_doorbell_waits", 0),
                )
                self._inc_delta(
                    self._c_ring_rechecks, "ring_recheck_wakeups",
                    p.get("ring_recheck_wakeups", 0),
                )
                self._inc_delta(
                    self._c_resubmits, "shed_resubmits",
                    p.get("shed_resubmits", 0),
                )
            folded_delay = False
            for key, b_obj in self._batcher_sources():
                folded_delay |= self._fold_batcher(key, b_obj)
            if folded_delay:
                # The p99/SLO gauges the Python AdmissionController
                # refreshes inline are refolded here per tick from
                # the registry's cumulative histogram (which aggregates
                # every batcher source under one serving-tier view).
                p99 = self._h_queue_delay.percentile(0.99)
                self._g_delay_p99.set(p99)
                if self._slo_target_s:
                    self._g_slo_ratio.set(p99 / self._slo_target_s)
            for gauge, b_obj in zip(
                self._g_slice_depth, self._slice_batchers
            ):
                gauge.set(b_obj.size())
            if self._slice_router is not None:
                counts = self._slice_router.telemetry()["requests"]
                for i, count in enumerate(counts):
                    self._inc_delta(
                        self._c_slice_requests[i],
                        f"slice{i}_requests", count,
                    )
            if self._replica_router is not None:
                r = self._replica_router.telemetry()
                self._inc_delta(
                    self._c_replica_requests, "replica_requests",
                    r["replica_requests"],
                )
                self._inc_delta(
                    self._c_central_requests, "central_requests",
                    r["central_requests"],
                )
            if self._queue is not None:
                q = self._queue.telemetry()
                self._inc_delta(self._c_queue_in, "queue_items_in",
                                q["items_in"])
                self._fold_hist(self._h_queue_wait, q["dequeue_wait_s"])
                self._fold_hist(self._h_queue_batch, q["batch_size"])
            if self._fleet is not None:
                for rank, gauges in self._fleet.remote_gauges().items():
                    for name, value in gauges.items():
                        full = f"host{rank}.{name}"
                        gauge = self._fleet_gauges.get(full)
                        if gauge is None:
                            gauge = self._registry.gauge(full)
                            self._fleet_gauges[full] = gauge
                        gauge.set(value)
