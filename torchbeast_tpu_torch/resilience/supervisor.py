"""Supervised recovery: the pipeline health state machine, the
inference-thread supervisor, and the learner stall watchdog.

Before this module, the failure modes these cover each ended a run its
own way: a poisoned DeviceStateTable killed the inference thread loudly
and the run *wedged* (actors blocked on a batcher nobody drains), a
stalled learner was invisible until someone read the SPS logs, and a
dying actor fleet either went unnoticed or took the whole run down with
the first error. Here every one of them flows through ONE health state
machine:

    HEALTHY --degrade--> DEGRADED --recover--> HEALTHY
        \\                   |
         \\---halt---> HALTED <--halt (terminal)

exported as the `health.state` gauge (0/1/2), with the driver's monitor
loop turning HALTED into a checkpoint-then-clean-exit instead of a hang.

The port's copy of torchbeast_tpu/resilience/supervisor.py.
"""

import logging
import sys
import threading
import time
import traceback
from typing import Callable, List, Optional, Tuple

from torchbeast_tpu_torch import telemetry

log = logging.getLogger(__name__)

HEALTHY, DEGRADED, HALTED = 0, 1, 2
STATE_NAMES = {HEALTHY: "HEALTHY", DEGRADED: "DEGRADED", HALTED: "HALTED"}


class PipelineHealth:
    """Thread-safe pipeline health with telemetry export.

    Transitions are logged and counted (`health.transitions`); the
    current state rides the `health.state` gauge (0=HEALTHY,
    1=DEGRADED, 2=HALTED). HALTED is terminal — `halted` is a
    threading.Event the driver's monitor loop waits on so a halt cuts
    the 5s monitor sleep short instead of racing it.
    """

    def __init__(self, registry=None):
        reg = registry if registry is not None else telemetry.get_registry()
        self._gauge = reg.gauge("health.state")
        self._transitions = reg.counter("health.transitions")
        self._lock = threading.Lock()
        self._state = HEALTHY  # guarded-by: self._lock
        self._reasons: List[Tuple[str, str]] = []  # guarded-by: self._lock
        # Active degradation causes, keyed so independent subsystems
        # can't erase each other's DEGRADED state: the stall watchdog
        # recovering must not mask a concurrent poison (and vice
        # versa), and a STICKY cause (actor attrition — retired actors
        # never come back) blocks recovery for the rest of the run.
        # key -> (reason, sticky); guarded-by: self._lock
        self._causes: dict = {}
        self.halted = threading.Event()
        self._gauge.set(HEALTHY)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    @property
    def state_name(self) -> str:
        return STATE_NAMES[self.state]

    @property
    def is_halted(self) -> bool:
        return self.halted.is_set()

    def reasons(self) -> List[Tuple[str, str]]:
        """(state_name, reason) transition history, oldest first."""
        with self._lock:
            return list(self._reasons)

    def _transition(self, new_state: int, reason: str) -> bool:
        with self._lock:
            if self._state == HALTED:
                return False  # terminal
            if new_state == self._state:
                return False
            self._state = new_state
            self._reasons.append((STATE_NAMES[new_state], reason))
            if len(self._reasons) > 64:
                del self._reasons[:-64]
        self._gauge.set(new_state)
        self._transitions.inc()
        level = logging.ERROR if new_state == HALTED else logging.WARNING
        log.log(
            level, "Pipeline health -> %s: %s",
            STATE_NAMES[new_state], reason,
        )
        if new_state == HALTED:
            self.halted.set()
        return True

    def degrade(self, reason: str, key: Optional[str] = None,
                sticky: bool = False) -> bool:
        """HEALTHY -> DEGRADED (no-op transition when already
        DEGRADED/HALTED, but the cause is recorded either way).

        `key` names the cause so the matching recover(key=...) clears
        exactly it; default is the reason text. `sticky=True` marks a
        permanent cause (retired actors don't come back): it can never
        be cleared, so the run stays DEGRADED until halt."""
        with self._lock:
            self._causes[key or reason] = (reason, sticky)
        return self._transition(DEGRADED, reason)

    def recover(self, reason: str, key: Optional[str] = None) -> bool:
        """Clear a degradation cause; DEGRADED -> HEALTHY only once NO
        cause remains (a stall recovering must not mask a concurrent
        poison, and sticky causes block recovery for good). `key=None`
        clears every non-sticky cause (a caller-agnostic all-clear).
        Never leaves HALTED."""
        with self._lock:
            if key is None:
                self._causes = {
                    k: v for k, v in self._causes.items() if v[1]
                }
            else:
                entry = self._causes.get(key)
                if entry is not None and not entry[1]:
                    del self._causes[key]
            remaining = [r for r, _ in self._causes.values()]
        if remaining:
            log.warning(
                "Health: %s, but staying DEGRADED (remaining: %s)",
                reason, "; ".join(remaining),
            )
            return False
        return self._transition(HEALTHY, reason)

    def halt(self, reason: str) -> bool:
        """Terminal: the driver checkpoints and exits cleanly."""
        return self._transition(HALTED, reason)


def dump_thread_stacks(header: str) -> None:
    """Log every live thread's stack — the stall watchdog's diagnostic
    dump (where exactly is the pipeline stuck?)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    lines = [header]
    for ident, frame in frames.items():
        lines.append(
            f"--- thread {names.get(ident, '?')} ({ident}) ---"
        )
        lines.append("".join(traceback.format_stack(frame)))
    log.error("%s", "\n".join(lines))


class InferenceSupervisor:
    """Run N serving-loop threads and recover a poisoned state table.

    The DeviceStateTable donates its buffer into every dispatch, so a
    failed dispatch poisons it and the serving loop re-raises rather
    than serve garbage (runtime/inference.py). Before this supervisor
    that re-raise ended the thread AND the run: actors blocked forever
    on a batcher nobody drained. Now the supervisor catches the typed
    poison error, rebuilds the table from initial state (all actor
    slots reset — in-flight rollouts restart from the failed batch's
    retry path), and restarts the thread, under `restart_budget`
    rebuilds per run. Budget exhaustion transitions health to HALTED so
    the driver checkpoints and exits instead of hanging.

    `loop_fn()` is one serving loop (it returns when the batcher
    closes); the supervisor owns the threads so the driver never touches
    raw inference threads again.

    The port adds a watcher: a table poisoned outside a serving step (a
    direct call, or the chaos harness's injection) is met by the next
    serving step only, and when every actor is at an unroll boundary
    (held by the learner queue's backpressure) the actors' own table
    calls fail instead, no request reaches a serving thread, and the
    actors retire on their retry budgets. So a watcher thread polls the
    table and rebuilds it under the same budget and counters, once per
    poison event, as a serving thread would (the reference waits for a
    serving thread).

    Telemetry: `recovery.table_rebuilds` and
    `recovery.inference_restarts` each count ONE per poison event
    (sibling threads re-entering after a rebuild don't re-count), which
    is what lets the chaos harness assert recovery == injected exactly.
    """

    def __init__(
        self,
        loop_fn: Callable[[], None],
        num_threads: int,
        state_table=None,
        restart_budget: int = 3,
        health: Optional[PipelineHealth] = None,
        registry=None,
        name: str = "inference",
        extra_loop_fns: Optional[List[Callable[[], None]]] = None,
    ):
        # `extra_loop_fns`: replica serving loops ride the
        # SAME supervisor as the central ones — they share the state
        # table, so a poison event must rebuild once and restart ALL
        # serving threads under one budget/generation, not race two
        # supervisors over the same table.
        self._loops = [loop_fn] * num_threads + list(extra_loop_fns or [])
        self._num_threads = len(self._loops)
        self._table = state_table
        self._budget = restart_budget
        self._health = health
        self._name = name
        reg = registry if registry is not None else telemetry.get_registry()
        self._tm_rebuilds = reg.counter("recovery.table_rebuilds")
        self._tm_restarts = reg.counter("recovery.inference_restarts")
        self._lock = threading.Lock()
        self._restarts = 0  # guarded-by: self._lock
        self._recovery_gen = 0  # guarded-by: self._lock
        self._exhausted = False  # guarded-by: self._lock
        # Appended by N serving threads, polled by the driver monitor
        # (RACE burn-down): exposed through the locked
        # `errors` property.
        self._errors: List[BaseException] = []  # guarded-by: self._lock
        self._threads: List[threading.Thread] = []
        self._watcher: Optional[threading.Thread] = None

    @property
    def errors(self) -> List[BaseException]:
        with self._lock:
            return list(self._errors)

    @property
    def restarts(self) -> int:
        with self._lock:
            return self._restarts

    def start(self) -> None:
        self._threads = [
            threading.Thread(
                target=self._run, args=(i,), daemon=True,
                name=f"{self._name}-{i}",
            )
            for i in range(len(self._loops))
        ]
        for t in self._threads:
            t.start()
        if self._table is not None:
            self._watcher = threading.Thread(
                target=self._watch, daemon=True, name=f"{self._name}-watch")
            self._watcher.start()

    def _watch(self, interval_s: float = 0.05) -> None:
        """Rebuild a table poisoned while no serving thread steps it;
        ends with the last serving thread."""
        while self.alive_count() > 0:
            time.sleep(interval_s)
            if getattr(self._table, "poisoned", False):
                with self._lock:
                    gen = self._recovery_gen
                self._recover(-1, gen)

    def alive_count(self) -> int:
        return sum(1 for t in self._threads if t.is_alive())

    def join(self, timeout: Optional[float] = None) -> None:
        for t in self._threads:
            t.join(timeout=timeout)
        if self._watcher is not None:
            self._watcher.join(timeout=timeout)

    @staticmethod
    def _is_poison_error(e: BaseException) -> bool:
        # runtime.errors is jax-free, so this never drags jax into a
        # process that only supervises.
        from torchbeast_tpu_torch.runtime.errors import StateTablePoisonedError

        return isinstance(e, StateTablePoisonedError)

    def _run(self, index: int) -> None:
        loop_fn = self._loops[index]
        while True:
            with self._lock:
                gen = self._recovery_gen
            try:
                loop_fn()
                return  # batcher closed: clean shutdown
            except BaseException as e:  # noqa: BLE001
                if self._is_poison_error(e) or (
                    self._table is not None
                    and getattr(self._table, "poisoned", False)
                ):
                    if self._recover(index, gen):
                        continue
                    return  # budget exhausted; health already HALTED
                # Not a poisoning: a real serving bug. Record it and die
                # loudly; actors drain their retry budgets against the
                # survivors and the health machine degrades from there.
                with self._lock:
                    self._errors.append(e)
                log.exception(
                    "Inference thread %d failed (unrecoverable)", index
                )
                if self._health is not None and self.alive_count() <= 1:
                    # alive_count still includes this dying thread.
                    self._health.halt(
                        f"all inference threads dead (last error: {e})"
                    )
                raise

    def _recover(self, index: int, gen_at_entry: int) -> bool:
        """Rebuild the poisoned table (once per poison event) and tell
        the calling thread whether to re-enter its serving loop."""
        with self._lock:
            if self._exhausted:
                return False
            table = self._table
            if table is None or not getattr(table, "poisoned", False):
                # A sibling already rebuilt for this poison event (our
                # generation predates its recovery): just re-enter.
                if self._recovery_gen != gen_at_entry:
                    return True
                return False
            if self._restarts >= self._budget:
                self._exhausted = True
                if self._health is not None:
                    self._health.halt(
                        "inference restart budget exhausted "
                        f"({self._restarts}/{self._budget} rebuilds)"
                    )
                return False
            self._restarts += 1
            self._recovery_gen += 1
            # Counted before the rebuild clears the poison: whoever sees
            # the table healthy again sees its rebuild counted.
            self._tm_rebuilds.inc()
            self._tm_restarts.inc()
            table.rebuild()
            n = self._restarts
        if self._health is not None:
            self._health.degrade(
                f"state table poisoned; rebuilt "
                f"(restart {n}/{self._budget})",
                key="state_table_poison",
            )
            self._health.recover(
                "inference restarted on the rebuilt state table",
                key="state_table_poison",
            )
        log.warning(
            "%s: state table poisoned; rebuilt from initial state and "
            "restarting (restart %d/%d)",
            f"Inference thread {index}" if index >= 0 else "Table watcher",
            n, self._budget,
        )
        return True


class LearnerWatchdog:
    """Detect a stalled learner: no `ping()` within `deadline_s`.

    The learner loop pings once per update dispatch. A stall (actor
    starvation, a wedged queue, a hung collective) transitions health
    to DEGRADED with a structured reason, dumps every thread's stack
    plus the caller's `dump_fn()` diagnostics, and counts
    `learner.stalls`; pings resuming transitions back to HEALTHY. The
    watchdog never halts on its own — stall length is workload-relative
    and the min-live-actors / inference-budget paths own terminal
    decisions.

    `deadline_s <= 0` disables the watchdog (start() is a no-op).
    """

    def __init__(
        self,
        deadline_s: float,
        health: Optional[PipelineHealth] = None,
        dump_fn: Optional[Callable[[], dict]] = None,
        registry=None,
        name: str = "learner",
    ):
        self.deadline_s = deadline_s
        self._health = health
        self._dump_fn = dump_fn
        self._name = name
        reg = registry if registry is not None else telemetry.get_registry()
        self._tm_stalls = reg.counter("learner.stalls")
        self._last_ping = time.monotonic()
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def ping(self) -> None:
        # beastlint: disable=RACE  single-writer monotonic float: only the learner thread writes at runtime, the GIL makes the store atomic, and the watchdog reading one stale value merely delays stall detection by a poll tick
        self._last_ping = time.monotonic()

    @property
    def stalled(self) -> bool:
        return self._stalled

    def start(self) -> "LearnerWatchdog":
        if self.deadline_s <= 0:
            return self
        self._last_ping = time.monotonic()  # the clock starts now
        self._thread = threading.Thread(
            target=self._watch, daemon=True, name=f"{self._name}-watchdog"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _watch(self) -> None:
        poll = max(0.1, min(self.deadline_s / 4.0, 5.0))
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._last_ping
            if not self._stalled and idle > self.deadline_s:
                self._stalled = True
                self._tm_stalls.inc()
                reason = (
                    f"{self._name} made no update dispatch for "
                    f"{idle:.1f}s (deadline {self.deadline_s}s)"
                )
                if self._health is not None:
                    self._health.degrade(
                        reason, key=f"{self._name}_stall"
                    )
                self._dump(reason)
            elif self._stalled and idle <= self.deadline_s:
                self._stalled = False
                if self._health is not None:
                    self._health.recover(
                        f"{self._name} update dispatches resumed",
                        key=f"{self._name}_stall",
                    )

    def _dump(self, reason: str) -> None:
        diag = ""
        if self._dump_fn is not None:
            try:
                diag = f"\ndiagnostics: {self._dump_fn()}"
            except Exception:  # noqa: BLE001
                log.exception("Watchdog dump_fn failed")
        dump_thread_stacks(f"Learner stall watchdog fired: {reason}{diag}")
