"""Deterministic fault injection for the async pipeline.

A `FaultPlan` is a seeded, JSON-loadable schedule of faults, each fired
once when the run crosses a step (`at_step`) or wall-clock (`at_s`)
trigger — `polybeast --chaos_plan plan.json` arms it against a live
run. Every injected fault increments a `chaos.<kind>.injected` counter,
which is what lets chaos_run.py assert that recovery telemetry
EXACTLY matches what was injected (not merely "the run survived").

Both runtimes are injectable: on the Python runtime the
transport faults ride a FaultingTransport wrap threaded into the
ActorPool; with `--native_runtime` they route through the C++ pool's
FaultHooks entry points (`attach_native_pool`, csrc/native/chaos.h) — the
process-level classes (server SIGKILL, state-table poison, SIGTERM)
are runtime-agnostic either way.

Fault classes (FAULT_KINDS):

    env_server_sigkill   SIGKILL env-server process `target` (uncleanest
                         possible death: abandoned sockets + shm rings)
    transport_sever      cut actor `target`'s transport mid-stream (the
                         socket is shut down under the actor's feet)
    transport_blackhole  actor `target`'s receives stall for
                         `duration_s` (network partition that heals)
    transport_delay      add `delay_s` to actor `target`'s transport ops
                         for `duration_s` (congestion/brown-out)
    shm_corrupt_header   stomp the length header of the next queued
                         frame in actor `target`'s shm recv ring
    shm_corrupt_payload  flip payload bytes of the next queued frame
                         (may decode clean — corruption is not always
                         detectable; recovery counters are asserted for
                         the header class, see the plan docs)
    state_table_poison   poison the DeviceStateTable (the donated-
                         dispatch failure mode, runtime/state_table.py)
    learner_stall        stall the learner AND the serving threads for
                         `duration_s` (the shared-chip overload model:
                         a busy learner chip slows inference dispatch
                         too) — the fault that makes the admission
                         gate shed for real. Injected via
                         the driver-installed `throttle()` gate; no
                         target needed.
    preempt_sigterm      SIGTERM this process (preemption: the driver's
                         graceful checkpoint-and-exit path)

Plan JSON:

    {"seed": 7,
     "faults": [
       {"kind": "env_server_sigkill", "at_step": 400, "target": 0},
       {"kind": "transport_sever", "at_step": 900, "target": 1},
       {"kind": "state_table_poison", "at_step": 1400}
     ]}

The controller runs a small poll thread inside the driver process; a
fault whose target is momentarily un-injectable (an actor between
connections) stays due and fires on a later tick, so the injected
counts are exact, not best-effort.

The port's copy of torchbeast_tpu/resilience/chaos.py; its native pool
is the port's `_tbt_core_torch` (csrc/native/chaos.h).
"""

import dataclasses
import json
import logging
import os
import random
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from torchbeast_tpu_torch import telemetry

log = logging.getLogger(__name__)

FAULT_KINDS = (
    "env_server_sigkill",
    "transport_sever",
    "transport_blackhole",
    "transport_delay",
    "shm_corrupt_header",
    "shm_corrupt_payload",
    "state_table_poison",
    "learner_stall",
    "preempt_sigterm",
)

# A due-but-uninjectable fault (e.g. sever while its actor is between
# connections) is retried every poll tick; after this many failed
# attempts it is abandoned with an error log so a misconfigured plan
# (bad target) cannot spin forever.
_MAX_ATTEMPTS = 3000


@dataclasses.dataclass
class FaultSpec:
    kind: str
    at_step: Optional[int] = None
    at_s: Optional[float] = None
    target: int = 0
    duration_s: float = 1.0
    delay_s: float = 0.05
    # -- runtime bookkeeping (not part of the JSON schema) --
    fired: bool = False
    abandoned: bool = False
    attempts: int = 0

    def validate(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"Unknown fault kind {self.kind!r}; know {FAULT_KINDS}"
            )
        if self.at_step is None and self.at_s is None:
            raise ValueError(
                f"Fault {self.kind!r} needs a trigger: at_step or at_s"
            )

    def due(self, step: int, elapsed_s: float) -> bool:
        if self.at_step is not None and step >= self.at_step:
            return True
        return self.at_s is not None and elapsed_s >= self.at_s

    def as_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "at_step": self.at_step,
            "at_s": self.at_s,
            "target": self.target,
            "duration_s": self.duration_s,
            "delay_s": self.delay_s,
            "fired": self.fired,
            "abandoned": self.abandoned,
        }


class FaultPlan:
    """A seeded schedule of FaultSpecs.

    The seed drives nothing inside the specs themselves (triggers are
    explicit) — it seeds the controller's jitter-free bookkeeping RNG
    reserved for future randomized targeting, and rides the artifact so
    a chaos run is reproducible from its JSON alone.
    """

    def __init__(self, faults: List[FaultSpec], seed: int = 0):
        self.seed = seed
        self.faults = list(faults)
        for f in self.faults:
            f.validate()
        self.rng = random.Random(seed)

    # The plan JSON schema: everything a user may write. The runtime
    # bookkeeping fields (fired/abandoned/attempts) are deliberately
    # NOT accepted — a summary/as_dict round-trip carrying
    # `"fired": true` back in would silently disarm the fault.
    _SCHEMA_KEYS = frozenset(
        {"kind", "at_step", "at_s", "target", "duration_s", "delay_s"}
    )

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "FaultPlan":
        if not isinstance(data, dict):
            raise ValueError(f"Fault plan must be an object, got {data!r}")
        faults = []
        for entry in data.get("faults", []):
            unknown = set(entry) - cls._SCHEMA_KEYS
            if unknown:
                raise ValueError(
                    f"Fault entry has unknown keys {sorted(unknown)}: "
                    f"{entry!r}"
                )
            faults.append(FaultSpec(**entry))
        return cls(faults, seed=int(data.get("seed", 0)))

    @classmethod
    def from_json(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.faults:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def as_dict(self) -> Dict[str, Any]:
        return {
            "seed": self.seed,
            "faults": [f.as_dict() for f in self.faults],
        }


class FaultingTransport:
    """A transport wrapper that the ChaosController can reach into.

    Wraps any SocketTransport/ShmTransport (same send/recv_sized/recv/
    close surface). Sever closes the write side of the underlying
    socket from the chaos thread, so an actor blocked in recv wakes
    with the same ConnectionError/EOF a real cable cut produces; delay
    and blackhole windows are consulted per operation.
    """

    def __init__(self, inner, actor_index: int, controller):
        self._inner = inner
        self._actor = actor_index
        self._controller = controller

    # -- chaos hooks ------------------------------------------------------
    def sever(self) -> None:
        sock = getattr(self._inner, "_sock", None)
        if sock is None:  # pragma: no cover - every transport has one
            return
        try:
            sock.shutdown(2)  # SHUT_RDWR: unblocks a parked recv
        except OSError:
            pass  # already dead: the sever still "fired"

    def recv_ring(self):
        """The shm recv ring, or None for socket transports."""
        return getattr(self._inner, "_recv_ring", None)

    # -- transport surface ------------------------------------------------
    def send(self, value: Any) -> int:
        self._controller.perturb(self._actor)
        return self._inner.send(value)

    def recv_sized(self) -> Tuple[Any, int]:
        self._controller.perturb(self._actor)
        return self._inner.recv_sized()

    def recv(self) -> Any:
        return self.recv_sized()[0]

    def unlink_segments(self) -> None:
        unlink = getattr(self._inner, "unlink_segments", None)
        if unlink is not None:
            unlink()

    def close(self) -> None:
        self._controller._unregister(self._actor, self)
        self._inner.close()


class ChaosController:
    """Arms a FaultPlan against a live driver.

    The driver attaches handles as they come up (`attach_servers`,
    `attach_state_table`, `set_step_fn`) and threads `wrap_transport`
    into its ActorPool; `start()` runs the poll loop. Injection is
    counted in `chaos.<kind>.injected` the instant it happens.
    """

    def __init__(self, plan: FaultPlan, registry=None,
                 poll_interval_s: float = 0.02):
        self.plan = plan
        self._poll_s = poll_interval_s
        reg = registry if registry is not None else telemetry.get_registry()
        self._counters = {
            kind: reg.counter(f"chaos.{kind}.injected")
            for kind in FAULT_KINDS
        }
        # Attached by the driver thread while the poll thread may
        # already be reading (re-attachment after a rebuild is legal):
        # all of these ride the controller lock.
        self._server_supervisor = None  # guarded-by: self._lock
        self._state_table = None  # guarded-by: self._lock
        self._native_pool = None  # guarded-by: self._lock
        self._step_fn: Callable[[], int] = lambda: 0  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._transports: Dict[int, FaultingTransport] = {}  # guarded-by: self._lock
        # actor -> (kind, window_end_monotonic, delay_s)
        self._windows: Dict[int, Tuple[str, float, float]] = {}  # guarded-by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None
        # learner_stall window end (monotonic); consulted by throttle()
        # from the learner loop and the serving threads.
        self._stall_until = 0.0  # guarded-by: self._lock

    # -- driver attachment ------------------------------------------------
    def attach_servers(self, supervisor) -> None:
        """A polybeast_env.ServerSupervisor (or anything with a
        `.processes` list of live mp.Process members)."""
        with self._lock:
            self._server_supervisor = supervisor

    def attach_state_table(self, table) -> None:
        with self._lock:
            self._state_table = table

    def attach_native_pool(self, pool) -> None:
        """A native (_tbt_core_torch) ActorPool built with fault_hooks=True:
        its connections live in C++ actor threads where the Python
        FaultingTransport wrap cannot reach, so transport faults route
        through the pool's C++ FaultHooks entry points instead
        (chaos_sever / chaos_window / chaos_corrupt_ring,
        csrc/native/chaos.h) — same fault classes, same injected-exact
        accounting."""
        with self._lock:
            self._native_pool = pool

    def set_step_fn(self, fn: Callable[[], int]) -> None:
        with self._lock:
            self._step_fn = fn

    def wrap_transport(self, transport, actor_index: int):
        wrapped = FaultingTransport(transport, actor_index, self)
        with self._lock:
            self._transports[actor_index] = wrapped
        return wrapped

    def _unregister(self, actor_index: int, wrapped) -> None:
        with self._lock:
            if self._transports.get(actor_index) is wrapped:
                del self._transports[actor_index]

    # -- per-op perturbation (called from FaultingTransport) --------------
    def perturb(self, actor_index: int) -> None:
        with self._lock:
            window = self._windows.get(actor_index)
        if window is None:
            return
        kind, until, delay_s = window
        now = time.monotonic()
        if now >= until:
            with self._lock:
                if self._windows.get(actor_index) == window:
                    del self._windows[actor_index]
            return
        if kind == "transport_delay":
            time.sleep(delay_s)
        else:  # blackhole: hold the op until the window heals
            time.sleep(max(0.0, until - now))

    # -- learner_stall gate (called from driver loops) --------------------
    def stall_remaining(self) -> float:
        """Seconds left in the active learner_stall window (0 = none)."""
        with self._lock:
            until = self._stall_until
        return max(0.0, until - time.monotonic())

    def throttle(self) -> None:
        """The shared-chip stall model: the driver installs
        this at the learner's update-dispatch site and the serving
        loops' per-batch site (inference_loop's throttle_fn). Outside a
        stall window it is one lock acquire; inside, it sleeps the
        window out in short slices so shutdown never waits on it."""
        while not self._stop.is_set():
            remaining = self.stall_remaining()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.05))

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ChaosController":
        self._started_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="chaos-controller"
        )
        self._thread.start()
        log.info(
            "Chaos armed: %d faults (%s), seed %d",
            len(self.plan.faults),
            ", ".join(sorted(self.plan.counts())),
            self.plan.seed,
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def done(self) -> bool:
        return all(f.fired or f.abandoned for f in self.plan.faults)

    def injected_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.plan.faults:
            if f.fired:
                out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def summary(self) -> Dict[str, Any]:
        return {
            "seed": self.plan.seed,
            "injected": self.injected_counts(),
            "abandoned": [
                f.as_dict() for f in self.plan.faults if f.abandoned
            ],
            "pending": [
                f.as_dict()
                for f in self.plan.faults
                if not f.fired and not f.abandoned
            ],
        }

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                step_fn = self._step_fn
            step = step_fn()
            elapsed = time.monotonic() - self._started_at
            for fault in self.plan.faults:
                if fault.fired or fault.abandoned:
                    continue
                if not fault.due(step, elapsed):
                    continue
                try:
                    ok = self._inject(fault)
                except Exception:  # noqa: BLE001
                    ok = False
                    log.exception(
                        "Chaos injector %s raised; will retry", fault.kind
                    )
                if ok:
                    fault.fired = True
                    self._counters[fault.kind].inc()
                    log.warning(
                        "Chaos injected: %s (target %d) at step %d / %.1fs",
                        fault.kind, fault.target, step, elapsed,
                    )
                else:
                    fault.attempts += 1
                    if fault.attempts >= _MAX_ATTEMPTS:
                        fault.abandoned = True
                        log.error(
                            "Chaos fault %s (target %d) could not be "
                            "injected after %d attempts; abandoning it.",
                            fault.kind, fault.target, fault.attempts,
                        )
            if self.done():
                return

    # -- injectors --------------------------------------------------------
    def _native_pool_handle(self):
        with self._lock:
            return self._native_pool

    def _live_transport(self, target: int) -> Optional[FaultingTransport]:
        with self._lock:
            if not self._transports:
                return None
            if target in self._transports:
                return self._transports[target]
            return None

    def _inject(self, fault: FaultSpec) -> bool:
        kind = fault.kind
        if kind == "env_server_sigkill":
            with self._lock:
                sup = self._server_supervisor
            if sup is None or not getattr(sup, "processes", None):
                return False
            proc = sup.processes[fault.target % len(sup.processes)]
            if not proc.is_alive() or proc.pid is None:
                return False  # mid-respawn: retry next tick
            os.kill(proc.pid, signal.SIGKILL)
            return True
        if kind == "transport_sever":
            native = self._native_pool_handle()
            if native is not None:
                # C++ FaultHooks: shutdown(SHUT_RDWR) on the actor's
                # live transport; False while it is between connections
                # (retry next tick), same as the Python wrap path.
                return bool(native.chaos_sever(fault.target))
            t = self._live_transport(fault.target)
            if t is None:
                return False
            t.sever()
            return True
        if kind in ("transport_blackhole", "transport_delay"):
            native = self._native_pool_handle()
            if native is not None:
                return bool(native.chaos_window(
                    fault.target, kind, fault.duration_s, fault.delay_s
                ))
            if self._live_transport(fault.target) is None:
                return False
            with self._lock:
                self._windows[fault.target] = (
                    kind,
                    time.monotonic() + fault.duration_s,
                    fault.delay_s,
                )
            return True
        if kind in ("shm_corrupt_header", "shm_corrupt_payload"):
            header = kind == "shm_corrupt_header"
            native = self._native_pool_handle()
            if native is not None:
                # ShmRing::corrupt_tail_frame — poke parity with the
                # Python path below, tail-stability checked C++-side.
                return bool(native.chaos_corrupt_ring(
                    fault.target, header
                ))
            t = self._live_transport(fault.target)
            ring = t.recv_ring() if t is not None else None
            if ring is None:
                return False
            return _corrupt_ring(ring, header=header)
        if kind == "state_table_poison":
            with self._lock:
                table = self._state_table
            if table is None:
                return False
            table.poison()
            return True
        if kind == "learner_stall":
            # Armed unconditionally: the gate is pull-based (the driver
            # loops consult throttle()), so there is no handle to wait
            # for — the window simply starts now.
            with self._lock:
                self._stall_until = time.monotonic() + fault.duration_s
            return True
        if kind == "preempt_sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return True
        raise ValueError(f"Unknown fault kind {kind!r}")  # pragma: no cover


def _corrupt_ring(ring, header: bool) -> bool:
    """Stomp the frame queued at the ring's tail (False when the ring is
    momentarily empty — the controller retries next tick). Header
    corruption writes an impossible frame length, which the reader's
    next read_frame deterministically rejects as WireError; payload
    corruption flips bytes that decode may or may not notice.

    The post-stomp tail check confirms the bytes landed in a frame the
    reader had not CONSUMED — there remains a narrow window where the
    reader is inside read_frame with the pre-stomp header already
    latched, in which case the fault counts as injected but produces no
    WireError. Corruption faults are therefore injected-exact but only
    recovery-probable; plans that assert recovery == injected should
    use the sever/SIGKILL/poison classes (as chaos_run does)."""
    import struct

    cap = ring.capacity
    tail = ring._u64[ring._TAIL]
    head = ring._u64[ring._HEAD]
    if head - tail < 8:  # need a real frame, not just a marker
        return False
    pos = int(tail % cap)
    if cap - pos < 4:
        pos = 0  # implicit wrap: the frame starts at the ring base
    if header:
        # 0xDEADBEEF: not WRAP/INLINE, way past any sane length.
        # (Stomping a WRAP marker is equally observable: the reader
        # decodes the bogus length and rejects it.)
        ring.poke(pos, (0xDEADBEEF).to_bytes(4, "little"))
    else:
        (length,) = struct.unpack_from("<I", ring._data, pos)
        if length >= ring._INLINE:  # WRAP/INLINE marker: no payload here
            return False
        # Flip at most 4 payload bytes, clamped to the payload AND the
        # data region (a tiny frame near the ring end must not make the
        # poke slice run past either bound).
        n = min(4, int(length), cap - pos - 4)
        if n <= 0:
            return False
        ring.poke(pos + 4, b"\xa5\x5a\xa5\x5a"[:n])
    # If the reader consumed the frame while we were stomping, the bytes
    # landed in free space the producer will overwrite — the fault did
    # NOT observably fire; report failure so the controller retries.
    return ring._u64[ring._TAIL] == tail
