"""Actor pool: N concurrent loops streaming env steps through dynamic
inference batching into the learner queue.

The reference's C++ `ActorPool` (torchbeast's src/cc/actorpool.cc:342-564)
re-designed for the framed-socket transport: each actor loop connects to an
env-server address, reads the initial Step, and then repeats
  compute(env_outputs, agent_state) -> action
  send(action) -> recv(next Step)
accumulating unroll_length+1 steps per rollout with the same invariants as
the sync collector (rollout.py): overlap-by-one (the last step of rollout k
is slot 0 of rollout k+1, actorpool.cc:414,443), agent-output pairing, and
agent-state carry with `initial_agent_state` captured at rollout entry
(actorpool.cc:449).

Rollouts are enqueued as (rollout_nest, initial_agent_state) onto the
learner BatchingQueue batched along time dim 0 with a [T+1, 1, ...] layout,
so the queue's batch_dim=1 concatenation yields [T+1, B, ...] learner
batches (reference actorpool.cc:443-447, polybeast_learner.py:306).

Threads instead of std::async tasks: the loops spend their time blocked in
socket IO and in compute() (both release the GIL); the C++ pool in csrc/
takes over when Python-thread overhead shows up in profiles.

The port's copy of torchbeast_tpu/runtime/actor_pool.py.
"""

import logging
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np

from torchbeast_tpu_torch import nest
from torchbeast_tpu_torch import telemetry
from torchbeast_tpu_torch.resilience.backoff import Backoff
from torchbeast_tpu_torch.runtime import transport as transport_lib
from torchbeast_tpu_torch.runtime import wire
from torchbeast_tpu_torch.runtime.errors import ShedError, StateTablePoisonedError
from torchbeast_tpu_torch.runtime.queues import (
    AsyncError,
    BatchingQueue,
    ClosedBatchingQueue,
    DynamicBatcher,
)

log = logging.getLogger(__name__)

_ENV_KEYS = (
    "frame", "reward", "done", "episode_step", "episode_return",
    "last_action",
)


class ActorPool:
    def __init__(
        self,
        unroll_length: int,
        learner_queue: BatchingQueue,
        inference_batcher: DynamicBatcher,
        env_server_addresses: List[str],
        initial_agent_state: Any,
        connect_timeout_s: float = 600,
        max_reconnects: int = 3,
        state_table=None,
        max_frame_bytes: Optional[int] = None,
        backoff_factory: Optional[Callable[[], Backoff]] = None,
        transport_wrap: Optional[Callable] = None,
        shed_backoff_factory: Optional[Callable[[], Backoff]] = None,
        slo_target_s: Optional[float] = None,
        record_policy_lag: bool = False,
    ):
        self._unroll_length = unroll_length
        self._learner_queue = learner_queue
        self._inference_batcher = inference_batcher
        self._addresses = list(env_server_addresses)
        self._initial_agent_state = initial_agent_state
        self._connect_timeout_s = connect_timeout_s
        self._max_frame_bytes = max_frame_bytes
        # Device-resident agent state (runtime/state_table.py): actor i
        # owns table slot i; requests carry {"slot", "advance"} instead
        # of agent_state, replies carry outputs only, and the rollout-
        # boundary initial_agent_state comes from a once-per-unroll
        # read_slot fetch instead of riding every reply.
        self._state_table = state_table
        if state_table is not None and state_table.num_slots < len(
            self._addresses
        ):
            raise ValueError(
                f"state table has {state_table.num_slots} slots for "
                f"{len(self._addresses)} actors"
            )
        # Elastic actors (beyond the reference's fail-fast): on a TRANSPORT
        # failure (env-server death / stream cut) or a failed inference
        # batch (a recovering serving thread), an actor may retry up to
        # max_reconnects times with a fresh env + reset agent state
        # (the partial rollout is discarded; learner batches stay valid).
        # Retries go through jittered exponential backoff — a dead
        # server must not be re-dialed in a tight loop, and a mass
        # server restart must not thundering-herd the fresh listener.
        # Deterministic env errors (error frames) remain fatal.
        self._max_reconnects = max_reconnects
        self._backoff_factory = backoff_factory or (
            lambda: Backoff(base_s=0.1, cap_s=2.0)
        )
        # Chaos hook (resilience/chaos.py): wraps every fresh transport
        # so the fault plan can sever/delay/corrupt it mid-stream.
        self._transport_wrap = transport_wrap
        # Shed handling: a ShedError from compute() is FLOW
        # CONTROL, not a failure — the SAME env step is re-submitted
        # after a jittered backoff, outside the reconnect budget, so a
        # shed can never retire an actor or lose a rollout. The backoff
        # starts smaller than the reconnect one (overload drains in
        # batches, not in server-restart time) and resets per request.
        self._shed_backoff_factory = shed_backoff_factory or (
            lambda: Backoff(base_s=0.05, cap_s=1.0)
        )
        # Per-connection SLO: RTTs above the
        # target count as breaches; the driver exports {target, p99,
        # breaches} as the `slo` block on every telemetry line — the
        # same number the shed gate's deadline uses.
        self._slo_target_s = slo_target_s
        # Replica serving (serving/replica.py): replies served from a
        # snapshot carry a policy_lag leaf; central-path replies don't.
        # Normalizing the missing leaf to 0 keeps rollouts that mix
        # both paths structurally uniform for the learner queue.
        self._record_policy_lag = record_policy_lag
        self._count = 0  # guarded-by: self._count_lock
        self._reconnects = 0  # guarded-by: self._count_lock
        self._dead = 0  # guarded-by: self._count_lock
        self._count_lock = threading.Lock()
        # Appended by N actor threads, read by the pool runner and the
        # driver monitor (RACE burn-down).
        self._errors: List[BaseException] = []  # guarded-by: self._count_lock
        # Per-connection wire accounting + request RTT.
        # "up" = env-server -> this process (observations rising toward
        # the learner), "down" = actions back out — the same direction
        # convention as polybeast's per-step acting-path gauges.
        reg = telemetry.get_registry()
        self._tm_bytes_up = reg.counter("wire.bytes_up")
        self._tm_bytes_down = reg.counter("wire.bytes_down")
        self._tm_rtt = reg.histogram("actor.request_rtt_s")
        self._tm_steps = reg.counter("actor.env_steps")
        self._tm_connects = reg.counter("actor.connects")
        # Recovery accounting: the chaos harness asserts these
        # against the injected fault counts, so each counter covers ONE
        # failure class — transport failures (reconnects) and failed
        # inference batches (rollout retries) never share a series.
        self._tm_reconnects = reg.counter("recovery.actor_reconnects")
        self._tm_retries = reg.counter("recovery.batch_retries")
        # Shed accounting twin (serving/admission.py): incremented once
        # per ShedError received, so serving.resubmitted ==
        # serving.shed + serving.expired holds exactly — the invariant
        # chaos_run asserts to prove a shed is never a lost rollout.
        self._tm_resubmits = reg.counter("serving.resubmitted")
        self._tm_slo_breaches = reg.counter("slo.rtt_breaches")
        self._tracer = telemetry.get_tracer()
        # Sampled per-request pipeline traces: one in _TRACE_EVERY
        # computes rides a StageTrace through the batcher (enqueue ->
        # batch -> reply), bounding trace overhead on the hot path.
        self._trace_tick = 0
        # The C++ batcher's compute() has no trace parameter; only the
        # Python DynamicBatcher threads StageTraces through.
        self._traceable = isinstance(inference_batcher, DynamicBatcher)

    _TRACE_EVERY = 256

    def count(self) -> int:
        """Total env steps taken (reference actorpool.cc:478,557)."""
        with self._count_lock:
            return self._count

    @property
    def errors(self) -> List[BaseException]:
        with self._count_lock:
            return list(self._errors)

    @property
    def reconnects(self) -> int:
        """COMPLETED recoveries (the stream re-established AND
        delivering again), not granted retry attempts — a recovery
        that needs several dials (a stale socket file, a mid-respawn
        handshake) counts ONCE, which is what lets chaos_run assert
        reconnects == injected faults exactly on both runtimes (the C++
        pool shares this contract)."""
        with self._count_lock:
            return self._reconnects

    def reconnect_count(self) -> int:
        """Method form matching the native pool's API."""
        return self.reconnects

    def live_actors(self) -> int:
        """Actor loops still running. The driver's health machine runs
        DEGRADED while this stays >= --min_live_actors and halts (clean
        checkpoint-and-exit) below it."""
        with self._count_lock:
            return len(self._addresses) - self._dead

    def run(self):
        """Run one loop per address; blocks until all exit. First error is
        re-raised (reference surfaces only the first future's exception,
        actorpool.cc:470-475)."""
        threads = [
            threading.Thread(
                target=self._guarded_loop, args=(i, addr), daemon=True
            )
            for i, addr in enumerate(self._addresses)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with self._count_lock:
            errors = list(self._errors)
        if errors:
            raise errors[0]

    def _guarded_loop(self, index: int, address: str):
        try:
            self._recovering_loop(index, address)
        finally:
            # Any exit — clean shutdown or a burned budget — retires
            # this actor; live_actors() feeds the health machine.
            with self._count_lock:
                self._dead += 1

    def _shutting_down(self) -> bool:
        return (
            self._inference_batcher.is_closed()
            or self._learner_queue.is_closed()
        )

    def _recovering_loop(self, index: int, address: str):
        failures = 0  # transport failures + batch retries, refillable
        backoff = self._backoff_factory()
        progress = [0]  # this actor's env steps (across reconnects)
        # A granted transport retry is COUNTED only once the new stream
        # delivers (the initial step lands, _loop clears the flag) —
        # attempts that die before streaming are budget, not
        # recoveries (see the `reconnects` property contract).
        reconnect_pending = [False]
        while True:
            steps_at_connect = progress[0]
            try:
                self._loop(index, address, progress, reconnect_pending)
                return
            except ClosedBatchingQueue:
                return  # clean shutdown (reference actorpool.cc:452-459)
            except (AsyncError, ShedError, StateTablePoisonedError) as e:
                # ShedError only escapes _request's in-place retry when
                # the pipeline is already closing (re-raised there);
                # the _shutting_down() check below turns it into the
                # clean exit it is.
                # A broken inference promise mid-training — or a DIRECT
                # table call (the unroll-boundary read_slot, the
                # connect-time reset) landing inside the poison-to-
                # rebuild window. During shutdown that's expected;
                # otherwise the failure may come from a RECOVERING
                # serving thread (state-table rebuild) — discard the
                # partial rollout and retry the stream under the same
                # budget/backoff as a reconnect, instead of retiring
                # the actor for good.
                if self._shutting_down():
                    return
                if progress[0] - steps_at_connect >= self._unroll_length:
                    failures = 0
                    backoff.reset()
                if failures < self._max_reconnects:
                    failures += 1
                    self._tm_retries.inc()
                    delay = backoff.sleep()
                    log.warning(
                        "Actor %d (%s): inference/state-table failure "
                        "(%s); retry %d/%d after %.2fs backoff",
                        index, address, e, failures,
                        self._max_reconnects, delay,
                    )
                    continue
                log.exception("Actor %d (%s) failed", index, address)
                with self._count_lock:
                    self._errors.append(e)
                return
            except (ConnectionError, TimeoutError, OSError,
                    wire.WireError) as e:
                # Transport failure: the env server died or the stream was
                # cut. During pipeline shutdown that's expected — exit
                # cleanly instead of burning the reconnect budget against
                # deliberately-stopped servers.
                if self._shutting_down():
                    return
                # A full recovery (at least one unroll streamed since the
                # last connect) earns the budget back — long runs survive
                # any number of spaced-out server redeploys.
                if progress[0] - steps_at_connect >= self._unroll_length:
                    failures = 0
                    backoff.reset()
                if failures < self._max_reconnects:
                    failures += 1
                    reconnect_pending[0] = True
                    delay = backoff.sleep()
                    log.warning(
                        "Actor %d (%s): transport failure (%s); "
                        "reconnect %d/%d after %.2fs backoff",
                        index, address, e, failures,
                        self._max_reconnects, delay,
                    )
                    continue
                log.exception("Actor %d (%s) failed", index, address)
                with self._count_lock:
                    self._errors.append(e)
                return
            except BaseException as e:  # noqa: BLE001
                log.exception("Actor %d (%s) failed", index, address)
                with self._count_lock:
                    self._errors.append(e)
                return

    def _connect(self, address: str, index: int):
        """Transport connect with retries until the deadline (the
        reference's 10-minute WaitForConnected semantics,
        actorpool.cc:354-372) — SocketTransport for tcp/unix addresses,
        ShmTransport (handshaken rings) for shm://. The chaos wrap (if
        armed) goes on here so injected faults see every connection,
        including post-reconnect ones."""
        sock = transport_lib.connect_transport(
            address, timeout_s=self._connect_timeout_s,
            max_frame_bytes=self._max_frame_bytes,
        )
        if self._transport_wrap is not None:
            sock = self._transport_wrap(sock, index)
        return sock

    @staticmethod
    def _env_outputs(msg) -> dict:
        if msg is None:
            raise ConnectionError("Env server closed the stream")
        if msg.get("type") == "error":
            raise RuntimeError(f"Env server error: {msg.get('message')}")
        # [T=1, B=1] leading dims so rollout stacking and queue batching
        # are pure concatenations (reference array_pb_to_nest prepends
        # [1, 1], actorpool.cc:480-491).
        # COPY, not view: decoded arrays alias the transport's reusable
        # receive buffer (RecvBuffer / shm ring), which the next recv on
        # this connection overwrites — while the rollout keeps these
        # steps alive for unroll_length receives (wire.py lifetime rule).
        return {
            k: np.asarray(msg[k])[None, None].copy() for k in _ENV_KEYS
        }

    def _recv_step(self, stream):
        msg, nbytes = stream.recv_sized()
        self._tm_bytes_up.inc(nbytes)
        return self._env_outputs(msg)

    def _loop(self, index: int, address: str, progress=None,
              reconnect_pending=None):
        progress = progress if progress is not None else [0]
        reconnect_pending = (
            reconnect_pending if reconnect_pending is not None else [False]
        )
        table = self._state_table
        sock = self._connect(address, index)
        self._tm_connects.inc()
        try:
            if table is not None:
                # Fresh stream => fresh recurrent state. This also covers
                # reconnects: the partial rollout was discarded, so the
                # slot must restart from the initial state.
                table.reset([index])
                initial_agent_state = table.initial_state_host
            else:
                initial_agent_state = self._initial_agent_state
            env_outputs = self._recv_step(sock)
            if reconnect_pending[0]:
                # The stream is re-established AND delivering: the
                # granted retry counts as a completed recovery now.
                reconnect_pending[0] = False
                with self._count_lock:
                    self._reconnects += 1
                self._tm_reconnects.inc()
            agent_state = self._initial_agent_state
            agent_outputs, agent_state = self._compute(
                index, env_outputs, agent_state, advance=False
            )
            rollout = [(env_outputs, agent_outputs)]
            while True:
                agent_outputs, agent_state = self._compute(
                    index, env_outputs, agent_state, advance=True
                )
                action = int(np.asarray(agent_outputs["action"]).reshape(()))
                self._tm_bytes_down.inc(
                    sock.send({"type": "action", "action": action})
                )
                env_outputs = self._recv_step(sock)
                progress[0] += 1
                self._tm_steps.inc()
                with self._count_lock:
                    self._count += 1
                rollout.append((env_outputs, agent_outputs))
                if len(rollout) == self._unroll_length + 1:
                    self._enqueue_rollout(rollout, initial_agent_state)
                    rollout = [rollout[-1]]  # overlap-by-one
                    # Boundary state for the NEXT rollout: with a state
                    # table, one read_slot fetch per unroll (the only
                    # time agent state crosses the host boundary);
                    # legacy mode carries it from the last reply.
                    if table is not None:
                        initial_agent_state = table.read_slot(index)
                    else:
                        initial_agent_state = agent_state
        finally:
            # shm connections: unlink the ring segments on every
            # teardown. A SIGKILL'd env server can't clean up its own
            # segments (/dev/shm would fill across chaos cycles); for a
            # live server this merely pre-empts the unlink its stream
            # teardown does anyway (rings are per-connection, never
            # re-attached — see ShmRing.unlink).
            try:
                sweep = getattr(sock, "unlink_segments", None)
                if sweep is not None:
                    sweep()
            finally:
                sock.close()

    def _request(self, inputs, index: int):
        """One batcher round-trip with RTT telemetry and a sampled
        per-request StageTrace (enqueue -> batch -> reply).

        Shed contract: a ShedError reply — the admission
        gate refused the request at enqueue, or its deadline expired in
        the queue — re-submits the SAME inputs after a jittered
        backoff, forever (overload is transient by construction: the
        gate sheds to protect drain rate). Shutdown cuts the loop via
        ClosedBatchingQueue from compute() or the re-raised ShedError
        when the pipeline is already closing. RTT and SLO breaches are
        observed for SERVED requests only — a shed's fast rejection
        must not read as a latency win."""
        trace = None
        if self._traceable:
            # beastlint: disable=RACE  sampling cadence, not an exact count: N actor threads may lose increments, which only shifts WHICH request gets traced
            self._trace_tick += 1
            if self._trace_tick % self._TRACE_EVERY == 0:
                trace = self._tracer.stage("actor.request", actor=index)
        shed_backoff = None
        while True:
            t0 = time.perf_counter()
            try:
                if trace is not None:
                    outputs = self._inference_batcher.compute(
                        inputs, trace=trace
                    )
                else:
                    outputs = self._inference_batcher.compute(inputs)
            except ShedError as e:
                # Counted BEFORE any early exit: every ShedError raised
                # is counted exactly once, which is what makes the
                # resubmitted == shed + expired audit exact.
                self._tm_resubmits.inc()
                if trace is not None:
                    if not getattr(e, "expired", False):
                        # Admission-path shed: the trace never entered
                        # the queue; close it here. (Expired sheds were
                        # finished by the batcher's dequeue gate.)
                        trace.stamp("shed")
                    trace.finish()
                    trace = None
                if self._shutting_down():
                    raise
                if shed_backoff is None:
                    shed_backoff = self._shed_backoff_factory()
                # Sliced sleep so shutdown never waits out a backoff
                # (the C++ twin's abort_shed callback, actor_pool.h);
                # a shutdown mid-sleep falls through to compute(),
                # which raises ClosedBatchingQueue -> clean exit.
                deadline = time.monotonic() + shed_backoff.next_delay()
                while (
                    time.monotonic() < deadline
                    and not self._shutting_down()
                ):
                    time.sleep(0.05)
                continue
            rtt = time.perf_counter() - t0
            self._tm_rtt.observe(rtt)
            if (
                self._slo_target_s is not None
                and rtt > self._slo_target_s
            ):
                self._tm_slo_breaches.inc()
            return outputs

    def _normalize_lag(self, agent_outputs):
        """Central-path replies carry no policy_lag leaf; replicas tag
        theirs. With lag recording on, default the missing leaf to 0 so
        a rollout mixing both serving paths stacks uniformly."""
        if (
            self._record_policy_lag
            and "policy_lag" not in agent_outputs
        ):
            agent_outputs["policy_lag"] = np.zeros((1, 1), np.int32)
        return agent_outputs

    def _compute(self, index: int, env_outputs, agent_state, advance: bool):
        if self._state_table is not None:
            # [1, 1]-shaped ids so queue batching along batch_dim=1
            # concatenates them like every other leaf.
            outputs = self._request(
                {
                    "env": env_outputs,
                    "slot": np.full((1, 1), index, np.int32),
                    "advance": np.full((1, 1), advance, bool),
                },
                index,
            )
            return self._normalize_lag(outputs["outputs"]), agent_state
        outputs = self._request(
            {"env": env_outputs, "agent_state": agent_state}, index
        )
        new_state = outputs["agent_state"]
        agent_outputs = self._normalize_lag(outputs["outputs"])
        if not advance:
            new_state = agent_state
        return agent_outputs, new_state

    def _enqueue_rollout(self, rollout, initial_agent_state):
        env_steps = [env for env, _ in rollout]
        agent_steps = [agent for _, agent in rollout]
        stacked = {
            k: np.concatenate([s[k] for s in env_steps], axis=0)
            for k in _ENV_KEYS
        }
        for key in agent_steps[0]:
            stacked[key] = np.concatenate(
                [np.asarray(s[key]) for s in agent_steps], axis=0
            )
        self._learner_queue.enqueue(
            {"batch": stacked, "initial_agent_state": initial_agent_state}
        )
