"""The port's chaos harness (torchbeast_tpu_torch/resilience/chaos.py)
and the recovery paths it drives: FaultPlan parsing and validation (and
one plan JSON parsed by both packages to the same specs and the same
due order), the ChaosController's injectors (the Python transport wrap,
the state table, the native pool's routing), the state table's rebuild
and the inference supervisor's recovery (its watcher included), the
chaos hooks of the port's C++ core (`_tbt_core_torch`), and short CPU
polybeast runs on the core under a plan: a SIGKILL above the live-actor
floor, attrition that degrades, a floor crossing that halts, and a
planned SIGTERM that checkpoints and exits under train()."""

import json
import os
import signal
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from torchbeast_tpu_torch import telemetry
from torchbeast_tpu_torch.resilience import (
    FAULT_KINDS,
    ChaosController,
    FaultPlan,
    FaultSpec,
    InferenceSupervisor,
    PipelineHealth,
)
from torchbeast_tpu_torch.runtime import native_build
from torchbeast_tpu_torch.telemetry import MetricsRegistry
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

PLAN = {
    "seed": 9,
    "faults": [
        {"kind": "env_server_sigkill", "at_step": 100, "target": 1},
        {"kind": "transport_sever", "at_step": 50, "target": 2},
        {"kind": "state_table_poison", "at_s": 3.5},
        {"kind": "learner_stall", "at_step": 75, "duration_s": 2.0},
        {"kind": "transport_delay", "at_s": 1.0, "target": 0,
         "duration_s": 0.5, "delay_s": 0.01},
        {"kind": "preempt_sigterm", "at_step": 10**6},
    ],
}


# ------------------------------------------------------------- FaultPlan


def test_plan_parses_like_the_reference(tmp_path):
    """One plan JSON through both packages: the same specs, counts and
    seed, and the same faults due, in the same order, at each (step,
    elapsed) tick of a schedule."""
    from torchbeast_tpu.resilience import FAULT_KINDS as JAX_KINDS
    from torchbeast_tpu.resilience import FaultPlan as JaxFaultPlan

    path = tmp_path / "plan.json"
    path.write_text(json.dumps(PLAN))
    ours, theirs = FaultPlan.from_json(str(path)), \
        JaxFaultPlan.from_json(str(path))
    assert FAULT_KINDS == JAX_KINDS
    assert ours.as_dict() == theirs.as_dict()
    assert ours.counts() == theirs.counts()
    assert ours.seed == theirs.seed == 9
    for step, elapsed in [(0, 0.0), (50, 0.5), (75, 1.0), (99, 3.4),
                          (100, 3.5), (10**6, 9.0)]:
        assert [f.as_dict() for f in ours.faults if f.due(step, elapsed)] \
            == [f.as_dict() for f in theirs.faults
                if f.due(step, elapsed)]
    for bad in ({"faults": [{"kind": "meteor_strike", "at_step": 1}]},
                {"faults": [{"kind": "transport_sever"}]},
                {"faults": [{"kind": "transport_sever", "at_step": 1,
                             "fired": True}]}):
        with pytest.raises(ValueError) as e_ours:
            FaultPlan.from_dict(bad)
        with pytest.raises(ValueError) as e_theirs:
            JaxFaultPlan.from_dict(bad)
        assert str(e_ours.value) == str(e_theirs.value)


def test_round_trip_and_counts(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"seed": 9, "faults": [
        {"kind": "env_server_sigkill", "at_step": 100},
        {"kind": "env_server_sigkill", "at_step": 200, "target": 1},
        {"kind": "state_table_poison", "at_s": 3.5}]}))
    plan = FaultPlan.from_json(str(path))
    assert plan.seed == 9
    assert plan.counts() == {"env_server_sigkill": 2,
                             "state_table_poison": 1}


@pytest.mark.parametrize("entry, match", [
    ({"kind": "meteor_strike", "at_step": 1}, "Unknown fault kind"),
    ({"kind": "transport_sever"}, "needs a trigger"),
    ({"kind": "transport_sever", "at_step": 1, "severity": 11},
     "unknown keys"),
    ({"kind": "transport_sever", "at_step": 1, "fired": True},
     "unknown keys"),
    ({"kind": "transport_sever", "at_step": 1, "abandoned": True},
     "unknown keys"),
    ({"kind": "transport_sever", "at_step": 1, "attempts": True},
     "unknown keys"),
])
def test_bad_plans_are_rejected(entry, match):
    with pytest.raises(ValueError, match=match):
        FaultPlan.from_dict({"faults": [entry]})


def test_due_semantics():
    by_step, by_time = FaultPlan.from_dict({"faults": [
        {"kind": "transport_sever", "at_step": 10},
        {"kind": "transport_sever", "at_s": 2.0}]}).faults
    assert not by_step.due(9, 100.0)
    assert by_step.due(10, 0.0)
    assert not by_time.due(10**9, 1.9)
    assert by_time.due(0, 2.0)


# ------------------------------------------------------- ChaosController


class _FakeSock:
    def __init__(self):
        self.shut = False

    def shutdown(self, how):
        self.shut = True


class _FakeTransport:
    def __init__(self):
        self._sock = _FakeSock()
        self.sent = []
        self.closed = False

    def send(self, value):
        self.sent.append(value)
        return 1

    def recv_sized(self):
        return {"type": "step"}, 1

    def close(self):
        self.closed = True


def _wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_step_triggered_sever_counts_exactly():
    reg = MetricsRegistry()
    plan = FaultPlan.from_dict({"seed": 1, "faults": [
        {"kind": "transport_sever", "at_step": 10, "target": 0}]})
    ctrl = ChaosController(plan, registry=reg, poll_interval_s=0.01)
    inner = _FakeTransport()
    wrapped = ctrl.wrap_transport(inner, 0)
    step = [0]
    ctrl.set_step_fn(lambda: step[0])
    ctrl.start()
    try:
        time.sleep(0.1)
        assert not inner._sock.shut  # not due yet
        step[0] = 10
        assert _wait_until(lambda: inner._sock.shut)
        assert _wait_until(ctrl.done)
        assert ctrl.injected_counts() == {"transport_sever": 1}
        assert telemetry.snapshot(reg)["counters"][
            "chaos.transport_sever.injected"] == 1.0
        assert ctrl.summary()["pending"] == []
    finally:
        ctrl.stop()
    wrapped.send({"x": 1})
    assert inner.sent == [{"x": 1}]
    wrapped.close()
    assert inner.closed
    assert ctrl._live_transport(0) is None


def test_sever_waits_for_a_live_transport():
    plan = FaultPlan.from_dict({"faults": [
        {"kind": "transport_sever", "at_step": 0, "target": 2}]})
    ctrl = ChaosController(plan, registry=MetricsRegistry(),
                           poll_interval_s=0.01)
    ctrl.start()
    try:
        time.sleep(0.1)
        assert ctrl.injected_counts() == {}
        inner = _FakeTransport()
        ctrl.wrap_transport(inner, 2)
        assert _wait_until(lambda: inner._sock.shut)
        assert ctrl.injected_counts() == {"transport_sever": 1}
    finally:
        ctrl.stop()


def test_state_table_poison_and_delay_window():
    class FakeTable:
        poisoned = False

        def poison(self):
            self.poisoned = True

    plan = FaultPlan.from_dict({"faults": [
        {"kind": "state_table_poison", "at_s": 0.0},
        {"kind": "transport_delay", "at_s": 0.0, "target": 0,
         "duration_s": 30.0, "delay_s": 0.05}]})
    ctrl = ChaosController(plan, registry=MetricsRegistry(),
                           poll_interval_s=0.01)
    table = FakeTable()
    ctrl.attach_state_table(table)
    wrapped = ctrl.wrap_transport(_FakeTransport(), 0)
    ctrl.start()
    try:
        assert _wait_until(ctrl.done)
        assert table.poisoned
        t0 = time.monotonic()
        wrapped.recv_sized()
        assert time.monotonic() - t0 >= 0.04  # the delay window
    finally:
        ctrl.stop()


def test_learner_stall_throttles_for_its_window():
    plan = FaultPlan.from_dict({"faults": [
        {"kind": "learner_stall", "at_step": 0, "duration_s": 0.3}]})
    ctrl = ChaosController(plan, registry=MetricsRegistry(),
                           poll_interval_s=0.01)
    ctrl.start()
    try:
        assert _wait_until(ctrl.done)
        t0 = time.monotonic()
        ctrl.throttle()
        assert 0.15 <= time.monotonic() - t0 < 2.0
        t0 = time.monotonic()
        ctrl.throttle()  # outside the window: no wait
        assert time.monotonic() - t0 < 0.05
    finally:
        ctrl.stop()


def test_shm_header_corruption_surfaces_as_wire_error():
    from torchbeast_tpu_torch.resilience.chaos import _corrupt_ring
    from torchbeast_tpu_torch.runtime import transport, wire

    server, client = transport.shm_pipe(obs_ring_bytes=1 << 16,
                                        act_ring_bytes=1 << 16)
    try:
        assert not _corrupt_ring(client._recv_ring, header=True)
        server.send({"type": "step", "frame": np.zeros(8)})
        assert _corrupt_ring(client._recv_ring, header=True)
        with pytest.raises(wire.WireError):
            client.recv_sized()
    finally:
        server.close()
        client.close()


class _FakeNativePool:
    def __init__(self, live=True):
        self.live = live
        self.calls = []

    def chaos_sever(self, actor):
        self.calls.append(("sever", actor))
        return self.live

    def chaos_window(self, actor, kind, duration_s, delay_s):
        self.calls.append(("window", actor, kind, duration_s, delay_s))
        return self.live

    def chaos_corrupt_ring(self, actor, header):
        self.calls.append(("corrupt", actor, header))
        return self.live


def _native_controller(pool):
    plan = FaultPlan([FaultSpec("transport_sever", at_step=1)])
    controller = ChaosController(plan, registry=MetricsRegistry())
    controller.attach_native_pool(pool)
    return controller


def test_transport_faults_route_to_the_native_pool():
    pool = _FakeNativePool()
    controller = _native_controller(pool)
    assert controller._inject(FaultSpec("transport_sever", at_step=1,
                                        target=2))
    assert controller._inject(FaultSpec("transport_delay", at_step=1,
                                        target=1, duration_s=0.5,
                                        delay_s=0.01))
    assert controller._inject(FaultSpec("shm_corrupt_header", at_step=1,
                                        target=0))
    assert controller._inject(FaultSpec("shm_corrupt_payload", at_step=1,
                                        target=3))
    assert pool.calls == [
        ("sever", 2),
        ("window", 1, "transport_delay", 0.5, 0.01),
        ("corrupt", 0, True),
        ("corrupt", 3, False),
    ]


def test_uninjectable_native_fault_reports_retry():
    controller = _native_controller(_FakeNativePool(live=False))
    assert not controller._inject(FaultSpec("transport_sever", at_step=1))
    assert not controller._inject(FaultSpec("shm_corrupt_header",
                                            at_step=1))


def test_chaos_run_flags_track_the_driver():
    """The resilience flags chaos_run forwards keep polybeast's defaults;
    --learner_stall_timeout_s is the documented divergence."""
    from torchbeast_tpu_torch import chaos_run, polybeast

    poly = polybeast.make_parser()
    harness = chaos_run.parse_args([])
    for flag in ("min_live_actors", "inference_restart_budget",
                 "max_actor_reconnects", "max_policy_lag",
                 "admission_depth_factor", "replica_refresh_updates"):
        assert getattr(harness, flag) == poly.get_default(flag), flag
    assert harness.learner_stall_timeout_s == 60.0


# ---------------------------------------- state table + InferenceSupervisor

H = 3


def _make_table(num_slots=2):
    from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable

    def act(ctx, env, state):
        new = state + env["frame"][..., None]  # [1, B, H]
        return {"out": new.sum(-1)}, new

    return DeviceStateTable(torch.zeros((1, 1, H)), num_slots=num_slots,
                            act_fn=act, batch_dim=1)


def _env(vals):
    return {"frame": np.asarray(vals, np.float32)[None]}


def test_rebuild_unpoisons_and_resets_slots():
    from torchbeast_tpu_torch.runtime.errors import StateTablePoisonedError

    table = _make_table()
    table.step(np.asarray([0], np.int32), np.ones(1, bool), _env([2.0]))
    assert np.asarray(table.read_slot(0)).reshape(-1).tolist() == [2.0] * H
    table.poison()
    assert table.poisoned
    with pytest.raises(StateTablePoisonedError):
        table.read_slot(0)
    table.rebuild()
    assert not table.poisoned
    assert np.asarray(table.read_slot(0)).reshape(-1).tolist() == [0.0] * H


def _supervised(table, budget):
    from torchbeast_tpu_torch.runtime.inference import inference_loop
    from torchbeast_tpu_torch.runtime.queues import DynamicBatcher

    batcher = DynamicBatcher(batch_dim=1, timeout_ms=10)
    reg = MetricsRegistry()
    health = PipelineHealth(registry=reg)
    sup = InferenceSupervisor(
        lambda: inference_loop(batcher, None, 4, state_table=table),
        num_threads=1, state_table=table, restart_budget=budget,
        health=health, registry=reg)
    sup.start()
    return batcher, reg, health, sup


def _compute(batcher, slot):
    out = batcher.compute({
        "env": _env([1.0]),
        "slot": np.full((1, 1), slot, np.int32),
        "advance": np.full((1, 1), True, bool),
    })
    return float(np.asarray(out["outputs"]["out"]).reshape(()))


def test_supervisor_recovers_serving_after_poison():
    from torchbeast_tpu_torch.runtime.queues import AsyncError

    table = _make_table()
    batcher, reg, health, sup = _supervised(table, budget=2)
    try:
        assert _compute(batcher, 0) == H * 1.0
        assert _compute(batcher, 0) == H * 2.0
        table.poison()
        recovered = None
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            try:
                recovered = _compute(batcher, 0)
                break
            except AsyncError:
                time.sleep(0.05)
        assert recovered == H * 1.0  # the rebuilt slot restarted
        assert sup.restarts == 1
        assert health.state_name == "HEALTHY"
        counters = telemetry.snapshot(reg)["counters"]
        assert counters["recovery.table_rebuilds"] == 1.0
        assert counters["recovery.inference_restarts"] == 1.0
    finally:
        batcher.close()
        sup.join(timeout=10)
    assert sup.alive_count() == 0
    assert sup.errors == []


def test_watcher_rebuilds_a_table_no_request_meets():
    """A poison while no request is in flight (every actor at an unroll
    boundary): the supervisor's watcher rebuilds the table once, with
    the same counters as a serving thread's recovery."""
    table = _make_table()
    batcher, reg, health, sup = _supervised(table, budget=2)
    try:
        assert _compute(batcher, 1) == H * 1.0
        table.poison()
        assert _wait_until(lambda: not table.poisoned)
        assert sup.restarts == 1
        counters = telemetry.snapshot(reg)["counters"]
        assert counters["recovery.table_rebuilds"] == 1.0
        assert _compute(batcher, 1) == H * 1.0
    finally:
        batcher.close()
        sup.join(timeout=10)
    assert sup.errors == []


def test_budget_exhaustion_halts():
    table = _make_table()
    batcher, reg, health, sup = _supervised(table, budget=0)
    table.poison()
    try:
        assert health.halted.wait(timeout=20)
        assert health.state_name == "HALTED"
        assert sup.restarts == 0
    finally:
        batcher.close()
        sup.join(timeout=10)


# ----------------------------------------------------- the port's C++ core


@pytest.fixture(scope="module")
def core():
    try:
        native_build.check_toolchain()
    except native_build.NativeBuildError as e:
        pytest.skip(str(e))
    return native_build.load()


def test_native_chaos_sever_forces_one_recovery(core):
    from tests.test_torch_native import _Pool, _start_server

    path = os.path.join(tempfile.mkdtemp(), "chaos_sever")
    server = _start_server(core, f"unix:{path}")
    # A learner queue of one: take(3) below then holds at least one
    # rollout of the recovered stream, not only rollouts the actor queued
    # before the sever while the test thread was slow.
    pool = _Pool(core, "native", f"unix:{path}", max_reconnects=3,
                 fault_hooks=True, queue_size=1)
    try:
        pool.take(1)  # the stream is live
        assert pool.pool.chaos_sever(0) is True
        pool.take(3)  # the pool recovers and keeps streaming
        assert pool.pool.reconnect_count() == 1
        assert list(pool.pool.errors) == []
        assert pool.pool.chaos_window(0, "transport_delay", 0.2,
                                      0.001) is True
        with pytest.raises(ValueError):
            pool.pool.chaos_window(0, "transport_teleport")
        # Ring corruption needs an shm transport: False here (retry).
        assert pool.pool.chaos_corrupt_ring(0, header=True) is False
    finally:
        pool.close()
        server.stop()


def test_native_chaos_requires_armed_pool(core):
    queue = core.BatchingQueue(batch_dim=1, minimum_batch_size=1)
    batcher = core.DynamicBatcher(batch_dim=1)
    kwargs = dict(unroll_length=3, learner_queue=queue,
                  inference_batcher=batcher, env_server_addresses=[],
                  initial_agent_state={})
    with pytest.raises(ValueError, match="fault_hooks"):
        core.ActorPool(**kwargs).chaos_sever(0)
    armed = core.ActorPool(fault_hooks=True, **kwargs)
    assert armed.chaos_sever(0) is False
    assert armed.chaos_window(0, "transport_blackhole", 0.1) is False
    assert armed.chaos_corrupt_ring(0) is False
    queue.close()
    batcher.close()


def test_native_chaos_corrupt_shm_ring_lands(core):
    from tests.test_torch_native import _Pool, _start_server

    path = os.path.join(tempfile.mkdtemp(), "chaos_ring")
    server = _start_server(core, f"shm:{path}")
    pool = _Pool(core, "native", f"shm:{path}", max_reconnects=3,
                 fault_hooks=True)
    try:
        pool.take(1)
        injected = False
        deadline = time.monotonic() + 10
        while not injected and time.monotonic() < deadline:
            injected = pool.pool.chaos_corrupt_ring(0, header=True)
            if not injected:
                time.sleep(0.0005)  # the ring momentarily empty: retry
        assert injected
        pool.take(3)  # still streaming (reconnected or unharmed)
        assert list(pool.pool.errors) == []
        assert pool.pool.reconnect_count() in (0, 1)
    finally:
        pool.close()
        server.stop()


def _poly(tmp_path, xpid, plan, *extra):
    from torchbeast_tpu_torch import polybeast

    plan_path = tmp_path / f"{xpid}.json"
    plan_path.write_text(json.dumps(plan))
    return polybeast.train(polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "shallow",
        "--num_servers", "2", "--batch_size", "2", "--unroll_length", "5",
        "--savedir", str(tmp_path), "--xpid", xpid, "--pipes_basename",
        f"unix:{tmp_path}/{xpid}", "--num_inference_threads", "1",
        "--max_inference_batch_size", "4", "--checkpoint_interval_s",
        "100000", "--native_runtime", "--chaos_plan", str(plan_path),
        *extra]))


def test_native_sigkill_above_floor_recovers(core, tmp_path):
    """A supervised env-server SIGKILL on the core: the server respawns,
    the actor reconnects, the run completes, and the recovery counts
    are exactly one respawn and one reconnect."""
    stats = _poly(tmp_path, "above-floor", {"seed": 7, "faults": [
        {"kind": "env_server_sigkill", "at_step": 100, "target": 0}]},
        "--total_steps", "400", "--min_live_actors", "1")
    assert stats["step"] >= 400
    assert stats["health"] in ("HEALTHY", "DEGRADED")
    assert stats["chaos"]["injected"] == {"env_server_sigkill": 1}
    assert stats["server_restarts"] == 1
    assert stats["actor_reconnects"] == 1
    assert stats["runtime"] == "native"


def test_native_attrition_degrades_above_floor(core, tmp_path):
    """One of two servers killed for good: its actor retires, the run
    stays DEGRADED (attrition is sticky) and completes on the other (a
    run long enough for a 5 s monitor tick to see the retirement)."""
    stats = _poly(tmp_path, "degraded", {"seed": 7, "faults": [
        {"kind": "env_server_sigkill", "at_step": 100, "target": 0}]},
        "--total_steps", "1600", "--min_live_actors", "1",
        "--max_server_restarts", "0", "--max_actor_reconnects", "1",
        "--actor_connect_timeout_s", "2")
    assert stats["step"] >= 1600
    assert stats["health"] == "DEGRADED"
    assert any("retired" in reason for _, reason in stats["health_reasons"])


def test_native_floor_crossing_halts_cleanly(core, tmp_path):
    """Both servers killed for good: both actors retire, live actors
    cross the floor, and the run checkpoints and exits HALTED."""
    stats = _poly(tmp_path, "halted", {"seed": 7, "faults": [
        {"kind": "env_server_sigkill", "at_step": 100, "target": 0},
        {"kind": "env_server_sigkill", "at_step": 100, "target": 1}]},
        "--total_steps", "100000000", "--min_live_actors", "1",
        "--max_server_restarts", "0", "--max_actor_reconnects", "1",
        "--actor_connect_timeout_s", "2")
    assert stats["health"] == "HALTED"
    assert any("below --min_live_actors" in reason
               for _, reason in stats["health_reasons"])
    assert (tmp_path / "halted" / "model.ckpt").exists()


def test_planned_sigterm_checkpoints_under_train(core, tmp_path):
    """preempt_sigterm under an in-process train() takes the driver's
    checkpoint-and-exit path (not only under cli()), and the SIGTERM
    handler is put back after the run."""
    assert threading.current_thread() is threading.main_thread()
    before = signal.getsignal(signal.SIGTERM)
    stats = _poly(tmp_path, "preempted", {"seed": 7, "faults": [
        {"kind": "preempt_sigterm", "at_step": 100}]},
        "--total_steps", "100000000")
    assert stats["chaos"]["injected"] == {"preempt_sigterm": 1}
    assert 100 <= stats["step"] < 100000000
    assert (tmp_path / "preempted" / "model.ckpt").exists()
    assert signal.getsignal(signal.SIGTERM) is before
