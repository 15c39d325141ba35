"""The port's serving tier (torchbeast_tpu_torch/serving/) against the
JAX package's: the admission controller's gates and its decisions over a
seeded arrival sequence in both packages, the shed/retry no-lost-rollout
contract through the port's Python pool, the snapshot store's bf16 bits
(equal to `astype(jnp.bfloat16)`, NaN and +-inf included) and dtype
restore, the replica hooks' lag stamps and health gate, both routers,
the core's admission gate, and the state table's replica step, bit for
bit equal to a central step on the bf16-rounded params."""

import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from torchbeast_tpu_torch import nest, telemetry
from torchbeast_tpu_torch.envs import CountingEnv
from torchbeast_tpu_torch.resilience.supervisor import PipelineHealth
from torchbeast_tpu_torch.runtime import native_build
from torchbeast_tpu_torch.runtime.actor_pool import ActorPool
from torchbeast_tpu_torch.runtime.env_server import EnvServer
from torchbeast_tpu_torch.runtime.errors import ShedError
from torchbeast_tpu_torch.runtime.inference import inference_loop
from torchbeast_tpu_torch.runtime.queues import (
    AsyncError,
    BatchingQueue,
    DynamicBatcher,
)
from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable
from torchbeast_tpu_torch.serving import (
    AdmissionController,
    PolicySnapshotStore,
    ReplicaRouter,
    ReplicaServingHooks,
    bf16_cast,
)
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

EPISODE_LEN = 5
T = 3


def _registry():
    return telemetry.MetricsRegistry()


# ------------------------------------------------------ AdmissionController


def test_admission_depth_gate_sheds():
    adm = AdmissionController(deadline_ms=1000, max_queue_depth=2,
                              registry=_registry())
    assert adm.admit(0) is not None  # absolute deadline returned
    assert adm.admit(1) is not None
    with pytest.raises(ShedError) as e:
        adm.admit(2)
    assert not e.value.expired
    assert adm.counts() == {"admitted": 2, "shed": 1, "expired": 0}


def test_admission_deadline_disarmed_returns_none():
    adm = AdmissionController(deadline_ms=0, max_queue_depth=4,
                              registry=_registry())
    assert adm.deadline_s is None
    assert adm.admit(0) is None


def test_admission_split_expired_and_slo_gauges():
    reg = _registry()
    adm = AdmissionController(deadline_ms=50, registry=reg)
    now = time.perf_counter()
    deadlines = [now - 1.0, now + 10.0, now - 0.5, None]
    enqueued = [now - 1.1, now - 0.01, now - 0.6, now - 0.2]
    live, expired = adm.split_expired(deadlines, enqueued)
    assert live == [1, 3] and expired == [0, 2]
    assert adm.counts()["expired"] == 2
    assert reg.histogram("serving.queue_delay_s").count == 4
    adm.refresh_gauges()
    p99 = reg.gauge("serving.queue_delay_p99_s").value()
    assert p99 > 0
    assert reg.gauge("serving.slo_ratio").value() == pytest.approx(
        p99 / 0.05)
    err = adm.expired_error()
    assert isinstance(err, ShedError) and err.expired


def test_admission_decisions_match_the_reference():
    """A seeded arrival sequence (queue depths at enqueue, then batches
    of deadlines at dequeue) through both packages' controllers: the
    same sheds, the same expiries, the same counts and the same
    queue-delay histogram counts."""
    from torchbeast_tpu import telemetry as jax_telemetry
    from torchbeast_tpu.runtime.errors import ShedError as JaxShedError
    from torchbeast_tpu.serving import AdmissionController as JaxAdmission

    rng = np.random.default_rng(0)
    depths = rng.integers(0, 12, size=200)
    ours = AdmissionController(deadline_ms=40, max_queue_depth=8,
                               registry=_registry())
    theirs = JaxAdmission(deadline_ms=40, max_queue_depth=8,
                          registry=jax_telemetry.MetricsRegistry())
    decisions = []
    for depth in depths:
        row = []
        for adm, shed_type in ((ours, ShedError), (theirs, JaxShedError)):
            try:
                row.append(adm.admit(int(depth)) is not None)
            except shed_type as e:
                row.append(("shed", e.expired))
        decisions.append(row)
    assert all(a == b for a, b in decisions)
    assert sum(isinstance(a, tuple) for a, _ in decisions) > 0
    for _ in range(20):
        n = int(rng.integers(1, 9))
        now = time.perf_counter()
        ages = rng.uniform(0.0, 0.08, size=n)
        enqueued = [now - a for a in ages]
        deadlines = [e + 0.04 if rng.random() > 0.1 else None
                     for e in enqueued]
        assert ours.split_expired(deadlines, enqueued) == \
            theirs.split_expired(deadlines, enqueued)
    assert ours.counts() == theirs.counts()
    assert ours.counts()["expired"] > 0


def test_batcher_sheds_at_depth_and_expires_in_queue():
    """End to end through the port's Python DynamicBatcher: depth shed
    at compute(), deadline expiry at dequeue, live rows still served."""
    adm = AdmissionController(deadline_ms=80, max_queue_depth=2,
                              registry=_registry())
    batcher = DynamicBatcher(batch_dim=1, maximum_batch_size=8,
                             timeout_ms=10, admission=adm)
    results = {}

    def submit(name):
        try:
            results[name] = batcher.compute(
                {"x": np.full((1, 1), ord(name), np.float32)})
        except ShedError as e:
            results[name] = e

    threads = [threading.Thread(target=submit, args=(n,), daemon=True)
               for n in "ab"]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 2
    while batcher.size() < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.raises(ShedError):
        batcher.compute({"x": np.zeros((1, 1), np.float32)})
    time.sleep(0.15)
    served = {}

    def consume():
        batch = next(batcher)
        served["rows"] = len(batch)
        batch.set_outputs({"y": np.zeros((1, len(batch)), np.float32)})

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    deadline = time.monotonic() + 2
    while batcher.size() > 0 and time.monotonic() < deadline:
        time.sleep(0.005)  # the expired pair drained by the consumer
    threading.Thread(target=submit, args=("c",), daemon=True).start()
    consumer.join(2)
    assert served["rows"] == 1  # only the fresh request was served
    for t in threads:
        t.join(2)
    assert isinstance(results["a"], ShedError) and results["a"].expired
    assert isinstance(results["b"], ShedError) and results["b"].expired
    assert adm.counts() == {"admitted": 3, "shed": 1, "expired": 2}
    batcher.close()


# ------------------------------------ shed/retry: never a lost rollout


class CountingPolicyServer:
    """state += 1 per forward, reset where done: independent of params,
    so shed-and-resubmitted steps reproduce the unshed run exactly."""

    def __call__(self, env_outputs, agent_state, batch_size):
        done = np.asarray(env_outputs["done"])
        state = np.where(done, 0, np.asarray(agent_state)) + 1
        outputs = {
            "action": np.zeros_like(done, dtype=np.int32),
            "policy_logits": state[..., None].astype(np.float32),
            "baseline": state.astype(np.float32),
        }
        return outputs, state


def _start_counting_server(path):
    server = EnvServer(lambda: CountingEnv(episode_length=EPISODE_LEN),
                       f"unix:{path}")
    server.start()
    deadline = time.monotonic() + 5
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError("server did not bind")
        time.sleep(0.01)
    return server


def _collect_rollouts(address, admission=None, wedge=None, num_rollouts=5):
    learner_queue = BatchingQueue(batch_dim=1, minimum_batch_size=1,
                                  maximum_batch_size=1)
    batcher = DynamicBatcher(batch_dim=1, timeout_ms=20,
                             admission=admission)

    def throttle():
        while wedge is not None and wedge.is_set():
            time.sleep(0.01)

    threading.Thread(
        target=inference_loop, args=(batcher, CountingPolicyServer(), 8),
        kwargs={"throttle_fn": throttle if wedge is not None else None},
        daemon=True).start()
    pool = ActorPool(unroll_length=T, learner_queue=learner_queue,
                     inference_batcher=batcher,
                     env_server_addresses=[address],
                     initial_agent_state=np.zeros((1, 1), np.int64))
    pool_thread = threading.Thread(target=pool.run, daemon=True)
    pool_thread.start()
    items = []
    for item in learner_queue:
        items.append(item)
        if wedge is not None and len(items) == 2:
            # Wedge mid-stream: the next requests expire in the queue
            # (or shed at depth) and must be re-submitted.
            wedge.set()
            time.sleep(0.35)
            wedge.clear()
        if len(items) >= num_rollouts:
            break
    batcher.close()
    learner_queue.close()
    pool_thread.join(5)
    return items


def test_shed_retry_rollouts_bit_identical():
    """A wedged batcher sheds mid-run; the port's actor re-submits; the
    rollout stream is bit-identical to the unshed run, and resubmitted
    == shed + expired exactly."""
    reg = telemetry.get_registry()
    base = int(reg.counter("serving.resubmitted").value())
    tmp = tempfile.mkdtemp()
    server = _start_counting_server(os.path.join(tmp, "a"))
    try:
        clean = _collect_rollouts(f"unix:{tmp}/a")
    finally:
        server.stop()
    server = _start_counting_server(os.path.join(tmp, "b"))
    adm = AdmissionController(deadline_ms=60, max_queue_depth=2,
                              registry=reg)
    try:
        shed = _collect_rollouts(f"unix:{tmp}/b", admission=adm,
                                 wedge=threading.Event())
    finally:
        server.stop()
    counts = adm.counts()
    shed_total = counts["shed"] + counts["expired"]
    assert shed_total > 0, "the wedge produced no sheds"
    assert int(reg.counter("serving.resubmitted").value()) - base == \
        shed_total
    assert len(clean) == len(shed)
    for a, b in zip(clean, shed):
        a, b = (x[0] if isinstance(x, tuple) else x for x in (a, b))
        for key in a["batch"]:
            np.testing.assert_array_equal(a["batch"][key], b["batch"][key],
                                          err_msg=key)
        np.testing.assert_array_equal(np.asarray(a["initial_agent_state"]),
                                      np.asarray(b["initial_agent_state"]))


# ------------------------------------------------------ PolicySnapshotStore


def _bf16_leaves():
    """f32 leaves with every rounding case: ties to even both ways,
    values that round up into the next binade, subnormals, the largest
    finite f32 (rounds to inf), NaN and +-inf."""
    rng = np.random.default_rng(1)
    bits = np.array([
        0x3F808000,  # tie, even below: rounds down
        0x3F818000,  # tie, odd below: rounds up
        0x3F80FFFF, 0x3F7FFFFF, 0x00000001, 0x807FFFFF, 0x7F7FFFFF,
        0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000, 0x00000000,
        0x80000000,
    ], np.uint32)
    special = bits.view(np.float32)
    return {
        "w": rng.standard_normal((16, 8)).astype(np.float32),
        "special": special,
        "b": (rng.standard_normal(40) * 1e-3).astype(np.float32),
    }


def test_snapshot_bf16_bits_equal_jax():
    import jax.numpy as jnp

    from torchbeast_tpu.serving.snapshot import bf16_cast as jax_bf16_cast

    leaves = _bf16_leaves()
    theirs, jax_dtypes = jax_bf16_cast(
        {k: jnp.asarray(v) for k, v in leaves.items()})
    ours, dtypes = bf16_cast({k: torch.from_numpy(v.copy())
                              for k, v in leaves.items()})
    for key in leaves:
        assert ours[key].dtype == torch.bfloat16
        assert dtypes[key] == torch.float32
        assert jax_dtypes[key] == jnp.float32
        np.testing.assert_array_equal(
            ours[key].view(torch.int16).numpy().view(np.uint16),
            np.asarray(theirs[key]).view(np.uint16), err_msg=key)


def test_snapshot_store_bf16_roundtrip_restores_dtypes():
    store = PolicySnapshotStore(4, registry=_registry())
    params = {
        "w": torch.arange(8, dtype=torch.float32) / 7.0,
        "n": torch.arange(4, dtype=torch.int32),
        "h": torch.ones(3, dtype=torch.bfloat16),
    }
    assert store.latest() is None
    store.note_update(0)
    store.publish(0, params)
    params["w"].add_(1.0)  # the learner updates in place: the copy stays
    version, restored = store.latest()
    assert version == 0
    assert restored["w"].dtype == torch.float32  # restored, bf16-rounded
    assert restored["n"].dtype == torch.int32
    assert torch.equal(restored["n"], params["n"])
    assert restored["h"].dtype == torch.bfloat16
    assert restored["h"].data_ptr() != params["h"].data_ptr()
    expected = (torch.arange(8, dtype=torch.float32) / 7.0).to(
        torch.bfloat16).float()
    assert torch.equal(restored["w"], expected)
    assert store.latest()[1] is restored  # cached per version


def test_snapshot_store_refresh_due_and_failure_hook():
    reg = _registry()
    store = PolicySnapshotStore(4, registry=reg)
    w = [torch.zeros(2)]
    assert store.note_update(0)  # nothing published yet: due
    store.publish(0, w)
    assert store.lag() == 0
    assert not store.note_update(3)
    assert store.note_update(4)
    store.fail_next_refreshes(2)
    assert not store.publish(4, w)
    assert store.version == 0 and store.lag() == 4
    assert store.note_update(5)  # still due: the drop retries
    assert not store.publish(5, w)
    assert store.note_update(6)
    assert store.publish(6, w)
    assert store.version == 6 and store.lag() == 0
    assert int(reg.counter("serving.snapshot_refresh_failures").value()) \
        == 2
    assert int(reg.counter("serving.snapshot_bytes_published").value()) \
        == 2 * 2 * 2  # two publishes of two bf16 values


def test_snapshot_store_full_precision_copies():
    store = PolicySnapshotStore(1, registry=_registry(), cast_bf16=False)
    w = torch.tensor([1.0 + 2 ** -20])
    store.publish(0, [w])
    w.zero_()
    assert store.latest()[1][0].item() == 1.0 + 2 ** -20


# ---------------------------------------------------- replica hooks, router


def test_replica_lag_matches_snapshot_actually_used():
    reg = _registry()
    store = PolicySnapshotStore(2, registry=reg)
    hooks = ReplicaServingHooks(store, max_policy_lag=10, registry=reg,
                                batch_dim=1)
    store.note_update(3)
    store.publish(3, {"v": torch.full((1,), 3.0)})
    store.note_update(5)  # the head runs ahead: lag 2
    (version, params), annotate = hooks.begin_batch()
    assert version == 3 and params["v"].item() == 3.0
    out = annotate({"action": np.zeros((1, 4), np.int32)}, 4)
    assert out["policy_lag"].shape == (1, 4)
    assert out["policy_lag"].dtype == np.int32
    assert (out["policy_lag"] == 2).all()
    store.note_update(6)
    store.publish(6, {"v": torch.full((1,), 6.0)})
    (version, params), annotate = hooks.begin_batch()
    assert version == 6 and params["v"].item() == 6.0
    assert (annotate({}, 2)["policy_lag"] == 0).all()


def test_replica_degrades_and_recovers_via_health():
    reg = _registry()
    store = PolicySnapshotStore(2, registry=reg)
    health = PipelineHealth(registry=reg)
    hooks = ReplicaServingHooks(store, max_policy_lag=3, health=health,
                                registry=reg)
    assert not hooks.serving_ok()  # nothing published yet
    assert health.state_name == "DEGRADED"
    store.note_update(0)
    store.publish(0, [torch.zeros(1)])
    assert hooks.serving_ok()
    assert health.state_name == "HEALTHY"
    store.note_update(4)  # lag 4 > budget 3
    assert not hooks.serving_ok()
    assert health.state_name == "DEGRADED"
    store.publish(4, [torch.zeros(1)])
    assert hooks.serving_ok()
    assert health.state_name == "HEALTHY"
    assert int(reg.counter("serving.replica_degradations").value()) == 2


def test_replica_generator_is_seeded():
    store = PolicySnapshotStore(1, registry=_registry())
    a = ReplicaServingHooks(store, max_policy_lag=2, rng_seed=5,
                            registry=_registry()).generator
    b = torch.Generator().manual_seed(5)
    assert torch.equal(torch.rand(4, generator=a),
                       torch.rand(4, generator=b))


class _FakeBatcher:
    def __init__(self, tag, error=None):
        self.tag, self.error = tag, error

    def compute(self, inputs, trace=None):
        if self.error is not None:
            raise self.error
        return {"served_by": self.tag}

    def size(self):
        return 0

    def is_closed(self):
        return False


def test_replica_router_routes_by_health():
    reg = _registry()
    store = PolicySnapshotStore(2, registry=reg)
    hooks = ReplicaServingHooks(store, max_policy_lag=2, registry=reg)
    router = ReplicaRouter(_FakeBatcher("central"), _FakeBatcher("replica"),
                           hooks, registry=reg)
    assert router.compute({})["served_by"] == "central"  # no snapshot
    store.note_update(0)
    store.publish(0, [torch.zeros(1)])
    assert router.compute({})["served_by"] == "replica"
    store.note_update(10)  # lag blows the budget: back to central
    assert router.compute({})["served_by"] == "central"
    assert int(reg.counter("serving.replica_requests").value()) == 1
    assert int(reg.counter("serving.central_requests").value()) == 2


def test_replica_router_falls_back_on_replica_failure():
    reg = _registry()
    store = PolicySnapshotStore(2, registry=reg)
    hooks = ReplicaServingHooks(store, max_policy_lag=2, registry=reg)
    store.note_update(0)
    store.publish(0, [torch.zeros(1)])
    router = ReplicaRouter(
        _FakeBatcher("central"),
        _FakeBatcher("replica", AsyncError("replica thread died")), hooks,
        registry=reg)
    assert router.compute({})["served_by"] == "central"
    router = ReplicaRouter(_FakeBatcher("central"),
                           _FakeBatcher("replica", ShedError("full")), hooks,
                           registry=reg)
    with pytest.raises(ShedError):  # sheds keep their retry contract
        router.compute({})


def test_replica_serving_stamps_lag_into_reply():
    """inference_loop + serving_hooks on the path without a state table:
    the reply's policy_lag describes the snapshot that served it."""
    reg = _registry()
    store = PolicySnapshotStore(2, registry=reg)
    hooks = ReplicaServingHooks(store, max_policy_lag=10, registry=reg,
                                batch_dim=1)
    store.note_update(7)
    store.publish(7, {"v": torch.full((1,), 7.0)})
    store.note_update(9)  # lag 2 at serve time
    batcher = DynamicBatcher(batch_dim=1, timeout_ms=10)

    def act_fn(env_outputs, agent_state, batch_size, ctx):
        _, params = ctx
        value = params["v"].item()
        done = np.asarray(env_outputs["done"])
        outputs = {
            "action": np.zeros_like(done, dtype=np.int32),
            "policy_logits": np.full(done.shape + (2,), value, np.float32),
            "baseline": np.full(done.shape, value, np.float32),
        }
        return outputs, np.asarray(agent_state)

    thread = threading.Thread(target=inference_loop,
                              args=(batcher, act_fn, 8),
                              kwargs={"serving_hooks": hooks}, daemon=True)
    thread.start()
    reply = batcher.compute({
        "env": {"frame": np.zeros((1, 1, 2, 2), np.uint8),
                "reward": np.zeros((1, 1), np.float32),
                "done": np.zeros((1, 1), bool),
                "last_action": np.zeros((1, 1), np.int32)},
        "agent_state": np.zeros((1, 1), np.int64),
    })
    batcher.close()
    thread.join(5)
    out = reply["outputs"]
    assert float(out["baseline"][0, 0]) == 7.0
    assert out["policy_lag"].shape == (1, 1)
    assert int(out["policy_lag"][0, 0]) == 2


# --------------------------------------------- the replica step of the table


def _model():
    from torchbeast_tpu_torch.models import create_model

    torch.manual_seed(0)
    return create_model("shallow", num_actions=3, use_lstm=True,
                        frame_shape=(84, 84, 4)).requires_grad_(False)


def _env(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 255, (1, n, 84, 84, 4), dtype=np.uint8),
        "reward": rng.standard_normal((1, n)).astype(np.float32),
        "done": rng.random((1, n)) < 0.3,
        "last_action": rng.integers(0, 3, (1, n), dtype=np.int32),
    }


def _forward(model, gen):
    from torchbeast_tpu_torch import learner as learner_lib

    def forward(env_d, state):
        inputs = {k: env_d[k][0] for k in learner_lib.MODEL_INPUT_KEYS}
        out, new_state = learner_lib.act_body(model, inputs, state, gen)
        return {"action": out.action[None],
                "policy_logits": out.policy_logits[None],
                "baseline": out.baseline[None]}, new_state

    return forward


def _table(model, num_slots):
    return DeviceStateTable(
        model.initial_state(1, torch.device("cpu")), num_slots=num_slots,
        act_fn=lambda ctx, env_d, s: _forward(model, torch.Generator()
                                              .manual_seed(3))(env_d, s),
        batch_dim=1)


def test_replica_step_equals_a_central_step_on_rounded_params():
    """A replica step of the table with snapshot v (loaded into the
    replica model's params) is bit for bit a central step whose params
    are v rounded through bf16: outputs, sampled actions and the rows it
    writes. A step with the same version does not reload; a newer one
    does."""
    model = _model()
    store = PolicySnapshotStore(1, registry=_registry())
    store.note_update(4)
    store.publish(4, list(model.parameters()))
    replica = _model()
    with torch.no_grad():  # the buffer holds something else at first
        for p in replica.parameters():
            p.mul_(-1.0)
    gen_replica = torch.Generator().manual_seed(11)
    table = _table(model, num_slots=4)
    table.bind_context(_forward(replica, gen_replica),
                       list(replica.parameters()))
    rounded = _model()
    with torch.no_grad():
        for p in rounded.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    twin = _table(rounded, num_slots=4)
    gen_twin = torch.Generator().manual_seed(11)
    twin._act_fn = lambda ctx, env_d, s: _forward(rounded, gen_twin)(
        env_d, s)

    slots = np.array([0, 2, 4, 4])  # two real slots and two of padding
    advance = np.array([True, True, False, False])
    for step, seed in enumerate((0, 1, 2)):
        env = _env(4, seed)
        got = table.step(slots, advance, env, context=store.latest())
        want = twin.step(slots, advance, env)
        assert table.context_version == 4
        for key in want:
            assert torch.equal(got[key], want[key]), (step, key)
        for a, b in zip(nest.flatten(table.read_slot(2)),
                        nest.flatten(twin.read_slot(2))):
            np.testing.assert_array_equal(a, b)
    # A refresh: the next step loads version 5.
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    store.note_update(5)
    store.publish(5, list(model.parameters()))
    with torch.no_grad():
        for p, q in zip(rounded.parameters(), model.parameters()):
            p.copy_(q.to(torch.bfloat16).float())
    env = _env(4, 9)
    got = table.step(slots, advance, env, context=store.latest())
    want = twin.step(slots, advance, env)
    assert table.context_version == 5
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_replica_and_central_steps_share_rows_and_survive_poison():
    """The two step kinds advance the same slots; a poison fails both
    and a rebuild brings both back on the same storage."""
    model = _model()
    store = PolicySnapshotStore(1, registry=_registry())
    store.publish(0, list(model.parameters()))
    replica = _model()
    table = _table(model, num_slots=2)
    table.bind_context(_forward(replica, torch.Generator().manual_seed(1)),
                       list(replica.parameters()))
    rows = nest.flatten(table._rows)
    slots, advance = np.array([0, 1]), np.array([True, True])
    table.step(slots, advance, _env(2, 0), context=store.latest())
    moved = [r.clone() for r in rows]
    table.step(slots, advance, _env(2, 1))
    assert any(not torch.equal(a, b) for a, b in zip(moved, rows))
    table.poison()
    from torchbeast_tpu_torch.runtime.errors import StateTablePoisonedError

    for context in (None, store.latest()):
        with pytest.raises(StateTablePoisonedError):
            table.step(slots, advance, _env(2, 2), context=context)
    table.rebuild()
    assert [r.data_ptr() for r in nest.flatten(table._rows)] == \
        [r.data_ptr() for r in rows]
    table.step(slots, advance, _env(2, 3), context=store.latest())
    table.step(slots, advance, _env(2, 4))


# ------------------------------------------------------------ the C++ core

@pytest.fixture(scope="module")
def core():
    try:
        native_build.check_toolchain()
    except native_build.NativeBuildError as e:
        pytest.skip(str(e))
    return native_build.load()


def test_native_api_version_and_shed_type(core):
    from torchbeast_tpu_torch.runtime.native import (
        REQUIRED_API_VERSION,
        gap_reason,
    )

    assert getattr(core, "API_VERSION", 0) >= REQUIRED_API_VERSION
    assert gap_reason(core) is None
    assert issubclass(core.ShedError, ShedError)
    assert issubclass(core.ShedError, core.AsyncError)


def test_native_batcher_sheds_at_depth_and_expires(core):
    batcher = core.DynamicBatcher(
        batch_dim=1, maximum_batch_size=8, timeout_ms=10,
        shed_max_queue_depth=2, request_deadline_ms=80.0)
    results = {}

    def submit(name):
        try:
            results[name] = batcher.compute(
                {"x": np.full((1, 1), float(ord(name)), np.float32)})
        except Exception as e:  # noqa: BLE001
            results[name] = e

    threads = [threading.Thread(target=submit, args=(n,), daemon=True)
               for n in "ab"]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 2
    while batcher.size() < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    with pytest.raises(core.ShedError):
        batcher.compute({"x": np.zeros((1, 1), np.float32)})
    time.sleep(0.15)  # let the queued two expire
    served = {}

    def consume():
        batch = next(iter(batcher))
        served["rows"] = len(batch)
        batch.set_outputs({"y": np.zeros((1, len(batch)), np.float32)})

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    deadline = time.monotonic() + 2
    while batcher.size() > 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    threading.Thread(target=submit, args=("c",), daemon=True).start()
    consumer.join(2)
    assert served["rows"] == 1
    for t in threads:
        t.join(2)
    assert isinstance(results["a"], ShedError)
    assert isinstance(results["b"], ShedError)
    tm = batcher.telemetry()
    assert (tm["admitted"], tm["shed"], tm["expired"]) == (3, 1, 2)
    assert tm["queue_delay_s"]["count"] >= 3
    batcher.close()


def test_native_replica_router_routes_by_flag(core):
    """The core's ReplicaRouter answers replica-first while the flag the
    driver pushes is set, central otherwise, and counts both."""
    central = core.DynamicBatcher(batch_dim=1, timeout_ms=5)
    replica = core.DynamicBatcher(batch_dim=1, timeout_ms=5)
    router = core.ReplicaRouter(central=central, replica=replica)
    served = []

    def serve(batcher, tag):
        for batch in batcher:
            served.append(tag)
            batch.set_outputs({"y": np.zeros((1, len(batch)), np.float32)})

    threads = [threading.Thread(target=serve, args=(b, t), daemon=True)
               for b, t in ((central, "central"), (replica, "replica"))]
    for t in threads:
        t.start()
    x = {"x": np.zeros((1, 1), np.float32)}
    router.set_serving(True)
    router.compute(x)
    router.set_serving(False)
    router.compute(x)
    router.compute(x)
    central.close()
    replica.close()
    for t in threads:
        t.join(5)
    assert served == ["replica", "central", "central"]
    tm = router.telemetry()
    assert (tm["replica_requests"], tm["central_requests"]) == (1, 2)


@pytest.mark.parametrize("runtime", ["--no_native_runtime",
                                     "--native_runtime"])
def test_polybeast_replicas_without_the_state_table(tmp_path, runtime,
                                                    monkeypatch):
    """A feed-forward policy (agent state on the host, no state table)
    with replicas armed: the replica thread serves through its own
    params buffer, loaded per snapshot version, and stamps policy_lag
    into the learner batches."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import polybeast

    lags = []
    instrument = learner_lib.instrument_update_step

    def recording(update, **kwargs):
        def wrapped(batch, state):
            lags.append(batch["policy_lag"].clone())
            return update(batch, state)

        return instrument(wrapped, **kwargs)

    monkeypatch.setattr(learner_lib, "instrument_update_step", recording)
    reg = telemetry.get_registry()
    before = int(reg.counter("serving.replica_requests").value())
    stats = polybeast.train(polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "shallow",
        "--num_servers", "2", "--batch_size", "2", "--unroll_length", "5",
        "--total_steps", "100", "--savedir", str(tmp_path), "--xpid", "ff",
        "--pipes_basename", f"unix:{tmp_path}/pipes",
        "--max_inference_batch_size", "4", "--num_inference_threads", "1",
        "--replica_refresh_updates", "1", runtime]))
    assert stats["step"] >= 100 and stats["health"] == "HEALTHY"
    assert int(reg.counter("serving.replica_requests").value()) > before
    assert lags and all(lag.dtype == torch.int32 for lag in lags)
    assert all(int(lag.max()) <= 20 for lag in lags)
