"""The port's fleet (torchbeast_tpu_torch/fleet/) against the JAX
package's (torchbeast_tpu/fleet/): every case of tests/test_fleet.py on
the port's modules, then the two packages together.

- The --fleet grammar and the static topology: FleetSpec and
  parse_fleet_spec against the reference's, spec for spec and error for
  error; compose_fleet_mesh_devices' host-major order and refusals.
- TAG_SNAPSHOT: a port-built snapshot applied by the port serves the
  bits of a local publish; the encoders agree; stale versions are
  dropped and counted; a template mismatch and every truncation are
  WireErrors. Across the packages: a reference-built snapshot (from the
  same weights, weights.py) applied by the port, and a port-built one
  applied by the reference, each bitwise the receiver's local publish,
  f32 and bf16, with the LSTM's gate leaves.
- The control plane over real sockets: heartbeat folding (sticky),
  snapshot delivery and skew, the param mean, the done / loss / halt /
  clean-shutdown rules. Across the packages: a reference lead and a port
  remote complete heartbeats, a snapshot and a param-mean round.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from torchbeast_tpu.fleet import (
    FleetCoordinator as JaxCoordinator,
    FleetSpec as JaxFleetSpec,
    apply_snapshot as jax_apply_snapshot,
    build_snapshot as jax_build_snapshot,
    parse_fleet_spec as jax_parse_fleet_spec,
)
from torchbeast_tpu.resilience.supervisor import (
    PipelineHealth as JaxPipelineHealth,
)
from torchbeast_tpu.runtime import wire as jax_wire
from torchbeast_tpu.serving.snapshot import (
    PolicySnapshotStore as JaxSnapshotStore,
)
from torchbeast_tpu.telemetry import MetricsRegistry as JaxRegistry
from torchbeast_tpu_torch import weights
from torchbeast_tpu_torch.fleet import (
    FleetCoordinator,
    FleetSpec,
    apply_snapshot,
    build_snapshot,
    compose_fleet_mesh_devices,
    parse_fleet_spec,
)
from torchbeast_tpu_torch.fleet import snapshot_wire
from torchbeast_tpu_torch.fleet.topology import CONTROL_PORT_OFFSET
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.resilience.supervisor import (
    DEGRADED,
    HALTED,
    HEALTHY,
    PipelineHealth,
)
from torchbeast_tpu_torch.runtime import wire
from torchbeast_tpu_torch.runtime.placement import fleet_host_for_slot
from torchbeast_tpu_torch.serving.snapshot import PolicySnapshotStore
from torchbeast_tpu_torch.telemetry import MetricsRegistry

# ---------------------------------------------------------------------------
# --fleet grammar


def test_parse_fleet_spec_roundtrip():
    spec = parse_fleet_spec("host=1/4,coord=10.0.0.1:8476")
    assert spec == FleetSpec(1, 4, "10.0.0.1:8476")
    assert not spec.is_lead
    assert parse_fleet_spec("host=0/1,coord=h:2").is_lead
    assert parse_fleet_spec(" coord=h:9 , host=2/3 ") == FleetSpec(
        2, 3, "h:9")
    theirs = jax_parse_fleet_spec("host=1/4,coord=10.0.0.1:8476")
    assert spec.describe() == theirs.describe()


def test_parse_fleet_spec_unset_means_single_host():
    for unset in (None, "", "   "):
        assert parse_fleet_spec(unset) is None
        assert jax_parse_fleet_spec(unset) is None


@pytest.mark.parametrize("bad", [
    "host=1/4",
    "coord=h:1",
    "host=1/4,coord=h:1,host=2/4",
    "host=14,coord=h:1",
    "host=a/b,coord=h:1",
    "host=4/4,coord=h:1",
    "host=-1/4,coord=h:1",
    "host=0/0,coord=h:1",
    "host=0/2,coord=nope",
    "host=0/2,coord=:123",
    "host=0/2,coord=h:port",
    "host=0/2,coord=h:65535",
    "host=0/2,coord=h:0",
    "host=0/2,clock=h:1",
    "host 0/2",
])
def test_parse_fleet_spec_rejects(bad):
    with pytest.raises(ValueError) as ours:
        parse_fleet_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jax_parse_fleet_spec(bad)
    assert str(ours.value) == str(theirs.value)


def test_control_address_is_coord_port_plus_one():
    spec = parse_fleet_spec("host=0/2,coord=10.0.0.1:8476")
    assert spec.control_address == f"10.0.0.1:{8476 + CONTROL_PORT_OFFSET}"
    d = spec.describe()
    assert d["coord"] == "10.0.0.1:8476"
    assert d["control"] == "10.0.0.1:8477"


# ---------------------------------------------------------------------------
# Static actor -> host assignment


def test_fleet_host_for_slot_static_and_in_range():
    for n in (1, 2, 3, 5):
        for slot in range(64):
            h = fleet_host_for_slot(slot, n)
            assert 0 <= h < n
            assert h == fleet_host_for_slot(slot, n)


def test_slots_partition_exactly_across_hosts():
    n_hosts, n_slots = 3, 256
    specs = [FleetSpec(r, n_hosts, "h:1") for r in range(n_hosts)]
    owned = [spec.slots_for_host(n_slots) for spec in specs]
    seen = [s for slots in owned for s in slots]
    assert sorted(seen) == list(range(n_slots))
    assert all(len(slots) > n_slots // (n_hosts * 4) for slots in owned)
    assert owned == [JaxFleetSpec(r, n_hosts, "h:1").slots_for_host(n_slots)
                     for r in range(n_hosts)]


def test_fleet_host_hash_decorrelated_from_modulo():
    assignment = [fleet_host_for_slot(s, 2) for s in range(256)]
    assert assignment != [s % 2 for s in range(256)]


# ---------------------------------------------------------------------------
# Mesh composition


class FakeDevice:
    def __init__(self, host, idx):
        self.process_index = host
        self.id = host * 100 + idx

    def __repr__(self):
        return f"dev(h{self.process_index}/{self.id})"


def _fake_fleet_devices(n_hosts, per_host):
    return [FakeDevice(h, i) for h in range(n_hosts)
            for i in range(per_host)]


def test_compose_fleet_mesh_is_host_major():
    split, learners = compose_fleet_mesh_devices(
        FleetSpec(1, 2, "h:1"), "inf=1,learn=rest",
        _fake_fleet_devices(2, 2))
    assert [d.id for d in learners] == [1, 101]
    assert [d.id for d in split.learner_devices] == [101]
    assert [d.id for d in split.inference_devices] == [100]


def test_compose_fleet_mesh_no_split_whole_hosts_learn():
    split, learners = compose_fleet_mesh_devices(
        FleetSpec(0, 2, "h:1"), "", _fake_fleet_devices(2, 2))
    assert split is None
    assert [d.id for d in learners] == [0, 1, 100, 101]


def test_compose_fleet_mesh_rejects_ragged_and_empty_hosts():
    fleet = FleetSpec(0, 2, "h:1")
    ragged = _fake_fleet_devices(2, 2) + [FakeDevice(1, 9)]
    with pytest.raises(ValueError, match="uniform"):
        compose_fleet_mesh_devices(fleet, "", ragged)
    with pytest.raises(ValueError, match="no devices"):
        compose_fleet_mesh_devices(
            fleet, "", [FakeDevice(0, 0), FakeDevice(0, 1)])
    with pytest.raises(ValueError, match="outside"):
        compose_fleet_mesh_devices(fleet, "", [FakeDevice(5, 0)])


# ---------------------------------------------------------------------------
# TAG_SNAPSHOT


def _model(seed=11, dtype=torch.float32):
    """A small mlp + LSTM policy (its LSTM crosses as gate leaves), its
    weights drawn from `seed`."""
    torch.manual_seed(seed)
    model = create_model("mlp", num_actions=3, use_lstm=True,
                         frame_shape=(3, 3, 1))
    return model.to(dtype)


def _params(model):
    return list(model.parameters())


def _tensor_bytes(tree):
    return [t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
            for t in tree]


def test_snapshot_wire_roundtrip_bit_exact_vs_local_publish():
    """encode -> decode -> apply_snapshot -> latest_on serves the bytes
    and dtypes of a plain local publish at the same version."""
    model = _model()
    local = PolicySnapshotStore(1, registry=MetricsRegistry())
    assert local.publish(3, _params(model))
    remote = PolicySnapshotStore(1, registry=MetricsRegistry())
    snap = wire.decode(wire.encode(build_snapshot(3, model))[4:])
    assert isinstance(snap, wire.PolicySnapshot)
    assert apply_snapshot(remote, snap, template=model)
    device = torch.device("cpu")
    v_local, tree_local = local.latest_on(device)
    v_remote, tree_remote = remote.latest_on(device)
    assert v_local == v_remote == 3
    assert _tensor_bytes(tree_local) == _tensor_bytes(tree_remote)
    assert [t.dtype for t in tree_remote] == [p.dtype for p in
                                               model.parameters()]


def test_snapshot_encoders_agree():
    snap = build_snapshot(9, _model())
    assert bytes(wire.encode_legacy(snap)) == wire.encode(snap)


def test_snapshot_version_skew_stale_rejected():
    model = _model()
    store = PolicySnapshotStore(1, registry=MetricsRegistry())
    stale = MetricsRegistry().counter("fleet.snapshots_stale_dropped")
    assert apply_snapshot(store, build_snapshot(5, model), model,
                          stale_counter=stale)
    assert store.version == 5
    assert not apply_snapshot(store, build_snapshot(5, model), model,
                              stale_counter=stale)
    assert not apply_snapshot(store, build_snapshot(3, model), model,
                              stale_counter=stale)
    assert store.version == 5 and stale.value() == 2
    assert apply_snapshot(store, build_snapshot(6, model), model,
                          stale_counter=stale)
    assert store.version == 6


def test_snapshot_template_mismatch_is_wire_error():
    model = _model()
    store = PolicySnapshotStore(1, registry=MetricsRegistry())
    snap = build_snapshot(1, model)
    with pytest.raises(wire.WireError, match="leaf"):
        apply_snapshot(store, snap,
                       template=torch.nn.Linear(2, 2))
    with pytest.raises(wire.WireError, match="PolicySnapshot"):
        apply_snapshot(store, {"not": "a snapshot"}, template=model)


def test_snapshot_truncation_fuzz_raises_wire_error():
    payload = bytes(wire.encode_legacy(build_snapshot(2, _model())))[4:]
    cuts = set(range(0, min(len(payload), 64)))
    cuts.update(np.random.default_rng(3).integers(
        0, len(payload), size=80).tolist())
    for cut in sorted(cuts):
        with pytest.raises(wire.WireError):
            wire.decode(payload[:cut])


def test_snapshot_negative_version_rejected_at_build():
    with pytest.raises(wire.WireError):
        wire.PolicySnapshot(-1, [], [])


def _jax_tree(model):
    """The reference's params tree of the port model's weights, each
    leaf in its param's dtype (bf16 params as bf16 leaves)."""
    import jax
    import jax.numpy as jnp

    tree = weights.torch_to_jax(model.state_dict())
    sources = dict(snapshot_wire.leaf_sources(model))
    dtypes = [p.dtype for p in model.parameters()]
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a).astype(
            jnp.bfloat16 if dtypes[sources[tuple(k.key for k in path)]]
            == torch.bfloat16 else jnp.float32), tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_snapshot_built_by_either_package_applies_in_the_other(dtype):
    import jax

    model = _model(dtype=dtype)
    tree = _jax_tree(model)
    # Reference-built, port-applied: the bits of the port's local publish.
    theirs = jax_build_snapshot(4, tree)
    ours = build_snapshot(4, model)
    assert jax_wire.encode(theirs) == wire.encode(ours)
    snap = wire.decode(jax_wire.encode(theirs)[4:])
    remote = PolicySnapshotStore(1, registry=MetricsRegistry())
    assert apply_snapshot(remote, snap, template=model)
    local = PolicySnapshotStore(1, registry=MetricsRegistry())
    assert local.publish(4, _params(model))
    cpu = torch.device("cpu")
    assert (_tensor_bytes(remote.latest_on(cpu)[1])
            == _tensor_bytes(local.latest_on(cpu)[1]))
    # Port-built, reference-applied: the bits of the reference's publish.
    snap = jax_wire.decode(wire.encode(ours)[4:])
    j_remote = JaxSnapshotStore(1, registry=JaxRegistry())
    assert jax_apply_snapshot(j_remote, snap, template=tree)
    j_local = JaxSnapshotStore(1, registry=JaxRegistry())
    assert j_local.publish(4, tree)
    dev = jax.local_devices()[0]
    got = jax.tree_util.tree_leaves(j_remote.latest_on(dev)[1])
    want = jax.tree_util.tree_leaves(j_local.latest_on(dev)[1])
    assert [np.asarray(a).dtype for a in got] == [
        np.asarray(a).dtype for a in want]
    assert [np.asarray(a).tobytes() for a in got] == [
        np.asarray(a).tobytes() for a in want]


def test_param_leaves_round_trip_the_model():
    """param_leaves / params_from_leaves: the reference's leaf order and
    layout, back to the model's parameters bitwise."""
    import jax

    model = _model()
    leaves = snapshot_wire.param_leaves(model, _params(model))
    flax = jax.tree_util.tree_leaves(weights.torch_to_jax(model.state_dict()))
    assert [a.shape for a in leaves] == [np.asarray(a).shape for a in flax]
    back = snapshot_wire.params_from_leaves(model, leaves, _params(model))
    assert _tensor_bytes(back) == _tensor_bytes(_params(model))


# ---------------------------------------------------------------------------
# Control plane over real sockets


def _free_port_pair():
    for _ in range(50):
        s1, s2 = socket.socket(), socket.socket()
        try:
            s1.bind(("127.0.0.1", 0))
            port = s1.getsockname()[1]
            try:
                s2.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
            return port
        finally:
            s1.close()
            s2.close()
    raise RuntimeError("no adjacent free ports")


def _coordinator(cls, spec_cls, health_cls, registry_cls, rank, coord,
                 min_live_hosts, heartbeat_s, sync_timeout_s):
    return cls(spec_cls(rank, 2, coord), health_cls(registry=registry_cls()),
               "wire", min_live_hosts=min_live_hosts,
               heartbeat_s=heartbeat_s, connect_timeout_s=10.0,
               sync_timeout_s=sync_timeout_s, registry=registry_cls())


PORT = (FleetCoordinator, FleetSpec, PipelineHealth, MetricsRegistry)
REFERENCE = (JaxCoordinator, JaxFleetSpec, JaxPipelineHealth, JaxRegistry)


def _pair(min_live_hosts=1, heartbeat_s=0.05, sync_timeout_s=5.0,
          lead_side=PORT):
    """(lead, remote) coordinators over a loopback pair: the remote is the
    port's, the lead the port's or (lead_side=REFERENCE) the
    reference's."""
    coord = f"127.0.0.1:{_free_port_pair()}"
    lead = _coordinator(*lead_side, 0, coord, min_live_hosts, heartbeat_s,
                        sync_timeout_s)
    remote = _coordinator(*PORT, 1, coord, min_live_hosts, heartbeat_s,
                          sync_timeout_s)
    lead_started = threading.Thread(target=lead.start, daemon=True)
    lead_started.start()
    remote.start()
    lead_started.join(timeout=10.0)
    assert not lead_started.is_alive(), "lead never saw the remote hello"
    return lead, remote


def _wait(predicate, timeout_s=5.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def test_coordinator_heartbeat_folds_sticky_degradation():
    lead, remote = _pair()
    try:
        assert lead.live_hosts() == 2
        _wait(lambda: 1 in lead.remote_stats(), what="first heartbeat")
        assert lead._health.state == HEALTHY
        remote.set_stats_source(
            lambda: {"updates": 42, "restarts": 2, "reconnects": 3})
        remote.set_gauges_source(lambda: {"inference.slice.0.depth": 1.5})
        _wait(lambda: lead._health.state == DEGRADED,
              what="fold on the lead")
        assert any(r.startswith("fleet.host1")
                   for _, r in lead._health.reasons())
        _wait(lambda: lead.remote_gauges().get(1, {}).get(
            "inference.slice.0.depth") == 1.5,
            what="remote gauges in heartbeats")
        assert lead.remote_stats()[1]["updates"] == 42
        remote.set_stats_source(
            lambda: {"updates": 50, "restarts": 0, "reconnects": 0})
        time.sleep(0.2)
        assert lead._health.state == DEGRADED
    finally:
        remote.shutdown()
        lead.shutdown()


def test_coordinator_snapshot_delivery_and_skew():
    lead, remote = _pair()
    try:
        model = _model()
        params = _params(model)
        store = PolicySnapshotStore(1, registry=MetricsRegistry())
        remote.attach_snapshot_store(store, model)
        assert lead.publish_snapshot(4, params, model) == 1
        _wait(lambda: store.version == 4, what="snapshot v4 applied")
        assert lead.publish_snapshot(4, params, model) == 1
        _wait(lambda: remote._c_snap_stale.value() == 1,
              what="stale drop counted")
        assert store.version == 4
        assert lead.publish_snapshot(7, params, model) == 1
        _wait(lambda: store.version == 7, what="snapshot v7 applied")
    finally:
        remote.shutdown()
        lead.shutdown()


def _filled(model, value):
    return [torch.full_like(p, value) for p in model.parameters()]


def test_coordinator_param_sync_means_across_hosts():
    lead, remote = _pair()
    try:
        model = _model()
        out = {}

        def remote_side():
            out["remote"] = remote.sync_params(_filled(model, 3.0), model)

        t = threading.Thread(target=remote_side, daemon=True)
        t.start()
        out["lead"] = lead.sync_params(_filled(model, 1.0), model)
        t.join(timeout=10.0)
        assert not t.is_alive()
        for side in ("lead", "remote"):
            got = out[side]
            assert got is not None, f"{side} sync degraded"
            for g, p in zip(got, model.parameters()):
                assert g.dtype == p.dtype and g.shape == p.shape
                assert torch.equal(g, torch.full_like(p, 2.0))
    finally:
        remote.shutdown()
        lead.shutdown()


def test_coordinator_lead_sync_degrades_after_remote_done():
    lead, remote = _pair(sync_timeout_s=1.0)
    try:
        remote.learner_done()
        _wait(lambda: 1 in lead._done, what="done registered")
        model = _model()
        t0 = time.monotonic()
        got = lead.sync_params(_filled(model, 5.0), model)
        assert time.monotonic() - t0 < 0.9
        assert all(torch.equal(g, torch.full_like(g, 5.0)) for g in got)
    finally:
        remote.shutdown()
        lead.shutdown()


def test_coordinator_host_loss_above_floor_is_sticky_degraded():
    lead, remote = _pair(min_live_hosts=1)
    try:
        with remote._lock:
            conn = remote._conns.pop(0)
            remote._send_locks.pop(0, None)
        conn.close()
        _wait(lambda: lead.live_hosts() == 1, what="loss detected")
        assert lead._health.state == DEGRADED
        assert any(r.startswith("fleet.host1_lost")
                   for _, r in lead._health.reasons())
    finally:
        remote._closing.set()
        lead.shutdown()


def test_coordinator_host_loss_below_floor_halts_fleet():
    lead, remote = _pair(min_live_hosts=2)
    try:
        with remote._lock:
            conn = remote._conns.pop(0)
            remote._send_locks.pop(0, None)
        conn.close()
        _wait(lambda: lead._health.state == HALTED,
              what="floor-crossing halt")
        assert any("min_live_hosts" in r for _, r in lead._health.reasons())
    finally:
        remote._closing.set()
        lead.shutdown()


def test_coordinator_remote_halts_when_lead_lost_uncleanly():
    lead, remote = _pair()
    try:
        with lead._lock:
            conn = lead._conns.pop(1)
            lead._send_locks.pop(1, None)
        conn.close()
        _wait(lambda: remote._health.state == HALTED,
              what="remote halt on lead loss")
        assert remote.live_hosts() == 0
    finally:
        lead._closing.set()
        remote.shutdown()


def test_coordinator_clean_shutdown_is_not_a_loss():
    lead, remote = _pair()
    try:
        remote.shutdown()
        _wait(lambda: 1 in lead._done, what="clean departure recorded")
        time.sleep(0.1)
        assert lead._health.state == HEALTHY
        assert lead.live_hosts() == 2
    finally:
        lead.shutdown()


def test_coordinator_remote_sync_bails_after_clean_lead_exit():
    lead, remote = _pair(sync_timeout_s=5.0)
    try:
        lead.shutdown()
        _wait(lambda: remote._lead_gone, what="lead departure seen")
        model = _model()
        t0 = time.monotonic()
        assert remote.sync_params(_filled(model, 0.0), model) is None
        assert time.monotonic() - t0 < 1.0
        assert remote._health.state == HEALTHY
    finally:
        remote.shutdown()


def test_coordinator_rejects_bad_floor():
    for floor in (3, 0):
        with pytest.raises(ValueError) as ours:
            FleetCoordinator(FleetSpec(0, 2, "h:1"),
                             PipelineHealth(registry=MetricsRegistry()),
                             "wire", min_live_hosts=floor,
                             registry=MetricsRegistry())
        with pytest.raises(ValueError) as theirs:
            JaxCoordinator(JaxFleetSpec(0, 2, "h:1"),
                           JaxPipelineHealth(registry=JaxRegistry()),
                           "wire", min_live_hosts=floor,
                           registry=JaxRegistry())
        assert str(ours.value) == str(theirs.value)


def test_reference_lead_and_port_remote_form_one_fleet():
    """A reference lead and a port remote over the control plane: the
    remote's heartbeat incident folds sticky on the reference lead, the
    lead's snapshot lands bitwise in the port's store, and a param-mean
    round gives both sides the mean of their params."""
    import jax

    lead, remote = _pair(lead_side=REFERENCE)
    try:
        model = _model()
        tree = _jax_tree(model)
        _wait(lambda: 1 in lead.remote_stats(), what="first heartbeat")
        remote.set_stats_source(
            lambda: {"updates": 7, "restarts": 1, "reconnects": 0})
        _wait(lambda: lead._health.state_name == "DEGRADED",
              what="fold on the reference lead")
        assert lead.remote_stats()[1]["updates"] == 7

        store = PolicySnapshotStore(1, registry=MetricsRegistry())
        remote.attach_snapshot_store(store, model)
        assert lead.publish_snapshot(3, tree) == 1
        _wait(lambda: store.version == 3, what="snapshot applied")
        local = PolicySnapshotStore(1, registry=MetricsRegistry())
        local.publish(3, _params(model))
        cpu = torch.device("cpu")
        assert (_tensor_bytes(store.latest_on(cpu)[1])
                == _tensor_bytes(local.latest_on(cpu)[1]))

        out = {}
        other = _model(seed=12)

        def remote_side():
            out["remote"] = remote.sync_params(_params(other), model)

        t = threading.Thread(target=remote_side, daemon=True)
        t.start()
        out["lead"] = lead.sync_params(tree)
        t.join(timeout=10.0)
        assert not t.is_alive()
        want = [(a.detach().double() + b.detach().double()) / 2
                for a, b in zip(model.parameters(), other.parameters())]
        for got, w in zip(out["remote"], want):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-7)
        mean_tree = weights.param_list_to_jax(model, out["remote"])
        for a, b in zip(jax.tree_util.tree_leaves(out["lead"]),
                        jax.tree_util.tree_leaves(mean_tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    finally:
        remote.shutdown()
        lead.shutdown()
