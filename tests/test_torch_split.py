"""The port's device split (torchbeast_tpu_torch/runtime/placement.py,
parallel/sebulba.py, PolicySnapshotStore.latest_on, the pinned
DeviceStateTable, and both drivers' --device_split) against the
reference's (tests/test_sebulba.py), on the CPU:

- the grammar and every error text of parse_device_split,
  resolve_device_split and validate_split_composition, over one table of
  specs, device counts and flag sets, equal to the reference's, and the
  warning on a single device;
- slice_for_slot and fleet_host_for_slot equal to the reference's for
  slots 0-4095 and negative slots, and describe() equal to the
  reference's over its 8 CPU devices;
- ShardedStateTables routing, reset, poison and rebuild, the
  SliceRouter's static hash and its round-robin of stateless requests,
  a slice's table step and its replies, and latest_on's version parity
  with the reference's;
- the reference's end-to-end case (polybeast --device_split inf=1,learn=2
  --num_learner_devices 2, mlp + LSTM) on both runtimes with its
  telemetry keys, polybeast's refusals, the single-device degradation;
- monobeast under the split bitwise equal to the time-shared run.

Multi-device cases run on conftest's 8 forced CPU devices (the port's
CPU device count reads the same XLA_FLAGS).
"""

import argparse
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu.runtime import placement as ref_placement
from torchbeast_tpu_torch import monobeast, nest, parallel, polybeast
from torchbeast_tpu_torch import telemetry
from torchbeast_tpu_torch.runtime import placement
from torchbeast_tpu_torch.serving import PolicySnapshotStore
from torchbeast_tpu_torch.utils.checkpoint import read_payload
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

CPU = torch.device("cpu")


class _FakeDevice:
    def __init__(self, i):
        self.id = i


def _outcome(fn, *args):
    """("ok", value) or (exception type name, message)."""
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


# ------------------------------------------------------ grammar and errors

PARSE_SPECS = [None, "", "  ", "auto", "inf=2,learn=rest", "inf=1,learn=3",
               "inf=3", " inf = 2 , learn = 1 ", "garbage", "inf=x",
               "inf=0", "learn=2", "inf=1,learn=0", "inf=1,learn=q",
               "inf=1,inf=2", "inf=1,weird=2", "inf=-1", "inf=1,learn=",
               "inf=1,"]


@pytest.mark.parametrize("spec", PARSE_SPECS)
def test_parse_matches_the_reference(spec):
    assert (_outcome(placement.parse_device_split, spec)
            == _outcome(ref_placement.parse_device_split, spec))


RESOLVE_CASES = [
    ("auto", 8), ("auto", 2), ("auto", 3), ("inf=1,learn=rest", 4),
    ("inf=2,learn=2", 8), ("inf=2,learn=rest", 4), ("inf=1,learn=1", 3),
    ("inf=4,learn=rest", 4), ("inf=3,learn=2", 4), ("inf=5", 5),
    ("inf=1,learn=2", 3), ("", 4), ("garbage", 4), ("inf=2", 1),
]


@pytest.mark.parametrize("spec,n", RESOLVE_CASES)
def test_resolve_matches_the_reference(spec, n):
    """The same split (slice and learner counts, describe()) or the same
    ValueError text, over n devices."""
    ours = _outcome(placement.resolve_device_split, spec, [CPU] * n)
    theirs = _outcome(ref_placement.resolve_device_split, spec,
                      [_FakeDevice(i) for i in range(n)])
    assert ours[0] == theirs[0]
    if ours[0] != "ok":
        assert ours[1] == theirs[1]
    elif theirs[1] is None:
        assert ours[1] is None
    else:
        assert ours[1].describe() == theirs[1].describe()
        for slot in range(64):
            assert ours[1].slice_for_slot(slot) == (
                theirs[1].slice_for_slot(slot))


@pytest.mark.parametrize("spec", ["auto", "inf=1,learn=rest", "inf=3"])
def test_single_device_warns_like_the_reference(spec, caplog):
    with caplog.at_level(logging.WARNING):
        assert placement.resolve_device_split(spec, [CPU]) is None
        assert ref_placement.resolve_device_split(
            spec, [_FakeDevice(0)]) is None
    ours, theirs = [r.getMessage() for r in caplog.records
                    if "single visible device" in r.getMessage()]
    assert ours == theirs


def _composition_flags(**kw):
    base = dict(batch_size=8, num_learner_devices=1, expert_parallel=0,
                sequence_parallel=0, pipeline_parallel=0,
                tensor_parallel=0)
    base.update(kw)
    return argparse.Namespace(**base)


COMPOSITION_CASES = [
    ("inf=1,learn=2", {}),
    ("inf=1,learn=2", {"num_learner_devices": 2}),
    ("inf=1,learn=2", {"num_learner_devices": 4}),
    ("inf=1,learn=3", {"batch_size": 8}),
    ("inf=1,learn=2", {"expert_parallel": 2}),
    ("inf=1,learn=2", {"sequence_parallel": 2}),
    ("inf=1,learn=2", {"pipeline_parallel": 2}),
    ("inf=1,learn=2", {"tensor_parallel": 2}),
    ("inf=1,learn=2", {"tensor_parallel": 1, "sequence_parallel": 1}),
    ("", {"expert_parallel": 2}),
]
POLY_PARALLEL = ("expert_parallel", "sequence_parallel",
                 "pipeline_parallel", "tensor_parallel")


@pytest.mark.parametrize("spec,kw", COMPOSITION_CASES)
def test_composition_matches_the_reference(spec, kw):
    flags = _composition_flags(**kw)
    ours = placement.resolve_device_split(spec, [CPU] * 4)
    theirs = ref_placement.resolve_device_split(
        spec, [_FakeDevice(i) for i in range(4)])
    assert (_outcome(placement.validate_split_composition, flags, ours,
                     POLY_PARALLEL)
            == _outcome(ref_placement.validate_split_composition, flags,
                        theirs, POLY_PARALLEL))


def test_describe_matches_the_reference_on_its_cpu_devices():
    """Over 8 CPU devices each: the same ids (the port's CPU devices
    report their positions, the reference's their ids)."""
    for spec in ("inf=1,learn=2", "inf=2,learn=rest", "auto"):
        ours = placement.resolve_device_split(spec, [CPU] * 8)
        theirs = ref_placement.resolve_device_split(spec, jax.devices())
        assert json.loads(json.dumps(ours.describe())) == theirs.describe()


def test_needs_both_sides():
    with pytest.raises(ValueError):
        placement.DeviceSplit("x", (), (CPU, CPU))
    with pytest.raises(ValueError):
        placement.DeviceSplit("x", (CPU, CPU), ())


# ----------------------------------------------------------------- hashes

SLOTS = list(range(4096)) + [-1, -2, -4096, 2 ** 40, -(2 ** 40)]


@pytest.mark.parametrize("n_slices", [1, 2, 3, 8])
def test_slice_for_slot_matches_the_reference(n_slices):
    ours = placement.DeviceSplit("t", (CPU,) * n_slices, (CPU,))
    theirs = ref_placement.DeviceSplit(
        "t", tuple(range(n_slices)), (n_slices,))
    assert [ours.slice_for_slot(s) for s in SLOTS] == [
        theirs.slice_for_slot(s) for s in SLOTS]
    # The reference's pinned literal: a hash change would migrate every
    # deployed run's slot tables.
    if n_slices == 2:
        assert [ours.slice_for_slot(i) for i in range(8)] == [
            1, 1, 0, 1, 0, 0, 0, 1]


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 5])
def test_fleet_host_for_slot_matches_the_reference(num_hosts):
    assert [placement.fleet_host_for_slot(s, num_hosts) for s in SLOTS] == [
        ref_placement.fleet_host_for_slot(s, num_hosts) for s in SLOTS]
    for bad in (0, -1):
        assert (_outcome(placement.fleet_host_for_slot, 3, bad)
                == _outcome(ref_placement.fleet_host_for_slot, 3, bad))


# -------------------------------------------------- serving: the slices


class _LstmLike(torch.nn.Module):
    """A tiny acting model of the production shape: reads its one param,
    advances a [1, B, 4] state, returns [1, B] outputs."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((4,), 0.5))


def _lstm_like_act(model, generator, env_d, state):
    h = state["h"]
    new_h = torch.tanh(h + env_d["obs"].mean(-1, keepdim=True) * model.w)
    return {"action": new_h.sum(-1)}, {"h": new_h}


def _store(value=0.5):
    store = PolicySnapshotStore(1, registry=telemetry.MetricsRegistry())
    store.note_update(0)
    store.publish(0, [torch.full((4,), value)])
    return store


def _serving(split, store, num_slots=8):
    return parallel.build_sebulba_serving(
        split, store, num_slots=num_slots, max_batch_size=4, timeout_ms=20,
        max_policy_lag=10, slice_model=lambda d: _LstmLike().to(d),
        initial_state={"h": torch.zeros(1, 1, 4)},
        act_fn=_lstm_like_act, registry=telemetry.MetricsRegistry())


def _split(n_inf=2):
    return placement.resolve_device_split(
        f"inf={n_inf},learn=rest", [CPU] * (n_inf + 1))


def test_slice_step_serves_the_snapshot_and_pins_its_table():
    """A slice's table steps from the slice's snapshot: its output is the
    act of the published params (after the bf16 round trip), and its
    table's rows and replies live on the slice's device."""
    serving = _serving(_split(), _store(0.3))
    env = {"obs": np.ones((1, 4, 3), np.float32)}
    want_w = torch.tensor(0.3).to(torch.bfloat16).float()
    for stack in serving.stacks:
        table = stack.state_table
        assert table.device == stack.device and table.stream is None
        ctx, annotate = stack.hooks.begin_batch()
        out = table.step(np.arange(4), np.ones(4, bool), env, context=ctx)
        fetched = annotate(table.fetch(out, 4), 4)
        np.testing.assert_allclose(fetched["action"],
                                   4 * np.tanh(want_w.item()) * np.ones(
                                       (1, 4)), rtol=1e-6)
        assert (fetched["policy_lag"] == 0).all()
        assert table.context_version == 0
        for leaf in nest.flatten(table._rows):
            assert leaf.device == stack.device


def test_sharded_facade_routes_by_slot():
    split = _split()
    serving = _serving(split, _store())
    tables = serving.state_tables
    assert tables.num_slots == 8 and tables.trash_slot == 8
    env = {"obs": np.ones((1, 8, 3), np.float32)}
    for stack in serving.stacks:
        ctx, _ = stack.hooks.begin_batch()
        stack.state_table.step(np.arange(8), np.ones(8, bool), env,
                               context=ctx)
    for slot in range(8):
        expected = serving.stacks[split.slice_for_slot(slot)].state_table
        assert tables.table_for_slot(slot) is expected
        state = tables.read_slot(slot)
        assert state["h"].shape == (1, 1, 4)
        np.testing.assert_array_equal(state["h"],
                                      expected.read_slot(slot)["h"])
        assert np.abs(state["h"]).sum() > 0  # advanced
    # reset groups by slice and touches only the owning tables: slot 2
    # (slice 0) back to the initial state, slot 0 (slice 1) too, slot 1
    # kept.
    tables.reset([0, 2])
    assert np.abs(tables.read_slot(0)["h"]).sum() == 0
    assert np.abs(tables.read_slot(2)["h"]).sum() == 0
    assert np.abs(tables.read_slot(1)["h"]).sum() > 0
    # Poison and rebuild fan out (the supervisor's one-event contract).
    tables.poison()
    assert tables.poisoned
    tables.rebuild()
    assert not tables.poisoned
    assert all(np.abs(tables.read_slot(s)["h"]).sum() == 0
               for s in range(8))


class _FakeBatcher:
    def __init__(self):
        self.seen = []

    def compute(self, inputs, trace=None):
        self.seen.append(int(np.asarray(inputs.get("slot", -1)).reshape(
            -1)[0]) if isinstance(inputs, dict) and "slot" in inputs
            else None)
        return {"ok": True}

    def size(self):
        return 0

    def is_closed(self):
        return False


def _fake_router(split, registry=None):
    stacks = [parallel.SliceStack(i, d, _FakeBatcher(), None, None,
                                  lambda: None)
              for i, d in enumerate(split.inference_devices)]
    return stacks, parallel.SliceRouter(
        split, stacks, registry=registry or telemetry.MetricsRegistry())


def test_router_static_hash_stable_across_reconnects():
    """Routing is a pure function of the slot id: the same slot lands on
    the same slice across repeated requests and router rebuilds, and the
    per-slice counters sum to all requests."""
    split = _split()
    reg = telemetry.MetricsRegistry()
    stacks_a, router_a = _fake_router(split, reg)
    stacks_b, router_b = _fake_router(split)
    for _ in range(3):
        for slot in range(8):
            req = {"slot": np.full((1, 1), slot, np.int32)}
            router_a.compute(req)
            router_b.compute(req)
    for slot in range(8):
        want = split.slice_for_slot(slot)
        for stacks in (stacks_a, stacks_b):
            for i, stack in enumerate(stacks):
                assert stack.batcher.seen.count(slot) == (3 if i == want
                                                          else 0)
    counts = [reg.counter(f"inference.slice.{i}.requests").value()
              for i in range(2)]
    assert sum(counts) == 24 and counts[0] == 3 * 4


def test_router_round_robins_stateless():
    stacks, router = _fake_router(_split())
    for _ in range(10):
        router.compute({"env": {}})
    assert [len(s.batcher.seen) for s in stacks] == [5, 5]


def test_gauge_tick_and_snapshot():
    reg = telemetry.MetricsRegistry()
    serving = parallel.build_sebulba_serving(
        _split(), _store(), num_slots=4, max_batch_size=4, timeout_ms=20,
        max_policy_lag=10, slice_model=lambda d: _LstmLike().to(d),
        act_fn=lambda m, g, env, s: ({"a": env["obs"]}, s),
        registry=reg)
    assert serving.state_tables is None
    serving.gauge_tick(reg)()
    snap = parallel.slice_gauge_snapshot(reg)
    assert snap["inference.slice.0.depth"] == 0.0
    assert "inference.slice.1.requests" in snap


def test_latest_on_version_parity_with_the_reference():
    """Publish, place on a device: the version latest() reports, the
    leaves on the device, the values the reference's placement gives
    (the bf16 round trip, dtypes restored), cached until a republish."""
    from torchbeast_tpu.serving import PolicySnapshotStore as RefStore
    from torchbeast_tpu.telemetry.metrics import MetricsRegistry

    w = np.arange(8, dtype=np.float32) / 7.0
    ours = PolicySnapshotStore(1, registry=telemetry.MetricsRegistry())
    theirs = RefStore(1, registry=MetricsRegistry())
    devices = jax.devices()
    ours.note_update(0)
    ours.publish(0, {"w": torch.from_numpy(w),
                     "b": torch.ones(3, dtype=torch.bfloat16)})
    theirs.note_update(0)
    theirs.publish(0, jax.device_put({"w": jnp.asarray(w),
                                      "b": jnp.ones((3,), jnp.bfloat16)},
                                     devices[0]))
    version, placed = ours.latest_on(CPU)
    ref_version, ref_placed = theirs.latest_on(devices[1])
    assert version == ours.latest()[0] == ref_version == 0
    assert placed["w"].dtype == torch.float32
    assert placed["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(placed["w"].numpy(),
                                  np.asarray(ref_placed["w"]))
    np.testing.assert_array_equal(placed["b"].float().numpy(),
                                  np.asarray(ref_placed["b"], np.float32))
    assert ours.latest_on(CPU)[1] is placed  # cached
    ours.note_update(5)
    ours.publish(5, {"w": torch.from_numpy(w) * 2.0,
                     "b": torch.ones(3, dtype=torch.bfloat16)})
    version2, placed2 = ours.latest_on(CPU)
    assert version2 == 5 and placed2 is not placed
    np.testing.assert_array_equal(
        placed2["w"].numpy(),
        (torch.from_numpy(w) * 2.0).to(torch.bfloat16).float().numpy())


def test_hooks_ctx_lands_on_the_slice_device():
    from torchbeast_tpu_torch.serving import ReplicaServingHooks

    store = _store()
    hooks = ReplicaServingHooks(
        store, max_policy_lag=4, registry=telemetry.MetricsRegistry(),
        device=CPU, health_key="slice1_lag")
    (version, params), annotate = hooks.begin_batch()
    assert version == 0 and params[0].device == CPU
    assert params is store.latest_on(CPU)[1]
    out = annotate({"action": np.zeros((1, 3))}, 3)
    np.testing.assert_array_equal(out["policy_lag"],
                                  np.zeros((1, 3), np.int32))


# ------------------------------------------------------------- the drivers


def _poly_argv(tmp_path, xpid, *extra):
    return ["--disable_cuda", "--env", "Mock", "--num_servers", "2",
            "--batch_size", "2", "--unroll_length", "5",
            "--total_steps", "60", "--savedir", str(tmp_path),
            "--xpid", xpid, "--model", "mlp", "--use_lstm",
            "--pipes_basename", f"unix:{tmp_path}/pipes",
            "--num_inference_threads", "1",
            "--max_inference_batch_size", "4",
            "--checkpoint_interval_s", "100000", *extra]


@pytest.mark.parametrize("runtime", ["--no_native_runtime",
                                     "--native_runtime"])
def test_polybeast_device_split_e2e(tmp_path, runtime):
    """The reference's end-to-end case on both runtimes: polybeast with
    --device_split inf=1,learn=2 --num_learner_devices 2 trains to the
    end; every telemetry line carries learner.mesh_shape, device_split
    and the slice's series with the reference's values; the snapshot
    publication ran; every request went through the slice."""
    if runtime == "--native_runtime":
        from torchbeast_tpu_torch.runtime import native_build

        try:
            native_build.check_toolchain()
        except native_build.NativeBuildError as e:
            pytest.skip(str(e))
    reg = telemetry.get_registry()
    published = reg.counter("serving.snapshots_published")
    published_before = published.value()
    stats = polybeast.train(polybeast.make_parser().parse_args(_poly_argv(
        tmp_path, "poly-split", runtime, "--device_split", "inf=1,learn=2",
        "--num_learner_devices", "2")))
    assert stats["step"] >= 60 and np.isfinite(stats["total_loss"])
    assert stats["health"] == "HEALTHY"
    assert published.value() - published_before >= 1 + stats["updates"]
    lines = [json.loads(line) for line in open(
        tmp_path / "poly-split" / "telemetry.jsonl")]
    assert lines
    for line in lines:
        assert line["learner.mesh_shape"] == {"data": 2, "model": 1}
        assert line["device_split"] == {
            "spec": "inf=1,learn=2", "inference_slices": 1,
            "learner_devices": 2, "inference_device_ids": [0],
            "learner_device_ids": [1, 2]}
        assert "inference.slice.0.depth" in line.get("gauges", {})
    counters = lines[-1]["counters"]
    assert counters["inference.slice.0.requests"] > 0
    assert counters["inference.slice.0.rows"] == counters[
        "inference.slice.0.requests"]
    assert stats["inference_batch_mean"] >= 1.0


def test_polybeast_split_refusals(tmp_path, monkeypatch):
    """Before any side effect: the reference's --opt_impl pallas refusal
    on the split's learner mesh and its multi-process refusal; with one
    learner device the fused tail stays on the path."""
    parse = polybeast.make_parser().parse_args
    with pytest.raises(ValueError, match="fused tail is a per-chip"):
        polybeast.train(parse(_poly_argv(
            tmp_path, "a", "--device_split", "inf=1,learn=2",
            "--opt_impl", "pallas")))
    with pytest.raises(ValueError, match="does not compose with "
                                         "--expert_parallel"):
        polybeast.train(parse(_poly_argv(
            tmp_path, "b", "--device_split", "inf=1,learn=2",
            "--model", "transformer", "--num_experts", "4",
            "--expert_parallel", "2")))
    monkeypatch.setattr(parallel, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="bare --coordinator_address"):
        polybeast.train(parse(_poly_argv(
            tmp_path, "c", "--device_split", "inf=1,learn=2",
            "--num_learner_devices", "2")))
    assert not os.listdir(tmp_path)


def test_polybeast_split_one_learner_runs_the_fused_tail(tmp_path):
    """inf=2,learn=1 with --opt_impl pallas (the chip smoke's settings,
    at a tiny size): two slices, the one-device learner takes the fused
    tail (no refusal; its launches are counted on the card), every
    actor's requests on its hashed slice."""
    reg = telemetry.get_registry()
    before = [reg.counter(f"inference.slice.{i}.requests").value()
              for i in range(2)]
    stats = polybeast.train(polybeast.make_parser().parse_args(_poly_argv(
        tmp_path, "split-tail", "--no_native_runtime", "--num_servers", "4",
        "--device_split", "inf=2,learn=1", "--opt_impl", "pallas",
        "--vtrace_impl", "pallas", "--num_inference_threads", "2")))
    assert stats["step"] >= 60 and np.isfinite(stats["total_loss"])
    got = [reg.counter(f"inference.slice.{i}.requests").value() - before[i]
           for i in range(2)]
    split = placement.DeviceSplit("t", (CPU, CPU), (CPU,))
    served = {split.slice_for_slot(s) for s in range(4)}
    assert all(got[i] > 0 for i in served)
    assert all(got[i] == 0 for i in {0, 1} - served)


def test_polybeast_single_device_degrades(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=1")
    with caplog.at_level(logging.WARNING):
        stats = polybeast.train(polybeast.make_parser().parse_args(
            _poly_argv(tmp_path, "degrade", "--no_native_runtime",
                       "--device_split", "auto")))
    assert any("degrading to the time-shared serving path" in r.message
               for r in caplog.records)
    assert stats["step"] >= 60 and "slice_capture_s" not in stats


def _mono(tmp_path, xpid, *extra):
    flags = monobeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "deep", "--use_lstm",
        "--num_actors", "4", "--batch_size", "2", "--unroll_length", "4",
        "--total_steps", "48", "--serial_envs", "--vtrace_impl", "pallas",
        "--savedir", str(tmp_path), "--xpid", xpid, *extra])
    stats = monobeast.train(flags)
    return stats, read_payload(str(tmp_path / xpid / "model.ckpt"))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_monobeast_split_is_bitwise_time_shared(tmp_path):
    """--device_split inf=1,learn=1 moves acting to the first inference
    device and the update to the learner device without changing either:
    stats and the checkpoint (params, optimizer state) bitwise equal to
    the time-shared run from the same seed."""
    shared, shared_ckpt = _mono(tmp_path, "shared")
    split, split_ckpt = _mono(tmp_path, "split", "--device_split",
                              "inf=1,learn=1")
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm", "step"):
        assert shared[key] == split[key], key
    a, b = _leaves(shared_ckpt["params"]), _leaves(split_ckpt["params"])
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    a, b = _leaves(shared_ckpt["opt_state"]), _leaves(split_ckpt["opt_state"])
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


def test_monobeast_split_refuses_the_fused_tail(tmp_path):
    flags = monobeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--num_actors", "4",
        "--batch_size", "2", "--savedir", str(tmp_path), "--xpid", "x",
        "--device_split", "inf=1,learn=1", "--opt_impl", "pallas"])
    with pytest.raises(ValueError, match="does not compose with "
                                         "--device_split"):
        monobeast.train(flags)
    assert not os.listdir(tmp_path)


def test_monobeast_split_dp_learner(tmp_path):
    """inf=1,learn=2: the data-parallel learner over exactly the split's
    learner devices, its mesh shape and the split on the telemetry."""
    stats, _ = _mono(tmp_path, "dp", "--device_split", "inf=1,learn=2")
    assert stats["step"] == 48 and np.isfinite(stats["total_loss"])
    line = [json.loads(x) for x in open(tmp_path / "dp" /
                                         "telemetry.jsonl")][-1]
    assert line["learner.mesh_shape"] == {"data": 2, "model": 1}
    assert line["device_split"]["learner_device_ids"] == [1, 2]


@pytest.mark.parametrize("runtime", ["--no_native_runtime",
                                     "--native_runtime"])
def test_polybeast_split_stateless(tmp_path, runtime):
    """A feed-forward model under the split: no state table, requests
    round-robin over the two slices, each acting from its snapshot, the
    replies stamped."""
    if runtime == "--native_runtime":
        from torchbeast_tpu_torch.runtime import native_build

        try:
            native_build.check_toolchain()
        except native_build.NativeBuildError as e:
            pytest.skip(str(e))
    reg = telemetry.get_registry()
    before = [reg.counter(f"inference.slice.{i}.rows").value()
              for i in range(2)]
    argv = _poly_argv(tmp_path, "stateless", runtime, "--device_split",
                      "inf=2,learn=1", "--num_inference_threads", "2")
    argv.remove("--use_lstm")
    stats = polybeast.train(polybeast.make_parser().parse_args(argv))
    assert stats["step"] >= 60 and np.isfinite(stats["total_loss"])
    assert stats["health"] == "HEALTHY"
    rows = [reg.counter(f"inference.slice.{i}.rows").value() - before[i]
            for i in range(2)]
    assert all(r > 0 for r in rows)
    line = [json.loads(x) for x in open(
        tmp_path / "stateless" / "telemetry.jsonl")][-1]
    assert line["acting_path"]["agent_state"] == "host"


def test_supervisor_rebuilds_poisoned_slices():
    """The InferenceSupervisor over the slices' loops and their sharded
    tables: a poison landing while no request is served (the chaos
    harness's injection) is seen through ShardedStateTables.poisoned and
    rebuilt once, every slice's table, under one budget."""
    import time

    from torchbeast_tpu_torch.resilience import InferenceSupervisor

    reg = telemetry.MetricsRegistry()
    serving = _serving(_split(), _store())
    loops = [loop for loop in serving.loop_fns for _ in range(2)]
    supervisor = InferenceSupervisor(
        loops[0], num_threads=1, state_table=serving.state_tables,
        restart_budget=3, registry=reg, extra_loop_fns=loops[1:])
    supervisor.start()
    try:
        serving.state_tables.poison()
        deadline = time.monotonic() + 10
        while (serving.state_tables.poisoned
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert not serving.state_tables.poisoned
        assert reg.counter("recovery.table_rebuilds").value() == 1
        assert supervisor.restarts == 1
    finally:
        for stack in serving.stacks:
            stack.batcher.close()
        supervisor.join(timeout=10)
    assert supervisor.alive_count() == 0 and not supervisor.errors
