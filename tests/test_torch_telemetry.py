"""The port's telemetry exporters and driver lifecycle
(torchbeast_tpu_torch/telemetry/{export,driver}.py) against the JAX
package's: the same registry operations give equal snapshots, deltas,
merges, validation, Prometheus text and telemetry blocks; the JSON-lines
exporter's lines read back alike; a CPU monobeast run of each package
with the same flags writes telemetry.jsonl lines with the same series
names and kinds, the remat plan's static and the bytes-accessed gauge
included; the port's polybeast lines carry the reference's serving,
chaos and recovery series; the Prometheus endpoint serves on an
ephemeral port; and --profile_dir writes a trace profile_update reads."""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from torchbeast_tpu_torch import telemetry
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_telemetry():
    from torchbeast_tpu import telemetry as jax_telemetry

    return jax_telemetry


def _drive(tel, reg):
    """The same instrument operations on one package's registry."""
    rng = np.random.default_rng(3)
    reg.counter("a.count").inc(3)
    reg.counter("b.bytes").inc(1024)
    reg.gauge("c.depth").set(7.5)
    h = reg.histogram("d.latency_s")
    for v in rng.exponential(0.01, size=200):
        h.observe(float(v))
    reg.histogram("e.empty")
    return tel.snapshot(reg)


def _without_time(snap):
    return {k: v for k, v in snap.items() if k not in ("time", "interval_s")}


def test_snapshot_delta_merge_prometheus_match_the_reference():
    jt = _jax_telemetry()
    ours_reg, theirs_reg = telemetry.MetricsRegistry(), jt.MetricsRegistry()
    first = (_drive(telemetry, ours_reg), _drive(jt, theirs_reg))
    assert _without_time(first[0]) == _without_time(first[1])
    second = (_drive(telemetry, ours_reg), _drive(jt, theirs_reg))
    assert _without_time(second[0]) == _without_time(second[1])
    d_ours = telemetry.delta(second[0], first[0])
    d_theirs = jt.delta(second[1], first[1])
    assert _without_time(d_ours) == _without_time(d_theirs)
    assert d_ours["counters"]["a.count"] == 3
    m_ours = telemetry.merge_snapshots(first[0], d_ours)
    m_theirs = jt.merge_snapshots(first[1], d_theirs)
    assert _without_time(m_ours) == _without_time(m_theirs)
    for snap in (first[0], d_ours, m_ours):
        assert telemetry.validate_snapshot(snap) == []
    bad = dict(first[0], counters={"x": "nan"})
    assert telemetry.validate_snapshot(bad) == jt.validate_snapshot(bad)
    assert telemetry.validate_snapshot(bad)
    assert (telemetry.render_prometheus(second[0])
            == jt.render_prometheus(second[1]))
    block_ours = telemetry.telemetry_block(prev=first[0], registry=ours_reg)
    block_theirs = jt.telemetry_block(prev=first[1], registry=theirs_reg)
    assert set(block_ours) == set(block_theirs) == {"enabled", "snapshot"}
    assert (_without_time(block_ours["snapshot"])
            == _without_time(block_theirs["snapshot"]))
    assert telemetry.SCHEMA_VERSION == jt.SCHEMA_VERSION


def test_jsonl_exporter_and_reader_match_the_reference(tmp_path):
    jt = _jax_telemetry()
    lines = {}
    for name, tel in (("ours", telemetry), ("theirs", jt)):
        reg = tel.MetricsRegistry()
        _drive(tel, reg)
        path = tmp_path / f"{name}.jsonl"
        exporter = tel.JsonLinesExporter(str(path), registry=reg,
                                         static={"driver": "x"})
        exporter.static["block"] = {"k": 1}
        exporter.write(extra={"step": 1})
        reg.counter("a.count").inc()
        exporter.write(extra={"step": 2, "final": True})
        with open(path, "a") as f:
            f.write("{torn line\n")  # a crash mid-write
        lines[name] = tel.read_jsonl(str(path))
    assert len(lines["ours"]) == len(lines["theirs"]) == 2
    for a, b in zip(lines["ours"], lines["theirs"]):
        assert _without_time(a) == _without_time(b)
    assert lines["ours"][1]["counters"]["a.count"] == 4
    assert lines["ours"][1]["block"] == {"k": 1}


def test_prometheus_endpoint_serves_on_an_ephemeral_port():
    reg = telemetry.MetricsRegistry()
    _drive(telemetry, reg)
    server = telemetry.PrometheusServer(reg, port=0).start()
    try:
        assert server.port > 0
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=10) as r:
            body = r.read().decode()
        assert body == telemetry.render_prometheus(telemetry.snapshot(reg))
        assert "a_count" in body
    finally:
        server.stop()


def test_selftest_passes():
    from torchbeast_tpu_torch.telemetry.export import _selftest

    verdict = _selftest(None)
    assert verdict["ok"], verdict


def _kinds(line):
    return {(kind, name) for kind in ("counters", "gauges", "histograms")
            for name in line[kind]}


def _statics(line):
    return set(line) - {"counters", "gauges", "histograms", "time"}


MONO_ARGV = ["--env", "Mock", "--model", "shallow", "--num_actors", "4",
             "--batch_size", "2", "--unroll_length", "4", "--total_steps",
             "48", "--serial_envs", "--xpid", "tele"]


def _train_in_a_fresh_process(package, argv):
    """One monobeast run in an interpreter of its own, so its registry
    holds that run's series alone (the registry is process-wide)."""
    code = (
        "import os, sys\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        f"from {package} import monobeast\n"
        "monobeast.train(monobeast.make_parser().parse_args(sys.argv[1:]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_monobeast_series_match_the_reference(tmp_path):
    """A CPU monobeast run of each package, the same flags: the same
    series names and kinds and the same statics on the final
    telemetry.jsonl line."""
    _train_in_a_fresh_process(
        "torchbeast_tpu", MONO_ARGV + ["--savedir", str(tmp_path / "jax")])
    _train_in_a_fresh_process(
        "torchbeast_tpu_torch",
        MONO_ARGV + ["--savedir", str(tmp_path / "port"), "--disable_cuda",
                     "--profile_dir", str(tmp_path / "prof")])
    theirs = telemetry.read_jsonl(str(tmp_path / "jax/tele/telemetry.jsonl"))
    ours = telemetry.read_jsonl(str(tmp_path / "port/tele/telemetry.jsonl"))
    assert ours and ours[-1]["final"] and ours[-1]["step"] == 48
    for line in ours:
        assert telemetry.validate_snapshot(line) == []
    assert _kinds(ours[-1]) == _kinds(theirs[-1])
    assert _statics(ours[-1]) == _statics(theirs[-1])
    assert set(ours[-1]["learner.remat_plan"]) == set(
        theirs[-1]["learner.remat_plan"])
    assert ours[-1]["gauges"]["learner.hbm_bytes_per_update"] > 0
    assert ours[-1]["learner.mesh_shape"] == theirs[-1]["learner.mesh_shape"]
    assert ours[-1]["counters"]["learner.updates"] == \
        theirs[-1]["counters"]["learner.updates"]
    # --profile_dir: a chrome trace profile_update's reader opens.
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


# The reference's series of a polybeast run with the serving tier and a
# chaos plan armed (the JAX polybeast's final line, Python runtime).
POLY_SERVING_SERIES = {
    ("counters", name) for name in (
        "serving.admitted", "serving.shed", "serving.expired",
        "serving.resubmitted", "serving.replica_requests",
        "serving.central_requests", "serving.snapshots_published",
        "serving.snapshot_bytes_published",
        "serving.snapshot_refresh_failures",
        "serving.replica_degradations", "slo.rtt_breaches",
        "chaos.env_server_sigkill.injected", "chaos.transport_sever.injected",
        "chaos.learner_stall.injected", "chaos.state_table_poison.injected",
        "recovery.server_restarts", "recovery.actor_reconnects",
        "recovery.inference_restarts", "recovery.table_rebuilds",
        "learner.updates", "learner.host_syncs", "replica.batches",
    )} | {
    ("gauges", name) for name in (
        "serving.queue_delay_p99_s", "serving.slo_ratio",
        "serving.snapshot_lag", "serving.snapshot_version", "actor.live",
        "acting.bytes_per_step_up", "acting.bytes_per_step_down",
        "health.state",
    )} | {
    ("histograms", name) for name in (
        "serving.queue_delay_s", "serving.policy_lag",
        "actor.request_rtt_s", "inference.request_wait_s",
        "replica.dispatch_s", "learner.update_dispatch_s",
        "learner.dequeue", "learner.learn",
    )}
POLY_STATICS = {"driver", "host_rank", "fleet_size", "learner.mesh_shape",
                "learner.remat_plan", "acting_path", "slo", "chaos",
                "final", "step", "schema"}


@pytest.mark.parametrize("runtime", ["--no_native_runtime",
                                     "--native_runtime"])
def test_polybeast_lines_carry_the_reference_series(tmp_path, runtime,
                                                   monkeypatch):
    """A short CPU polybeast run with the admission gate, replicas and a
    chaos plan armed writes lines that validate, with the reference's
    serving, chaos and recovery series and statics. The learner batches
    carry the leaves the card's learner graph is captured with
    (polybeast._dummy_learner_inputs, policy_lag included)."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import polybeast

    batch_keys = set()
    instrument = learner_lib.instrument_update_step

    def recording(update, **kwargs):
        def wrapped(batch, state):
            batch_keys.update(batch)
            return update(batch, state)

        return instrument(wrapped, **kwargs)

    monkeypatch.setattr(learner_lib, "instrument_update_step", recording)

    plan = tmp_path / "plan.json"
    # The chaos harness's plan shape (chaos_run.build_plan) at its
    # selftest's unroll, T=20, with two actors a server: a poison is
    # rebuilt by the serving thread that meets it first, so some actor
    # must be mid-unroll when it lands (the learner's step, which
    # triggers it, moves right after actors hand in their rollouts).
    plan.write_text(json.dumps({"seed": 1, "faults": [
        {"kind": "env_server_sigkill", "at_step": 80, "target": 0},
        {"kind": "transport_sever", "at_step": 160, "target": 1},
        {"kind": "learner_stall", "at_step": 200, "duration_s": 0.5},
        {"kind": "state_table_poison", "at_step": 280}]}))
    before = telemetry.snapshot()
    stats = polybeast.train(polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "shallow",
        "--use_lstm", "--num_servers", "2", "--num_actors", "4",
        "--batch_size", "2",
        "--unroll_length", "20", "--total_steps", "400", "--savedir",
        str(tmp_path), "--xpid", "poly", "--pipes_basename",
        f"unix:{tmp_path}/pipes", "--max_inference_batch_size", "4",
        "--num_inference_threads", "1", "--request_deadline_ms", "300",
        "--replica_refresh_updates", "1", "--chaos_plan", str(plan),
        runtime]))
    lines = telemetry.read_jsonl(str(tmp_path / "poly/telemetry.jsonl"))
    for line in lines:
        assert telemetry.validate_snapshot(line) == []
    last = lines[-1]
    assert POLY_SERVING_SERIES <= _kinds(last), \
        POLY_SERVING_SERIES - _kinds(last)
    assert POLY_STATICS <= _statics(last)
    assert last["learner.remat_plan"]["source"] == "default"
    assert last["gauges"]["learner.hbm_bytes_per_update"] > 0
    assert last["chaos"] == stats["chaos"]
    assert stats["chaos"]["injected"] == {
        "learner_stall": 1, "env_server_sigkill": 1, "transport_sever": 1,
        "state_table_poison": 1}
    assert last["acting_path"]["agent_state"] == "device_table"
    dummy, _ = polybeast._dummy_learner_inputs(
        20, 2, 1, (84, 84, 4), 6, {}, None, policy_lag=True)
    assert batch_keys == set(dummy)
    assert last["slo"]["target_s"] == pytest.approx(0.3)
    c = telemetry.delta(last, before)["counters"]  # this run's counts
    assert c["serving.resubmitted"] == c["serving.shed"] + \
        c["serving.expired"]
    assert c["serving.replica_requests"] > 0
    assert c["recovery.server_restarts"] == 1
    assert c["recovery.actor_reconnects"] == 2 + 1  # 2 actors a server
    assert c["recovery.table_rebuilds"] == 1


def test_driver_telemetry_degrades_on_a_taken_port(tmp_path):
    """A --telemetry_port that cannot be bound leaves the run without
    the endpoint, not failed; --no_telemetry writes nothing."""
    import argparse

    parser = argparse.ArgumentParser()
    telemetry.add_arguments(parser)
    blocker = telemetry.PrometheusServer(telemetry.MetricsRegistry(),
                                         port=0).start()
    try:
        flags = parser.parse_args(["--telemetry_port", str(blocker.port)])
        tele = telemetry.DriverTelemetry(flags, str(tmp_path / "t.jsonl"),
                                         driver="x")
        assert tele.prometheus is None
        ticks = []
        tele.add_tick_callback(lambda: ticks.append(1))
        tele.shutdown(step=3)
        assert ticks == [1]
        assert telemetry.read_jsonl(str(tmp_path / "t.jsonl"))[-1][
            "step"] == 3
    finally:
        blocker.stop()
    off = telemetry.DriverTelemetry(parser.parse_args(["--no_telemetry"]),
                                    str(tmp_path / "off.jsonl"), driver="x")
    try:
        off.write()
        off.shutdown()
        assert not os.path.exists(tmp_path / "off.jsonl")
    finally:
        telemetry.set_enabled(True)
