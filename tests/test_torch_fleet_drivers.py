"""The port's polybeast as a two-host fleet on the CPU: two processes
(tests/torch_fleet_worker.py), Mock env servers each, a few dispatches.

- The wire strategy (the CPU's): the hosts average their params after
  every dispatch and end with equal params; the lead checkpoints, the
  remote logs under {xpid}-host1; each host's telemetry carries the
  fleet's statics with the reference's keys (FleetSpec.describe() and
  the strategy), host_rank and fleet_size; the lead's remote snapshot
  publications reach the remote's store.
- The process-group strategy (the card's, "xla"), on the CPU in a gloo
  group both hosts join first (the worker's choice): the learner mesh's
  data axis spans the hosts and the hosts end with equal params.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

from torchbeast_tpu.fleet import FleetSpec as JaxFleetSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _run_fleet(tmp_path, mode, total_steps=60):
    port = _free_port_pair()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    env.pop("XLA_FLAGS", None)  # one CPU device a host
    worker = os.path.join(REPO, "tests", "torch_fleet_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(rank), "2", str(port), str(tmp_path),
         str(total_steps), mode], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for rank in (1, 0)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    results = {}
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        line = json.loads(out.strip().splitlines()[-1])
        results[line["rank"]] = (line, out)
    return results


def _telemetry(path):
    return [json.loads(line) for line in open(path)][-1]


@pytest.mark.parametrize("mode", ["wire", "group"])
def test_two_host_fleet_trains_with_equal_params(tmp_path, mode):
    results = _run_fleet(tmp_path, mode)
    lead, remote = results[0][0], results[1][0]
    assert lead["step"] >= 60 and remote["step"] == lead["step"]
    assert lead["health"] == remote["health"] == "HEALTHY"
    assert lead["params"] == remote["params"]
    assert (tmp_path / "fleet" / "model.ckpt").exists()
    assert not (tmp_path / "fleet-host1" / "model.ckpt").exists()
    strategy = "wire" if mode == "wire" else "xla"
    keys = set(JaxFleetSpec(0, 2, "h:1").describe()) | {"strategy"}
    for rank, sub in ((0, "fleet"), (1, "fleet-host1")):
        last = _telemetry(tmp_path / sub / "telemetry.jsonl")
        assert last["host_rank"] == rank and last["fleet_size"] == 2
        assert set(last["fleet"]) == keys
        assert last["fleet"]["strategy"] == strategy
        assert last["fleet"]["host_rank"] == rank
        assert last["learner.mesh_shape"]["data"] == 2
    if mode == "wire":
        remote_last = _telemetry(tmp_path / "fleet-host1" /
                                 "telemetry.jsonl")
        assert remote_last["counters"]["fleet.param_syncs"] > 0
        assert remote_last["counters"]["fleet.param_sync_timeouts"] == 0
        assert remote_last["counters"]["fleet.snapshots_received"] > 0
    else:
        assert "Parallel learner: data=2 (2 processes)" in results[0][1]
