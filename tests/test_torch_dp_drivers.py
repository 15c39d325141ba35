"""The data-parallel learner in the port's three drivers, on the CPU's
virtual devices (tests/conftest.py's XLA_FLAGS), under --disable_cuda:

- monobeast --num_learner_devices 2 (batch 4): it trains, resumes with a
  monotone logs.csv step column and composes with --overlap_collect and
  --superstep_k, as the reference's test_train_mono_data_parallel does;
  the reference's bad-combination errors and the --opt_impl pallas
  refusal; learner.mesh_shape on every telemetry line;
- polybeast --num_learner_devices 2 on the Python pool and on the C++
  core; the reference's multi-host flag checks; --coordinator_address
  with two processes (tests/torch_dp_worker.py): every process trains
  the same number of collective updates, the lead alone checkpoints, the
  other logs under {xpid}-host1, and a second launch resumes;
- anakin --num_devices 2 on Catch: it trains and resumes, and one DP
  iteration's update equals the one-device update on the batch its
  shards collected (params rtol 1e-5, atol 2e-6; stats rtol 1e-4, eps
  1.0 as in tests/test_torch_learner.py);
- a DP checkpoint across the packages: the reference's monobeast over 4
  devices writes one that the port's 2-device monobeast resumes, and the
  port's 2-device checkpoint resumes in the reference's 4-device run.
"""

import copy
import csv
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torchbeast_tpu import monobeast as jax_monobeast
from torchbeast_tpu_torch import anakin, learner as learner_lib
from torchbeast_tpu_torch import monobeast, polybeast
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mono(tmp_path, xpid, *extra, total_steps=48):
    return monobeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "deep", "--use_lstm",
        "--num_actors", "4", "--batch_size", "4", "--unroll_length", "4",
        "--total_steps", str(total_steps), "--serial_envs", "--savedir",
        str(tmp_path), "--xpid", xpid, *extra])


def _steps(path):
    with open(path) as f:
        return [int(float(r["step"])) for r in csv.DictReader(f)]


def test_mono_data_parallel_trains_and_resumes(tmp_path):
    """The reference's test_train_mono_data_parallel on 2 devices, plus
    --superstep_k 2 on the resume."""
    stats = monobeast.train(_mono(tmp_path, "mono-dp",
                                  "--num_learner_devices", "2"))
    assert stats["step"] >= 48 and np.isfinite(stats["total_loss"])
    stats2 = monobeast.train(_mono(
        tmp_path, "mono-dp", "--num_learner_devices", "2",
        "--overlap_collect", "--num_actors", "8", "--superstep_k", "2",
        total_steps=112))
    assert stats2["step"] >= 112 and np.isfinite(stats2["total_loss"])
    assert stats2["updates"] == 4
    steps = _steps(tmp_path / "mono-dp" / "logs.csv")
    assert steps == sorted(steps) and steps[-1] >= 112, steps
    lines = [json.loads(line) for line in
             open(tmp_path / "mono-dp" / "telemetry.jsonl")]
    assert lines[-1]["learner.mesh_shape"] == {"data": 2, "model": 1}


@pytest.mark.parametrize("extra,match", [
    (["--num_learner_devices", "3"], "not divisible"),
    (["--num_learner_devices", "2", "--model", "transformer",
      "--sequence_parallel", "2", "--unroll_length", "7"],
     "composite meshes"),
    (["--num_learner_devices", "2", "--opt_impl", "pallas"],
     "--opt_impl pallas does not compose with --num_learner_devices"),
    (["--num_learner_devices", "16", "--batch_size", "16",
      "--num_actors", "16"], "only 8 devices are visible"),
])
def test_mono_dp_rejects_bad_combos(tmp_path, extra, match):
    """The reference's test_mono_dp_rejects_bad_combos, its --opt_impl
    pallas refusal and its mesh's "visible" error, raised before any
    side effect."""
    with pytest.raises(ValueError, match=match):
        monobeast.train(_mono(tmp_path, "bad", *extra))
    assert not (tmp_path / "bad").exists()


def test_mono_dp_reference_errors_match(tmp_path):
    """The same argv raises the same ValueError in the reference."""
    argv = ["--env", "Mock", "--num_actors", "4", "--batch_size", "4",
            "--savedir", str(tmp_path), "--xpid", "bad",
            "--num_learner_devices", "3"]
    with pytest.raises(ValueError, match="batch_size 4 not divisible by "
                                         "num_learner_devices 3"):
        jax_monobeast.train(jax_monobeast.make_parser().parse_args(argv))
    with pytest.raises(ValueError, match="batch_size 4 not divisible by "
                                         "num_learner_devices 3"):
        monobeast.train(monobeast.make_parser().parse_args(
            ["--disable_cuda", *argv]))


T, B = 5, 4


def _poly(tmp_path, xpid, *extra, total_steps=3 * T * B):
    return polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "deep", "--use_lstm",
        "--num_servers", "2", "--batch_size", str(B), "--unroll_length",
        str(T), "--total_steps", str(total_steps), "--savedir",
        str(tmp_path), "--xpid", xpid, "--pipes_basename",
        f"unix:{tmp_path}/pipes", "--max_inference_batch_size", "4",
        "--num_learner_devices", "2", "--vtrace_impl", "pallas", *extra])


@pytest.mark.parametrize("runtime", [
    ["--no_native_runtime"], ["--native_runtime", "--native_server"]],
    ids=["python", "native"])
def test_poly_data_parallel_trains_and_resumes(tmp_path, runtime):
    stats = polybeast.train(_poly(tmp_path, "poly-dp", *runtime))
    assert stats["step"] >= 3 * T * B and stats["updates"] >= 3
    assert np.isfinite(stats["total_loss"]) and stats["health"] == "HEALTHY"
    stats2 = polybeast.train(_poly(tmp_path, "poly-dp", *runtime,
                                   "--superstep_k", "2",
                                   total_steps=7 * T * B))
    assert stats2["step"] >= 7 * T * B
    steps = _steps(tmp_path / "poly-dp" / "logs.csv")
    assert steps == sorted(steps), steps
    lines = [json.loads(line) for line in
             open(tmp_path / "poly-dp" / "telemetry.jsonl")]
    last = lines[-1]
    assert last["learner.mesh_shape"] == {"data": 2, "model": 1}
    assert last["host_rank"] == 0 and last["fleet_size"] == 1


def test_poly_dp_refuses_the_fused_tail(tmp_path):
    with pytest.raises(ValueError, match="sharded learner meshes"):
        polybeast.train(_poly(tmp_path, "bad", "--opt_impl", "pallas"))


@pytest.mark.parametrize("changes,match", [
    ({"xpid": None}, "explicit --xpid"),
    ({"num_learner_devices": 1}, "--num_learner_devices > 1"),
    ({"num_learner_devices": 3}, "divisible by the 2 processes"),
    ({"batch_size": 3}, r"--batch_size 3 \(global\) must be divisible"),
])
def test_multihost_checks_are_the_reference(tmp_path, changes, match):
    flags = _poly(tmp_path, "mh")
    flags.num_learner_devices = 4
    for key, value in changes.items():
        setattr(flags, key, value)
    polybeast.check_multihost_flags(flags, 1)  # one process: no checks
    with pytest.raises(ValueError, match=match):
        polybeast.check_multihost_flags(flags, 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_poly_workers(savedir, total_steps, n=2):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "poly", str(rank), str(n), str(port),
         str(savedir), str(total_steps)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for rank in range(n)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank}:\n{out[-4000:]}"
    return outs


def test_poly_two_processes_end_to_end(tmp_path):
    """--coordinator_address: two processes, each with its own env
    servers, actors and inference on 2 of the 4 global rows, one
    collective update per dispatch over 4 shards (2 a process); the lead
    alone checkpoints; a second launch resumes in both. Each process seeds
    its acting generator from --seed + its rank, as the reference keys
    its acting rng."""
    total = 60  # 3 collective updates of 5 x 4 global frames
    outs = _run_poly_workers(tmp_path, total)
    updates = set()
    for rank, out in enumerate(outs):
        assert f"worker {rank}: final step" in out
        assert (f"Acting generator seeded from {1234 + rank} (host {rank})"
                in out), out[-4000:]
        updates.add(out.split(f"worker {rank}: final step")[1].split()[2])
    assert len(updates) == 1, updates  # the same number of updates
    assert (tmp_path / "poly-dist" / "logs.csv").exists()
    assert (tmp_path / "poly-dist-host1" / "logs.csv").exists()
    assert (tmp_path / "poly-dist" / "model.ckpt").exists()
    assert not (tmp_path / "poly-dist-host1" / "model.ckpt").exists()
    outs = _run_poly_workers(tmp_path, 2 * total)
    for out in outs:
        assert "Resuming preempted job" in out
    steps = _steps(tmp_path / "poly-dist" / "logs.csv")
    assert steps == sorted(steps) and steps[-1] >= 2 * total, steps


def _anakin(tmp_path, xpid, *extra):
    return anakin.make_parser().parse_args([
        "--disable_cuda", "--env", "Catch", "--batch_size", "4",
        "--unroll_length", "4", "--savedir", str(tmp_path), "--xpid", xpid,
        "--log_interval_updates", "1", "--checkpoint_interval_s",
        "100000", *extra])


def test_anakin_data_parallel_trains_and_resumes(tmp_path):
    stats = anakin.train(_anakin(tmp_path, "ana-dp", "--num_devices", "2",
                                 "--total_steps", "64"))
    assert stats["step"] == 64 and np.isfinite(stats["total_loss"])
    stats = anakin.train(_anakin(tmp_path, "ana-dp", "--num_devices", "2",
                                 "--total_steps", "128"))
    assert stats["step"] == 128
    assert _steps(tmp_path / "ana-dp" / "logs.csv") == [
        16 * i for i in range(1, 9)]


@pytest.mark.parametrize("model", [["--model", "mlp"],
                                   ["--model", "deep", "--use_lstm"]],
                         ids=["mlp", "deep_lstm"])
def test_anakin_dp_iteration_is_the_batchs_update(tmp_path, model):
    """One 2-shard iteration: each shard collects its half of the envs
    (the one-device run's initial carry, split); its update equals the
    one-device update_body on the two shards' batches side by side, from
    the agent state that entered the unroll."""
    flags = _anakin(tmp_path, "x", "--num_devices", "2", "--epsilon", "1.0",
                    "--entropy_cost_final", "0.0", *model)
    setup = anakin.setup(flags, torch.device("cpu"))
    twin = copy.deepcopy(setup.model)
    state0 = [s.clone() for s in (setup.carry.agent_state or ())]
    step = anakin.make_dispatch(flags, setup)
    stats = step()
    batch = {k: torch.cat([c.buffers[k] for c in step.collects], dim=1)
             for k in step.collects[0].buffers}
    opt = learner_lib.make_optimizer(setup.hp, list(twin.parameters()))
    want = learner_lib.update_body(twin, opt, setup.hp)(
        batch, tuple(state0) if state0 else setup.carry.agent_state)
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm", "episode_count"):
        np.testing.assert_allclose(float(stats[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    for p, q in zip(setup.model.parameters(), twin.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-5, atol=2e-6)


def _mono_ckpt_args(tmp_path, devices, total_steps):
    return ["--env", "Mock", "--model", "deep", "--use_lstm",
            "--num_actors", "4", "--batch_size", "4", "--unroll_length",
            "4", "--total_steps", str(total_steps), "--serial_envs",
            "--savedir", str(tmp_path), "--xpid", "cross",
            "--num_learner_devices", str(devices)]


def test_dp_checkpoint_crosses_the_packages(tmp_path):
    """The reference's 4-device DP monobeast writes model.ckpt, the
    port's 2-device DP run resumes it (its log continues past the
    reference's step) and writes its own, which the reference's 4-device
    run resumes in turn."""
    jax_monobeast.train(jax_monobeast.make_parser().parse_args(
        _mono_ckpt_args(tmp_path, 4, 16)))
    stats = monobeast.train(monobeast.make_parser().parse_args(
        ["--disable_cuda", *_mono_ckpt_args(tmp_path, 2, 32)]))
    assert stats["step"] == 32
    stats = jax_monobeast.train(jax_monobeast.make_parser().parse_args(
        _mono_ckpt_args(tmp_path, 4, 48)))
    assert stats["step"] == 48
    steps = _steps(tmp_path / "cross" / "logs.csv")
    assert steps == [16, 32, 48], steps
