"""Sequence parallelism in the port's drivers on the CPU's virtual devices
(tests/conftest.py's XLA_FLAGS), under --disable_cuda, against the
reference's drivers with the same flags.

- The update each driver builds from its flags, against the reference's
  from the same flags (its _init_model_and_params on the `seq` mesh its
  flags build), on one batch from the same weights: monobeast
  --sequence_parallel 2 with the contiguous ring, the zigzag ring,
  Ulysses, and seq 2 x expert 2 (V-trace's kernel and the fused tail,
  their plain versions here), and polybeast --sequence_parallel 2
  --num_learner_devices 2 (the composite data x seq mesh, each replica
  on its row's seq devices). Params rtol 1e-4 / atol 1e-6, the stats
  rtol 1e-4; RMSprop eps 1.0 as tests/test_torch_learner.py explains.
- End to end: monobeast trains under each strategy, and polybeast data 2
  x seq 2 on the Python pool and on the C++ core, its telemetry line
  carrying the reference's learner.mesh_shape, and across two
  --coordinator_address processes (tests/torch_dp_worker.py `poly_sp`;
  the seq axis stays within each process).

The refusals are tests/test_torch_sp_fleet_refusals.py's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu import monobeast as jax_monobeast
from torchbeast_tpu import polybeast as jax_polybeast
from torchbeast_tpu.parallel import create_mesh as jax_create_mesh
from torchbeast_tpu.parallel import (
    make_parallel_update_step as jax_parallel_update,
    replicate as jax_replicate,
    shard_batch as jax_shard_batch,
)
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import monobeast, parallel, polybeast, weights
from tests.test_torch_tp_pp_drivers import REPO, RUNTIMES, _free_port
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

A = 5
FRAME = (6, 6, 2)
T, B = 7, 4  # T + 1 = 8 steps: the ring, the zigzag (2P = 4) and Ulysses
STATS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss")
CPU = torch.device("cpu")


def _argv(*extra):
    return ["--env", "Mock", "--num_actors", str(B), "--batch_size",
            str(B), "--unroll_length", str(T), "--total_steps", "64",
            "--serial_envs", "--epsilon", "1.0", "--model", "transformer",
            "--vtrace_impl", "pallas", *extra]


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    n = T + 1
    return {
        "frame": rng.integers(0, 255, (n, B) + FRAME, dtype=np.uint8),
        "reward": rng.standard_normal((n, B)).astype(np.float32),
        "done": rng.random((n, B)) < 0.2,
        "last_action": rng.integers(0, A, (n, B)).astype(np.int32),
        "episode_return": rng.standard_normal((n, B)).astype(np.float32),
        "episode_step": rng.integers(0, 9, (n, B)).astype(np.int32),
        "action": rng.integers(0, A, (n, B)).astype(np.int32),
        "policy_logits": rng.standard_normal((n, B, A)).astype(np.float32),
        "baseline": rng.standard_normal((n, B)).astype(np.float32),
    }


def _tensors(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _close(got, want):
    for key in STATS:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                                atol=1e-6),
        got["params"], want["params"])


MONO_CASES = {
    "ring": [],
    "zigzag": ["--ring_schedule", "zigzag"],
    "ulysses": ["--sp_strategy", "ulysses"],
    "seq2_expert2": ["--num_experts", "4", "--expert_parallel", "2"],
}


@pytest.mark.parametrize("case", sorted(MONO_CASES))
def test_monobeast_sp_update_is_the_references(case):
    argv = _argv("--sequence_parallel", "2", "--opt_impl", "pallas",
                 *MONO_CASES[case])
    flags = jax_monobeast.make_parser().parse_args(argv)
    jmodel, params = jax_monobeast._init_model_and_params(
        flags, A, B, FRAME)
    params = jax.device_get(params)
    hp = jax_monobeast.hparams_from_flags(flags)
    optimizer = jax_learner.make_optimizer(hp)
    state = jmodel.initial_state(B)
    p, _, stats = jax_learner.make_update_step(
        jmodel, optimizer, hp, donate=False)(
            params, optimizer.init(params), _batch(), state)
    want = {**jax.device_get(stats), "params": jax.device_get(p)}

    flags = monobeast.make_parser().parse_args(["--disable_cuda", *argv])
    monobeast.check_flags(flags)
    mesh = monobeast.seq_mesh(CPU, flags)
    # The reference's 1-D mesh has the seq axis alone; the port's mesh
    # always names data and model too.
    assert all(mesh.shape[k] == v for k, v in jmodel.mesh.shape.items())
    model = monobeast.build_model(flags, A, FRAME, CPU)
    weights.load_jax_params(model, params)
    monobeast.place_sequence_parallel(model, mesh, flags)
    if "expert" in mesh.shape:
        monobeast.place_experts(model, mesh)
    strategy = "ulysses" if case == "ulysses" else "ring"
    assert model.block_0._sequence_parallel(T + 1, 4) == strategy
    hp = monobeast.hparams_from_flags(flags)
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    got = port_learner.make_update_dispatch(model, opt, hp)(
        _tensors(_batch()), _tensors(state))
    _close({**got, "params": weights.torch_to_jax(model.state_dict())},
           want)


def test_polybeast_data2_seq2_update_is_the_references():
    """The reference's composite (data 2, seq 2) learner
    (polybeast.py:860-873, the model's batch_axis "data") against the
    port's: each replica's ring over its row's seq devices."""
    argv = [a for a in _argv("--sequence_parallel", "2",
                             "--num_learner_devices", "2")
            if a != "--serial_envs"]
    flags = jax_polybeast.make_parser().parse_args(argv)
    mesh = jax_create_mesh(4, seq_parallelism=2)
    jmodel, params = jax_monobeast._init_model_and_params(
        flags, A, B, FRAME, seq_mesh=mesh)
    params = jax.device_get(params)
    hp = jax_monobeast.hparams_from_flags(flags)
    optimizer = jax_learner.make_optimizer(hp)
    state = jmodel.initial_state(B)
    step = jax_parallel_update(jmodel, optimizer, hp, mesh, donate=False)
    b, s = jax_shard_batch(mesh, _batch(), state)
    p, _, stats = step(jax_replicate(mesh, params),
                       jax_replicate(mesh, optimizer.init(params)), b, s)
    want = {**jax.device_get(stats), "params": jax.device_get(p)}

    flags = polybeast.make_parser().parse_args(["--disable_cuda", *argv])
    polybeast.check_flags(flags)
    ours = monobeast.learner_mesh(CPU, 2, seq_par=2)
    assert ours.shape == dict(mesh.shape)
    model = monobeast.build_model(flags, A, FRAME, CPU)
    weights.load_jax_params(model, params)
    monobeast.place_sequence_parallel(model, ours, flags)
    hp = monobeast.hparams_from_flags(flags)
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    update = parallel.make_parallel_update_step(model, opt, hp, ours)
    got = update(_tensors(_batch()), _tensors(state))
    assert [r.block_0.seq_devices for r in update.learner.replicas] == [
        ours.seq_devices(i) for i in range(2)]
    _close({**got, "params": weights.torch_to_jax(model.state_dict())},
           want)


@pytest.mark.parametrize("case", sorted(MONO_CASES))
def test_monobeast_trains_sequence_parallel(tmp_path, case):
    flags = monobeast.make_parser().parse_args([
        "--disable_cuda", *_argv("--sequence_parallel", "2",
                                 "--opt_impl", "pallas",
                                 *MONO_CASES[case]),
        "--total_steps", "56", "--savedir", str(tmp_path), "--xpid", case])
    stats = monobeast.main(flags)
    # Two updates of B x T = 28 frames.
    assert stats["step"] == 56 and np.isfinite(stats["total_loss"])
    last = [json.loads(line) for line in
            open(tmp_path / case / "telemetry.jsonl")][-1]
    want = {"data": 1, "model": 1, "seq": 2}
    if "expert" in case:
        want["expert"] = 2
    assert last["learner.mesh_shape"] == want


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_polybeast_trains_data2_seq2(tmp_path, runtime):
    flags = polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "transformer",
        "--num_servers", "2", "--batch_size", "4", "--unroll_length",
        str(T), "--total_steps", "64", "--max_inference_batch_size", "4",
        "--pipes_basename", f"unix:{tmp_path}/pipes", "--savedir",
        str(tmp_path), "--xpid", "sp", "--vtrace_impl", "pallas",
        "--checkpoint_interval_s", "100000", "--sequence_parallel", "2",
        "--num_learner_devices", "2", *runtime])
    stats = polybeast.main(flags)
    assert stats["step"] >= 64 and np.isfinite(stats["total_loss"])
    assert stats["health"] == "HEALTHY"
    last = [json.loads(line) for line in
            open(tmp_path / "sp" / "telemetry.jsonl")][-1]
    assert last["learner.mesh_shape"] == {"data": 2, "model": 1, "seq": 2}


def test_two_process_polybeast_sp(tmp_path):
    """polybeast --sequence_parallel 2 --num_learner_devices 2 across two
    --coordinator_address processes (2 CPU devices each: one data row of
    2 seq devices a process)."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "poly_sp", str(rank), "2", str(port),
         str(tmp_path), "20"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for rank in range(2)]
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
    updates = {out.split(f"worker {r}: final step")[1].split()[2]
               for r, out in enumerate(outs)}
    assert len(updates) == 1, updates
    assert "Parallel learner: data=2 x seq=2 (2 processes)" in outs[0]
    assert (tmp_path / "poly-dist" / "model.ckpt").exists()
