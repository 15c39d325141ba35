"""Tensor and pipeline parallelism in the port's drivers on the CPU's
virtual devices (tests/conftest.py's XLA_FLAGS), under --disable_cuda,
against the reference's drivers with the same flags.

- The update each driver builds from its flags, against the reference's
  from the same flags (its _init_model_and_params, its mesh and
  shardings), on one batch from the same weights: monobeast
  --pipeline_parallel 2 for both pipelined families (the fused tail and
  V-trace's kernel, their plain versions here; params rtol 1e-5 / atol
  2e-6), polybeast --tensor_parallel 2 with and without
  --num_learner_devices 2, and polybeast --num_learner_devices 2
  --pipeline_parallel 2 (the pipelined transformer's 4 layers in two
  passes; params rtol 1e-4 / atol 1e-6); the stats rtol
  1e-4; RMSprop eps 1.0 as tests/test_torch_learner.py explains. The
  whole runs sample their actions from each package's own RNG, so their
  trajectories part: each driver trains with these flags to the same
  step, and monobeast's checkpoint resumes in the reference's run with
  the same flags.
- End to end: polybeast --tensor_parallel 2 (alone, with
  --num_learner_devices 2, with --expert_parallel 2), data 2 x pipe 2
  and --pipeline_parallel 2 alone, on the Python pool and on the C++
  core; learner.mesh_shape on the telemetry line; TP across two
  --coordinator_address processes (tests/torch_dp_worker.py `poly_tp`)
  on both runtimes.

The reference's refusals of these flags are tests/test_torch_tp_pp_
refusals.py's.
"""

import csv
import json
import os
import socket
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
    merge_param_shardings as jax_merge_param_shardings,
    replicate as jax_replicate,
    shard_batch as jax_shard_batch,
    transformer_tp_shardings as jax_transformer_tp_shardings,
)
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import monobeast, parallel, polybeast, weights
from torchbeast_tpu_torch.runtime import native_build
from tests.test_torch_pipelined import A, FRAME, _tensors
from tests.test_torch_pp import _learner_batch
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B = 4, 8  # tests/test_torch_pipelined.py's batch
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss")
CPU = torch.device("cpu")


def _argv(*extra):
    return ["--env", "Mock", "--num_actors", str(B), "--batch_size",
            str(B), "--unroll_length", str(T), "--total_steps", "64",
            "--serial_envs", "--epsilon", "1.0", *extra]


def _close(got, want, rtol, atol):
    for key in STATS:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=rtol,
                                                atol=atol), got["params"],
        want["params"])


def _reference_mono_update(argv):
    """The reference monobeast's update from `argv`: its model and params
    from _init_model_and_params on the pipe mesh its flags build, one
    update on _learner_batch."""
    flags = jax_monobeast.make_parser().parse_args(argv)
    model, params = jax_monobeast._init_model_and_params(
        flags, A, flags.batch_size, FRAME)
    params = jax.device_get(params)
    hp = jax_monobeast.hparams_from_flags(flags)
    optimizer = jax_learner.make_optimizer(hp)
    state = model.initial_state(flags.batch_size)
    p, _, stats = jax_learner.make_update_step(
        model, optimizer, hp, donate=False)(
            params, optimizer.init(params), _learner_batch(), state)
    return params, state, {**jax.device_get(stats),
                           "params": jax.device_get(p)}


@pytest.mark.parametrize("family", [
    ["--model", "pipelined_mlp", "--use_lstm"],
    ["--model", "pipelined_transformer", "--pipeline_stages", "2"]],
    ids=["mlp_lstm", "transformer"])
def test_monobeast_pp_update_is_the_references(family):
    argv = _argv(*family, "--pipeline_parallel", "2",
                 "--pipeline_microbatches", "4", "--vtrace_impl", "pallas",
                 "--opt_impl", "pallas")
    params, state, want = _reference_mono_update(argv)
    flags = monobeast.make_parser().parse_args(["--disable_cuda", *argv])
    mesh = monobeast.pipe_mesh(CPU, flags)
    n_mb = monobeast.check_pp_flags(flags, mesh)
    assert n_mb == 4 and mesh.shape == {"data": 1, "model": 1, "pipe": 2}
    model = monobeast.build_model(flags, A, FRAME, CPU)
    parallel.set_pipeline(model, mesh, n_mb)
    weights.load_jax_params(model, params)
    hp = monobeast.hparams_from_flags(flags)
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    got = port_learner.make_update_dispatch(model, opt, hp)(
        _tensors(_learner_batch()), _tensors(state) if state else ())
    assert model.last_pipelined
    _close({**got, "params": weights.torch_to_jax(model.state_dict())},
           want, 1e-5, 2e-6)


def _reference_poly_update(argv, n_dev, tp, pp):
    """The reference polybeast's learner from `argv`: its composite mesh
    (polybeast.py:860-873), its model on it and, under TP, its shardings
    (:995-1031); one update on _learner_batch."""
    flags = jax_polybeast.make_parser().parse_args(argv)
    mesh = jax_create_mesh(n_dev * tp * pp, model_parallelism=tp,
                           pipe_parallelism=pp)
    model, params = jax_monobeast._init_model_and_params(
        flags, A, flags.batch_size, FRAME,
        pipe_mesh=mesh if pp > 1 else None)
    params = jax.device_get(params)
    hp = jax_monobeast.hparams_from_flags(flags)
    optimizer = jax_learner.make_optimizer(hp)
    state = model.initial_state(flags.batch_size)
    if tp > 1:
        shardings = jax_merge_param_shardings(
            jax_transformer_tp_shardings(mesh, params))
        placed = jax.tree_util.tree_map(jax.device_put, params, shardings)
        step = jax_parallel_update(model, optimizer, hp, mesh, donate=False,
                                   param_shardings=shardings)
        opt_state = optimizer.init(placed)
    else:
        placed = jax_replicate(mesh, params)
        step = jax_parallel_update(model, optimizer, hp, mesh, donate=False)
        opt_state = jax_replicate(mesh, optimizer.init(params))
    b, s = jax_shard_batch(mesh, _learner_batch(), state)
    p, _, stats = step(placed, opt_state, b, s)
    return params, state, {**jax.device_get(stats),
                           "params": jax.device_get(p)}


POLY_CASES = {
    "model2": (["--model", "transformer", "--tensor_parallel", "2"], 1, 2,
               1),
    "data2_model2": (["--model", "transformer", "--tensor_parallel", "2",
                      "--num_learner_devices", "2"], 2, 2, 1),
    "data2_pipe2": (["--model", "pipelined_transformer",
                     "--pipeline_parallel", "2",
                     "--num_learner_devices", "2"], 2, 1, 2),
}


@pytest.mark.parametrize("case", sorted(POLY_CASES))
def test_polybeast_learner_update_is_the_references(case):
    extra, n_dev, tp, pp = POLY_CASES[case]
    argv = [a for a in _argv(*extra, "--vtrace_impl", "pallas")
            if a != "--serial_envs"]
    params, state, want = _reference_poly_update(argv, n_dev, tp, pp)
    flags = polybeast.make_parser().parse_args(["--disable_cuda", *argv])
    polybeast.check_flags(flags)
    mesh = monobeast.learner_mesh(CPU, n_dev, 1, tp, pp)
    n_mb = (polybeast._check_pipe_model(flags, mesh, "data") if pp > 1
            else None)
    model = monobeast.build_model(flags, A, FRAME, CPU)
    weights.load_jax_params(model, params)
    if pp > 1:
        parallel.set_pipeline(model, mesh.row(0), n_mb)
    hp = monobeast.hparams_from_flags(flags)
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    update = parallel.make_parallel_update_step(model, opt, hp, mesh)
    got = update(_tensors(_learner_batch()), _tensors(state))
    if pp > 1:
        assert all(r.last_pipelined for r in update.learner.replicas)
        assert [r.mesh.pipe_devices(0) for r in update.learner.replicas] \
            == [mesh.pipe_devices(i) for i in range(n_dev)]
    # The learner's one-device tree (its TP leaves are resident slices).
    _close({**got, "params": weights.torch_to_jax(
        parallel.local_view(model))}, want, 1e-4, 1e-6)


@pytest.mark.parametrize("family", [
    ["--model", "pipelined_mlp", "--use_lstm"],
    ["--model", "pipelined_transformer", "--pipeline_stages", "2"]],
    ids=["mlp_lstm", "transformer"])
def test_monobeast_pp_trains_and_resumes_in_the_reference(tmp_path,
                                                          family):
    argv = ["--env", "Mock", "--num_actors", "4", "--batch_size", "4",
            "--unroll_length", "4", "--serial_envs", "--savedir",
            str(tmp_path), "--xpid", "pp", *family, "--pipeline_parallel",
            "2", "--vtrace_impl", "pallas"]
    ours = monobeast.main(monobeast.make_parser().parse_args(
        ["--disable_cuda", "--total_steps", "32", *argv]))
    assert ours["step"] == 32 and np.isfinite(ours["total_loss"])
    theirs = jax_monobeast.train(jax_monobeast.make_parser().parse_args(
        ["--total_steps", "48", "--no_telemetry", *argv]))
    assert theirs["step"] == 48 and np.isfinite(theirs["total_loss"])
    # The reference resumed the port's checkpoint at step 32: the shared
    # logs.csv never steps back.
    with open(tmp_path / "pp" / "logs.csv") as f:
        steps = [int(float(r["step"])) for r in csv.DictReader(f)]
    assert steps == sorted(steps) and steps[-1] == 48, steps


# ------------------------------------------------------------ end to end


def _toolchain_gap():
    try:
        native_build.check_toolchain()
    except native_build.NativeBuildError as e:
        return str(e)
    return None


RUNTIMES = [
    pytest.param(["--no_native_runtime"], id="python"),
    pytest.param(["--native_runtime", "--native_server"], id="native",
                 marks=pytest.mark.skipif(
                     _toolchain_gap() is not None,
                     reason=f"no C++ toolchain: {_toolchain_gap()}")),
]


def _poly(tmp_path, xpid, *extra):
    return polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--num_servers", "2",
        "--batch_size", "4", "--unroll_length", "4", "--total_steps", "24",
        "--max_inference_batch_size", "4", "--pipes_basename",
        f"unix:{tmp_path}/pipes", "--savedir", str(tmp_path), "--xpid",
        xpid, "--vtrace_impl", "pallas", "--checkpoint_interval_s",
        "100000", *extra])


POLY_RUNS = {
    "tp2": (["--model", "transformer", "--tensor_parallel", "2"],
            {"data": 1, "model": 2}),
    "data2_tp2": (["--model", "transformer", "--tensor_parallel", "2",
                   "--num_learner_devices", "2"], {"data": 2, "model": 2}),
    "tp2_ep2": (["--model", "transformer", "--tensor_parallel", "2",
                 "--num_experts", "4", "--expert_parallel", "2"],
                {"data": 1, "model": 2, "expert": 2}),
    "data2_pp2": (["--model", "pipelined_transformer",
                   "--pipeline_parallel", "2",
                   "--num_learner_devices", "2"],
                  {"data": 2, "model": 1, "pipe": 2}),
    "pp2_fused_tail": (["--model", "pipelined_mlp", "--use_lstm",
                        "--pipeline_parallel", "2", "--opt_impl", "pallas"],
                       {"data": 1, "model": 1}),
}


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("case", sorted(POLY_RUNS))
def test_polybeast_trains(tmp_path, case, runtime):
    extra, shape = POLY_RUNS[case]
    stats = polybeast.main(_poly(tmp_path, case, *extra, *runtime))
    assert stats["step"] >= 24 and np.isfinite(stats["total_loss"])
    assert stats["health"] == "HEALTHY"
    last = [json.loads(line) for line in
            open(tmp_path / case / "telemetry.jsonl")][-1]
    assert last["learner.mesh_shape"] == shape


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("runtime", [
    pytest.param([], id="python"),
    pytest.param(["native"], id="native", marks=pytest.mark.skipif(
        _toolchain_gap() is not None, reason="no C++ toolchain"))])
def test_two_process_polybeast_tp(tmp_path, runtime):
    """The reference's dp_tp mode: polybeast --tensor_parallel 2
    --num_learner_devices 2 across two --coordinator_address processes
    (2 CPU devices each: one data row of 2 model devices a process)."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "poly_tp", str(rank), "2", str(port),
         str(tmp_path), "24", *runtime], stdout=subprocess.PIPE,
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
    assert "Parallel learner: data=2 x model=2 (2 processes)" in outs[0]
    assert (tmp_path / "poly-dist" / "model.ckpt").exists()
