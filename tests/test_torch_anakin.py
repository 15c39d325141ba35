"""The port's Anakin trainer (torchbeast_tpu_torch/anakin.py) against the
JAX package's (torchbeast_tpu/anakin.py) on the CPU.

One whole iteration from the same weights: the port's collect and update
run from a seeded carry, and the reference's model and learner are held
against what the port recorded.

- Acting: the reference's forward with sample_action=False on each
  recorded env output, carrying its own agent state from the carry's,
  gives the recorded behavior logits and baselines (rtol 1e-5, atol
  1e-6); the batch pairs slot i's agent output with env output i-1.
- The update: the reference's compute_loss and optimizer on the recorded
  batch from the carry's agent state give the port's post-update params
  (rtol 1e-5, atol 2e-6) and loss stats (rtol 1e-4), at RMSprop eps 1.0
  for the reason tests/test_torch_learner.py gives, with the gradient
  clipped (its norm is reported before the clip) and the entropy
  annealed.

Also: the parser against the reference's, the NotImplementedErrors, the
CPU command line (model.ckpt and logs.csv written), and a checkpoint
written by either package and resumed by the other at B=4, T=4.
"""

import csv
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from torchbeast_tpu import anakin as jax_anakin
from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu_torch import anakin, nest, weights
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch.envs import device_env
from torchbeast_tpu_torch.models import create_model as port_create_model
from tests.test_torch_monobeast import _actions
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B = 10, 4
CASES = [("mlp", False, "Catch"), ("mlp", True, "Memory"),
         ("deep", True, "Catch")]
STAT_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "aux_loss", "episode_returns_sum", "episode_count",
             "grad_norm")


def _setup(model_name, use_lstm, env_name, seed=0, **kw):
    env = device_env.create_device_env(env_name)
    torch.manual_seed(seed)
    model = port_create_model(model_name, env.num_actions,
                              use_lstm=use_lstm, frame_shape=env.frame_shape,
                              **kw)
    gen = torch.Generator().manual_seed(seed + 1)
    carry = anakin.initial_carry(env, model, B, gen)
    return env, model, gen, carry


def _np_state(state):
    return nest.map(lambda t: t.detach().numpy().copy(), state)


def _np_batch(batch):
    out = {k: v.detach().numpy().copy() for k, v in batch.items()}
    out["action"] = out["action"].astype(np.int32)
    return out


@pytest.mark.parametrize("model_name,use_lstm,env_name", CASES)
def test_recorded_behavior_matches_jax_forward(model_name, use_lstm,
                                               env_name):
    env, model, gen, carry = _setup(model_name, use_lstm, env_name)
    params = weights.torch_to_jax(model.state_dict())
    state = _np_state(carry.agent_state)
    batch, next_carry = anakin.make_collect(env, model, T, gen)(carry)
    batch = _np_batch(batch)
    ref = jax_create_model(model_name, num_actions=env.num_actions,
                           use_lstm=use_lstm)

    def forward(t, state):
        inputs = {k: batch[k][t][None]
                  for k in port_learner.MODEL_INPUT_KEYS}
        out, state = ref.apply(params, inputs, state, sample_action=False)
        return np.asarray(out.policy_logits[0]), np.asarray(
            out.baseline[0]), state

    # Slot 0 (the prime) and slot 1 both act on env output 0 from the
    # carry's state; slot t+1 on env output t.
    want = []
    logits, base, state_next = forward(0, state)
    want.append((logits, base))
    state = state_next
    want.append((logits, base))
    for t in range(1, T):
        logits, base, state = forward(t, state)
        want.append((logits, base))
    for t, (logits, base) in enumerate(want):
        np.testing.assert_allclose(batch["policy_logits"][t], logits,
                                   rtol=1e-5, atol=1e-6, err_msg=str(t))
        np.testing.assert_allclose(batch["baseline"][t], base, rtol=1e-5,
                                   atol=1e-6, err_msg=str(t))
    # Pairing: env output t+1 follows action t+1.
    np.testing.assert_array_equal(batch["last_action"][1:],
                                  batch["action"][1:])
    for a, b in zip(nest.flatten(_np_state(next_carry.agent_state)),
                    nest.flatten(state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(next_carry.env_out["frame"].numpy(),
                                  batch["frame"][T])


def _hp(**kw):
    return dict(unroll_length=T, batch_size=B, total_steps=T * B * 10,
                entropy_cost=0.01, entropy_cost_final=0.002,
                rmsprop_eps=1.0, grad_norm_clipping=0.5,
                learning_rate=1e-3, **kw)


@pytest.mark.parametrize("model_name,use_lstm,env_name", CASES)
def test_iteration_update_matches_jax(model_name, use_lstm, env_name):
    env, model, gen, carry = _setup(model_name, use_lstm, env_name)
    params = weights.torch_to_jax(model.state_dict())
    state = _np_state(carry.agent_state)
    rng = gen.get_state()
    twin = nest.map(torch.clone, carry)
    batch, next_carry = anakin.make_collect(env, model, T, gen)(twin)
    batch = _np_batch(batch)
    gen.set_state(rng)

    hp = port_learner.HParams(**_hp())
    optimizer = port_learner.make_optimizer(hp, list(model.parameters()))
    stats = anakin.make_train_step(env, model, optimizer, hp, gen)(carry)
    # The carry now holds the next one, in place.
    for got, want in zip(nest.flatten(carry), nest.flatten(next_carry)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    ref = jax_create_model(model_name, num_actions=env.num_actions,
                           use_lstm=use_lstm)
    jhp = jax_learner.HParams(**_hp())
    jopt = jax_learner.make_optimizer(jhp)
    step = jax_learner.make_update_step(ref, jopt, jhp, donate=False)
    want_params, _, want_stats = jax.device_get(
        step(params, jopt.init(params), batch, state))
    for key in STAT_KEYS:
        np.testing.assert_allclose(float(stats[key]),
                                   float(want_stats[key]), rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    assert float(stats["grad_norm"]) > hp.grad_norm_clipping
    assert float(stats["episode_count"]) > 0  # resets inside the unroll
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6),
        weights.torch_to_jax(model.state_dict()), want_params)


def test_iterations_on_the_cpu_draw_new_resets():
    """Eager iterations through make_iteration_dispatch: finite stats,
    the optimizer's count advancing, and the generator moving on, so a
    second iteration's resets are not the first's."""
    env, model, gen, carry = _setup("mlp", False, "Catch")
    hp = port_learner.HParams(**_hp())
    optimizer = port_learner.make_optimizer(hp, list(model.parameters()))
    dispatch = anakin.make_iteration_dispatch(env, model, optimizer, hp,
                                              gen, carry)
    states = []
    for _ in range(3):
        stats = dispatch()
        assert all(np.isfinite(float(v)) for v in stats.values())
        states.append(gen.get_state())
    assert optimizer.state.count == 3
    assert not torch.equal(states[0], states[1])


def test_parser_matches_the_reference():
    ours = _actions(anakin.make_parser())
    theirs = _actions(jax_anakin.make_parser())
    assert set(ours) - set(theirs) == {("--disable_cuda",)}
    assert set(theirs) - set(ours) == set()
    for flag, spec in theirs.items():
        assert ours[flag] == spec, flag


def _argv(tmp_path, xpid, *extra):
    return ["--env", "Catch", "--batch_size", "4", "--unroll_length", "4",
            "--savedir", str(tmp_path), "--xpid", xpid,
            "--log_interval_updates", "1", "--checkpoint_interval_s",
            "100000", *extra]


@pytest.mark.parametrize("extra,error,match", [
    # --num_devices is in the port: the reference's errors for it.
    (["--num_devices", "3"], ValueError,
     "batch_size 4 not divisible by num_devices 3"),
    (["--model", "pipelined_mlp", "--num_devices", "16", "--batch_size",
      "16"], ValueError, "only 8 devices are visible"),
    (["--num_experts", "4"], ValueError,
     "--num_experts applies to --model transformer only"),
])
def test_unported_and_invalid_settings_raise(tmp_path, extra, error, match):
    flags = anakin.make_parser().parse_args(
        _argv(tmp_path, "x", "--disable_cuda", *extra))
    with pytest.raises(error, match=match):
        anakin.train(flags)


def test_no_gpu_without_disable_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    flags = anakin.make_parser().parse_args(_argv(tmp_path, "x"))
    with pytest.raises(RuntimeError, match="--disable_cuda"):
        anakin.train(flags)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cpu_run_writes_checkpoint_and_logs(tmp_path):
    stats = anakin.train(anakin.make_parser().parse_args(
        _argv(tmp_path, "run", "--disable_cuda", "--total_steps", "64")))
    assert stats["step"] == 64 and np.isfinite(stats["total_loss"])
    assert (tmp_path / "run" / "model.ckpt").is_file()
    rows = _rows(tmp_path / "run" / "logs.csv")
    assert [int(float(r["step"])) for r in rows] == [16, 32, 48, 64]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, caplog, first):
    """A run of one package writes model.ckpt at step 32; the other
    package's run on the same xpid resumes from it and logs from step
    48 on."""
    runs = {"jax": (jax_anakin, []), "port": (anakin, ["--disable_cuda"])}
    second = "port" if first == "jax" else "jax"
    pkg, extra = runs[first]
    pkg.train(pkg.make_parser().parse_args(
        _argv(tmp_path, "x", "--total_steps", "32", *extra)))
    before = len(_rows(tmp_path / "x" / "logs.csv"))
    pkg, extra = runs[second]
    with caplog.at_level(logging.INFO):
        stats = pkg.train(pkg.make_parser().parse_args(
            _argv(tmp_path, "x", "--total_steps", "64", *extra)))
    assert "Resuming preempted job at step 32" in caplog.text
    assert stats["step"] == 64
    new = _rows(tmp_path / "x" / "logs.csv")[before:]
    assert [int(float(r["step"])) for r in new] == [48, 64]


def test_the_cli_writes_checkpoint_and_logs(tmp_path):
    """`python -m torchbeast_tpu_torch.anakin --disable_cuda` at the
    default --log_interval_updates (20) for 4 iterations: model.ckpt and
    logs.csv, whose one row is the last iteration's; without
    --disable_cuda and without a GPU it raises."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [sys.executable, "-m", "torchbeast_tpu_torch.anakin", "--env",
            "Catch", "--batch_size", "4", "--unroll_length", "4",
            "--total_steps", "64", "--savedir", str(tmp_path), "--xpid",
            "cli"]
    done = subprocess.run(argv + ["--disable_cuda"], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert (tmp_path / "cli" / "model.ckpt").is_file()
    assert [int(float(r["step"])) for r in
            _rows(tmp_path / "cli" / "logs.csv")] == [64]
    if not torch.cuda.is_available():
        refused = subprocess.run(argv, cwd=repo, capture_output=True,
                                 text=True, timeout=300)
        assert refused.returncode != 0
        assert "--disable_cuda" in refused.stderr
