"""The pipelined families in the port's three drivers on the CPU, and the
parallelism flags' rules against the reference's drivers.

- monobeast trains --model pipelined_transformer --pipeline_stages 2 and
  --model pipelined_mlp --use_lstm with every kernel switch on (the
  kernels' plain versions on the CPU); --pipeline_stages sets the depth
  of both families (the transformer's layers, the MLP's stages), as the
  reference's _init_model_and_params does without --pipeline_parallel.
- polybeast trains both families on the Python pool and on the port's
  C++ core (with --native_server).
- anakin trains --model pipelined_mlp on Catch, with and without the
  LSTM; one of its iterations' update equals the reference's learner on
  the recorded batch (params rtol 1e-5 / atol 2e-6, stats rtol 1e-4, as
  tests/test_torch_anakin.py holds the mlp).
- Without --disable_cuda and without a GPU, each driver raises.
- The flags: --sequence_parallel above 1 on a pipelined family raises
  the reference's ValueError (it needs --model transformer) in both
  drivers; --ring_schedule and
  --sp_strategy away from their defaults without --sequence_parallel > 1
  raise the reference's ValueError, and --attention_impl on the
  pipelined transformer the reference's ValueError, checked against the
  reference's monobeast on the same argv; --pipeline_parallel 1 and
  --sequence_parallel 1 train in both packages.
- The remat planner's levers for both families are the reference's.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402

from torchbeast_tpu import learner as jax_learner  # noqa: E402
from torchbeast_tpu import monobeast as jax_monobeast  # noqa: E402
from torchbeast_tpu.models import create_model as jax_create_model  # noqa
from torchbeast_tpu.runtime import remat_plan as jax_remat_plan  # noqa
from torchbeast_tpu_torch import anakin, monobeast, nest  # noqa: E402
from torchbeast_tpu_torch import polybeast  # noqa: E402
from torchbeast_tpu_torch import learner as port_learner  # noqa: E402
from torchbeast_tpu_torch import weights  # noqa: E402
from torchbeast_tpu_torch.runtime import native_build, remat_plan  # noqa
from tests.test_torch_anakin import T as ANAKIN_T  # noqa: E402
from tests.test_torch_anakin import (  # noqa: E402
    STAT_KEYS,
    _hp,
    _np_batch,
    _np_state,
    _setup,
)
from tests.torch_port_fixtures import few_torch_threads  # noqa: E402,F401

TRANSFORMER = ["--model", "pipelined_transformer"]
MLP_LSTM = ["--model", "pipelined_mlp", "--use_lstm"]
# Each multi-device flag -> the ROADMAP.md Queue 1 item that brings it.
# Flags refused on the pipelined families -> the reference's error.
ITEMS = {
    "--sequence_parallel": (
        ValueError, r"--sequence_parallel needs --model transformer \(the "
        r"conv\+LSTM families have no sequence-sharded formulation\)"),
}


def _mono_args(tmp_path, *extra):
    return ["--env", "Mock", "--num_actors", "4", "--batch_size", "2",
            "--unroll_length", "4", "--total_steps", "16", "--serial_envs",
            "--savedir", str(tmp_path), "--xpid", "x", *extra]


def _mono(tmp_path, *extra):
    return monobeast.make_parser().parse_args(
        _mono_args(tmp_path, "--disable_cuda", *extra))


def _finite(stats):
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm"):
        assert np.isfinite(stats[key]), key


@pytest.mark.parametrize("model_args", [
    TRANSFORMER + ["--pipeline_stages", "2"], MLP_LSTM])
def test_monobeast_trains_the_pipelined_families(tmp_path, model_args):
    stats = monobeast.main(_mono(
        tmp_path, *model_args, "--vtrace_impl", "pallas", "--opt_impl",
        "pallas", "--total_steps", "32"))
    _finite(stats)
    assert stats["step"] == 32
    assert (tmp_path / "x" / "model.ckpt").is_file()


@pytest.mark.parametrize("model,stages,attr", [
    ("pipelined_transformer", 3, "num_layers"),
    ("pipelined_mlp", 3, "num_stages")])
def test_pipeline_stages_sets_the_depth(tmp_path, model, stages, attr):
    flags = _mono(tmp_path, "--model", model, "--pipeline_stages",
                  str(stages))
    built = monobeast.build_model(flags, 6, (84, 84, 4), torch.device("cpu"))
    assert getattr(built, attr) == stages
    lead = "wq" if model == "pipelined_transformer" else "w_in"
    assert getattr(built, lead).shape[0] == stages
    default = monobeast.build_model(_mono(tmp_path, "--model", model), 6,
                                    (84, 84, 4), torch.device("cpu"))
    assert getattr(default, attr) == 4


def _poly(tmp_path, *extra):
    return polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--num_servers", "2",
        "--batch_size", "2", "--unroll_length", "5", "--total_steps", "30",
        "--max_inference_batch_size", "4", "--pipes_basename",
        f"unix:{tmp_path}/pipes", "--savedir", str(tmp_path), "--xpid",
        "poly", "--vtrace_impl", "pallas", "--opt_impl", "pallas", *extra])


def _toolchain_gap():
    try:
        native_build.check_toolchain()
    except native_build.NativeBuildError as e:
        return str(e)
    return None


@pytest.mark.parametrize("runtime", [
    ["--no_native_runtime"],
    pytest.param(["--native_runtime", "--native_server"],
                 marks=pytest.mark.skipif(_toolchain_gap() is not None,
                                          reason=str(_toolchain_gap())))],
    ids=["python", "native"])
@pytest.mark.parametrize("model_args", [TRANSFORMER, MLP_LSTM],
                         ids=["transformer", "mlp_lstm"])
def test_polybeast_trains_the_pipelined_families(tmp_path, runtime,
                                                 model_args):
    stats = polybeast.main(_poly(tmp_path, *model_args, *runtime))
    _finite(stats)
    assert stats["health"] == "HEALTHY", stats["health_reasons"]
    assert stats["runtime"] == ("native" if "--native_runtime" in runtime
                                else "python")
    assert (tmp_path / "poly" / "model.ckpt").is_file()


def _anakin_args(tmp_path, *extra):
    return ["--env", "Catch", "--model", "pipelined_mlp", "--batch_size",
            "4", "--unroll_length", "4", "--total_steps", "64",
            "--savedir", str(tmp_path), "--xpid", "a",
            "--checkpoint_interval_s", "100000", *extra]


@pytest.mark.parametrize("extra", [[], ["--use_lstm"]],
                         ids=["feed_forward", "lstm"])
def test_anakin_trains_the_pipelined_mlp(tmp_path, extra):
    stats = anakin.train(anakin.make_parser().parse_args(
        _anakin_args(tmp_path, "--disable_cuda", *extra)))
    assert stats["step"] >= 64 and np.isfinite(stats["total_loss"])
    assert (tmp_path / "a" / "model.ckpt").is_file()


def test_anakin_pipelined_mlp_update_matches_jax():
    env, model, gen, carry = _setup("pipelined_mlp", False, "Catch")
    params = weights.torch_to_jax(model.state_dict())
    state = _np_state(carry.agent_state)
    rng = gen.get_state()
    batch, _ = anakin.make_collect(env, model, ANAKIN_T, gen)(
        nest.map(torch.clone, carry))
    batch = _np_batch(batch)
    gen.set_state(rng)
    hp = port_learner.HParams(**_hp())
    optimizer = port_learner.make_optimizer(hp, list(model.parameters()))
    stats = anakin.make_train_step(env, model, optimizer, hp, gen)(carry)
    ref = jax_create_model("pipelined_mlp", num_actions=env.num_actions)
    jhp = jax_learner.HParams(**_hp())
    jopt = jax_learner.make_optimizer(jhp)
    step = jax_learner.make_update_step(ref, jopt, jhp, donate=False)
    want_params, _, want_stats = jax.device_get(
        step(params, jopt.init(params), batch, state))
    for key in STAT_KEYS:
        np.testing.assert_allclose(float(stats[key]),
                                   float(want_stats[key]), rtol=1e-4,
                                   atol=1e-7, err_msg=key)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6),
        weights.torch_to_jax(model.state_dict()), want_params)


def test_no_gpu_without_disable_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--disable_cuda"):
        monobeast.train(monobeast.make_parser().parse_args(
            _mono_args(tmp_path, *TRANSFORMER)))
    flags = _poly(tmp_path, *MLP_LSTM)
    flags.disable_cuda = False
    with pytest.raises(RuntimeError, match="--disable_cuda"):
        polybeast.train(flags)
    with pytest.raises(RuntimeError, match="--disable_cuda"):
        anakin.train(anakin.make_parser().parse_args(
            _anakin_args(tmp_path)))


# ---------------------------------------------------------------- flags


@pytest.mark.parametrize("driver", ["monobeast", "polybeast"])
@pytest.mark.parametrize("extra", [
    ["--pipeline_parallel", "2"], ["--sequence_parallel", "2"],
    ["--pipeline_microbatches", "2"]], ids=lambda a: a[0][2:])
def test_multi_device_flags_raise_not_implemented(tmp_path, driver, extra):
    """--sequence_parallel 2 on the pipelined transformer raises the
    reference's ValueError (sequence parallelism is the transformer
    family's); the pipeline flags raise nothing:
    --pipeline_parallel 2 runs the tower's GPipe over 2 devices, and
    --pipeline_microbatches without it is ignored, as in the
    reference."""
    if driver == "monobeast":
        flags = _mono(tmp_path, *TRANSFORMER, *extra)
    else:
        flags = _poly(tmp_path, *TRANSFORMER, *extra)
    flags.pipeline_stages = 2
    main = {"monobeast": monobeast, "polybeast": polybeast}[driver].main
    if extra[0] in ITEMS:
        error, match = ITEMS[extra[0]]
        with pytest.raises(error, match=match):
            main(flags)
        return
    _finite(main(flags))


# argv -> the reference's ValueError, raised by both packages.
VALUE_ERRORS = [
    ["--ring_schedule", "zigzag"],
    ["--sp_strategy", "ulysses"],
    ["--sequence_parallel", "1", "--ring_schedule", "zigzag"],
    TRANSFORMER + ["--attention_impl", "pallas"],
]


@pytest.mark.parametrize("argv", VALUE_ERRORS,
                         ids=lambda a: "-".join(x.strip("-") for x in a))
def test_value_errors_match_the_reference(tmp_path, argv):
    with pytest.raises(ValueError) as theirs:
        jax_monobeast.train(jax_monobeast.make_parser().parse_args(
            _mono_args(tmp_path, "--no_telemetry", *argv)))
    with pytest.raises(ValueError) as ours:
        monobeast.main(_mono(tmp_path, *argv))
    assert str(ours.value) == str(theirs.value)
    if "--attention_impl" not in argv:
        with pytest.raises(ValueError) as poly:
            polybeast.main(_poly(tmp_path, *argv))
        assert str(poly.value) == str(theirs.value)


@pytest.mark.parametrize("argv", [
    ["--model", "pipelined_mlp", "--pipeline_parallel", "1"],
    TRANSFORMER + ["--sequence_parallel", "1", "--pipeline_stages", "2"],
], ids=["pipeline_parallel_1", "sequence_parallel_1"])
def test_one_device_counts_train_in_both_packages(tmp_path, argv):
    theirs = jax_monobeast.train(jax_monobeast.make_parser().parse_args(
        _mono_args(tmp_path / "jax", "--no_telemetry", *argv)))
    ours = monobeast.main(_mono(tmp_path / "port", *argv))
    assert ours["step"] == theirs["step"] == 16
    _finite(ours)


@pytest.mark.parametrize("model,use_lstm", [
    ("pipelined_transformer", False), ("pipelined_mlp", True),
    ("pipelined_mlp", False)])
def test_remat_levers_are_the_references(model, use_lstm):
    ours = remat_plan.stages_for(model, use_lstm)
    theirs = jax_remat_plan.stages_for(model, use_lstm)
    assert [(s.name, s.options) for s in ours] == [
        (s.name, s.options) for s in theirs]
    everything = remat_plan.all_remat(ours)
    assert (remat_plan.model_kwargs(model, everything)
            == jax_remat_plan.model_kwargs(model, everything))
