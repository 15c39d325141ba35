"""The port's driver (torchbeast_tpu_torch/monobeast.py): parser parity
with the JAX driver, a tiny CPU run of the slice's configuration, the
no-silent-CPU rule, the not-yet-ported flags, and import purity (the
port loads neither jax nor the JAX package)."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torchbeast_tpu import monobeast as jax_monobeast
from torchbeast_tpu_torch import monobeast
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _actions(parser):
    out = {}
    for a in parser._actions:
        if not a.option_strings or "-h" in a.option_strings:
            continue
        out[tuple(a.option_strings)] = (
            type(a).__name__, a.dest, a.type, a.default,
            tuple(a.choices) if a.choices else None, a.nargs, a.const,
        )
    return out


def test_parser_matches_the_reference():
    ours = _actions(monobeast.make_parser())
    theirs = _actions(jax_monobeast.make_parser())
    assert set(ours) - set(theirs) == {("--disable_cuda",)}
    assert set(theirs) - set(ours) == set()
    for flag, spec in theirs.items():
        assert ours[flag] == spec, flag


DEEP = ("--model", "deep", "--use_lstm")


def _flags(*extra, tmp_path, model=DEEP):
    return monobeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", *model,
        "--num_actors", "4", "--batch_size", "2", "--unroll_length", "4",
        "--total_steps", "48", "--serial_envs",
        "--savedir", str(tmp_path), "--xpid", "tiny", *extra,
    ])


@pytest.mark.parametrize("impls", [
    ("pallas", "pallas", "--pipelined_collect"),
    ("associative", "xla", "--no_pipelined_collect"),
    ("pallas", "pallas", "--pipelined_collect",
     ("--model", "transformer", "--attention_impl", "pallas")),
])
def test_tiny_run_on_cpu(tmp_path, monkeypatch, impls):
    """T=4, B=2 (two updates per collect of 4 actors), on the deep model
    and on the transformer, whose nested KV-cache state the driver slices
    per update."""
    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    vtrace_impl, opt_impl, collect, *model = impls
    flags = _flags("--vtrace_impl", vtrace_impl, "--opt_impl", opt_impl,
                   collect, tmp_path=tmp_path, model=model[0] if model
                   else DEEP)
    stats = monobeast.train(flags)
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm", "sps", "update_ms_median"):
        assert np.isfinite(stats[key]), key
    assert stats["step"] == 48
    assert os.path.exists(tmp_path / "tiny" / "logs.csv")


def test_no_silent_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = _flags(tmp_path=tmp_path)
    flags.disable_cuda = False
    with pytest.raises(RuntimeError, match="--disable_cuda"):
        monobeast.train(flags)
    assert monobeast.select_device(_flags(tmp_path=tmp_path)).type == "cpu"


@pytest.mark.parametrize("args,error,match", [
    # The device split is in the port: on one CPU device it warns, as the
    # reference does, and trains the time-shared path.
    pytest.param(["--device_split", "auto"], None,
                 "degrading to the time-shared serving path",
                 id="args0-device_split-degrades"),
    # The data-parallel learner is in the port: two shards train.
    (["--num_learner_devices", "2"], None, None),
    (["--fleet", "host=0/2,coord=127.0.0.1:1"], ValueError,
     "the sync trainer is single-host"),
    # The pipelined transformer across devices is in the port: its
    # GPipe over 2 devices trains. Sequence parallelism is too: on the
    # deep model it raises the reference's ValueError.
    pytest.param(["--model", "pipelined_transformer", "--pipeline_parallel",
                  "2", "--pipeline_stages", "2"], None, None,
                 id="args3-transformer"),
    pytest.param(["--sequence_parallel", "2"], ValueError,
                 "--sequence_parallel needs --model transformer",
                 id="args4-transformer"),
    # Expert parallelism is in the port: the MoE transformer's experts
    # split over 2 devices train.
    pytest.param(["--model", "transformer", "--num_experts", "4",
                  "--expert_parallel", "2"], None, None,
                 id="args5-expert_parallel-trains"),
])
def test_features_outside_the_port_raise(tmp_path, monkeypatch, caplog,
                                        args, error, match):
    """Each multi-device flag: the ROADMAP.md item that brings it, the
    reference's error for it, or (--num_learner_devices, --pipeline_
    parallel on the pipelined transformer, and --expert_parallel on the
    MoE transformer) a run; --device_split on a
    single visible device (XLA_FLAGS' CPU count 1) the reference's
    warning and a time-shared run."""
    flags = _flags(*args, tmp_path=tmp_path,
                   model=() if "--model" in args else DEEP)
    if "--device_split" in args:
        monkeypatch.setenv("XLA_FLAGS",
                           "--xla_force_host_platform_device_count=1")
    if error is None:
        with caplog.at_level(logging.WARNING):
            stats = monobeast.main(flags)
        assert stats["step"] == 48 and np.isfinite(stats["total_loss"])
        if match is not None:
            assert any(match in r.getMessage() for r in caplog.records)
        return
    with pytest.raises(error, match=match):
        monobeast.main(flags)


def test_real_atari_id_raises_the_reference_error(tmp_path):
    """The default --env (a real Atari id) needs ale_py: without it both
    packages' drivers raise the same ImportError."""
    pytest.importorskip("gymnasium")
    try:
        import ale_py  # noqa: F401

        pytest.skip("ale_py installed; the gate is not reachable")
    except ImportError:
        pass
    from torchbeast_tpu.envs.atari import create_atari_env

    with pytest.raises(ImportError) as theirs:
        create_atari_env("PongNoFrameskip-v4")
    flags = _flags("--env", "PongNoFrameskip-v4", tmp_path=tmp_path)
    with pytest.raises(ImportError) as ours:
        monobeast.main(flags)
    assert str(ours.value) == str(theirs.value)


def test_attention_impl_applies_to_the_transformer_only(tmp_path):
    flags = _flags("--attention_impl", "pallas", tmp_path=tmp_path)
    with pytest.raises(ValueError, match="--model transformer only"):
        monobeast.main(flags)
    flags = _flags(tmp_path=tmp_path, model=("--model", "transformer",
                                             "--use_lstm"))
    with pytest.raises(ValueError, match="use_lstm"):
        monobeast.main(flags)


def test_no_telemetry_is_accepted(tmp_path):
    flags = _flags("--no_telemetry", tmp_path=tmp_path)
    monobeast.check_flags(flags)


def test_checkpoints_periodic_final_resume_and_test_mode(tmp_path, caplog):
    """--checkpoint_interval_s 0 writes one checkpoint per collect and
    one at exit; a second run with the same xpid resumes from it; --mode
    test plays greedy episodes from it (Mock: 200 steps of reward 1),
    from {savedir}/latest/ when --xpid is unset, and from the random init
    when there is no checkpoint."""
    flags = _flags("--checkpoint_interval_s", "0", tmp_path=tmp_path)
    with caplog.at_level(logging.INFO):
        monobeast.train(flags)
    # Three collects of 4 actors x T=4, then the final one.
    assert caplog.text.count("Saved checkpoint") == 4
    assert os.path.exists(tmp_path / "tiny" / "model.ckpt")
    flags = _flags(tmp_path=tmp_path)
    flags.total_steps = 64
    caplog.clear()
    with caplog.at_level(logging.INFO):
        stats = monobeast.train(flags)
    assert "Resuming preempted job" in caplog.text
    assert stats["step"] == 64
    test = _flags("--mode", "test", "--num_test_episodes", "1",
                  tmp_path=tmp_path)
    assert monobeast.main(test) == [200.0]
    # Without --xpid: the FileWriter's `latest` link to the last run.
    test.xpid = None
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert monobeast.test(test) == [200.0]
    assert "latest/model.ckpt" in caplog.text
    test.savedir = str(tmp_path / "empty")
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert monobeast.test(test) == [200.0]
    assert "testing random init" in caplog.text


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import torchbeast_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'torchbeast_tpu')]\n"
        "print(len(names), bad)\n"
        "missing = [m for m in NEW if m not in names]\n"
        "assert not missing, missing\n"
        "assert not bad, bad\n"
    ).replace("NEW", repr([
        # The telemetry exporters, the serving tier and the chaos
        # harness, walked like every other module.
        "torchbeast_tpu_torch.telemetry.export",
        "torchbeast_tpu_torch.telemetry.driver",
        "torchbeast_tpu_torch.telemetry.__main__",
        "torchbeast_tpu_torch.serving",
        "torchbeast_tpu_torch.serving.admission",
        "torchbeast_tpu_torch.serving.snapshot",
        "torchbeast_tpu_torch.serving.replica",
        "torchbeast_tpu_torch.resilience.chaos",
        "torchbeast_tpu_torch.chaos_run",
        # Tensor and pipeline parallelism.
        "torchbeast_tpu_torch.parallel.tp",
        "torchbeast_tpu_torch.parallel.pp",
        # The fleet.
        "torchbeast_tpu_torch.fleet",
        "torchbeast_tpu_torch.fleet.topology",
        "torchbeast_tpu_torch.fleet.coordinator",
        "torchbeast_tpu_torch.fleet.snapshot_wire",
    ]))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15
