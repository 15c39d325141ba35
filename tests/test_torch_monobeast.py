"""The port's driver (torchbeast_tpu_torch/monobeast.py): parser parity
with the JAX driver, a tiny CPU run of the slice's configuration, the
no-silent-CPU rule, the not-yet-ported flags, and import purity (the
port loads neither jax nor the JAX package)."""

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


@pytest.mark.parametrize("args,item", [
    (["--checkpoint_interval_s", "60"], "checkpoints"),
    (["--loss", "impact"], "IMPACT"),
    (["--device_split", "auto"], "serving"),
    (["--num_learner_devices", "2"], "data parallel"),
    (["--overlap_collect"], "overlap"),
    (["--superstep_k", "2"], "overlap"),
    (["--remat", "all"], "stage remat"),
    (["--mode", "test"], "checkpoints"),
    (["--trace_path", "t.json"], "telemetry"),
    (["--model", "pipelined_transformer"], "transformer"),
    (["--sequence_parallel", "2"], "transformer"),
    (["--num_experts", "4"], "transformer"),
    (["--env", "PongNoFrameskip-v4"], "Atari"),
])
def test_features_outside_the_port_raise(tmp_path, args, item):
    flags = _flags(*args, tmp_path=tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        monobeast.main(flags)


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
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15
