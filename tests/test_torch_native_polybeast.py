"""The port's polybeast on its C++ runtime core, on the CPU
(--disable_cuda): deep + LSTM trains a few updates under
--native_runtime (the core's queue, batcher and actor pool over the
port's state table), and under --native_runtime --native_server at
--superstep_k 2 (the core's env servers, the arena's intake); losses are
finite, health is HEALTHY, the core's series fold into the registry, and
the run resumes from its checkpoint. The default (auto) picks the core
and logs it; with the builder failing, --native_runtime and
--native_server raise its message and auto logs it and runs the Python
pool."""

import logging
import os

import numpy as np
import pytest

from torchbeast_tpu_torch import polybeast, telemetry
from torchbeast_tpu_torch.runtime import native, native_build
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B = 5, 2
NATIVE_POOL = "_tbt_core_torch.ActorPool"
PYTHON_POOL = "torchbeast_tpu_torch.runtime.actor_pool.ActorPool"


def _toolchain_gap():
    try:
        native_build.check_toolchain()
    except native_build.NativeBuildError as e:
        return str(e)
    return None


_GAP = _toolchain_gap()


def _args(tmp_path, *extra):
    return ["--disable_cuda", "--env", "Mock", "--model", "deep",
            "--use_lstm", "--num_servers", "2", "--batch_size", str(B),
            "--unroll_length", str(T), "--savedir", str(tmp_path),
            "--xpid", "poly", "--pipes_basename", f"unix:{tmp_path}/pipes",
            "--max_inference_batch_size", "4", "--vtrace_impl", "pallas",
            "--opt_impl", "pallas", *extra]


def _check_run(stats, pool, runtime):
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm", "sps", "update_interval_ms_median",
                "inference_batch_mean"):
        assert np.isfinite(stats[key]), key
    assert stats["inference_batch_mean"] >= 1
    assert stats["health"] == "HEALTHY", stats["health_reasons"]
    assert stats["runtime"] == runtime
    assert stats["actor_pool"] == pool


@pytest.mark.skipif(_GAP is not None, reason=str(_GAP))
@pytest.mark.parametrize("k,server", [(1, []), (2, ["--native_server"])],
                         ids=["k1", "k2-native_server"])
def test_native_runtime_trains_and_resumes(tmp_path, monkeypatch, caplog,
                                           k, server):
    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    reg = telemetry.get_registry()
    rtt_before = reg.histogram("actor.request_rtt_s").count
    items_before = reg.counter("learner_queue.items_in").value()
    base = _args(tmp_path, "--native_runtime", "--superstep_k", str(k),
                 *server)
    parse = polybeast.make_parser().parse_args
    steps = 2 * k * T * B
    with caplog.at_level(logging.INFO, logger="torchbeast_tpu_torch"):
        stats = polybeast.train(parse(base + ["--total_steps", str(steps)]))
    assert "Using the native (C++) runtime" in caplog.text
    _check_run(stats, NATIVE_POOL, "native")
    assert stats["step"] >= steps
    assert stats["updates"] >= 2
    assert stats["actor_reconnects"] == 0
    # The core's stamps and queue counters folded into the registry.
    assert reg.histogram("actor.request_rtt_s").count > rtt_before
    assert reg.counter("learner_queue.items_in").value() >= (
        items_before + stats["updates"] * k * B)
    ckpt = tmp_path / "poly" / "model.ckpt"
    assert ckpt.exists()

    caplog.clear()
    with caplog.at_level(logging.INFO, logger="torchbeast_tpu_torch"):
        resumed = polybeast.train(parse(
            base + ["--total_steps", str(stats["step"] + k * T * B)]))
    assert f"'step': {stats['step']}" in next(
        r.getMessage() for r in caplog.records
        if r.getMessage().startswith("Resuming preempted job"))
    _check_run(resumed, NATIVE_POOL, "native")
    assert resumed["step"] > stats["step"]


@pytest.mark.skipif(_GAP is not None, reason=str(_GAP))
def test_auto_picks_the_core_and_logs_it(tmp_path, caplog):
    flags = polybeast.make_parser().parse_args(_args(
        tmp_path, "--total_steps", str(T * B)))
    assert flags.native_runtime is None
    with caplog.at_level(logging.INFO, logger="torchbeast_tpu_torch"):
        stats = polybeast.train(flags)
    assert "Using the native (C++) runtime" in caplog.text
    _check_run(stats, NATIVE_POOL, "native")


def _fail_build(monkeypatch):
    def broken():
        raise native_build.NativeBuildError(
            "runtime core build failed:\nsentinel: compiler said no")

    monkeypatch.setattr(native_build, "load", broken)


@pytest.mark.parametrize("flag", ["--native_runtime", "--native_server"])
def test_explicit_request_raises_the_build_error(tmp_path, monkeypatch,
                                                 flag):
    _fail_build(monkeypatch)
    flags = polybeast.make_parser().parse_args(_args(
        tmp_path, flag, "--total_steps", str(T * B)))
    with pytest.raises(RuntimeError, match="sentinel: compiler said no"):
        polybeast.train(flags)
    # Raised before any env server or checkpoint existed.
    assert not os.path.exists(tmp_path / "poly" / "model.ckpt")


def test_auto_falls_back_to_the_python_pool(tmp_path, monkeypatch, caplog):
    _fail_build(monkeypatch)
    flags = polybeast.make_parser().parse_args(_args(
        tmp_path, "--total_steps", str(T * B)))
    with caplog.at_level(logging.INFO, logger="torchbeast_tpu_torch"):
        stats = polybeast.train(flags)
    assert "Native runtime unavailable" in caplog.text
    assert "sentinel: compiler said no" in caplog.text
    _check_run(stats, PYTHON_POOL, "python")


def test_no_native_runtime_runs_the_python_pool(tmp_path, caplog):
    flags = polybeast.make_parser().parse_args(_args(
        tmp_path, "--no_native_runtime", "--total_steps", str(T * B)))
    with caplog.at_level(logging.INFO, logger="torchbeast_tpu_torch"):
        stats = polybeast.train(flags)
    assert "Using the Python runtime" in caplog.text
    _check_run(stats, PYTHON_POOL, "python")
