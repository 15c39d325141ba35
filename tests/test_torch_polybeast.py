"""The port's async driver (torchbeast_tpu_torch/polybeast.py): parser
parity with the JAX driver, tiny CPU runs of the shallow and the deep +
LSTM models through spawned env servers, the actor pool, the inference
threads and the state table, checkpoints with SIGTERM and resume,
--mode test, the not-yet-ported flags, and import purity (neither the
driver nor its env servers load jax; the env servers load no torch)."""

import logging
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torchbeast_tpu import polybeast as jax_polybeast
from torchbeast_tpu_torch import monobeast, polybeast
from torchbeast_tpu_torch.utils import serialization
from tests.test_torch_monobeast import _actions
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B = 5, 2


def test_parser_matches_the_reference():
    ours = _actions(polybeast.make_parser())
    theirs = _actions(jax_polybeast.make_parser())
    assert set(ours) - set(theirs) == {("--disable_cuda",)}
    assert set(theirs) - set(ours) == set()
    for flag, spec in theirs.items():
        assert ours[flag] == spec, flag
    assert len(theirs) == 85  # 80 dests, five of them with a --no_ twin


def test_env_server_parser_matches_the_reference():
    from torchbeast_tpu import polybeast_env as jax_env
    from torchbeast_tpu_torch import polybeast_env

    assert _actions(polybeast_env.make_parser()) == \
        _actions(jax_env.make_parser())
    flags = polybeast_env.make_parser().parse_args(["--native_server"])
    assert flags.native_server
    # --native_server: a fresh server interpreter serves through the
    # port's C++ EnvServer, which advertises the env as the Python one.
    from torchbeast_tpu_torch.runtime import transport

    address = polybeast_env.free_tcp_basename(1)
    proc = polybeast_env.ServerProcess("Mock", address, native=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                stream = transport.connect_transport(
                    address, timeout_s=5.0, recv_timeout_s=30.0)
                break
            except OSError:
                assert proc.is_alive() and time.monotonic() < deadline
                time.sleep(0.2)
        try:
            step = stream.recv()
            assert step["type"] == "step" and int(step["num_actions"]) == 6
            assert np.asarray(step["frame"]).shape == (84, 84, 4)
        finally:
            stream.close()
    finally:
        polybeast_env.reap_group([proc])


def _args(tmp_path, *extra, model=("--model", "deep", "--use_lstm")):
    return ["--disable_cuda", "--env", "Mock", *model,
            "--num_servers", "2", "--batch_size", str(B),
            "--unroll_length", str(T), "--savedir", str(tmp_path),
            "--xpid", "poly", "--pipes_basename", f"unix:{tmp_path}/pipes",
            "--max_inference_batch_size", "4", *extra]


@pytest.mark.parametrize("model,impls", [
    (("--model", "shallow"), ("associative", "xla", "--prewarm_inference")),
    (("--model", "deep", "--use_lstm"), ("pallas", "pallas",
                                         "--prewarm_inference")),
    (("--model", "deep", "--use_lstm"), ("pallas", "xla",
                                         "--no_device_agent_state")),
    (("--model", "transformer"), ("pallas", "pallas",
                                  "--device_agent_state")),
])
def test_tiny_run_on_cpu(tmp_path, monkeypatch, model, impls):
    """Three updates at T=5, B=2 from two env servers, the stateless
    acting path (shallow), the state table (deep + LSTM, and the
    transformer's KV cache) and the LSTM state riding the requests
    (--no_device_agent_state); the deep runs then play a greedy test
    episode from their checkpoint."""
    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    vtrace_impl, opt_impl, acting = impls
    flags = polybeast.make_parser().parse_args(_args(
        tmp_path, "--total_steps", str(3 * T * B), "--vtrace_impl",
        vtrace_impl, "--opt_impl", opt_impl, acting, model=model))
    stats = polybeast.train(flags)
    assert stats["step"] >= 3 * T * B
    assert stats["updates"] >= 3
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm", "sps", "update_interval_ms_median",
                "inference_batch_mean"):
        assert np.isfinite(stats[key]), key
    assert stats["inference_batch_mean"] >= 1
    assert stats["health"] == "HEALTHY"
    assert os.path.exists(tmp_path / "poly" / "model.ckpt")
    assert os.path.exists(tmp_path / "poly" / "logs.csv")
    if "--use_lstm" in model:
        test = polybeast.make_parser().parse_args(_args(
            tmp_path, "--mode", "test", "--num_test_episodes", "1"))
        assert polybeast.main(test) == [200.0]


def test_mode_test_without_a_checkpoint_uses_the_random_init(tmp_path,
                                                            caplog):
    flags = polybeast.make_parser().parse_args(_args(
        tmp_path, "--mode", "test", "--num_test_episodes", "1"))
    with caplog.at_level(logging.WARNING):
        assert polybeast.main(flags) == [200.0]
    assert "testing random init" in caplog.text


def _wait_for_output(proc, needle, timeout_s=120):
    buf = ""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                return False, buf
            continue
        buf += line
        if needle in line:
            return True, buf
    return False, buf


def _ckpt_step(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())["step"]


def test_sigterm_checkpoints_and_the_next_run_resumes(tmp_path):
    """SIGTERM a run mid-training: a clean exit (rc 0) with a checkpoint;
    the same xpid relaunched resumes from that checkpoint's step and
    finishes past it."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    argv = [sys.executable, "-u", "-m", "torchbeast_tpu_torch.polybeast",
            *_args(tmp_path, "--num_inference_threads", "1",
                   "--checkpoint_interval_s", "100000",
                   model=("--model", "shallow"))]
    proc = subprocess.Popen(
        argv + ["--total_steps", "100000000"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO,
    )
    started, buf = _wait_for_output(proc, "Step ")
    if not started:
        proc.kill()
    assert started, "driver never started:\n" + buf
    proc.send_signal(signal.SIGTERM)
    try:
        out = buf + proc.communicate(timeout=120)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, out[-4000:]
    assert "shutting down gracefully" in out
    ckpt = tmp_path / "poly" / "model.ckpt"
    step = _ckpt_step(ckpt)
    assert step > 0
    resumed = subprocess.run(
        argv + ["--total_steps", str(step + T * B)], capture_output=True,
        text=True, env=env, cwd=REPO, timeout=180,
    )
    assert resumed.returncode == 0, resumed.stdout[-4000:] + \
        resumed.stderr[-4000:]
    assert "Resuming preempted job" in resumed.stderr
    assert _ckpt_step(ckpt) > step


def _not_default(parser, dest):
    """A value of `dest` other than its parser default, as argv."""
    action = next(a for a in parser._actions if a.dest == dest)
    flag = action.option_strings[0]
    if action.nargs == 0:
        return [flag]
    if action.choices:
        return [flag, next(c for c in action.choices
                           if c != action.default)]
    if action.type in (int, float):
        return [flag, str((action.default or 0) + 2)]
    return [flag, "x"]


# Flags that raised NotImplementedError before their slice of the port
# (the data-parallel one, then the sequence-parallel and fleet one) ->
# what a value other than the default now does: the reference's error
# for that input, or (None) a run.
PORTED = {
    "num_learner_devices": (
        ValueError, "batch_size 2 not divisible by the learner mesh's "
        r"data axis \(3\)"),
    "coordinator_address": (None, None),
    "sequence_parallel": (
        ValueError, r"--sequence_parallel needs --model transformer \(the "
        r"conv\+LSTM families have no sequence-sharded formulation\)"),
    "fleet": (ValueError, "--fleet piece 'x' is not key=value"),
    "min_live_hosts": (None, None),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("dest", sorted(
    [*monobeast.SEQUENCE_PARALLEL_ONLY, *PORTED]))
def test_features_outside_the_port_raise(tmp_path, dest):
    """A sequence-parallel option without --sequence_parallel > 1 raises
    the reference's ValueError; a ported flag raises the reference's
    error for its value, or (--coordinator_address of a one-process
    group, --min_live_hosts without --fleet) trains."""
    parser = polybeast.make_parser()
    extra = _not_default(parser, dest)
    if dest == "coordinator_address":
        extra = ["--coordinator_address", f"127.0.0.1:{_free_port()}",
                 "--total_steps", str(T * B)]
    if dest == "min_live_hosts":
        # The fleet's floor: without --fleet the run is one host's.
        extra += ["--total_steps", str(T * B)]
    flags = parser.parse_args(_args(tmp_path) + extra)
    if dest in monobeast.SEQUENCE_PARALLEL_ONLY:
        with pytest.raises(ValueError,
                           match="only takes effect with --sequence_parallel"):
            polybeast.main(flags)
        return
    error, match = PORTED[dest]
    if error is None:
        stats = polybeast.main(flags)
        assert stats["step"] >= T * B
        assert not torch.distributed.is_initialized()
        return
    with pytest.raises(error, match=match):
        polybeast.main(flags)


def test_native_runtime_only_when_asked_for(tmp_path, monkeypatch):
    """The reference's tri-state: --native_runtime and the default (auto)
    take the port's C++ core, --no_native_runtime the Python pool; when
    the core cannot be built, --native_runtime raises with the reason
    and auto falls back to the Python pool. The native runtime's knobs
    are accepted."""
    from torchbeast_tpu_torch.runtime import native

    parser = polybeast.make_parser()
    for argv in ([], ["--native_runtime"], ["--no_native_runtime"],
                 ["--native_server"], ["--no_continuous_batching"],
                 ["--max_policy_lag", "3"]):
        polybeast.check_flags(parser.parse_args(argv))
    core = native.import_native()
    assert core is not None, native.gap_reason()
    assert polybeast.select_runtime(parser.parse_args([])) is core
    assert polybeast.select_runtime(
        parser.parse_args(["--native_runtime"])) is core
    assert polybeast.select_runtime(
        parser.parse_args(["--no_native_runtime"])) is None
    monkeypatch.setattr(native, "import_native", lambda: None)
    monkeypatch.setattr(native, "_error", "no compiler here")
    with pytest.raises(RuntimeError, match="no compiler here"):
        polybeast.select_runtime(parser.parse_args(["--native_runtime"]))
    assert polybeast.select_runtime(parser.parse_args([])) is None


def test_driver_and_env_servers_import_no_jax():
    code = (
        "import sys\n"
        "import torchbeast_tpu_torch.polybeast_env\n"
        "import torchbeast_tpu_torch.runtime.env_server\n"
        "server_side = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'flax', 'torchbeast_tpu'))\n"
        "import torchbeast_tpu_torch.polybeast\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'torchbeast_tpu')]\n"
        "assert not server_side, server_side\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


_SERVER_PARENT = """\
import argparse
import os
import sys
import time

import torch  # noqa: F401  (this main module loads torch)

from torchbeast_tpu_torch import polybeast_env

if __name__ == "__main__":
    base = sys.argv[1]
    flags = argparse.Namespace(env="Mock", num_servers=2,
                               pipes_basename="unix:" + base)
    supervisor = polybeast_env.ServerSupervisor(flags)
    try:
        deadline = time.time() + 60
        while not all(os.path.exists(f"{base}.{i}") for i in range(2)):
            assert time.time() < deadline, "the servers never listened"
            time.sleep(0.05)
        for proc in supervisor.processes:
            with open(f"/proc/{proc.pid}/maps") as f:
                maps = f.read()
            loaded = [lib for lib in ("libtorch", "jaxlib", "xla_extension")
                      if lib in maps]
            assert not loaded, (proc.pid, loaded)
        print("servers clean")
    finally:
        polybeast_env.reap_group(supervisor.processes)
    assert not any(p.is_alive() for p in supervisor.processes)
"""


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="reads /proc/<pid>/maps")
def test_env_servers_load_no_torch_under_a_torch_main(tmp_path):
    """A server started from a main module that imports torch (as
    chip_smoke.py and the driver are) loads neither torch nor jax: it is
    a fresh interpreter, not a child that imports the parent's main."""
    script = tmp_path / "parent.py"
    script.write_text(_SERVER_PARENT)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "pipes")], cwd=tmp_path,
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "servers clean" in proc.stdout
