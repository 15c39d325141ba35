"""--loss impact, --replay_reuse and --target_refresh_updates in the port's
drivers on the CPU, and --model mlp with --env tbt/MiniAtari-v0:

- monobeast with --replay_reuse 2 takes exactly twice the updates of
  --replay_reuse 1 at the same env frames; polybeast (on both runtimes)
  takes the reference's count, ending at the first dispatch that reaches
  --total_steps, so the last batch's replay is never handed out;
- the target network's series and cadence are the reference's, every
  telemetry.jsonl line is valid, and a monobeast run writes the
  reference's series names;
- polybeast arms replicas every 10 updates under --loss impact by
  default, as the reference resolves it;
- the mlp model trains on the MiniAtari stack in both drivers."""

import os
import subprocess
import sys

import numpy as np
import pytest

from torchbeast_tpu import polybeast as jax_polybeast
from torchbeast_tpu_torch import monobeast, polybeast, telemetry
from torchbeast_tpu_torch.runtime import native_build
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "grad_norm")


def _toolchain_gap():
    try:
        native_build.check_toolchain()
    except native_build.NativeBuildError as e:
        return str(e)
    return None


COUNTERS = ("learner.updates", "learner.target.snapshots_published",
            "serving.snapshots_published")


def _counts():
    """The process-wide registry's COUNTERS now (0 for one not made yet):
    a run's own counts are the difference across it."""
    made = telemetry.get_registry().instruments()
    return {name: made[name].value() if name in made else 0.0
            for name in COUNTERS}


def _run(train, flags):
    before = _counts()
    stats = train(flags)
    after = _counts()
    return stats, {name: after[name] - before[name] for name in COUNTERS}


def _lines(tmp_path, xpid):
    lines = telemetry.read_jsonl(str(tmp_path / xpid / "telemetry.jsonl"))
    assert lines and lines[-1]["final"]
    for line in lines:
        assert telemetry.validate_snapshot(line) == []
    return lines


# -------------------------------------------------------------- monobeast

def _mono(tmp_path, xpid, *extra, model=("--model", "deep", "--use_lstm"),
          env="Mock"):
    return monobeast.make_parser().parse_args([
        "--disable_cuda", "--env", env, *model, "--num_actors", "4",
        "--batch_size", "2", "--unroll_length", "4", "--total_steps", "48",
        "--serial_envs", "--vtrace_impl", "pallas", "--opt_impl", "pallas",
        "--savedir", str(tmp_path), "--xpid", xpid, *extra])


@pytest.mark.parametrize("k", [1, 2])
def test_monobeast_reuse_doubles_the_updates(tmp_path, monkeypatch, k):
    """48 env frames in both runs; --replay_reuse 2 dispatches each
    staged batch twice: 12 updates against 6, and the target refreshed
    between reuse groups only, when 2 updates are due."""
    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    runs = {}
    for reuse in (1, 2):
        xpid = f"mono_r{reuse}"
        stats, counts = _run(monobeast.train, _mono(
            tmp_path, xpid, "--loss", "impact", "--replay_reuse",
            str(reuse), "--target_refresh_updates", "2", "--superstep_k",
            str(k)))
        for key in LOSS_KEYS:
            assert np.isfinite(stats[key]), key
        runs[reuse] = (stats, counts, _lines(tmp_path, xpid)[-1])
    (one, _, _), (two, counts, line) = runs[1], runs[2]
    assert one["step"] == two["step"] == 48
    assert (one["updates"], two["updates"]) == (6, 12)
    assert counts["learner.updates"] == 12
    assert line["gauges"]["learner.sample_reuse"] == 2
    for reuse, (_, counts, line) in runs.items():
        # Version 0, then one at the end of each group of K x K' updates
        # (6 / K groups) when 2 or more updates passed since the last.
        published, last, version = 1, 0, 0
        for _ in range(6 // k):
            version += k * reuse
            if version - last >= 2:
                published, last = published + 1, version
        assert counts["learner.target.snapshots_published"] == published
        assert line["gauges"]["learner.target.snapshot_version"] == (
            6 * reuse)


def test_monobeast_impact_series_match_the_reference(tmp_path):
    """A CPU monobeast run of each package with --loss impact
    --replay_reuse 2, in interpreters of their own: the same series
    names and kinds on the final line (learner.target.* included), the
    same update count and the same target cadence."""
    argv = ["--env", "Mock", "--model", "shallow", "--num_actors", "4",
            "--batch_size", "2", "--unroll_length", "4", "--total_steps",
            "48", "--serial_envs", "--xpid", "tele", "--loss", "impact",
            "--replay_reuse", "2", "--target_refresh_updates", "3"]
    for package, extra in (("torchbeast_tpu", []),
                           ("torchbeast_tpu_torch", ["--disable_cuda"])):
        code = (
            "import os, sys\n"
            "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            f"from {package} import monobeast\n"
            "monobeast.train(monobeast.make_parser().parse_args("
            "sys.argv[1:]))\n")
        proc = subprocess.run(
            [sys.executable, "-c", code, *argv, *extra, "--savedir",
             str(tmp_path / package)], cwd=REPO, capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    theirs = telemetry.read_jsonl(
        str(tmp_path / "torchbeast_tpu" / "tele" / "telemetry.jsonl"))[-1]
    ours = _lines(tmp_path / "torchbeast_tpu_torch", "tele")[-1]

    def kinds(line):
        return {(kind, name) for kind in ("counters", "gauges",
                                          "histograms")
                for name in line[kind]}

    assert kinds(ours) == kinds(theirs)
    statics = set(theirs) - {"counters", "gauges", "histograms", "time"}
    assert set(ours) - {"counters", "gauges", "histograms", "time"} == (
        statics)
    for name in ("learner.updates", "learner.target.snapshots_published"):
        assert ours["counters"][name] == theirs["counters"][name], name
    for name in ("learner.target.snapshot_version", "learner.sample_reuse"):
        assert ours["gauges"][name] == theirs["gauges"][name], name


def test_monobeast_mlp_on_miniatari(tmp_path):
    """--model mlp --use_lstm on the full Atari stack of the MiniAtari
    cabinet."""
    pytest.importorskip("gymnasium")
    stats = monobeast.train(_mono(tmp_path, "mlp", model=(
        "--model", "mlp", "--use_lstm"), env="tbt/MiniAtari-v0"))
    for key in LOSS_KEYS:
        assert np.isfinite(stats[key]), key
    assert stats["step"] == 48 and stats["updates"] == 6


# -------------------------------------------------------------- polybeast

T, B = 5, 2


def _poly(tmp_path, xpid, *extra, model=("--model", "deep", "--use_lstm"),
          env="Mock"):
    return polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", env, *model, "--num_servers", "2",
        "--batch_size", str(B), "--unroll_length", str(T), "--savedir",
        str(tmp_path), "--xpid", xpid, "--pipes_basename",
        f"unix:{tmp_path}/pipes-{xpid}", "--max_inference_batch_size", "4",
        "--vtrace_impl", "pallas", "--opt_impl", "pallas",
        "--total_steps", str(3 * T * B), *extra])


@pytest.mark.parametrize("runtime", ["python", "native"])
def test_polybeast_reuse_doubles_the_updates(tmp_path, runtime):
    """3 batches of env frames in both runs, on either runtime: --loss
    impact --replay_reuse 2 takes 5 updates against 3, as the reference
    does (the run ends at the dispatch of the third fresh batch, before
    its replay), replicas armed by the relaxed default, the target and
    replica stores publishing their version 0, every line valid."""
    if runtime == "native":
        gap = _toolchain_gap()
        if gap is not None:
            pytest.skip(gap)
        extra = ["--native_runtime", "--native_server"]
    else:
        extra = ["--no_native_runtime"]
    runs = {}
    for reuse in (1, 2):
        xpid = f"poly_{runtime}_r{reuse}"
        stats, counts = _run(polybeast.train, _poly(
            tmp_path, xpid, "--loss", "impact", "--replay_reuse",
            str(reuse), *extra))
        assert stats["health"] == "HEALTHY", stats["health_reasons"]
        assert stats["runtime"] == runtime
        for key in LOSS_KEYS:
            assert np.isfinite(stats[key]), key
        _lines(tmp_path, xpid)
        runs[reuse] = (stats, counts)
    (one, _), (two, counts) = runs[1], runs[2]
    assert one["step"] == two["step"] == 3 * T * B
    assert (one["updates"], two["updates"]) == (3, 5)
    assert counts["learner.updates"] == 5
    for _, counts in runs.values():
        # Refreshes every 8 updates: version 0 alone in 5 updates.
        assert counts["learner.target.snapshots_published"] == 1
        # Replicas armed without --replica_refresh_updates.
        assert counts["serving.snapshots_published"] == 1


def test_polybeast_vtrace_keeps_central_serving(tmp_path):
    """Under --loss vtrace the default stays central serving only: no
    replica store, no target store."""
    stats, counts = _run(polybeast.train, _poly(
        tmp_path, "vt", "--no_native_runtime", "--total_steps", str(T * B)))
    assert stats["updates"] == 1 and counts["learner.updates"] == 1
    _lines(tmp_path, "vt")
    assert counts["serving.snapshots_published"] == 0
    assert counts["learner.target.snapshots_published"] == 0


@pytest.mark.parametrize("loss,explicit", [
    ("vtrace", None), ("impact", None), ("vtrace", 3), ("impact", 3)])
def test_replica_refresh_default_matches_the_reference(loss, explicit):
    argv = ["--loss", loss]
    if explicit is not None:
        argv += ["--replica_refresh_updates", str(explicit)]
    ours = polybeast.effective_replica_refresh_updates(
        polybeast.make_parser().parse_args(argv))
    theirs = jax_polybeast.effective_replica_refresh_updates(
        jax_polybeast.make_parser().parse_args(argv))
    assert ours == theirs == (explicit or (10 if loss == "impact" else 0))


def test_polybeast_impact_superstep_and_resume(tmp_path):
    """--superstep_k 2 --replay_reuse 2 (a [2, T+1, B] arena stack,
    dispatched twice), then a resume from its checkpoint that runs on.
    As the reference does, each run ends at the dispatch of its last
    fresh stack, before that stack's replay: fresh, replay, fresh (3
    dispatches), then fresh (1)."""
    argv = ["--no_native_runtime", "--loss", "impact", "--replay_reuse",
            "2", "--superstep_k", "2"]
    first = polybeast.train(_poly(tmp_path, "ks", *argv, "--total_steps",
                                  str(4 * T * B)))
    assert first["step"] == 4 * T * B and first["updates"] == 3
    second = polybeast.train(_poly(tmp_path, "ks", *argv, "--total_steps",
                                   str(6 * T * B)))
    assert second["step"] == 6 * T * B and second["updates"] == 1
    line = _lines(tmp_path, "ks")[-1]
    assert line["counters"]["learner.updates"] >= 4


def test_polybeast_mlp_on_miniatari(tmp_path):
    pytest.importorskip("gymnasium")
    stats = polybeast.train(_poly(
        tmp_path, "mlp", "--no_native_runtime", model=(
            "--model", "mlp", "--use_lstm"), env="tbt/MiniAtari-v0"))
    assert stats["health"] == "HEALTHY"
    for key in LOSS_KEYS:
        assert np.isfinite(stats[key]), key
