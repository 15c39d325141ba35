"""polybeast of each package, run for run on the CPU.

Each case runs the reference's `polybeast.train` and the port's, each in
an interpreter of its own, with the same argv (the JAX package's native
core is not built on the CPU, so both run on the Python pool). The two
runs must agree on the final env-frame step, the final telemetry line's
update count, IMPACT target counters and sample reuse, the series names
and kinds, the health verdict, the keys of the returned stats, and the
checkpoint's tree of keys, shapes and dtypes. The port's acting and
replica seeds are held to the reference's formulas at host ranks 0-3.

Both drivers set their throughput gauges (learner.sps,
learner.sample_reuse, ...) on a 5 s monitor tick, so a run shorter than
one tick writes none. Every run here slows its stats flush by FLUSH_S
seconds (the flush only post-processes the stats the update already
returned), so its learner outlasts the first tick in either package."""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torchbeast_tpu import polybeast as jax_polybeast
from torchbeast_tpu_torch import parallel, polybeast, telemetry
from torchbeast_tpu_torch.fleet import parse_fleet_spec
from torchbeast_tpu_torch.utils import serialization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, B = 5, 2
ARGV = ["--env", "Mock", "--num_servers", "2", "--batch_size", str(B),
        "--unroll_length", str(T), "--max_inference_batch_size", "4",
        "--no_native_runtime"]
TOTAL_STEPS = 3 * T * B  # three batches of env frames
# Case: (its own flags, the updates the reference takes, its final env
# frames). The run ends at the first dispatch whose env frames reach
# --total_steps, so N fresh dispatches under --replay_reuse K' take
# K' (N - 1) + 1 in all; at --superstep_k 2 a dispatch is two batches.
CASES = {
    "deep_lstm_vtrace": (["--model", "deep", "--use_lstm"], 3, TOTAL_STEPS),
    "impact_reuse2": (["--loss", "impact", "--replay_reuse", "2"], 5,
                      TOTAL_STEPS),
    "impact_reuse2_superstep2": (["--loss", "impact", "--replay_reuse", "2",
                                  "--superstep_k", "2"], 6, 4 * T * B),
}
FLUSH_S = 2.5
PACKAGES = ("torchbeast_tpu", "torchbeast_tpu_torch")
# Flags only the port's parser has.
PORT_ONLY_FLAGS = {"disable_cuda"}

CODE = f"""
import importlib, json, os, sys, time
os.environ['JAX_PLATFORMS'] = 'cpu'
package = sys.argv[1]
learner = importlib.import_module(package + '.learner')
polybeast = importlib.import_module(package + '.polybeast')
postprocess = learner.episode_stat_postprocess

def slow_postprocess(stats):
    time.sleep({FLUSH_S})
    return postprocess(stats)

learner.episode_stat_postprocess = slow_postprocess
stats = polybeast.train(polybeast.make_parser().parse_args(sys.argv[2:]))
print('STATS ' + json.dumps({{'keys': sorted(stats), 'step': int(
    stats['step']), 'health': str(stats['health'])}}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(case, package): (returned stats, final telemetry line, lines,
    checkpoint)}, every run started at once."""
    root = tmp_path_factory.mktemp("parity")
    procs = {}
    for case, (flags, _, _) in CASES.items():
        for package in PACKAGES:
            savedir = root / package
            extra = ["--disable_cuda"] if package.endswith("_torch") else []
            argv = [*ARGV, *flags, "--total_steps", str(TOTAL_STEPS),
                    "--savedir", str(savedir), "--xpid", case,
                    "--pipes_basename", f"unix:{root}/pipes-{package}-{case}",
                    *extra]
            procs[case, package] = subprocess.Popen(
                [sys.executable, "-c", CODE, package, *argv], cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0, (key, stderr[-3000:])
            stats = json.loads(stdout.rsplit("STATS ", 1)[1])
            rundir = root / key[1] / key[0]
            lines = telemetry.read_jsonl(str(rundir / "telemetry.jsonl"))
            with open(rundir / "model.ckpt", "rb") as f:
                checkpoint = serialization.msgpack_restore(f.read())
            out[key] = (stats, lines[-1], lines, checkpoint)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _pair(runs, case):
    return runs[case, "torchbeast_tpu"], runs[case, "torchbeast_tpu_torch"]


@pytest.mark.parametrize("case", CASES)
def test_updates_and_step_match_the_reference(runs, case):
    (theirs, their_line, _, _), (ours, our_line, _, _) = _pair(runs, case)
    _, updates, step = CASES[case]
    assert their_line["counters"]["learner.updates"] == updates
    assert our_line["counters"]["learner.updates"] == updates
    assert ours["step"] == theirs["step"] == step
    assert our_line["step"] == their_line["step"] == step
    for kind in ("counters", "gauges"):
        target = {n: v for n, v in their_line[kind].items()
                  if n.startswith("learner.target.")}
        assert {n: our_line[kind].get(n) for n in target} == target, kind
    reuse = their_line["gauges"]["learner.sample_reuse"]
    assert our_line["gauges"]["learner.sample_reuse"] == reuse


@pytest.mark.parametrize("case", CASES)
def test_series_match_the_reference(runs, case):
    """The final lines carry the same series by name and kind (the monitor
    tick's gauges included: each run outlasted a tick; the port writes no
    series of its own) and the same static fields."""
    (_, theirs, their_lines, _), (_, ours, our_lines, _) = _pair(runs, case)
    assert len(their_lines) >= 2 and len(our_lines) >= 2

    def kinds(line):
        return {(kind, name) for kind in ("counters", "gauges",
                                          "histograms")
                for name in line[kind]}

    assert kinds(ours) == kinds(theirs), sorted(kinds(ours) ^ kinds(theirs))
    assert set(ours) == set(theirs)
    assert ours["final"] and theirs["final"]


@pytest.mark.parametrize("case", CASES)
def test_health_and_stats_keys_match_the_reference(runs, case):
    (theirs, _, _, _), (ours, _, _, _) = _pair(runs, case)
    assert ours["health"] == theirs["health"] == "HEALTHY"
    assert set(theirs["keys"]) <= set(ours["keys"]), sorted(
        set(theirs["keys"]) - set(ours["keys"]))


def _tree(node, path=()):
    """{key path: (shape, dtype)} of a restored checkpoint; a leaf that is
    no array by its Python type."""
    if isinstance(node, dict):
        out = {}
        for key, value in node.items():
            out.update(_tree(value, path + (key,)))
        return out
    if isinstance(node, torch.Tensor):
        return {path: (tuple(node.shape), str(node.dtype).split(".")[-1])}
    if isinstance(node, (np.ndarray, np.generic)):
        return {path: (np.shape(node), str(np.asarray(node).dtype))}
    return {path: type(node).__name__}


@pytest.mark.parametrize("case", CASES)
def test_checkpoint_tree_matches_the_reference(runs, case):
    """The checkpoint of each, read through the port's codec: the same
    params, optimizer state, stats and step, leaf by leaf in shape and
    dtype, and the reference's flags plus the port's own."""
    (_, _, _, theirs), (_, _, _, ours) = _pair(runs, case)
    assert ours["step"] == theirs["step"] == CASES[case][2]
    assert set(ours["flags"]) - set(theirs["flags"]) == PORT_ONLY_FLAGS
    ours = {**ours, "flags": {k: v for k, v in ours["flags"].items()
                              if k not in PORT_ONLY_FLAGS}}
    assert _tree(ours) == _tree(theirs)


# The reference's host rank and the two seeds drawn from it, as its
# polybeast.py writes them.
REFERENCE_SEED_LINES = (
    "host_rank = fleet.host_rank if fleet is not None else proc_id",
    "jax.random.PRNGKey(flags.seed + host_rank)",
    "rng_seed=flags.seed + 7919 * (host_rank + 1)",
)


def test_reference_seeds_are_the_ones_held():
    source = inspect.getsource(jax_polybeast)
    for line in REFERENCE_SEED_LINES:
        assert line in source, line


@pytest.mark.parametrize("fleet", [False, True], ids=["process", "fleet"])
@pytest.mark.parametrize("rank", range(4))
def test_seeds_follow_the_host_rank(monkeypatch, rank, fleet):
    """The acting seed is --seed + host_rank and the replica seed --seed +
    7919 (host_rank + 1), the host rank being the fleet rank under --fleet
    and else the process index."""
    argv = ["--seed", "77"]
    if fleet:
        argv += ["--fleet", f"host={rank}/4,coord=127.0.0.1:1"]
        # Another process index: the fleet rank wins.
        monkeypatch.setattr(parallel, "process_index", lambda: 3 - rank)
    else:
        monkeypatch.setattr(parallel, "process_index", lambda: rank)
    flags = polybeast.make_parser().parse_args(argv)
    host_rank = polybeast.resolve_host_rank(parse_fleet_spec(flags.fleet))
    assert host_rank == rank
    assert polybeast.acting_seed(flags, host_rank) == 77 + rank
    assert polybeast.replica_seed(flags, host_rank) == 77 + 7919 * (rank + 1)
