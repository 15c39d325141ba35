"""The benchmark's guards: what a run may load, read and write, the run
without a card, and BENCHMARK.json against its schema."""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from portbench import cells, run
from portbench.tests.tiny import WORKLOADS

ROOT = cells.ROOT


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["torchbeast_tpu_torch", "torchbeast_tpu_torch.learner", "jaxx",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "torchbeast_tpu", "torchbeast_tpu.learner", "torch"]
    assert run.forbidden_modules(names) == sorted([
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
        "torchbeast_tpu", "torchbeast_tpu.learner"])


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "deep_lstm.learn", "--seed", "3000000000", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""
    assert "no result" in proc.stderr


# A whole run at CPU-test size, under an audit hook that records every
# file the process opens and every module it holds at the end.
_AUDITED = textwrap.dedent("""
    import json, os, sys, time
    opened = []
    def hook(event, args):
        if event == "open" and isinstance(args[0], (str, bytes)):
            path = os.fsdecode(args[0])
            mode = args[1] if isinstance(args[1], str) else ""
            flags = args[2] if len(args) > 2 and isinstance(args[2], int) else 0
            write = any(c in (mode or "") for c in "wax+") or bool(
                flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
            opened.append((os.path.abspath(path), write))
    sys.addaudithook(hook)
    import torch
    from portbench import harness, run
    from portbench.tests.tiny import tiny
    result, ctx = harness.run(tiny(sys.argv[1]), 7, 0.2, True,
                              torch.device("cpu"), time.perf_counter())
    print(json.dumps({"opened": opened, "correct": result["correct"],
                      "forbidden": run.forbidden_modules(sys.modules)}))
""")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_run_reads_and_writes_only_where_it_may(workload, tmp_path):
    dirs = {k: tmp_path / k for k in ("home", "cache", "tmp")}
    for d in dirs.values():
        d.mkdir()
    env = {**os.environ, "HOME": str(dirs["home"]),
           "XDG_CACHE_HOME": str(dirs["cache"]), "TMPDIR": str(dirs["tmp"]),
           "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", _AUDITED, workload],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["forbidden"] == []
    for path, write in out["opened"]:
        assert not path.startswith(os.path.join(ROOT, "benchmarks") + os.sep)
        assert path != os.path.join(ROOT, "bench.py")
        assert not path.startswith("/dev/shm")
        if write and path != os.devnull:
            allowed = [ROOT] + [str(d) for d in dirs.values()]
            assert any(path == a or path.startswith(a + os.sep)
                       for a in allowed), path


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["portbench"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    metrics = b["end_to_end"] + b["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    pairs = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cells_find_their_files_by_name(workload):
    cell = cells.load(workload)
    assert cell.chips == 1
    names = {m.name for m in cell.metrics}
    assert {"learn_fps", "step_p95_ms", "setup_s", "mfu"} <= names
    assert ("pool_bwd_roofline" in names) == (workload == "deep_lstm.learn")
    assert all(callable(m.read) for m in cell.metrics)
    assert cell.config["limits"] and cell.config["reduced"] == []


def test_traffic_with_a_knob_no_loop_reads_is_refused(tmp_path):
    (tmp_path / "traffic").mkdir()
    mix = dict(cells.read_traffic("learn"), loop="actor_pool")
    (tmp_path / "traffic" / "other.json").write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="loop"):
        cells.read_traffic("other", here=str(tmp_path))
