"""The port's chaos harness CLI (python -m torchbeast_tpu_torch.chaos_run):
the selftest on the CPU on both runtimes, with the verdict's schema
pinned as the reference's is (tests/test_bench_scripts.py), and the
plan-scaling rule, held to the reference's own build_plan."""

import json
import os
import subprocess
import sys

import pytest

from torchbeast_tpu_torch import chaos_run
from torchbeast_tpu_torch.runtime import native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _selftest(tmp_path, *extra):
    out_json = tmp_path / "chaos_run.json"
    proc = subprocess.run(
        [sys.executable, "-m", "torchbeast_tpu_torch.chaos_run",
         "--selftest", "--disable_cuda", "--out", str(out_json),
         "--savedir", str(tmp_path), *extra],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert json.loads(out_json.read_text()) == out
    return out


# Slow: each selftest is two polybeast runs of 2400 steps with the
# reference's mlp model + LSTM on 84x84 frames, 22-27 s on the CPU over
# three timed runs of both cases, above the 20 s a quick-lane test may
# take. The quick lane keeps in-process chaos runs that assert the exact
# counts on both runtimes (tests/test_torch_telemetry.py).
def _spinners():
    """Pids of live `while True: pass` processes (chaos_run's spinners)."""
    pids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    if b"while True: pass" in f.read():
                        pids.append(int(entry))
            except OSError:
                pass
    return pids


@pytest.mark.slow
@pytest.mark.parametrize("runtime,pressure", [("python", 0), ("native", 0),
                                              ("python", 2)])
def test_chaos_run_selftest(tmp_path, runtime, pressure):
    """Two short polybeast runs (fault-free, then a seeded 4-class plan)
    and the acceptance contract: completion, exact recovery accounting,
    return parity, real and lossless load shedding, no leaks; with
    --scheduler_pressure 2 the chaos leg runs beside two spinners, the
    ring block records 2, and no spinner outlives the run."""
    if runtime == "native":
        try:
            native_build.check_toolchain()
        except native_build.NativeBuildError as e:
            pytest.skip(str(e))
    spinners = set(_spinners())
    out = _selftest(tmp_path, *(["--native"] if runtime == "native"
                                else []),
                    "--scheduler_pressure", str(pressure))
    assert out["bench"] == "chaos_run"
    assert out["selftest"] is True
    assert out["native"] is (runtime == "native")
    assert out["ok"] is True and out["failures"] == []
    assert out["scale"] == 1
    kinds = {f["kind"] for f in out["plan"]["faults"]}
    assert {"env_server_sigkill", "transport_sever", "state_table_poison",
            "learner_stall"} <= kinds
    chaos = out["results"]["chaos"]
    assert chaos["chaos"]["pending"] == []
    assert chaos["chaos"]["abandoned"] == []
    serving = out["serving"]
    assert set(serving) == {"admitted", "shed", "expired", "resubmitted"}
    assert serving["shed"] + serving["expired"] > 0
    assert serving["resubmitted"] == serving["shed"] + serving["expired"]
    assert serving["admitted"] > 0
    counters = chaos["counters"]
    for name in ("recovery.server_restarts", "recovery.actor_reconnects",
                 "recovery.inference_restarts", "recovery.table_rebuilds"):
        assert name in out["expected_counters"]
    for name, want in out["expected_counters"].items():
        assert int(counters.get(name, 0)) == want, (name, counters)
    for run in out["results"].values():
        assert run["step"] >= out["total_steps"]
        assert run["leaked_processes"] == []
        assert run["leaked_shm"] == []
    assert out["results"]["baseline"]["mean_episode_return"] == \
        chaos["mean_episode_return"]
    ring = out["ring"]
    assert ring["scheduler_pressure"] == pressure
    assert set(_spinners()) <= spinners
    for leg in ("baseline", "chaos"):
        assert set(ring[leg]) == {"doorbell_waits", "recheck_wakeups"}
        assert 0 <= ring[leg]["recheck_wakeups"] <= \
            ring[leg]["doorbell_waits"]
    assert set(out["telemetry"]) == {"enabled", "snapshot"}
    assert out["telemetry"]["enabled"] is True


def test_verdict_schema_matches_the_reference():
    """The port's verdict carries the reference's top-level keys and
    per-run keys (read from the reference's own source)."""
    import ast

    with open(os.path.join(REPO, "scripts", "chaos_run.py")) as f:
        tree = ast.parse(f.read())
    dicts = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Dict):
            target = node.targets[0]
            if isinstance(target, ast.Name):
                dicts[target.id] = {k.value for k in node.value.keys
                                    if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Return) and isinstance(node.value,
                                                       ast.Dict):
            keys = {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
            if "leaked_shm" in keys:
                dicts["run"] = keys
    with open(os.path.join(REPO, "torchbeast_tpu_torch",
                           "chaos_run.py")) as f:
        ours = ast.parse(f.read())
    our_dicts = {}
    for node in ast.walk(ours):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Dict):
            target = node.targets[0]
            if isinstance(target, ast.Name):
                our_dicts[target.id] = {k.value for k in node.value.keys
                                        if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Return) and isinstance(node.value,
                                                       ast.Dict):
            keys = {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
            if "leaked_shm" in keys:
                # "stats" is popped before the verdict is written.
                our_dicts["run"] = keys - {"stats"}
    assert our_dicts["verdict"] == dicts["verdict"]
    assert our_dicts["run"] == dicts["run"]


def _reference_chaos_run():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import chaos_run as reference
    finally:
        sys.path.pop(0)
    return reference


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_plan_scaling_rule(scale):
    """scale N plans N SIGKILLs on servers 0..N-1 and N severs on actors
    N..2N-1, one poison and one learner_stall, triggers staggered inside
    the run: the reference's build_plan, fault for fault."""
    args = chaos_run.parse_args([])
    args.scale = scale
    args.num_servers, args.num_actors = 2 * scale, 4 * scale
    plan = chaos_run.build_plan(args)
    reference = _reference_chaos_run()
    ref_args = reference.parse_args([])
    ref_args.scale = scale
    ref_args.num_servers, ref_args.num_actors = 2 * scale, 4 * scale
    assert plan == reference.build_plan(ref_args)
    by_kind = {}
    for fault in plan["faults"]:
        by_kind.setdefault(fault["kind"], []).append(fault)
    assert len(by_kind["env_server_sigkill"]) == scale
    assert len(by_kind["transport_sever"]) == scale
    assert len(by_kind["state_table_poison"]) == 1
    assert len(by_kind["learner_stall"]) == 1
    kill_servers = {f["target"] for f in by_kind["env_server_sigkill"]}
    sever_actors = {f["target"] for f in by_kind["transport_sever"]}
    assert kill_servers == set(range(scale))
    assert sever_actors == set(range(scale, 2 * scale))
    assert not {a % args.num_servers for a in sever_actors} & kill_servers
    for fault in plan["faults"]:
        assert 0 < fault["at_step"] < args.total_steps
    stall = by_kind["learner_stall"][0]
    assert stall["duration_s"] == args.stall_s


@pytest.mark.parametrize("argv, message", [
    (["--scale", "0"], "--scale must be >= 1"),
    (["--num_servers", "4", "--num_actors", "6"], "must be a multiple"),
    (["--scale", "3", "--num_servers", "1", "--num_actors", "1"],
     "must be >= 2*scale"),
    (["--stall_s", "0.2"], "--stall_s must exceed"),
])
def test_bad_configurations_are_refused(argv, message, capsys):
    assert chaos_run.main(argv) == 2
    assert message in capsys.readouterr().err


def test_expected_counters_follow_the_topology():
    expected = chaos_run.expected_counters(
        {"env_server_sigkill": 2, "transport_sever": 1,
         "state_table_poison": 1, "learner_stall": 1},
        actors_per_server=3)
    assert expected["recovery.actor_reconnects"] == 2 * 3 + 1
    assert expected["recovery.server_restarts"] == 2
    assert expected["recovery.inference_restarts"] == 1
    assert expected["recovery.table_rebuilds"] == 1
    assert expected["chaos.learner_stall.injected"] == 1


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_scheduler_pressure_spinners_come_and_go():
    """--scheduler_pressure's spinners: N processes, each the leader of a
    process group of its own while the leg runs, all gone after it."""
    with chaos_run.SchedulerPressure(2) as pressure:
        pids = pressure.pids
        assert len(pids) == 2 and all(_alive(pid) for pid in pids)
        assert all(os.getpgid(pid) == pid for pid in pids)
    assert not any(_alive(pid) for pid in pids)
    with chaos_run.SchedulerPressure(0) as pressure:
        assert pressure.pids == []


def test_scheduler_pressure_wraps_the_chaos_leg_only(tmp_path, monkeypatch,
                                                     capsys):
    """main() with --scheduler_pressure 2 (the legs stubbed out): the
    baseline leg runs beside no spinner, the chaos leg beside 2, the
    verdict's ring block records 2 with each leg's ring counters, and no
    spinner outlives the run."""
    seen = {}
    real = chaos_run.SchedulerPressure

    class Watched(real):
        def __enter__(self):
            super().__enter__()
            seen["pids"] = list(self.pids)
            return self

    def fake_run(args, savedir, xpid, chaos_plan_path=None, argv=None):
        seen[xpid] = [pid for pid in seen.get("pids", []) if _alive(pid)]
        waits = 5 if chaos_plan_path else 3
        return {"xpid": xpid, "step": args.total_steps, "health": "HEALTHY",
                "mean_episode_return": 200.0, "chaos": None,
                "counters": {"ring.doorbell_waits": waits,
                             "ring.recheck_wakeups": 1},
                "leaked_processes": [], "leaked_shm": [], "stats": {}}

    monkeypatch.setattr(chaos_run, "SchedulerPressure", Watched)
    monkeypatch.setattr(chaos_run, "run_one", fake_run)
    chaos_run.main(["--selftest", "--disable_cuda", "--savedir",
                    str(tmp_path), "--scheduler_pressure", "2"])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert seen["chaos-baseline"] == []
    assert len(seen["chaos-faulted"]) == 2
    assert verdict["ring"] == {
        "scheduler_pressure": 2,
        "baseline": {"doorbell_waits": 3, "recheck_wakeups": 1},
        "chaos": {"doorbell_waits": 5, "recheck_wakeups": 1}}
    assert not any(_alive(pid) for pid in seen["pids"])
    assert chaos_run.main(["--scheduler_pressure", "-1"]) == 2
