"""Chaos acceptance harness for the port's polybeast: run it under a
seeded multi-fault plan and PROVE recovery, not just survival (the port
of scripts/chaos_run.py, without its multi-host fleet mode, which goes
with ROADMAP.md Queue 1 item 'the fleet').

Two in-process polybeast runs on the same config:

  1. baseline — fault-free,
  2. chaos    — a seeded FaultPlan firing >=4 fault classes mid-run
                (env-server SIGKILL x scale, transport sever x scale,
                state-table poison, learner stall),

then assert (each check is a function here, which chip_smoke.py calls
too):

  - the chaos run completes (reaches --total_steps, health != HALTED),
  - learning is intact: the final mean episode return matches the
    fault-free baseline within --return_tol,
  - recovery counters EXACTLY equal the injected fault counts (server
    restarts == SIGKILLs, actor reconnects == SIGKILLs x
    actors-per-server + severs, inference restarts == table rebuilds
    == poisons),
  - load shedding is real AND lossless: with the admission gate armed
    (--request_deadline_ms) and a learner stall planned, the serving
    tier sheds (serving.shed + serving.expired > 0) and every shed was
    re-submitted (serving.resubmitted == shed + expired),
  - nothing leaked: no live child process (env servers included) and no
    new /dev/shm segment of the run's own processes. Segments are named
    after the pid that created them (runtime/transport.segment_owner_pid),
    so segments of other processes on the machine, which come and go
    meanwhile, are not counted.

Both legs run the reference's model, `--model mlp --use_lstm`. The
harness runs on the card, and on the CPU only with --disable_cuda.
--scheduler_pressure N runs the chaos leg beside N spinner processes
(each killed by its process group when the leg ends); the verdict's ring
block records N with each leg's ring.doorbell_waits and
ring.recheck_wakeups.

Usage:
  python -m torchbeast_tpu_torch.chaos_run --selftest --disable_cuda
  python -m torchbeast_tpu_torch.chaos_run --selftest --native
  python -m torchbeast_tpu_torch.chaos_run --selftest --scheduler_pressure 2
  python -m torchbeast_tpu_torch.chaos_run --out chaos_run.json
"""

import argparse
import json
import multiprocessing as mp
import os
import signal
import subprocess
import sys
import time

SHM_DIR = "/dev/shm"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--selftest", action="store_true",
                   help="Short structural run on Mock (the CI gate).")
    p.add_argument("--native", action="store_true",
                   help="Run both legs with --native_runtime (the port's "
                        "C++ core): transport faults then ride the "
                        "core's FaultHooks instead of the Python "
                        "FaultingTransport wrap. Without it both legs "
                        "pin --no_native_runtime.")
    p.add_argument("--scale", type=int, default=1,
                   help="Multiplies num_actors/num_servers AND the fault "
                        "plan together (N SIGKILLs on distinct servers, "
                        "N severs on distinct actors disjoint from the "
                        "killed servers' actors). Requires num_servers "
                        ">= 2*scale.")
    p.add_argument("--request_deadline_ms", type=float, default=300.0,
                   help="Forwarded to both legs: arms the admission "
                        "gate so the planned learner_stall produces real "
                        "sheds (asserted > 0). 0 disarms it.")
    p.add_argument("--stall_s", type=float, default=3.0,
                   help="learner_stall duration; must exceed "
                        "request_deadline_ms.")
    p.add_argument("--replica_refresh_updates", type=int, default=0)
    p.add_argument("--max_policy_lag", type=int, default=20)
    p.add_argument("--admission_depth_factor", type=int, default=4)
    p.add_argument("--min_live_actors", type=int, default=1)
    p.add_argument("--inference_restart_budget", type=int, default=3)
    p.add_argument("--max_actor_reconnects", type=int, default=3)
    p.add_argument("--learner_stall_timeout_s", type=float, default=60.0)
    p.add_argument("--env", default="Catch")
    p.add_argument("--total_steps", type=int, default=60000)
    p.add_argument("--num_servers", type=int, default=4)
    p.add_argument("--num_actors", type=int, default=4,
                   help="Keep a multiple of num_servers: uniform "
                        "actors-per-server keeps reconnect accounting "
                        "exact.")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--unroll_length", type=int, default=20)
    p.add_argument("--learning_rate", type=float, default=2e-3)
    p.add_argument("--entropy_cost", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=7,
                   help="FaultPlan seed + --env_seed for both runs.")
    p.add_argument("--return_tol", type=float, default=0.2,
                   help="Allowed |chaos - baseline| final-return gap.")
    p.add_argument("--scheduler_pressure", type=int, default=0,
                   help="Run the CHAOS leg with N spinner subprocesses "
                        "competing for every core and record the "
                        "ring.doorbell_waits / ring.recheck_wakeups "
                        "contrast between the unpressured baseline leg "
                        "and the pressured chaos leg in the verdict's "
                        "\"ring\" block. 0 = off (both legs unpressured; "
                        "the ring block is still recorded).")
    p.add_argument("--savedir", default=None,
                   help="Default: a fresh temp dir.")
    p.add_argument("--out", default=None,
                   help="Also write the JSON verdict here.")
    p.add_argument("--disable_cuda", action="store_true",
                   help="Run polybeast on the CPU.")
    return p.parse_args(argv)


def build_plan(args) -> dict:
    """>=4 fault classes, step-triggered at fractions of the run so the
    pipeline is warm at injection time, SCALED with --scale.

    The plan-scaling rule: scale N plans N `env_server_sigkill` on
    servers 0..N-1 and N `transport_sever` on actors N..2N-1 — actor i
    connects to server i % num_servers, so with num_servers >= 2N the
    severed actors' servers are never killed and each fault maps to
    EXACTLY one recovery: reconnects == kills * (num_actors //
    num_servers) + severs. One state-table poison and one learner_stall
    (duration --stall_s) round out the classes; triggers stagger across
    [0.15, 0.65] of the run so recoveries do not overlap their own
    class's next injection."""
    t, n = args.total_steps, args.scale
    faults = []
    for i in range(n):
        faults.append({
            "kind": "env_server_sigkill",
            "at_step": int(t * (0.15 + 0.4 * i / n)),
            "target": i,
        })
        faults.append({
            "kind": "transport_sever",
            "at_step": int(t * (0.25 + 0.4 * i / n)),
            "target": n + i,
        })
    faults.append({"kind": "learner_stall", "at_step": int(t * 0.5),
                   "duration_s": args.stall_s})
    faults.append({"kind": "state_table_poison", "at_step": int(t * 0.7)})
    return {"seed": args.seed, "faults": faults}


def make_argv(args, savedir, xpid, chaos_plan_path=None):
    argv = [
        "--env", args.env,
        "--model", "mlp",
        "--use_lstm",  # the state table only exists for recurrent models
        "--num_servers", str(args.num_servers),
        "--num_actors", str(args.num_actors),
        "--batch_size", str(args.batch_size),
        "--unroll_length", str(args.unroll_length),
        "--total_steps", str(args.total_steps),
        "--learning_rate", str(args.learning_rate),
        "--entropy_cost", str(args.entropy_cost),
        "--env_seed", str(args.seed),
        "--savedir", savedir,
        "--xpid", xpid,
        # shm rings so the SIGKILL class also exercises the segment
        # sweep (the no-leak check below would catch a regression).
        "--pipes_basename", f"shm:{savedir}/pipes-{xpid}",
        "--num_inference_threads", "1",
        "--max_inference_batch_size", "4",
        "--checkpoint_interval_s", "100000",
        "--min_live_actors", str(args.min_live_actors),
        "--inference_restart_budget", str(args.inference_restart_budget),
        "--max_actor_reconnects", str(args.max_actor_reconnects),
        "--learner_stall_timeout_s", str(args.learner_stall_timeout_s),
        "--request_deadline_ms", str(args.request_deadline_ms),
        "--admission_depth_factor", str(args.admission_depth_factor),
        "--replica_refresh_updates", str(args.replica_refresh_updates),
        "--max_policy_lag", str(args.max_policy_lag),
    ]
    # The runtime is pinned either way: the interposition accounting
    # (FaultHooks vs FaultingTransport) must audit the runtime it chose.
    argv += ["--native_runtime"] if args.native else ["--no_native_runtime"]
    if args.disable_cuda:
        argv += ["--disable_cuda"]
    if chaos_plan_path is not None:
        argv += ["--chaos_plan", chaos_plan_path]
    return argv


def make_flags(args, savedir, xpid, chaos_plan_path=None):
    from torchbeast_tpu_torch import polybeast

    return polybeast.make_parser().parse_args(
        make_argv(args, savedir, xpid, chaos_plan_path))


def final_return(savedir, xpid):
    """Last non-empty mean_episode_return from the run's logs.csv."""
    import csv

    path = os.path.join(savedir, xpid, "logs.csv")
    last = None
    with open(path) as f:
        for row in csv.DictReader(f):
            val = row.get("mean_episode_return")
            if val:
                last = float(val)
    return last


def own_shm_entries(pids=None):
    """The ring segments in /dev/shm that the processes `pids` created
    (None: any process; the names carry their creator's pid)."""
    from torchbeast_tpu_torch.runtime.transport import segment_owner_pid

    if not os.path.isdir(SHM_DIR):
        return set()
    owners = {n: segment_owner_pid(n) for n in os.listdir(SHM_DIR)}
    return {n for n, pid in owners.items()
            if pid is not None and (pids is None or pid in pids)}


def live_children():
    """Pids of this process's live children: multiprocessing's and the
    env servers (polybeast_env.ServerProcess, plain subprocesses)."""
    from torchbeast_tpu_torch import polybeast_env

    pids = {p.pid for p in mp.active_children() if p.is_alive()}
    pids |= {p.pid for p in list(polybeast_env._LIVE) if p.is_alive()}
    return pids


def run_one(args, savedir, xpid, chaos_plan_path=None, argv=None):
    """One polybeast run with leak accounting and a counter delta.
    `argv` (the driver's whole command line) replaces make_argv's, for
    callers that drive another configuration through the same checks
    (chip_smoke.py)."""
    from torchbeast_tpu_torch import polybeast, polybeast_env, telemetry

    spawned_before = len(polybeast_env.SPAWNED_PIDS)
    procs_before = live_children()
    # A server's pid may be a dead process's whose segment is still
    # there: count only segments that were not.
    shm_before = own_shm_entries()
    snap_before = telemetry.snapshot()
    t0 = time.monotonic()
    flags = (make_flags(args, savedir, xpid, chaos_plan_path) if argv is None
             else polybeast.make_parser().parse_args(argv))
    stats = polybeast.train(flags)
    elapsed = time.monotonic() - t0
    counters = telemetry.delta(telemetry.snapshot(), snap_before).get(
        "counters", {})
    # This run's processes: the driver (this one) and every env server
    # it started, respawns included.
    pids = {os.getpid(), *polybeast_env.SPAWNED_PIDS[spawned_before:]}
    return {
        "xpid": xpid,
        "elapsed_s": round(elapsed, 1),
        "step": stats.get("step", 0),
        "health": stats.get("health"),
        "mean_episode_return": final_return(savedir, xpid),
        "server_restarts": stats.get("server_restarts", 0),
        "actor_reconnects": stats.get("actor_reconnects", 0),
        "inference_restarts": stats.get("inference_restarts", 0),
        "health_reasons": stats.get("health_reasons"),
        "chaos": stats.get("chaos"),
        "counters": counters,
        "leaked_processes": sorted(live_children() - procs_before),
        "leaked_shm": sorted(own_shm_entries(pids) - shm_before),
        "stats": {k: v for k, v in stats.items()
                  if isinstance(v, (int, float, str))},
    }


# -- the checks ------------------------------------------------------------


def check_completion(run, total_steps):
    failures = []
    if run["step"] < total_steps:
        failures.append(
            f"{run['xpid']} stopped at step {run['step']} < {total_steps} "
            f"(health {run['health']})")
    if run["health"] == "HALTED":
        failures.append(f"{run['xpid']} ended HALTED")
    return failures


def check_return_parity(baseline, chaos, tol):
    base_ret, chaos_ret = (baseline["mean_episode_return"],
                           chaos["mean_episode_return"])
    if base_ret is None or chaos_ret is None:
        return [f"missing episode returns (baseline {base_ret}, "
                f"chaos {chaos_ret})"]
    if abs(base_ret - chaos_ret) > tol:
        return [f"return drift: baseline {base_ret} vs chaos {chaos_ret} "
                f"(tol {tol})"]
    return []


def expected_counters(plan_counts, actors_per_server):
    """Each injected fault maps to its recovery counter exactly: 1
    respawn per SIGKILL, actors-per-server reconnects per SIGKILL + 1
    per sever, 1 rebuild + restart per poison; and every
    chaos.<kind>.injected counter matches the plan."""
    n_kill = plan_counts.get("env_server_sigkill", 0)
    n_sever = plan_counts.get("transport_sever", 0)
    n_poison = plan_counts.get("state_table_poison", 0)
    return {
        **{f"chaos.{kind}.injected": n for kind, n in plan_counts.items()},
        "recovery.server_restarts": n_kill,
        "recovery.actor_reconnects": n_kill * actors_per_server + n_sever,
        "recovery.inference_restarts": n_poison,
        "recovery.table_rebuilds": n_poison,
    }


def check_recovery(run, plan_counts, expected):
    failures = []
    injected = (run.get("chaos") or {}).get("injected", {})
    if injected != plan_counts:
        failures.append(f"injected {injected} != planned {plan_counts} "
                        "(a fault never fired)")
    for name, want in expected.items():
        got = int(run["counters"].get(name, 0))
        if got != want:
            failures.append(f"counter {name}: got {got}, want {want}")
    return failures


def check_shedding(run, plan_counts, request_deadline_ms):
    """(serving counts, failures): every shed re-submitted, and sheds
    happened when a stall hit an armed gate."""
    counters = run["counters"]
    serving = {key: int(counters.get(f"serving.{key}", 0))
               for key in ("admitted", "shed", "expired", "resubmitted")}
    shed_total = serving["shed"] + serving["expired"]
    failures = []
    if serving["resubmitted"] != shed_total:
        failures.append(
            f"shed accounting broken: resubmitted {serving['resubmitted']}"
            f" != shed {serving['shed']} + expired {serving['expired']} "
            "(a shed was a lost request)")
    if (request_deadline_ms > 0 and plan_counts.get("learner_stall", 0)
            and shed_total == 0):
        failures.append(
            "learner stall injected with the admission gate armed but "
            "nothing was shed (the overload path was not exercised)")
    return serving, failures


def check_leaks(run):
    failures = []
    if run["leaked_processes"]:
        failures.append(
            f"{run['xpid']}: leaked processes {run['leaked_processes']}")
    if run["leaked_shm"]:
        failures.append(
            f"{run['xpid']}: leaked /dev/shm segments {run['leaked_shm']}")
    return failures


class SchedulerPressure:
    """Spinner subprocesses competing for every core while the chaos leg
    runs (the reference's _SchedulerPressure): each in a session of its
    own, killed by its process group on exit. n=0 spawns nothing.
    `pids` lists the spinners while they run."""

    def __init__(self, n: int):
        self._n = max(0, int(n))
        self._procs = []

    @property
    def pids(self):
        return [p.pid for p in self._procs]

    def __enter__(self):
        for _ in range(self._n):
            self._procs.append(subprocess.Popen(
                [sys.executable, "-c", "while True: pass"],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                start_new_session=True,
            ))
        return self

    def __exit__(self, *exc):
        for proc in self._procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.wait()
        self._procs = []
        return False


def ring_block(baseline, chaos, scheduler_pressure=0):
    """Each leg's ring-wait counters, the chaos leg run beside
    `scheduler_pressure` spinners."""

    def leg(run):
        return {
            "doorbell_waits": int(
                run["counters"].get("ring.doorbell_waits", 0)),
            "recheck_wakeups": int(
                run["counters"].get("ring.recheck_wakeups", 0)),
        }

    return {"scheduler_pressure": scheduler_pressure,
            "baseline": leg(baseline), "chaos": leg(chaos)}


def validate_args(args):
    """An error message for an unusable configuration, or None."""
    if args.scale < 1:
        return "--scale must be >= 1"
    if args.scheduler_pressure < 0:
        return "--scheduler_pressure must be >= 0"
    if args.num_actors % args.num_servers != 0:
        return (f"num_actors {args.num_actors} must be a multiple of "
                f"num_servers {args.num_servers} (uniform actors-per-server "
                "is what keeps reconnect accounting exact)")
    if args.num_servers < 2 * args.scale:
        return (f"num_servers {args.num_servers} must be >= 2*scale "
                f"{2 * args.scale} (kill and sever target sets must stay "
                "disjoint for exact accounting)")
    if (args.request_deadline_ms > 0
            and args.stall_s * 1000 <= args.request_deadline_ms):
        return ("--stall_s must exceed --request_deadline_ms or the stall "
                "cannot produce deterministic expiry sheds")
    return None


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.selftest:
        # Short structural gate: Mock's return is deterministic (200.0
        # per episode regardless of policy), so return parity is exact.
        args.env = "Mock"
        args.total_steps = 2400
        args.num_servers = args.num_actors = 2
        args.batch_size = 2
        args.return_tol = 1e-6
        # Short stall, same contract: it still exceeds the deadline so
        # expiry sheds fire deterministically.
        args.stall_s = min(args.stall_s, 1.5)
    if args.scale >= 1:
        args.num_servers *= args.scale
        args.num_actors *= args.scale
    error = validate_args(args)
    if error is not None:
        print(error, file=sys.stderr)
        return 2

    from torchbeast_tpu_torch import polybeast, telemetry
    from torchbeast_tpu_torch.resilience.chaos import FaultPlan
    from torchbeast_tpu_torch.runtime import native

    if args.native:
        # gap_reason, not available(): a stale core would make the
        # driver fall back and this harness audit the wrong runtime.
        reason = native.gap_reason()
        if reason is not None:
            print(f"chaos_run --native: {reason}", file=sys.stderr)
            return 2
    # The harness calls train() directly, so it owns logging config.
    polybeast._configure_logging()

    savedir = args.savedir
    if savedir is None:
        import tempfile

        savedir = tempfile.mkdtemp(prefix="chaos_run_")
    plan_dict = build_plan(args)
    plan = FaultPlan.from_dict(plan_dict)  # validates kinds/triggers
    plan_path = os.path.join(savedir, "fault_plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan_dict, f, indent=2)

    baseline = run_one(args, savedir, "chaos-baseline")
    # Only the chaos leg runs under scheduler pressure: the unpressured
    # baseline leg is the contrast the ring block records.
    with SchedulerPressure(args.scheduler_pressure):
        chaos = run_one(args, savedir, "chaos-faulted", plan_path)
    for run in (baseline, chaos):
        run.pop("stats")  # the driver's own figures: not in the verdict

    plan_counts = plan.counts()
    expected = expected_counters(plan_counts,
                                 args.num_actors // args.num_servers)
    serving, shed_failures = check_shedding(chaos, plan_counts,
                                            args.request_deadline_ms)
    failures = (
        check_completion(chaos, args.total_steps)
        + check_return_parity(baseline, chaos, args.return_tol)
        + check_recovery(chaos, plan_counts, expected)
        + shed_failures
        + check_leaks(baseline) + check_leaks(chaos)
    )
    verdict = {
        "bench": "chaos_run",
        "selftest": bool(args.selftest),
        "native": bool(args.native),
        "scale": args.scale,
        "num_actors": args.num_actors,
        "num_servers": args.num_servers,
        "request_deadline_ms": args.request_deadline_ms,
        "ok": not failures,
        "failures": failures,
        "env": args.env,
        "total_steps": args.total_steps,
        "plan": plan_dict,
        "expected_counters": expected,
        "serving": serving,
        "ring": ring_block(baseline, chaos, args.scheduler_pressure),
        "results": {"baseline": baseline, "chaos": chaos},
        "telemetry": telemetry.telemetry_block(),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2)
            f.write("\n")
    print(json.dumps(verdict))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
