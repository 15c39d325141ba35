"""Where the time of the port's learner update and acting step goes on the
GPU, at one of the port's model configurations, each with 84x84x4
frames, 6 actions (MockEnv), T=80, B=32, --vtrace_impl pallas --opt_impl
pallas: deep ResNet + LSTM with TBT_POOL_PALLAS=1 (the default), the
transformer policy at full width with --attention_impl pallas, or a
pipelined family at its defaults, its tower run sequentially
(pipelined_transformer: 4 layers, d_model 128, 4 heads, memory 64;
pipelined_mlp + LSTM: 4 stages of d_model 128); at the
precision policy --precision (default f32; bf16_train casts the params,
the batch and the agent state as the driver does). `polybeast` traces
the async driver instead (see polybeast_trace), on the Python pool or,
with --native_runtime, on the port's C++ runtime core, with
--num_inference_threads inference threads (default 2). `anakin` profiles
the Anakin iteration graph instead (see anakin_profile). `moe --dp N
--ep K [--tp M]` times the MoE transformer's update over a data N x
model M x expert K mesh of cuda:0 repeated, `tp --dp N --tp M` the
transformer's over data N x model M (see parallel_profile).

    python -m torchbeast_tpu_torch.profile_update
        [deep|transformer|pipelined_transformer|pipelined_mlp|polybeast
         |anakin|moe|tp]
        [--precision f32|bf16_compute|bf16_train] [--superstep_k K]
        [--remat none|all|<spec>]
        [--native_runtime] [--num_inference_threads N] [--dp N] [--ep K]
        [--tp M]

--remat sets the model's remat levers as the drivers' flag does
(runtime/remat_plan.py: none, the default, keeps every activation; all;
or a per-stage spec such as stage0=front,stage1=front,stage2=front,
core=none); the JSON line then also carries the plan and the allocator's
peak over one eager update (precision.memory_stats), so one call can
time and trace each plan.

The update and the acting step run as the drivers run them on the card:
one captured CUDA graph per learner dispatch of K updates
(learner.make_update_dispatch) and per acting step
(learner.make_act_step). Prints the card (nvidia-smi name and power
limit), then one JSON line: the median update time (CUDA events around
each dispatch, over its K updates), the median acting step time (host
clock around one T=1, B=32 forward and the copy of its actions to the
host; the transformer families act from a cache about 70% valid), the
eager
step's update and acting times in the same process for comparison, and
from a torch.profiler window over UPDATES dispatches the host's CUDA API
calls per dispatch by name (a graph replay is one), the device time per
update by kernel name (top entries, and every one of the port's own
kernels with its time per call) and by group (the port's own kernels,
convolutions, matrix products, the rest), with the medians of
update_windows over the profiled updates. The device's busy share is
that device time over the unprofiled median update time (the profiler
itself slows the host's launches down). Weights and batch are random,
made from SEED. Needs a CUDA device.

T, B, NUM_ACTIONS, random_batch, random_cache and polybeast_argv are the
configurations' shape, batch, transformer state and polybeast flags,
shared with chip_smoke.py.
"""

import argparse
import bisect
import faulthandler
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from torchbeast_tpu_torch import graphs
from torchbeast_tpu_torch import learner as learner_lib
from torchbeast_tpu_torch import nest, precision
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.runtime import remat_plan

T, B = 80, 32
NUM_ACTIONS = 6  # MockEnv
UPDATES, WARMUP, SEED, TOP = 10, 3, 0, 15
TRACE_UPDATES = 8  # polybeast_trace's run; three of them traced
# A polybeast_trace run that has not finished by then dumps every
# thread's stack and ends the process (a healthy one takes 40-120 s on
# the card, the kernels' build included).
STALL_S = 300
# update_windows: the kernel that ends an update, and the name mark of a
# kernel that only the backward pass launches.
TAIL, BACKWARD, TOP_GAPS = "rmsprop_tail", "_bwd", 5

# Substrings of device kernel names -> group, tried in order. The port's
# kernels are csrc/'s vtrace_targets_kernel, rmsprop_*, pool_bwd_kernel
# and attention_* (the port runs no library attention kernel). cuDNN's
# convolutions carry a direction (fprop/dgrad/wgrad) or "conv" in their
# names, or run inside cudnn:: (its layout conversions too); cuBLAS's
# Hopper products are sm90_xmma_gemm_*, so a bare "xmma" key would file
# them under convolutions, and its bf16 ones nvjet_*.
GROUPS = (
    ("port kernels", ("vtrace_targets_kernel", "rmsprop_",
                      "pool_bwd_kernel", "attention_", "lstm_step_")),
    ("convolution", ("conv", "cudnn", "implicit", "wgrad", "dgrad",
                     "fprop", "nchw", "nhwc")),
    ("matrix product", ("gemm", "gemv", "cutlass", "nvjet")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def random_batch(seed, device):
    """A random [T+1, B] learner batch of the slice's fields, from numpy's
    generator seeded with `seed`, as tensors on `device`."""
    A = NUM_ACTIONS
    rng = np.random.default_rng(seed)
    arrays = {
        "frame": rng.integers(0, 256, (T + 1, B, 84, 84, 4), np.uint8),
        "reward": rng.standard_normal((T + 1, B)).astype(np.float32),
        "done": rng.random((T + 1, B)) < 0.05,
        "episode_return": rng.standard_normal((T + 1, B)).astype(
            np.float32),
        "episode_step": rng.integers(0, 200, (T + 1, B)).astype(np.int32),
        "last_action": rng.integers(0, A, (T + 1, B)),
        "action": rng.integers(0, A, (T + 1, B)),
        "policy_logits": rng.standard_normal((T + 1, B, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((T + 1, B)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def random_cache(model, seed, device):
    """A transformer state of random keys and values with about 70% of
    the cache valid, from numpy's generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    state = []
    for k, _, valid in model.initial_state(B):
        state.append(tuple(
            torch.from_numpy(a).to(device) for a in (
                rng.standard_normal(k.shape).astype(np.float32),
                rng.standard_normal(k.shape).astype(np.float32),
                (rng.random(valid.shape) < 0.7).astype(np.float32))))
    return tuple(state)


# The update's model configurations: create_model's kwargs at full width.
MODEL_CONFIGS = {
    "deep": {"use_lstm": True},
    "transformer": {"attention_impl": "pallas"},
    "pipelined_transformer": {},
    "pipelined_mlp": {"use_lstm": True},
}


def remat_levers(model_name, use_lstm, spec=None):
    """(the plan's assignment, the model's remat kwargs) of a --remat value
    other than auto: None or "none" keeps every activation."""
    stages = remat_plan.stages_for(model_name, use_lstm)
    if spec in (None, "none"):
        assignment = remat_plan.no_remat(stages)
    elif spec == "all":
        assignment = remat_plan.all_remat(stages)
    else:
        assignment = remat_plan.parse_spec(spec, stages)
    return assignment, remat_plan.model_kwargs(model_name, assignment)


def polybeast_argv(savedir, xpid):
    """The polybeast deep + LSTM path's flags: 16 Mock env servers on
    free 127.0.0.1 ports, T=80, B=32, the three deep kernels, two
    inference threads. Without --total_steps."""
    from torchbeast_tpu_torch import polybeast_env

    return ["--env", "Mock", "--model", "deep", "--use_lstm",
            "--num_servers", "16", "--batch_size", str(B),
            "--unroll_length", str(T), "--vtrace_impl", "pallas",
            "--opt_impl", "pallas", "--no_native_runtime",
            "--num_inference_threads", "2",
            "--max_inference_batch_size", "32", "--savedir", savedir,
            "--xpid", xpid,
            "--pipes_basename", polybeast_env.free_tcp_basename(16)]


def _card():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    return card


def _union_ms(spans, lo, hi):
    """Milliseconds of [lo, hi] covered by the (start, end) spans, in
    microseconds."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in spans
                     if b > lo and a < hi)
    total, reach = 0.0, lo
    for a, b in clipped:
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total / 1e3


def update_windows(events):
    """One learner update interval of a trace per window: from the end of
    one update's last kernel (TAIL, the RMSprop tail) on the card to the
    end of the next. `events` are a chrome trace's traceEvents:
    device kernels, copies and sets carry the correlation id of the CUDA
    API call that launched them, and that call's event carries the
    launching thread (tid). Threads have roles: "learner" launched the
    tail, "backward" launched a kernel named with BACKWARD (autograd
    runs the backward pass on a thread of its own), "other" are the rest
    (polybeast's acting forwards and staging copies).

    Per window: its length; the card's busy time (union of every kernel,
    copy and set); per role the kernels launched, their device time,
    the copies and the threads; and the learner thread's API calls
    between the two tails' launches: their number, time inside the API,
    the median and the sum of the gaps between one call and the next,
    the TOP_GAPS longest gaps (with the kernels or calls before and
    after each) and the TOP_GAPS longest calls."""
    api, launched = {}, {}
    for ev in events:
        corr = (ev.get("args") or {}).get("correlation")
        if corr is None:
            continue
        if ev.get("cat") in ("cuda_runtime", "cuda_driver"):
            api[corr] = ev
        elif ev.get("cat") == "kernel":
            launched[corr] = ev.get("name", "")
    device = [ev for ev in events
              if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    tails = sorted((ev for ev in device if ev.get("cat") == "kernel"
                    and TAIL in ev.get("name", "")),
                   key=lambda ev: ev["ts"])
    if len(tails) < 2:
        raise ValueError(f"{len(tails)} {TAIL} kernels among the "
                         f"trace's {len(device)} device events and "
                         f"{len(api)} API calls: no whole update")

    def launch(ev):
        return api.get((ev.get("args") or {}).get("correlation"))

    tail_api = [launch(ev) for ev in tails]
    tids = {ev["tid"] for ev in tail_api if ev is not None}
    if len(tids) != 1:
        raise ValueError(f"the tail was launched from threads {tids}")
    learner = tids.pop()
    backward = {launch(ev)["tid"] for ev in device
                if BACKWARD in ev.get("name", "")
                and launch(ev) is not None} - {learner}

    def role(ev):
        call = launch(ev)
        if call is None:
            return "unattributed"
        return ("learner" if call["tid"] == learner else
                "backward" if call["tid"] in backward else "other")

    learner_api = sorted((ev for ev in api.values()
                          if ev["tid"] == learner), key=lambda ev: ev["ts"])
    starts = [ev["ts"] for ev in learner_api]
    windows = []
    for (a, b), (ca, cb) in zip(zip(tails, tails[1:]),
                                zip(tail_api, tail_api[1:])):
        lo, hi = a["ts"] + a["dur"], b["ts"] + b["dur"]
        inside = [ev for ev in device if ev["ts"] < hi
                  and ev["ts"] + ev["dur"] > lo]
        window = {
            "ms": (hi - lo) / 1e3,
            "device_busy_ms": _union_ms(
                [(ev["ts"], ev["ts"] + ev["dur"]) for ev in inside], lo, hi),
        }
        for who in ("learner", "backward", "other", "unattributed"):
            mine = [ev for ev in inside if role(ev) == who]
            kernels = [ev for ev in mine if ev.get("cat") == "kernel"]
            window[f"{who}_kernels"] = len(kernels)
            window[f"{who}_kernel_ms"] = sum(ev["dur"] for ev in kernels) / 1e3
            window[f"{who}_copies"] = len(mine) - len(kernels)
            window[f"{who}_threads"] = len({launch(ev)["tid"] for ev in mine
                                            if launch(ev) is not None})
        calls = learner_api[bisect.bisect_right(starts, ca["ts"]):
                            bisect.bisect_right(starts, cb["ts"])]
        gaps = [((y["ts"] - (x["ts"] + x["dur"])) / 1e3, x, y)
                for x, y in zip(calls, calls[1:])]

        def what(call):
            corr = call["args"]["correlation"]
            return launched.get(corr, call.get("name", ""))[:80]

        window.update({
            "learner_api_calls": len(calls),
            "learner_api_ms": sum(ev["dur"] for ev in calls) / 1e3,
            "learner_api_gap_ms_median": (
                statistics.median(g[0] for g in gaps) if gaps else None),
            "learner_api_gap_ms_sum": sum(g[0] for g in gaps),
            "learner_longest_gaps": [
                [g, what(x), what(y)] for g, x, y in sorted(
                    gaps, key=lambda g: -g[0])[:TOP_GAPS]],
            "learner_longest_calls": [
                [ev["dur"] / 1e3, what(ev)] for ev in sorted(
                    calls, key=lambda ev: -ev["dur"])[:TOP_GAPS]],
        })
        windows.append(window)
    return windows


def median_window(windows):
    """The median of each numeric entry of update_windows' windows."""
    return {k: statistics.median(w[k] for w in windows) for k in windows[0]
            if all(isinstance(w[k], (int, float)) for w in windows)}


def _windows_of(prof):
    """(update_windows, traceEvents) of a finished torch.profiler run."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return update_windows(events), events


def _logged_updates(path):
    """Rows in a FileWriter's logs.csv (one per flushed update)."""
    try:
        with open(path) as f:
            return max(sum(1 for _ in f) - 1, 0)
    except FileNotFoundError:
        return 0


def api_calls(events, tid=None):
    """{CUDA runtime/driver API call name: count} in a chrome trace's
    events, of thread `tid` (None: every thread)."""
    out = {}
    for ev in events:
        if ev.get("cat") in ("cuda_runtime", "cuda_driver") and (
                tid is None or ev.get("tid") == tid):
            out[ev.get("name", "")] = out.get(ev.get("name", ""), 0) + 1
    return out


def polybeast_trace(policy="f32", superstep_k=1, native_runtime=False,
                    num_inference_threads=2, remat=None):
    """The async driver at polybeast_argv's flags for TRACE_UPDATES
    updates, with a torch.profiler window (CUDA activity: device work and
    CUDA API calls, no CPU ops) over three flushed updates from the
    second: every kernel of the process is traced, whichever thread
    launched it. Prints the card and one JSON line: the run's own stats
    (with the medians of the learner's wait for its next batch and of
    one acting forward's host time), and update_windows of the trace
    (the profiler slows every launch down, so the traced updates are
    slower than the run's others). A run past STALL_S dumps every
    thread's stack to stderr and exits."""
    from torch.profiler import ProfilerActivity, profile
    from torchbeast_tpu_torch import polybeast, telemetry

    card = _card()
    os.environ["TBT_POOL_PALLAS"] = "1"
    savedir = tempfile.mkdtemp(prefix="polybeast_trace")
    logs = os.path.join(savedir, "trace", "logs.csv")
    argv = polybeast_argv(savedir, "trace")
    argv[argv.index("--num_inference_threads") + 1] = str(
        num_inference_threads)
    if native_runtime:
        argv[argv.index("--no_native_runtime")] = "--native_runtime"
    if remat is not None:
        argv += ["--remat", remat]
    flags = polybeast.make_parser().parse_args(
        argv + [
            "--precision", policy, "--superstep_k", str(superstep_k),
            "--total_steps", str(TRACE_UPDATES * superstep_k * T * B)])
    # The profiler runs on this (the main) thread, where torch registered
    # its tracing client; the driver runs on another.
    result = {}

    def run():
        try:
            result["stats"] = polybeast.train(flags)
        except BaseException as e:  # noqa: BLE001  re-raised below
            result["error"] = e

    faulthandler.dump_traceback_later(STALL_S, exit=True)
    with profile(activities=[ProfilerActivity.CUDA]):
        pass  # the tracer's set-up, before the window
    driver = threading.Thread(target=run, name="driver")
    driver.start()
    try:
        while _logged_updates(logs) < 2 and driver.is_alive():
            time.sleep(0.05)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            end = _logged_updates(logs) + 3
            while _logged_updates(logs) < end and driver.is_alive():
                time.sleep(0.05)
        windows, _ = _windows_of(prof)
        driver.join()
        if "error" in result:
            raise result["error"]
        stats = result["stats"]
        reg = telemetry.get_registry()

        def p50_ms(name):
            return 1000 * reg.histogram(name).percentile(0.5)

        print(json.dumps({
            "card": card,
            "config": {"driver": "polybeast", **{
                k: getattr(flags, k) for k in (
                    "env", "model", "use_lstm", "num_servers", "batch_size",
                    "unroll_length", "vtrace_impl", "opt_impl",
                    "num_inference_threads", "max_inference_batch_size",
                    "precision", "native_runtime")}},
            "actor_pool": stats["actor_pool"],
            "updates": stats["updates"],
            "sps": stats["sps"],
            "update_interval_ms_median": stats["update_interval_ms_median"],
            "learner_wait_ms_p50": p50_ms("learner.dequeue"),
            "inference_batch_mean": stats["inference_batch_mean"],
            "act_dispatch_ms_p50": p50_ms("inference.dispatch_s"),
            "reply_ms_p50": p50_ms("inference.reply_s"),
            "request_rtt_ms_p50": p50_ms("actor.request_rtt_s"),
            "traced_windows": windows,
        }))
    finally:
        driver.join()
        faulthandler.cancel_dump_traceback_later()
        shutil.rmtree(savedir, ignore_errors=True)


# anakin_profile's configurations: the reference's anakin defaults (Catch,
# B=64, T=16) on the mlp and on deep + LSTM.
ANAKIN_CONFIGS = (("mlp", ["--model", "mlp"]),
                  ("deep+LSTM", ["--model", "deep", "--use_lstm"]))


def _device_ms(fn, calls):
    """(device ms per call of fn() by torch.profiler over `calls` calls,
    {kernel name: (ms per call, launches per call)}, {CUDA API call:
    count per call})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    api = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0.0, 0])
            k[0] += evt.device_time / 1e3 / calls
            k[1] += 1 / calls
        elif evt.name.startswith("cuda") and "ynchronize" not in evt.name:
            api[evt.name] = api.get(evt.name, 0) + 1 / calls
    return sum(v[0] for v in kernels.values()), kernels, api


def anakin_profile():
    """The Anakin iteration graph (anakin.make_iteration_dispatch: one
    CUDA graph a replay) of each ANAKIN_CONFIGS entry, TBT_POOL_PALLAS=1:
    one JSON line each with the median replay time (CUDA events over
    UPDATES replays after WARMUP), the device time a replay and the
    device's busy share (profiled device time over the median replay
    time), the host's CUDA API calls and the port's kernels a replay, and
    where the device time goes: the same pieces captured apart, each its
    own graph from the iteration's shapes and state (T acting forwards
    on a fixed env output; T env steps on fixed actions; the update on a
    batch the collect recorded), each profiled for its device time a
    replay."""
    from torchbeast_tpu_torch import anakin

    os.environ["TBT_POOL_PALLAS"] = "1"
    device = torch.device("cuda", 0)
    card = _card()
    for label, model_args in ANAKIN_CONFIGS:
        flags = anakin.make_parser().parse_args(["--env", "Catch",
                                                 *model_args])
        env, model, opt, hp, gen, carry = anakin.setup(flags, device)
        n_t = flags.unroll_length
        # The pieces' inputs, recorded before the iteration moves on.
        batch, _ = anakin.make_collect(env, model, n_t, gen)(carry)
        batch = {k: v.clone() for k, v in batch.items()}
        state = nest.map(torch.clone, carry.agent_state)
        dispatch = anakin.make_iteration_dispatch(env, model, opt, hp, gen,
                                                  carry)
        for _ in range(WARMUP):
            dispatch()
        replay_ms = []
        for _ in range(UPDATES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dispatch()
            end.record()
            torch.cuda.synchronize()
            replay_ms.append(start.elapsed_time(end))
        device_ms, kernels, api = _device_ms(dispatch, UPDATES)

        def act(inputs):
            out, st = None, inputs["state"]
            for _ in range(n_t):
                out, st = anakin._policy_step(model, inputs["env"], st,
                                              gen)
            return out["policy_logits"]

        def step_envs(inputs):
            st, out = inputs["state"], None
            for _ in range(n_t):
                st, out = env.step(st, inputs["action"], gen)
            return out["frame"]

        act_graph = graphs.CapturedForward(
            act, {"env": {k: v for k, v in carry.env_out.items()},
                  "state": state}, device, gen)
        env_graph = graphs.CapturedForward(
            step_envs, {"state": carry.env_state,
                        "action": carry.agent_out["action"]}, device, gen)
        update = learner_lib.make_update_dispatch(model, opt, hp)
        update.capture(batch, state)
        split = {}
        for name, graph, args in (
                ("acting forwards", act_graph, (act_graph.inputs,)),
                ("env steps", env_graph, (env_graph.inputs,)),
                ("update", update, (batch, state))):
            split[name] = _device_ms(lambda g=graph, a=args: g(*a),
                                     UPDATES)[0]
        parts = sum(split.values())
        print(json.dumps({
            "card": card,
            "config": {"anakin": label, "env": "Catch",
                       "batch_size": flags.batch_size, "T": n_t,
                       "pool_kernel": "deep" in model_args,
                       "dispatch": "CUDA graph per iteration"},
            "iteration_ms_median": statistics.median(replay_ms),
            "iteration_ms_all": replay_ms,
            "frames_per_s": n_t * flags.batch_size * 1e3
            / statistics.median(replay_ms),
            "device_ms_per_iteration": device_ms,
            "device_busy_share": device_ms / statistics.median(replay_ms),
            "host_api_calls_per_replay": sum(api.values()),
            "host_api_calls_by_name_per_replay": api,
            "kernels_per_iteration": sum(v[1] for v in kernels.values()),
            "port_kernels_per_replay": dispatch.launches_per_replay,
            "port_kernels_profiled": {
                name[:80]: {"ms_per_iteration": ms, "calls": c}
                for name, (ms, c) in sorted(kernels.items())
                if _group(name) == "port kernels"},
            # The pieces captured apart: device ms a replay of each.
            "device_ms_split": split,
            "device_share_split": {k: v / parts for k, v in split.items()},
        }))


MOE_EXPERTS = 8


def _slot_bytes(learner):
    """The sharded learner's bytes by place (models/sharded.slot_bytes):
    each row's params and row 0's optimizer state, {place: bytes}, a
    place "row<i>" for the whole leaves or "row<i> <axis> <j>" for slot j."""
    from torchbeast_tpu_torch.models import sharded

    def named(counts, row):
        return {f"row{row}" + ("" if pos is None else f" {pos[0]} {pos[1]}"):
                n for pos, n in counts.items()}

    st = learner.optimizer.state
    state = {}
    for tensors in (st.nu, st.mom, st.master):
        if tensors is not None:
            for k, n in named(sharded.slot_bytes(learner.replicas[0],
                                                 tensors), 0).items():
                state[k] = state.get(k, 0) + n
    return {"params": [named(sharded.slot_bytes(r), i)
                       for i, r in enumerate(learner.replicas)],
            "optimizer_state": state}


def parallel_profile(dp=2, ep=1, tp=1, policy="f32",
                     num_experts=MOE_EXPERTS):
    """The transformer (MODEL_CONFIGS["transformer"]; with num_experts >
    0 the MoE transformer, top-2, d_ff 512) at T=80, B=32, --vtrace_impl
    pallas --opt_impl xla (the sharded learner refuses the fused tail),
    its update over a (data dp x model tp x expert ep) mesh whose devices
    are all cuda:0 (parallel.create_mesh's explicit list: one card runs
    every shard; a MoE model at dp > 1 runs the shards in lockstep,
    eagerly, exchanging their routing counts in each MoE layer), beside
    the one-device update (one CUDA graph) in the same process. One JSON
    line: the card, both updates' median ms (CUDA events over UPDATES
    dispatches after WARMUP), the host's CUDA API calls and the device
    operations (kernels and copies) per dispatch of each (torch.
    profiler), the device time per update, the port's kernel launches
    per update a data shard (ops.launch_counts), the allocator's bytes
    once the sharded learner is built (before any capture) and the bytes
    by row and slot."""
    from torchbeast_tpu_torch import ops, parallel

    device = torch.device("cuda", 0)
    card = _card()
    pol = precision.get(policy)
    hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                             vtrace_impl="pallas", opt_impl="xla",
                             param_dtype=pol.param_dtype,
                             opt_state_dtype=pol.opt_state_dtype)
    experts = {"num_experts": num_experts} if num_experts else {}

    def build():
        torch.manual_seed(SEED)
        model = create_model("transformer", NUM_ACTIONS,
                             **MODEL_CONFIGS["transformer"], **experts,
                             dtype=pol.compute_dtype,
                             head_dtype=pol.head_dtype)
        model = precision.cast_params(model.to(device), pol)
        return model, learner_lib.make_optimizer(
            hp, list(model.parameters()))

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    model, optimizer = build()
    mesh = parallel.create_mesh(devices=[device] * (dp * ep * tp),
                                expert_parallelism=ep, model_parallelism=tp)
    sharded = parallel.make_parallel_update_step(model, optimizer, hp,
                                                 mesh)
    torch.cuda.synchronize()
    learner_bytes = torch.cuda.memory_allocated(device) - base
    slots = _slot_bytes(sharded.learner)
    one = learner_lib.make_update_dispatch(*build(), hp)
    batch = precision.cast_batch(random_batch(SEED, device), pol.batch_dtype)
    state = precision.cast_batch(random_cache(model, SEED, device),
                                 pol.batch_dtype)

    def median_ms(fn):
        for _ in range(WARMUP):
            fn(batch, state)
        torch.cuda.synchronize()
        out = []
        for _ in range(UPDATES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(batch, state)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)

    ms = {"sharded": median_ms(sharded), "one_device": median_ms(one)}
    ops.reset_launch_counts()
    for _ in range(UPDATES):
        sharded(batch, state)
    torch.cuda.synchronize()
    launches = {k: v / (UPDATES * dp)
                for k, v in ops.launch_counts().items() if v}
    profiled = {}
    for name, fn in (("sharded", sharded), ("one_device", one)):
        device_ms, kernels, api = _device_ms(
            lambda fn=fn: fn(batch, state), 3)
        profiled[name] = (device_ms, sum(api.values()),
                          sum(v[1] for v in kernels.values()))
    print(json.dumps({
        "card": card,
        "config": {"model": "transformer", **MODEL_CONFIGS["transformer"],
                   **experts, "T": T, "B": B,
                   "precision": policy, "vtrace_impl": "pallas",
                   "opt_impl": "xla", "mesh": mesh.shape,
                   "devices": f"{dp * ep * tp} x {device}",
                   "dispatch": ("CUDA graphs" if sharded.captures_graphs
                                else "eager")},
        "update_ms_median": ms["sharded"],
        "one_device_update_ms_median": ms["one_device"],
        "host_api_calls_per_dispatch": profiled["sharded"][1],
        "one_device_host_api_calls_per_dispatch": profiled["one_device"][1],
        "device_ops_per_dispatch": profiled["sharded"][2],
        "one_device_device_ops_per_dispatch": profiled["one_device"][2],
        "device_ms_per_update": profiled["sharded"][0],
        "one_device_device_ms_per_update": profiled["one_device"][0],
        "launches_per_update_per_data_shard": launches,
        "learner_allocated_bytes": learner_bytes,
        "bytes_by_slot": slots,
    }))


def main(model_name="deep", policy="f32", superstep_k=1,
         native_runtime=False, num_inference_threads=2, remat=None,
         dp=1, ep=1, tp=1):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_update needs a CUDA device")
    if model_name in ("moe", "tp"):
        if (superstep_k, remat, native_runtime) != (1, None, False):
            raise ValueError(f"{model_name} takes --dp, --ep, --tp and "
                             "--precision only")
        if model_name == "tp" and ep != 1:
            raise ValueError("tp is the dense transformer: no --ep")
        return parallel_profile(dp, ep, tp, policy,
                                MOE_EXPERTS if model_name == "moe" else 0)
    if (dp, ep, tp) != (1, 1, 1):
        raise ValueError("--dp, --ep and --tp are the moe and tp modes'")
    if remat == "auto":
        raise ValueError("--remat auto is the drivers'; pass a plan")
    if model_name == "polybeast":
        return polybeast_trace(policy, superstep_k, native_runtime,
                               num_inference_threads, remat)
    if model_name == "anakin":
        if (policy, superstep_k, remat) != ("f32", 1, None):
            raise ValueError("anakin takes no --precision, --superstep_k "
                             "or --remat (its parser has none)")
        return anakin_profile()
    if native_runtime or num_inference_threads != 2:
        raise ValueError("--native_runtime and --num_inference_threads "
                         "are polybeast's")
    if model_name not in MODEL_CONFIGS:
        raise ValueError(f"model {model_name!r}: one of "
                         f"{sorted(MODEL_CONFIGS)}, polybeast or anakin")
    os.environ["TBT_POOL_PALLAS"] = "1"
    device = torch.device("cuda", 0)
    card = _card()

    pol = precision.get(policy)
    dtypes = dict(dtype=pol.compute_dtype, head_dtype=pol.head_dtype)
    torch.manual_seed(SEED)
    model_kw = MODEL_CONFIGS[model_name]
    use_lstm = model_kw.get("use_lstm", False)
    assignment, levers = remat_levers(model_name, use_lstm, remat)
    model = create_model(model_name, NUM_ACTIONS, **model_kw, **dtypes,
                         **levers)
    config = {"model": model_name, **model_kw}
    if model_name == "deep":
        config["pool_kernel"] = True
    config["remat"] = remat_plan.spell(assignment)
    model = precision.cast_params(model.to(device), pol)
    if "transformer" in model_name:
        state = random_cache(model, SEED, device)
    else:
        state = model.initial_state(B, device)
    hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                             vtrace_impl="pallas", opt_impl="pallas",
                             param_dtype=pol.param_dtype,
                             opt_state_dtype=pol.opt_state_dtype)
    optimizer = learner_lib.make_optimizer(hp, list(model.parameters()))
    K = superstep_k
    update = learner_lib.make_update_dispatch(model, optimizer, hp, K)
    eager_update = learner_lib.update_body(model, optimizer, hp)
    # The acting step takes the f32 batch and state, as the driver does;
    # the update the staged ones, cast by the policy.
    host_batch, act_state = random_batch(SEED, device), state
    batch = precision.cast_batch(host_batch, pol.batch_dtype)
    state = precision.cast_batch(state, pol.batch_dtype)
    eager_args = (batch, state)
    if K > 1:
        batch = {k: torch.stack([v] * K) for k, v in batch.items()}
        state = nest.map(lambda s: torch.stack([s] * K), state)

    def timed(fn, args, per):
        for _ in range(WARMUP):
            fn(*args)
        torch.cuda.synchronize()
        out = []
        for _ in range(UPDATES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / per)
        return out

    # Before any graph holds memory of its own.
    with graphs.update_state_restored(optimizer):
        memory = precision.memory_stats(
            eager_update, *eager_args,
            resident=graphs.update_state_tensors(optimizer))
    update_ms = timed(update, (batch, state), K)
    eager_update_ms = timed(eager_update, eager_args, 1)

    gen = torch.Generator(device=device).manual_seed(SEED)
    env = {k: v[0].cpu().numpy() for k, v in host_batch.items()}

    def act_times(act, act_state):
        ms = []
        for i in range(WARMUP + UPDATES):
            t0 = time.perf_counter()
            out, act_state = act(env, act_state)
            out.action.cpu()
            if i >= WARMUP:
                ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    act_ms = act_times(learner_lib.make_act_step(model, device, gen),
                       act_state)
    with torch.no_grad():
        eager_act_ms = act_times(
            lambda e, s: learner_lib.act_body(
                model, {k: torch.as_tensor(e[k]).to(device)
                        for k in learner_lib.MODEL_INPUT_KEYS}, s, gen),
            act_state)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(UPDATES):
            update(batch, state)
        torch.cuda.synchronize()
    # The same updates under the tracing that polybeast_trace uses (device
    # and CUDA API activity only), cut into update_windows.
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        for _ in range(UPDATES):
            update(batch, state)
        torch.cuda.synchronize()
    windows, events = _windows_of(trace)
    calls = api_calls(events, threading.get_native_id())
    if not calls:  # the trace names threads by another id
        calls = api_calls(events)

    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0.0, 0])
            k[0] += evt.device_time
            k[1] += 1
    device_us = sum(v[0] for v in kernels.values())
    groups = {}
    for name, (us, _) in kernels.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / (UPDATES * K)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    n = UPDATES * K  # updates profiled
    print(json.dumps({
        "card": card,
        "config": {**config, "T": T, "B": B, "frames": [84, 84, 4],
                   "vtrace_impl": "pallas", "opt_impl": "pallas",
                   "precision": policy, "superstep_k": K,
                   "dispatch": "CUDA graph"},
        "update_ms_median": statistics.median(update_ms),
        "update_ms_all": update_ms,
        "eager_update_ms_median": statistics.median(eager_update_ms),
        # The caching allocator's peak over one eager update, and the
        # bytes that update accessed (precision.memory_stats).
        "eager_update_peak_bytes": memory.peak_bytes,
        "eager_update_bytes_accessed": memory.bytes_accessed,
        "act_ms_median": statistics.median(act_ms),
        "eager_act_ms_median": statistics.median(eager_act_ms),
        "profiled_updates": n,
        # The host's CUDA API calls per dispatch (of K updates): a graph
        # replay is one cudaGraphLaunch, each input copy one call.
        "host_api_calls_per_dispatch": sum(calls.values()) / UPDATES,
        "host_api_calls_by_name_per_dispatch": {
            k: v / UPDATES for k, v in sorted(calls.items())},
        "device_ms_per_update": device_us / 1e3 / n,
        # The profiler slows the host's launches down, so the busy share
        # divides the profiled device time by the unprofiled update time.
        "device_busy_share": device_us / 1e3 / n
        / statistics.median(update_ms),
        "kernels_per_update": sum(v[1] for v in kernels.values()) / n,
        "ms_per_update_by_group": groups,
        # The profiled updates cut at their tails, as polybeast's are
        # (the same instrument, so the two can be set side by side).
        "traced_windows_median": median_window(windows),
        "traced_window_longest_gaps": [w["learner_longest_gaps"][:2]
                                       for w in windows],
        "top_kernels": [
            {"name": name[:120], "ms_per_update": us / 1e3 / n,
             "calls_per_update": c / n}
            for name, (us, c) in top
        ],
        # Every launch of the port's own kernels, however small.
        "port_kernels": [
            {"name": name[:120], "ms_per_update": us / 1e3 / n,
             "calls_per_update": c / n, "ms_per_call": us / 1e3 / c}
            for name, (us, c) in sorted(kernels.items())
            if _group(name) == "port kernels"
        ],
    }))


def cli():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model", nargs="?", default="deep",
                        choices=[*MODEL_CONFIGS, "polybeast", "anakin",
                                 "moe", "tp"])
    parser.add_argument("--precision", default="f32",
                        choices=precision.CHOICES)
    parser.add_argument("--superstep_k", type=int, default=1,
                        help="Learner updates per dispatch (one graph).")
    parser.add_argument("--native_runtime", action="store_true",
                        help="polybeast on the port's C++ runtime core "
                             "(default: the Python pool).")
    parser.add_argument("--num_inference_threads", type=int, default=2,
                        help="polybeast's inference threads.")
    parser.add_argument("--remat", default=None,
                        help="The model's remat plan: none (default), all "
                             "or a per-stage spec (the drivers' --remat "
                             "without auto).")
    parser.add_argument("--dp", type=int, default=1,
                        help="moe: data shards.")
    parser.add_argument("--ep", type=int, default=1,
                        help="moe: expert shards a data shard.")
    parser.add_argument("--tp", type=int, default=1,
                        help="moe and tp: model shards a data shard.")
    args = parser.parse_args()
    main(args.model, args.precision, args.superstep_k, args.native_runtime,
         args.num_inference_threads, args.remat, args.dp, args.ep, args.tp)


if __name__ == "__main__":
    cli()
