#!/usr/bin/env python3
"""Smoke test of the PyTorch port (torchbeast_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only | --vtrace-only | --serving-only]

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing the final result line:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the port's CUDA kernels built from the checkout's sources
   (torchbeast_tpu_torch/ops/_build.py) and, at the same time, its C++
   runtime core (runtime/native_build.py, from csrc/native/ with the host
   C++ compiler; the Python include path and whether Python.h is in it
   printed first), each timed; a core that does not build fails the run;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' shapes, TF32 off, with its median time over CUDA-event
   timed runs beside its bound, the plain version's time and, where one
   PyTorch call computes the same function, that call's time. The pool
   backward is timed per trunk stage and also checked on ties and on
   shapes its 16-byte path does not take; V-trace must equal its plain
   version bit for bit, at ragged shapes and unaligned inputs too, and is
   timed beside an empty launch; the RMSprop tail is checked and
   timed on both models' parameter trees; the attention forward is timed
   at the learner shape (T=81) and the acting shape (T=1); the attention
   backward is also checked at a shape beyond one block of its kernel
   (T=300, D=64) and must give identical bits on two calls; the device
   kernels of one call of the tail and of the backward are counted with
   torch.profiler. Each kernel with a bf16 variant (the tail, the pool
   backward, the attention forward and backward) has a second row, its
   bf16 variant against the plain version in bf16, checked, timed and
   counted the same way. With --kernels-only the script stops here and
   prints the kernels line (to compare two trees' kernels on one card);
   with --vtrace-only it does so after V-trace's row;
4. graphs (TF32 off, cuDNN deterministic): the learner's CUDA graph
   (learner.make_update_dispatch) at K=1 and K=4, two dispatches against
   2K eager updates of a copy on the same batches, with the LR decay and
   the entropy anneal moving: deep + LSTM at f32 and at bf16_train and
   the transformer at f32; params, nu, the master and every stat must be
   bitwise equal and the device count read 2K; one replay, profiled,
   must make one cudaGraphLaunch and run K times the port kernels of one
   eager update (V-trace 1, the tail 1, pool_bwd 3; attention 2 + 2),
   and the host's API calls per dispatch are printed beside one eager
   update's. The acting graphs: monobeast's step at B=32 for five chained
   steps, and polybeast's state-table step at each bucket of
   --max_inference_batch_size 32 against an eager twin, from the same
   generator state: actions, logits, baseline and states bitwise; and
   the state table's replica graphs (one per bucket, bound to a replica
   params buffer, captured beside the central ones) against an eager
   twin, bitwise, before and after one snapshot refresh;
5. main paths: `monobeast.train` through the port's own parser, every
   kernel switch on, T=80, B=32, each dispatch one CUDA graph, at full
   width: (a) deep ResNet + LSTM (84x84x4 frames, 16/32/32 trunk, fc
   and LSTM 256); (b) the transformer policy (84x84x4 frames, 2 layers,
   d_model 128, 4 heads, memory 64) with --attention_impl pallas; (c),
   (d) the same two at --precision bf16_train, 3 updates each; (e) deep + LSTM with 128 actors, --superstep_k 4 and
   --overlap_collect: three dispatches of 4 updates. The launch counts
   are set to 0 before each path and read after it; each kernel the
   path is meant to launch must show at least one launch per update (at
   bf16_train, every launch of a kernel with a bf16 variant must be a
   bf16 launch, counted apart), every pool backward launch must have
   taken the kernel's 16-byte path (the trunk hands it channels_last
   tensors, uncopied), and every loss stat must be finite;
   Then the async driver, `polybeast.train` through its own parser with
   16 Mock env servers (processes of their own on 127.0.0.1 ports), the
   Python actor pool, two inference threads on the state table (one
   graph per bucket), deep + LSTM at T=80, B=32, the same kernel
   switches: (f) three updates, each launching V-trace and the tail at
   least once and the pool backward at least three times, every pool
   launch on the 16-byte path, finite losses, a checkpoint written; it
   prints SPS (over the run, and from the second batch's arrival to the
   last one's), the median update interval on the default stream that
   acting shares, the mean inference batch and the medians of one acting
   forward's host time, its reply's copy, an actor's request round trip
   and the learner's wait for a batch; (g) the same xpid for one more
   update: it must resume from the checkpoint and run on; (h) `--mode
   test` on that checkpoint: one greedy Mock episode must return 200.0;
   (i) the same three on the port's C++ runtime core (--native_runtime in
   place of --no_native_runtime, so the run differs in the pool alone;
   the resume adds --native_server): the log must name the native
   runtime and the pool must be the core's ActorPool, with the same
   launch checks and the same printed line; (j) the Python pool's three
   with --superstep_k 2 (two dispatches of 2 updates, then one more
   after the resume); (k) a deep + LSTM train state on the
   card (bf16_train with --opt_impl pallas, f32 with xla) saved and
   loaded into a fresh model and optimizer: params, nu and the master
   bitwise equal; (l) the serving tier and the chaos harness: polybeast
   deep + LSTM (the same flags, env servers on shm rings) with
   --request_deadline_ms 300 --replica_refresh_updates 1
   --max_policy_lag 20 and chaos_run.build_plan's plan (one env-server
   SIGKILL, one transport sever, a 3 s learner stall, one state-table
   poison, each after the first batch) over 7 updates, on the Python pool
   and on the core with --native_server, each through chaos_run.run_one
   and held by chaos_run's own checks: every fault injected, recovery
   counters equal to the injected counts, resubmitted == shed + expired
   > 0, no live child and no segment of the run's own left in /dev/shm;
   replica requests served with a policy_lag within the budget; every
   telemetry.jsonl line valid, the last with the reference's serving,
   chaos and recovery series; the launch and loss checks of (f). It
   prints SPS, the p50 and p99 of an inference request's wait, of the
   serving queue delay and of the replica forward's host time, and the
   seconds from each fault's injection to its recovery (the respawn, the
   reconnect, the first update after the stall, the rebuild). With
   --serving-only the script runs only the replica graph check and (l),
   after the builds;
6. parity: one learner update of each model from the same weights and
   batch with the kernels and with the plain versions on the card (TF32
   off, cuDNN deterministic), at f32, bf16_compute and bf16_train;
   params, RMSprop state and loss stats must agree, at the tolerances
   printed.

Then one JSON line with every kernel's numbers, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX or of the JAX package.
"""

import copy
import csv
import importlib.util
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# The slice's shape and random batch, shared with the port's profiler.
from torchbeast_tpu_torch.profile_update import (  # noqa: E402
    B, NUM_ACTIONS, T, polybeast_argv, random_batch, random_cache)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, and the rate
# of operations on the operands' type: f32 outside the tensor cores, bf16
# on them (a bf16 x bf16 product is exact in f32, so the tensor cores'
# f32-accumulating bf16 rate computes what the bf16 variants compute).
HBM_BYTES_PER_S = 3.35e12
BF16 = torch.bfloat16
FLOPS_PER_S = {torch.float32: 67e12, BF16: 989e12}

BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to a value, at most

STAGES = ((84, 84, 16), (42, 42, 32), (21, 21, 32))  # pool inputs (H, W, C)
# The transformer's attention at full width: heads, head dim, memory.
HEADS, HEAD_DIM, MEMORY = 4, 32, 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def bound_ms(nbytes, flops, dtype=torch.float32):
    """The least time in ms for `nbytes` moved and `flops` operations on
    operands of `dtype`, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps=20):
    """Median device time of fn() in ms over `reps` CUDA-event timed runs.
    A sleep kernel first keeps the card busy while the host enqueues fn's
    launches, so the events measure the card's work, not the host's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def close(a, b, rtol, atol):
    """max |a - b| and whether |a - b| <= atol + rtol * |b| everywhere."""
    diff = (a.double() - b.double()).abs()
    ok = bool((diff <= atol + rtol * b.double().abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def kernel_label(mangled):
    """A kernel's mangled name '_ZN<n><namespace><m><name><template
    arguments>...' -> '<name><the first characters of its template
    arguments>' (IffE: float, float; 13__nv_bfloat16: bf16)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled[:48]
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"\d+", rest)
    if not m:
        return mangled[:48]
    end = m.end() + int(m.group())
    return rest[m.end():end] + rest[end:end + 28]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0]


# ---------------------------------------------------------------- kernels


# V-trace checks ([T, ...] shapes): the main path's, a long unroll beyond
# the kernel's ring of chunks, ragged T (1, 81: a partial chunk) against
# ragged B (7, 33: the 4-byte copy path; 100: a partial last block), and
# trailing dims flattened into B.
VTRACE_SHAPES = ((T, B), (4000, 128), *((t, b) for t in (1, 81)
                                         for b in (7, 33, 100)),
                 (T + 1, B, 3))


def vtrace_inputs(shape, seed, dev, offset=0):
    """The kernel's seven inputs at [T, ...] `shape`, each starting
    `offset` floats into its own storage (1: not 16-byte aligned)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    n = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    disc = 0.99 * (r(*shape) > 0.05).float()
    cs = r(*shape)
    xs = (disc * cs, n(*shape), r(*shape), n(*shape), disc, n(*shape),
          n(*shape[1:]))
    out = []
    for x in xs:
        buf = torch.empty(offset + x.numel(), device=dev)
        out.append(buf[offset:].view(x.shape))
        out[-1].copy_(x)
    return tuple(out)


def check_vtrace(ops, dev):
    """The kernel against its plain version, bit for bit, at
    VTRACE_SHAPES and at the main path's shape with unaligned inputs;
    timed at the main path's shape beside an empty launch (the launch
    floor its time is read against)."""
    from torchbeast_tpu_torch.ops import vtrace

    cases = [(shape, 0) for shape in VTRACE_SHAPES] + [((T, B), 1)]
    err = 0.0
    for i, (shape, offset) in enumerate(cases):
        xs = vtrace_inputs(shape, i, dev, offset)
        got = vtrace.vtrace_targets(*xs)
        torch.cuda.synchronize()
        want = vtrace.vtrace_targets_plain(*xs)
        for g_, w_ in zip(got, want):
            err = max(err, close(g_, w_, 0.0, 0.0)[0])
            check(torch.equal(g_, w_), f"vtrace {shape} offset {offset}: "
                  f"kernel differs from plain, max |err| {err}")
    print(f"kernel vtrace_targets: bit for bit equal to plain at "
          f"{', '.join(str(s) for s, _ in cases)} (the last one 4 bytes "
          "into its storage)")
    xs = vtrace_inputs((T, B), 0, dev)
    ms = time_ms(lambda: vtrace.vtrace_targets(*xs))
    floor = time_ms(lambda: torch.cuda._sleep(0))
    plain = time_ms(lambda: vtrace.vtrace_targets_plain(*xs))
    # The same shape through the kernel's 4-byte copies (unaligned), and
    # a long unroll.
    xs_4 = vtrace_inputs((T, B), 0, dev, offset=1)
    ms_4 = time_ms(lambda: vtrace.vtrace_targets(*xs_4))
    xs_long = vtrace_inputs((4000, 128), 0, dev)
    ms_long = time_ms(lambda: vtrace.vtrace_targets(*xs_long))
    nbytes = 4 * (8 * T * B + B)  # 6 [T,B] + boot in, 2 [T,B] out
    bms, by = bound_ms(nbytes, 10 * T * B)
    print(f"kernel vtrace_targets T={T} B={B}: ms {ms:.4f}, empty launch "
          f"{floor:.4f}, plain {plain:.4f}, bound {bms:.7f} ({by}); "
          f"4-byte copies {ms_4:.4f}; T=4000 B=128 {ms_long:.4f}")
    return {
        "name": "vtrace_targets", "route": "cuda",
        "source": "torchbeast_tpu_torch/csrc/vtrace.cu",
        "replaces": "torchbeast_tpu/ops/pallas_vtrace.py:34",
        "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "launch_floor_ms": floor, "ms_4_byte_copies": ms_4,
        "ms_T4000_B128": ms_long,
    }


def nhwc_at_offset(t, offset):
    """A copy of the channels_last tensor t that starts `offset` elements
    into its storage (offset 1: not 16-byte aligned)."""
    N, C, H, W = t.shape
    buf = torch.empty(offset + t.numel(), device=t.device, dtype=t.dtype)
    out = buf[offset:].view(N, H, W, C).permute(0, 3, 1, 2)
    out.copy_(t)
    return out


def pool_case(pool, label, x, y, g, vector):
    """The kernel against its plain version on one input, exactly (it adds
    tied windows in the plain tap-sum's order); `vector`: whether the
    launch must take the 16-byte path."""
    before = pool.pool_bwd.vector_launches
    got = pool.pool_bwd(x, y, g)
    torch.cuda.synchronize()
    took = pool.pool_bwd.vector_launches > before
    check(took == vector, f"pool_bwd {label}: 16-byte path {took}")
    want = pool.pool_bwd_plain(x, y, g)
    e, ok = close(got, want, 0.0, 0.0)
    check(ok, f"pool_bwd {label}: max |err| {e}")
    print(f"kernel pool_bwd {label} ({'16-byte' if took else 'scalar'} "
          f"path): max_abs_err {e:.3g} (exact)")
    return e


def check_pool(ops, dev, dtype=torch.float32):
    """pool_bwd per trunk stage at the main path's N, in `dtype` (f32, or
    bf16: the bf16 variant, 8 channels a 16-byte access); exact against
    the plain version, which adds (and in bf16 rounds) in its order."""
    from torchbeast_tpu_torch.ops import pool

    n = (T + 1) * B
    gen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    stages = []
    tag = "" if dtype == torch.float32 else "_bf16"
    for H, W, C in STAGES:
        x = torch.randn(n, H, W, C, generator=gen, device=dev).to(dtype)
        x = x.permute(0, 3, 1, 2)  # channels_last [N, C, H, W]
        y, idx = F.max_pool2d(x, 3, 2, 1, return_indices=True)
        g = torch.randn(y.shape, generator=gen, device=dev).to(
            dtype).contiguous(memory_format=torch.channels_last)
        got = pool.pool_bwd(x, y, g)
        torch.cuda.synchronize()
        want = pool.pool_bwd_plain(x, y, g)
        e, ok = close(got, want, 0.0, 0.0)
        check(ok, f"pool_bwd {(n, H, W, C)}: max |err| {e}")
        # Tie-free input: PyTorch's one-tie backward is the same function.
        lib_gx = torch.ops.aten.max_pool2d_with_indices_backward(
            g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx)
        e_lib, _ = close(got, lib_gx, 0.0, 0.0)
        err = max(err, e)
        ms = time_ms(lambda: pool.pool_bwd(x, y, g))
        plain = time_ms(lambda: pool.pool_bwd_plain(x, y, g))
        lib = time_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            g, x, [3, 3], [2, 2], [1, 1], [1, 1], False, idx))
        nbytes = x.element_size() * (2 * x.numel() + 2 * y.numel())
        bms, _ = bound_ms(nbytes, 9 * x.numel(), dtype)
        print(f"kernel pool_bwd{tag} N={n} {H}x{W}x{C}: max_abs_err {e:.3g} "
              f"(exact); vs torch backward {e_lib:.3g}; ms {ms:.4f} "
              f"plain {plain:.4f} torch {lib:.4f} bound {bms:.4f} share of "
              f"bound {bms / ms:.3f}")
        stages.append({"shape": [n, H, W, C], "ms": ms, "bound_ms": bms,
                       "share_of_bound": bms / ms})
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", bms)):
            tot[k] += v
        del x, y, g, idx, got, want, lib_gx
        torch.cuda.empty_cache()
    print(f"kernel pool_bwd{tag} three stages: {tot['ms']:.4f} ms against "
          f"a bound of {tot['bound_ms']:.4f} ms, share "
          f"{tot['bound_ms'] / tot['ms']:.3f}")

    def case(shape, ties):
        if ties:
            x = torch.randint(0, 4, shape, generator=gen, device=dev)
        else:
            x = torch.randn(shape, generator=gen, device=dev)
        x = x.to(dtype).permute(0, 3, 1, 2)
        y = F.max_pool2d(x, 3, 2, 1)
        g = torch.randn(y.shape, generator=gen, device=dev).to(
            dtype).contiguous(memory_format=torch.channels_last)
        return x, y, g

    # Planted ties: values on a coarse grid tie inside most windows.
    err = max(err, pool_case(pool, f"ties{tag} N=64 84x84x16",
                             *case((64, 84, 84, 16), True), True))
    # Shapes the 16-byte path does not take: odd H and W with C=3 (ties
    # planted too), and a C=16 input one element into its storage.
    err = max(err, pool_case(pool, f"ties{tag} N=64 21x21x3",
                             *case((64, 21, 21, 3), True), False))
    err = max(err, pool_case(
        pool, f"N=64 42x42x16 offset 1{tag}",
        *(nhwc_at_offset(t, 1) for t in case((64, 42, 42, 16), False)),
        False))
    return {
        "name": "pool_bwd" + tag, "wrapper": "pool_bwd",
        "bf16": dtype == BF16, "route": "cuda",
        "source": "torchbeast_tpu_torch/csrc/pool_bwd.cu",
        "replaces": "torchbeast_tpu/ops/pallas_pool.py:54",
        "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": "bytes",
        "library_ms": tot["library_ms"], "stages": stages,
    }


def _param_tree(dev, name="deep", policy="f32"):
    """A model of the slice at full width, random from seed 0, built at
    the precision `policy` (its params cast to the resident dtype), and a
    copy of its parameters."""
    from torchbeast_tpu_torch import precision
    from torchbeast_tpu_torch.models import create_model

    pol = precision.get(policy)
    torch.manual_seed(0)
    kw = dict(dtype=pol.compute_dtype, head_dtype=pol.head_dtype)
    if name == "deep":
        model = create_model("deep", NUM_ACTIONS, use_lstm=True, **kw)
    else:
        model = create_model("transformer", NUM_ACTIONS,
                             attention_impl="pallas", **kw)
    model = precision.cast_params(model.to(dev), pol)
    return model, [p.detach().clone() for p in model.parameters()]


def kernels_per_call(fn, calls=5):
    """The device kernels one call of fn() launches, by torch.profiler over
    `calls` calls, after a first profiled window that is thrown away (the
    first window after start-up can miss events): (count, names)."""
    from torch.profiler import ProfilerActivity, profile

    for _window in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _call in range(calls):
                fn()
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(names) / calls, sorted(set(n[:60] for n in names))


# The bf16 tail against its plain version: both do the same f32
# operations, but the norm's partials are summed in another order, and
# where the two f32 values of nu straddle a bf16 rounding boundary the
# stored nu differs by one ulp; the next step's update then differs by up
# to 2**-8 of itself: the master by about lr * 2**-8 (TAIL_BF16_ATOL), mom
# (a sum of unscaled updates) by up to one bf16 ulp of its largest entry.
TAIL_BF16_ATOL = 4e-6


def check_opt(ops, dev, tree, policy="f32"):
    """The tail against its plain version on one model's parameter tree at
    `policy` (f32: f32 params and nu; bf16_train, the bf16 variant: bf16
    params, grads and nu, f32 master and mom), clip active, clip inactive
    and momentum, then timed there beside its bound and, in f32,
    clip_grad_norm_ + RMSprop(foreach=True). No PyTorch call keeps an f32
    master beside bf16 params, so the bf16 row has no library time."""
    from torchbeast_tpu_torch.ops import opt

    model, params0 = _param_tree(dev, tree, policy)
    bf16 = policy == "bf16_train"
    n_params = sum(p.numel() for p in params0)
    ragged = sum(p.numel() % 4 != 0 for p in params0)
    g_cpu = torch.Generator(device="cpu").manual_seed(1)
    hyper = dict(alpha=0.99, eps=0.01, max_norm=40.0)
    # (what, rtol, atol) of each compared group; bf16 mom apart, below.
    if bf16:
        tols = (("norm", 1e-6, 1e-6), ("master", 1e-6, TAIL_BF16_ATOL),
                ("params/nu", BF16_ULP, TAIL_BF16_ATOL))
        tol_text = (f"norm rtol 1e-6; master rtol 1e-6, atol "
                    f"{TAIL_BF16_ATOL}; bf16 params/nu 1 ulp or atol "
                    f"{TAIL_BF16_ATOL}; mom 1 ulp of its largest; params == "
                    "bf16(master) bit for bit")
    else:
        tols = (("norm", 1e-6, 1e-6), ("params/nu/mom", 1e-6, 1e-6))
        tol_text = "rtol 1e-6, atol 1e-6"

    def fresh(momentum):
        p = [t.clone() for t in params0]
        return (p, [t.float() for t in p] if bf16 else None,
                [torch.zeros_like(t) for t in p],
                [torch.zeros_like(t, dtype=torch.float32) for t in p]
                if momentum else None)

    err = 0.0
    for label, gscale, momentum in (("clip active", 1.0, 0.0),
                                    ("clip inactive", 1e-3, 0.0),
                                    ("momentum 0.9", 1.0, 0.9)):
        steps = 1 if momentum and not bf16 else 3
        grads = [[(gscale * torch.randn(p.shape, generator=g_cpu)).to(
            dev, p.dtype).contiguous(memory_format=(
                torch.channels_last if p.dim() == 4
                else torch.contiguous_format)) for p in params0]
            for _ in range(steps)]
        runs = []
        for plain in (False, True):
            p, master, nu, mom = fresh(momentum)
            sums = []
            for step, gs in enumerate(grads):
                # The rate in device memory, where the learner puts it.
                lr = torch.tensor(4.8e-4 * (1 - step / 10), device=dev)
                kw = dict(lr=lr, momentum=momentum, masters=master, **hyper)
                if plain:
                    with ops.plain_on_device():
                        sums.append(opt.rmsprop_tail(p, gs, nu, mom, **kw))
                else:
                    sums.append(opt.rmsprop_tail(p, gs, nu, mom, **kw))
            torch.cuda.synchronize()
            runs.append((sums, p, master or [], nu, mom or []))
        (sk, pk, mk, nk, momk), (sp, pp, mp, npl, momp) = runs
        pairs = {"norm": zip(sk, sp), "master": zip(mk, mp),
                 "params/nu": zip(pk + nk, pp + npl),
                 "params/nu/mom": zip(pk + nk + momk, pp + npl + momp)}
        errs = {}
        for what, rtol, atol in tols:
            for a, b in pairs[what]:
                ei, ok = close(a.float(), b.float(), rtol, atol)
                check(ok, f"rmsprop_tail {policy} {tree} ({label}): {what} "
                          f"max |err| {ei}")
                errs[what] = max(errs.get(what, 0.0), ei)
        if bf16:
            check(all(torch.equal(a, m.to(BF16)) for a, m in zip(pk, mk)),
                  f"rmsprop_tail bf16 {tree}: params are not bf16(master)")
            for a, b in zip(momk, momp):
                ei, _ = close(a, b, 0.0, 0.0)
                check(ei <= BF16_ULP * float(b.abs().max()),
                      f"rmsprop_tail bf16 {tree} ({label}): mom max |err| "
                      f"{ei}")
                errs["mom"] = max(errs.get("mom", 0.0), ei)
        err = max(err, *errs.values())
        print(f"kernel rmsprop_tail {policy} {tree} {label} (|g| "
              f"{float(torch.sqrt(sp[-1])):.3g}, {steps} steps, "
              f"{len(params0)} leaves, {ragged} of them not a multiple of "
              f"4, {n_params} params): max_abs_err "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f" ({tol_text})")
    p, master, nu, _ = fresh(0.0)
    grads = [torch.randn_like(t) for t in p]
    lr = torch.tensor(1e-9, device=dev)
    step = lambda: opt.rmsprop_tail(p, grads, nu, None, lr=lr,  # noqa
                                    momentum=0.0, masters=master, **hyper)
    ms = time_ms(step)
    per_call, names = kernels_per_call(step)
    with ops.plain_on_device():
        plain = time_ms(step)
    lib = None
    if not bf16:
        # Yardstick: clip_grad_norm_ + torch.optim.RMSprop(foreach=True).
        for q, g in zip(model.parameters(), grads):
            q.grad = g
        rms = torch.optim.RMSprop(model.parameters(), lr=1e-9, alpha=0.99,
                                  eps=0.01, foreach=True)

        def library_step():
            torch.nn.utils.clip_grad_norm_(model.parameters(), 40.0,
                                           foreach=True)
            rms.step()

        lib = time_ms(library_step)
    # Bytes, each input read once and each output written once, for the
    # timed call (no momentum, which would add mom in and out, 8 B more).
    # f32: g, nu, p in and nu, p out, 20 B a parameter; bf16: g 2 in, nu
    # 2 + 2, master 4 + 4, param 2 out, 16 B.
    bms, by = bound_ms((16 if bf16 else 20) * n_params, 12 * n_params,
                       params0[0].dtype)
    print(f"kernel rmsprop_tail {policy} {tree} ({n_params} params): ms "
          f"{ms:.4f} bound {bms:.5f} ({by}), share of bound {bms / ms:.3f}; "
          f"{per_call} device kernels a call {names}")
    return {
        "name": ("rmsprop_tail" + ("_bf16" if bf16 else "")
                 + ("" if tree == "deep" else "_" + tree)),
        "wrapper": "rmsprop_tail", "bf16": bf16, "route": "cuda",
        "source": "torchbeast_tpu_torch/csrc/rmsprop_tail.cu",
        "replaces": "torchbeast_tpu/ops/pallas_opt.py:78",
        "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": lib,
        "params": n_params, "kernels_per_call": per_call,
    }


def attention_inputs(t, seed, dev, b=B, d=HEAD_DIM, m=MEMORY,
                     dtype=torch.float32):
    """Attention inputs for an unroll of t steps, by default at the full
    model's B, H, D and M: planted dones (segments and the no-done gate
    act) and a cache about 70% valid, from numpy's generator; q, k, v and
    rel_bias in `dtype`."""
    rng = np.random.default_rng(seed)
    done = rng.random((t, b)) < 0.05
    done[min(3, t - 1), 0] = True
    seg = np.ascontiguousarray(np.cumsum(done, 0).T, dtype=np.int32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = (f32(b, t, HEADS, d), f32(b, m + t, HEADS, d),
              f32(b, m + t, HEADS, d), seg,
              (rng.random((b, m)) < 0.7).astype(np.float32), seg == 0,
              0.1 * f32(HEADS, m + 1))
    xs = [torch.from_numpy(a).to(dev) for a in arrays]
    for i in (0, 1, 2, 6):
        xs[i] = xs[i].to(dtype)
    return tuple(xs)


# Shapes of the attention checks (B, T, D, M): the learner's, the acting
# step's, and one whose rows and band exceed one block of the backward
# (row tiles and key chunks).
ATTENTION_CHECKS = ((B, T + 1, HEAD_DIM, MEMORY), (B, 1, HEAD_DIM, MEMORY),
                    (8, 300, 64, MEMORY))


# bf16: the forward within one bf16 ulp of the plain version (both round
# an f32 result once; atol for outputs that cancel to near 0); the
# backward's gradients within BF16_BWD_TOL of each gradient's largest
# entry (the kernel's Delta = rowsum(dO * O) reads the forward's bf16 out,
# the plain version's autograd its f32 out).
BF16_BWD_TOL = 1e-2


def check_attention(ops, dev, dtype=torch.float32):
    """Forward and backward kernels against the plain version at
    ATTENTION_CHECKS, in `dtype` (q, k, v and rel_bias); the backward run
    twice on the same inputs must agree bit for bit. The forward is timed
    at the learner shape (T = unroll + 1) and the acting shape (T = 1),
    the backward at the learner shape. Returns the three kernel rows."""
    from torchbeast_tpu_torch.ops import attention

    M = MEMORY
    bf16 = dtype == BF16
    tag = "_bf16" if bf16 else ""
    fwd_tol = (BF16_ULP, 1e-6) if bf16 else (1e-5, 1e-6)
    err_f = err_b = 0.0
    for b, t, d, m in ATTENTION_CHECKS:
        xs = attention_inputs(t, seed=t, dev=dev, b=b, d=d, m=m, dtype=dtype)
        q, k, v, seg, valid, nodone, bias = xs
        g = torch.from_numpy(np.random.default_rng(t + 1).standard_normal(
            q.shape).astype(np.float32)).to(dev, dtype)
        leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
        args = lambda ls: (m, ls[0], ls[1], ls[2], seg, valid,  # noqa: E731
                           nodone, ls[3])
        out_k = attention.transformer_attention(*args(leaves))
        grads_k = torch.autograd.grad(out_k, leaves, g)
        torch.cuda.synchronize()
        with ops.plain_on_device():
            out_p = attention.transformer_attention(*args(leaves))
            grads_p = torch.autograd.grad(out_p, leaves, g)
        ef, ok = close(out_k.detach(), out_p.detach(), *fwd_tol)
        check(ok, f"attention{tag} forward T={t}: max |err| {ef}")
        eb = []
        for label, a, b_ in zip(("q", "k_all", "v_all", "rel_bias"),
                                grads_k, grads_p):
            check(a.dtype == b_.dtype == dtype,
                  f"attention{tag} d{label} dtype {a.dtype}")
            if bf16:
                e, _ = close(a, b_, 0.0, 0.0)
                ok = e <= BF16_BWD_TOL * float(b_.float().abs().max())
            else:
                e, ok = close(a, b_, 1e-4, 1e-5)
            check(ok, f"attention{tag} backward T={t} d{label}: max |err| "
                      f"{e}")
            eb.append(e)
        with torch.no_grad():
            out, lse = attention._launch_forward(m, *xs)
        again = [attention.transformer_attention_bwd(m, *xs, out, lse, g)
                 for _ in range(2)]
        check(all(torch.equal(a, b_) for a, b_ in zip(*again)),
              f"attention{tag} backward T={t}: two calls differ")
        err_f, err_b = max(err_f, ef), max(err_b, *eb)
        bwd_tol = (f"max |err| <= {BF16_BWD_TOL} of each gradient's largest"
                   if bf16 else "rtol 1e-4, atol 1e-5")
        print(f"kernel transformer_attention{tag} B={b} T={t} H={HEADS} "
              f"D={d} M={m}: forward max_abs_err {ef:.3g} (rtol "
              f"{fwd_tol[0]:.3g}, atol {fwd_tol[1]:.3g}); backward "
              f"dq/dk/dv/drel_bias max_abs_err "
              f"{' / '.join(f'{e:.3g}' for e in eb)} ({bwd_tol}), two "
              "calls bitwise equal")

    # Timing of the forward at the learner shape (T = unroll + 1) and the
    # acting shape (T = 1), and of the backward at the learner shape,
    # inputs as the model gives them.
    fwd = {t: time_attention_forward(attention, t, dev, dtype)
           for t in (T + 1, 1)}
    q, k, v, seg, valid, nodone, bias = xs = attention_inputs(
        T + 1, 5, dev, dtype=dtype)
    g = torch.randn_like(q)
    with torch.no_grad():
        out, lse = attention._launch_forward(M, *xs)
    bwd = lambda: attention.transformer_attention_bwd(  # noqa: E731
        M, *xs, out, lse, g)
    bwd_ms = time_ms(bwd)
    per_call, names = kernels_per_call(bwd)
    print(f"kernel transformer_attention_bwd{tag} B={B} T={T + 1} "
          f"H={HEADS} D={HEAD_DIM} M={M}: {per_call} device kernels a call "
          f"{names}")
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    out_p = attention.transformer_attention_plain(
        M, leaves[0], leaves[1], leaves[2], seg, valid, nodone, leaves[3])
    bwd_plain = time_ms(lambda: torch.autograd.grad(out_p, leaves, g,
                                                    retain_graph=True))
    # Yardstick: SDPA's autograd backward, with the mask's gradient left
    # as [B, H, T, K], not reduced to the bias.
    add_mask = sdpa_mask(attention, M, seg, valid, nodone, bias)
    add_mask.requires_grad_()
    sq, sk, sv = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=add_mask)
    g_t = g.transpose(1, 2).contiguous()
    bwd_lib = time_ms(lambda: torch.autograd.grad(
        lib_out, (sq, sk, sv, add_mask), g_t, retain_graph=True))
    # Backward: q k v meta out dO lse in, dq dk dv dbias out; per band pair
    # q.k and p.v recomputed plus dO.v, dS.k and dS.q (10 D flops).
    qb, kb = q.element_size() * q.numel(), k.element_size() * k.numel()
    bwd_bound, bwd_by = bound_ms(
        (qb + 2 * kb + meta_bytes(seg, valid, nodone, bias) + 2 * qb
         + 4 * lse.numel()) + (qb + 2 * kb
                               + bias.element_size() * bias.numel()),
        10 * HEAD_DIM * B * HEADS * (T + 1) * (M + 1), dtype)
    rows = []
    for name, t, (ms, plain, lib, bms, by), err in (
            ("transformer_attention", T + 1, fwd[T + 1], err_f),
            ("transformer_attention_acting", 1, fwd[1], err_f),
            ("transformer_attention_bwd", T + 1,
             (bwd_ms, bwd_plain, bwd_lib, bwd_bound, bwd_by), err_b)):
        rows.append({
            "name": name + tag, "bf16": bf16, "route": "cuda",
            "source": "torchbeast_tpu_torch/csrc/attention.cu",
            "replaces": "torchbeast_tpu/ops/pallas_attention.py:85",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "shape": {"B": B, "T": t, "H": HEADS, "D": HEAD_DIM, "M": M},
        })
    # The acting row is the same wrapper's forward at T = 1.
    for row, wrapper in zip(rows, ("transformer_attention",
                                   "transformer_attention",
                                   "transformer_attention_bwd")):
        row["wrapper"] = wrapper
    rows[2]["kernels_per_call"] = per_call
    return rows


def meta_bytes(seg, valid, nodone, bias):
    return (4 * seg.numel() + 4 * valid.numel() + nodone.numel()
            + bias.element_size() * bias.numel())


def sdpa_mask(attention, M, seg, valid, nodone, bias):
    """The mask and the bias folded into one precomputed [B, H, T, K]
    additive mask for SDPA (the port never builds it)."""
    _, offsets = attention.band_relative_offsets(seg.shape[1], M,
                                                 device=seg.device)
    visible = attention.attention_mask(M, seg, valid, nodone)
    return torch.where(visible[:, None], bias[:, offsets][None],
                       attention.BIG_NEG).to(bias.dtype).contiguous()


def time_attention_forward(attention, t, dev, dtype=torch.float32):
    """(ms, plain_ms, sdpa_ms, bound_ms, bound_by) of the forward kernel at
    unroll length t in `dtype`; SDPA takes the same inputs with a
    precomputed additive mask (in `dtype`), and its difference from the
    kernel is printed."""
    M = MEMORY
    q, k, v, seg, valid, nodone, bias = xs = attention_inputs(
        t, 5 + t, dev, dtype=dtype)
    add_mask = sdpa_mask(attention, M, seg, valid, nodone, bias)
    sq, sk, sv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with torch.no_grad():
        out = attention.transformer_attention(M, *xs)
        ms = time_ms(lambda: attention.transformer_attention(M, *xs))
        plain = time_ms(lambda: attention.transformer_attention_plain(M, *xs))
        lib_out = F.scaled_dot_product_attention(sq, sk, sv,
                                                 attn_mask=add_mask)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=add_mask))
    e_lib, _ = close(out, lib_out.transpose(1, 2), 0.0, 0.0)
    # Bytes: q k v meta in, out and lse out, each once. Operations: only
    # the band's pairs are needed, M + 1 keys per query row, q.k and p.v
    # on each (4 D flops).
    qb, kb = q.element_size() * q.numel(), k.element_size() * k.numel()
    bms, by = bound_ms(qb + 2 * kb + meta_bytes(seg, valid, nodone, bias)
                       + qb + 4 * B * HEADS * t,
                       4 * HEAD_DIM * B * HEADS * t * (M + 1), dtype)
    print(f"kernel transformer_attention forward {str(dtype)[6:]} B={B} "
          f"T={t} H={HEADS} "
          f"D={HEAD_DIM} M={M}: ms {ms:.4f} plain {plain:.4f} SDPA {lib:.4f} "
          f"(max_abs_err vs kernel {e_lib:.3g}) bound {bms:.5f} ({by}), "
          f"share of bound {bms / ms:.3f}")
    return ms, plain, lib, bms, by


# ------------------------------------------------------------- main paths

DEEP_KERNELS = ("vtrace_targets", "rmsprop_tail", "pool_bwd")
TRANSFORMER_KERNELS = ("vtrace_targets", "rmsprop_tail",
                       "transformer_attention", "transformer_attention_bwd")
DEEP_ARGS = ["--model", "deep", "--use_lstm"]
TRANSFORMER_ARGS = ["--model", "transformer", "--attention_impl", "pallas"]
# (label, flags, the kernels the path must launch, its precision policy,
# its updates). At bf16_train every kernel but V-trace (which the
# reference keeps in f32) must launch its bf16 variant. The last path
# runs 128 actors: 4 learner sub-batches a collect, one K=4 superstep
# dispatch, with acting one dispatch behind (--overlap_collect).
SUPERSTEP_ARGS = ["--num_actors", str(4 * B), "--superstep_k", "4",
                  "--overlap_collect"]
PATHS = (
    ("deep+LSTM", DEEP_ARGS, DEEP_KERNELS, "f32", 3),
    ("transformer", TRANSFORMER_ARGS, TRANSFORMER_KERNELS, "f32", 3),
    ("deep+LSTM bf16_train", DEEP_ARGS, DEEP_KERNELS, "bf16_train", 3),
    ("transformer bf16_train", TRANSFORMER_ARGS, TRANSFORMER_KERNELS,
     "bf16_train", 3),
    ("deep+LSTM superstep_k 4 overlap_collect",
     DEEP_ARGS + SUPERSTEP_ARGS, DEEP_KERNELS, "f32", 12),
)


def run_main_path(ops, savedir, path):
    """Train one path's updates; return its launch counts, all and
    bf16. Every dispatch replays a CUDA graph; each replay adds the port
    kernels its capture counted, so the counts are launches on the
    card."""
    from torchbeast_tpu_torch import monobeast

    label, model_args, expected, policy, updates = path
    flags = monobeast.make_parser().parse_args([
        "--env", "Mock", "--num_actors", str(B), *model_args,
        "--batch_size", str(B),
        "--unroll_length", str(T), "--vtrace_impl", "pallas",
        "--opt_impl", "pallas", "--serial_envs", "--precision", policy,
        "--total_steps", str(updates * T * B), "--savedir", savedir,
        "--xpid", "chip_smoke_" + re.sub(r"\W+", "_", label),
    ])
    # A checkpoint left by an earlier run of this script would resume.
    shutil.rmtree(os.path.join(savedir, flags.xpid), ignore_errors=True)
    ops.reset_launch_counts()
    t0 = time.time()
    stats = monobeast.train(flags)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    for name in expected:
        check(counts[name] >= updates, f"{label} path launched {name} "
                                       f"{counts[name]} times in {updates} "
                                       "updates")
        if name in bf16:
            want = counts[name] if policy == "bf16_train" else 0
            check(bf16[name] == want, f"{label} path: {bf16[name]} of "
                  f"{counts[name]} {name} launches were bf16")
    # The trunk hands the pool backward its tensors as they are (no layout
    # copy); every launch must have found them channels_last and aligned.
    vector = ops.pool_bwd.vector_launches
    check(vector == counts["pool_bwd"], f"{label} path: {vector} of "
          f"{counts['pool_bwd']} pool_bwd launches took the 16-byte path")
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm"):
        check(key in stats and np.isfinite(stats[key]),
              f"{label} loss stat {key} = {stats.get(key)}")
    print(f"main path {label} 84x84x4 T={T} B={B}: {updates} updates in "
          f"{wall:.1f} s; SPS {stats['sps']:.1f}; median update "
          f"{stats['update_ms_median']:.2f} ms; launches {counts}; bf16 "
          f"launches {bf16}; total_loss {stats['total_loss']:.4f}")
    return counts, bf16


# -------------------------------------------------------------- polybeast

POLY_LABEL = "polybeast deep+LSTM"
# The medians a polybeast run prints: one acting forward's host time, its
# reply's copy, an actor's request round trip, the learner's wait.
P50_SERIES = ("inference.dispatch_s", "inference.reply_s",
              "actor.request_rtt_s", "learner.dequeue")


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_polybeast(ops, savedir, k=1, native=False):
    """The async driver on the card, through its own parser: 16 Mock env
    servers (spawned processes), deep + LSTM at T=80, B=32, the three
    main-path kernels on, `k` updates a dispatch (--superstep_k), the
    Python pool (--no_native_runtime) or, with `native`, the port's C++
    core (--native_runtime; the resume adds --native_server). (1) three
    dispatches (two at k > 1): every kernel launched at least once per
    update, every pool launch on the 16-byte path, finite losses,
    HEALTHY, the runtime asked for (its log line and its pool's class), a
    checkpoint; (2) the same xpid again for one more dispatch: it resumes
    from the checkpoint and runs on; (3) --mode test on that checkpoint:
    one greedy Mock episode returns 200.0. Returns the launch counts of
    (1) and (2)."""
    from torchbeast_tpu_torch import polybeast, telemetry
    from torchbeast_tpu_torch.telemetry.metrics import (
        percentiles_from_buckets)

    xpid = f"chip_smoke_polybeast_k{k}" + ("_native" if native else "")
    label = (POLY_LABEL + (" native runtime" if native else "")
             + ("" if k == 1 else f" superstep_k {k}"))
    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    base = polybeast_argv(savedir, xpid) + ["--superstep_k", str(k)]
    if native:
        base[base.index("--no_native_runtime")] = "--native_runtime"
    phase = label
    runtime, pool = (("native", "_tbt_core_torch.ActorPool") if native
                     else ("python", "torchbeast_tpu_torch.runtime."
                           "actor_pool.ActorPool"))
    dispatches = 3 if k == 1 else 2
    parse = polybeast.make_parser().parse_args
    lines = _Lines()
    logging.getLogger("torchbeast_tpu_torch").addHandler(lines)
    logging.getLogger("torchbeast_tpu_torch").setLevel(logging.INFO)
    by_path = {}
    try:
        runs = []
        reg = telemetry.get_registry()
        before = {name: dict(reg.histogram(name).merged().buckets)
                  for name in P50_SERIES}
        for label, steps, extra in (
                (label, dispatches * k * T * B, []),
                (label + " resume", (dispatches + 1) * k * T * B,
                 ["--native_server"] if native else [])):
            lines.lines.clear()
            ops.reset_launch_counts()
            t0 = time.time()
            stats = polybeast.train(parse(base + extra + [
                "--total_steps", str(steps)]))
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
            by_path[label] = (counts, bf16)
            updates = stats["updates"]
            check(updates >= 1, f"{label}: no update ran")
            for name, per_update in (("vtrace_targets", 1),
                                     ("rmsprop_tail", 1), ("pool_bwd", 3)):
                check(counts[name] >= per_update * updates * k,
                      f"{label}: {counts[name]} {name} launches in "
                      f"{updates} dispatches of {k}")
            vector = ops.pool_bwd.vector_launches
            check(vector == counts["pool_bwd"], f"{label}: {vector} of "
                  f"{counts['pool_bwd']} pool_bwd launches took the 16-byte "
                  "path")
            for key in ("total_loss", "pg_loss", "baseline_loss",
                        "entropy_loss", "grad_norm"):
                check(key in stats and np.isfinite(stats[key]),
                      f"{label} loss stat {key} = {stats.get(key)}")
            check(stats["health"] == "HEALTHY",
                  f"{label}: health {stats['health']}")
            check(stats["runtime"] == runtime and stats["actor_pool"] == pool,
                  f"{label}: runtime {stats['runtime']}, pool "
                  f"{stats['actor_pool']}")
            if native:
                used = [m for m in lines.lines
                        if m.startswith("Using the native (C++) runtime")]
                check(used, f"{label}: the log does not name the native "
                            "runtime")
            ckpt = os.path.join(savedir, xpid, "model.ckpt")
            check(os.path.exists(ckpt), f"{label}: no {ckpt}")
            print(f"{label} 84x84x4 T={T} B={B}, 16 env servers: "
                  f"{updates} dispatches of {k} to step {stats['step']} in "
                  f"{wall:.1f} s; SPS {stats['sps']:.1f}; median update "
                  "interval on the shared stream "
                  f"{stats['update_interval_ms_median']:.2f} ms; mean "
                  f"inference batch {stats['inference_batch_mean']:.2f}; "
                  f"launches {counts}; per update "
                  f"{ {k: round(v / updates, 2) for k, v in counts.items()} }"
                  f"; total_loss {stats['total_loss']:.4f}")
            if not runs:
                # This run's own samples: the registry's series are the
                # process's.
                p50 = {name: 1000 * percentiles_from_buckets({
                    i: n - before[name].get(i, 0) for i, n in
                    reg.histogram(name).merged().buckets.items()}, [0.5])[0]
                    for name in P50_SERIES}
                print(f"{label}: SPS from the second batch to the last "
                      f"{_steady_sps(os.path.join(savedir, xpid, 'logs.csv'))}"
                      f"; medians: one acting forward's host time "
                      f"{p50['inference.dispatch_s']:.2f} ms, its reply's "
                      f"copy {p50['inference.reply_s']:.2f} ms, an actor's "
                      f"request round trip {p50['actor.request_rtt_s']:.2f}"
                      f" ms, the learner's wait for a batch "
                      f"{p50['learner.dequeue']:.2f} ms")
            runs.append((stats, lines.lines[:]))
        (first, _), (second, logged) = runs
        resumed = [m for m in logged if m.startswith(
            "Resuming preempted job")]
        check(resumed, "the second run did not resume")
        check(f"'step': {first['step']}" in resumed[0],
              f"the second run resumed from {resumed[0][:200]}")
        check(first["step"] >= dispatches * k * T * B
              and second["step"] > first["step"],
              f"steps {first['step']} then {second['step']}")
        returns = polybeast.main(parse(base + ["--mode", "test",
                                               "--num_test_episodes", "1"]))
        check(returns == [200.0], f"--mode test returned {returns}")
        print(f"{phase}: resumed from step {first['step']} to "
              f"{second['step']} ({second['updates']} updates); --mode test "
              f"on its checkpoint returned {returns}")
    finally:
        logging.getLogger("torchbeast_tpu_torch").removeHandler(lines)
    return by_path


# The reference's series a polybeast line carries with the serving tier
# and a chaos plan armed (its final line on the Python runtime).
CHAOS_SERIES = {
    "counters": ("serving.admitted", "serving.shed", "serving.expired",
                 "serving.resubmitted", "serving.replica_requests",
                 "serving.central_requests", "serving.snapshots_published",
                 "chaos.env_server_sigkill.injected",
                 "chaos.transport_sever.injected",
                 "chaos.learner_stall.injected",
                 "chaos.state_table_poison.injected",
                 "recovery.server_restarts", "recovery.actor_reconnects",
                 "recovery.inference_restarts", "recovery.table_rebuilds",
                 "learner.updates", "slo.rtt_breaches"),
    "gauges": ("serving.queue_delay_p99_s", "serving.slo_ratio",
               "serving.snapshot_lag", "actor.live", "health.state",
               "acting.bytes_per_step_up"),
    "histograms": ("serving.queue_delay_s", "serving.policy_lag",
                   "actor.request_rtt_s", "inference.request_wait_s",
                   "learner.update_dispatch_s"),
}
CHAOS_UPDATES = 7  # build_plan's first fault, at 0.15 of the run, lands
#                    after the first batch: 0.15 * 7 > 1 update
# Each fault's recovery counter and how far past the injection it must
# move: a SIGKILL's server respawn, a sever's reconnect, the first update
# dispatched after a stall, a poison's table rebuild.
RECOVERY = {"env_server_sigkill": "recovery.server_restarts",
            "transport_sever": "recovery.actor_reconnects",
            "learner_stall": "learner.updates",
            "state_table_poison": "recovery.table_rebuilds"}


class _CounterTimes:
    """Samples counters on a thread of its own every 10 ms and keeps the
    times at which each first passed each of its values."""

    def __init__(self, reg, names):
        self._counters = {n: reg.counter(n) for n in names}
        self.times = {n: [] for n in names}  # (value, first seen at)
        self._stop = None
        self._thread = None

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.01):
            now = time.monotonic()
            for name, counter in self._counters.items():
                value = counter.value()
                seen = self.times[name]
                if not seen or value > seen[-1][0]:
                    seen.append((value, now))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False

    def first(self, name, above, after):
        """When `name` first read more than `above`, not before `after`."""
        for value, at in self.times[name]:
            if value > above and at >= after:
                return at
        return None

    def value_at(self, name, at, default):
        """The value `name` read last before `at` (a recovery within the
        injection's own 10 ms sample reads as 0 s, not as none)."""
        value = default
        for v, seen in self.times[name]:
            if seen < at:
                value = v
        return value


def run_polybeast_chaos(ops, savedir, native):
    """5l. polybeast deep + LSTM at f32, T=80, B=32, 16 Mock env servers
    on shm rings, the kernel switches, with the serving tier
    (--request_deadline_ms 300, --replica_refresh_updates 1,
    --max_policy_lag 20) and chaos_run.build_plan's plan (one SIGKILL,
    one sever, a 3 s learner stall, one poison, each after the first
    batch), on the Python pool or on the core with --native_server,
    through chaos_run.run_one and held by chaos_run's own checks; plus
    the replica path, the telemetry lines and the kernels. Recovery is
    timed from the registry's counters, sampled every 10 ms; on the core
    the reconnect count reaches the registry at the monitor's 5 s fold,
    so there the sever's time is an upper bound. Returns the launch
    counts."""
    from torchbeast_tpu_torch import chaos_run, telemetry
    from torchbeast_tpu_torch.telemetry.metrics import (
        percentiles_from_buckets)

    label = ("polybeast deep+LSTM serving + chaos"
             + (" native runtime" if native else ""))
    xpid = "chip_smoke_chaos" + ("_native" if native else "")
    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    args = chaos_run.parse_args([
        "--scale", "1", "--num_servers", "16", "--num_actors", "16",
        "--total_steps", str(CHAOS_UPDATES * T * B), "--stall_s", "3",
        "--request_deadline_ms", "300", "--replica_refresh_updates", "1",
        "--max_policy_lag", "20"] + (["--native"] if native else []))
    plan_dict = chaos_run.build_plan(args)
    plan_counts = {}
    for fault in plan_dict["faults"]:
        check(fault["at_step"] >= T * B, f"{label}: {fault} fires before "
              "the first batch")
        plan_counts[fault["kind"]] = plan_counts.get(fault["kind"], 0) + 1
    plan_path = os.path.join(savedir, f"{xpid}_plan.json")
    os.makedirs(savedir, exist_ok=True)
    with open(plan_path, "w") as f:
        json.dump(plan_dict, f)
    argv = polybeast_argv(savedir, xpid)
    argv[argv.index("--pipes_basename") + 1] = \
        f"shm:{savedir}/pipes-{xpid}"
    if native:
        argv[argv.index("--no_native_runtime")] = "--native_runtime"
        argv.append("--native_server")
    argv += ["--total_steps", str(args.total_steps),
             "--request_deadline_ms", "300", "--replica_refresh_updates",
             "1", "--max_policy_lag", "20", "--chaos_plan", plan_path,
             "--checkpoint_interval_s", "100000",
             "--learner_stall_timeout_s", "60"]

    reg = telemetry.get_registry()
    hist = ("inference.request_wait_s", "replica.request_wait_s",
            "serving.queue_delay_s", "replica.dispatch_s",
            "serving.policy_lag")
    before = {name: dict(reg.histogram(name).merged().buckets)
              for name in hist}
    watched = [f"chaos.{kind}.injected" for kind in RECOVERY] + \
        sorted(set(RECOVERY.values()))
    at_start = {name: reg.counter(name).value() for name in watched}
    ops.reset_launch_counts()
    t0 = time.time()
    with _CounterTimes(reg, watched) as times:
        run = chaos_run.run_one(args, savedir, xpid, plan_path, argv=argv)
    torch.cuda.synchronize()
    phase_s = time.time() - t0
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    stats = run["stats"]

    # chaos_run's own checks: completion, exact recovery accounting, the
    # shed audit, no leaked process or segment.
    expected = chaos_run.expected_counters(plan_counts, 1)
    serving, shed_failures = chaos_run.check_shedding(run, plan_counts, 300)
    failures = (chaos_run.check_completion(run, args.total_steps)
                + chaos_run.check_recovery(run, plan_counts, expected)
                + shed_failures + chaos_run.check_leaks(run))
    check(not failures, f"{label}: {failures}")
    check(run["chaos"]["pending"] == [] and run["chaos"]["abandoned"] == [],
          f"{label}: chaos summary {run['chaos']}")
    check(serving["shed"] + serving["expired"] > 0, f"{label}: no shed")
    counters = run["counters"]
    check(counters.get("serving.replica_requests", 0) > 0,
          f"{label}: no replica request served")
    lag = {i: n - before["serving.policy_lag"].get(i, 0) for i, n in
           reg.histogram("serving.policy_lag").merged().buckets.items()}
    check(sum(lag.values()) > 0 and
          percentiles_from_buckets(lag, [0.0])[0] <= 20,
          f"{label}: no replica reply stamped a policy_lag within 20")

    lines = telemetry.read_jsonl(os.path.join(savedir, xpid,
                                              "telemetry.jsonl"))
    check(lines, f"{label}: no telemetry.jsonl lines")
    for line in lines:
        errors = telemetry.validate_snapshot(line)
        check(not errors, f"{label}: telemetry line invalid: {errors}")
    last = lines[-1]
    missing = [(kind, name) for kind, names in CHAOS_SERIES.items()
               for name in names if name not in last[kind]]
    check(not missing, f"{label}: the last telemetry line lacks {missing}")
    check(last.get("chaos") == run["chaos"] and "slo" in last
          and last.get("acting_path", {}).get("agent_state")
          == "device_table", f"{label}: statics {sorted(last)}")

    updates = stats["updates"]
    for name, per_update in (("vtrace_targets", 1), ("rmsprop_tail", 1),
                             ("pool_bwd", 3)):
        check(counts[name] >= per_update * updates,
              f"{label}: {counts[name]} {name} launches in {updates} "
              "updates")
    vector = ops.pool_bwd.vector_launches
    check(vector == counts["pool_bwd"], f"{label}: {vector} of "
          f"{counts['pool_bwd']} pool_bwd launches took the 16-byte path")
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm"):
        check(key in stats and np.isfinite(stats[key]),
              f"{label} loss stat {key} = {stats.get(key)}")

    def pct(q, *names):
        """This run's percentile of the named series together, in ms."""
        delta = {}
        for name in names:
            for i, n in reg.histogram(name).merged().buckets.items():
                delta[i] = delta.get(i, 0) + n - before[name].get(i, 0)
        return 1000 * percentiles_from_buckets(delta, [q])[0]

    # The Python runtime keeps the replica batcher's waits apart
    # (replica.*); the core's fold credits both batchers to inference.*.
    wait = ("inference.request_wait_s", "replica.request_wait_s")

    recover = {}
    for kind, counter in RECOVERY.items():
        injected = times.first(f"chaos.{kind}.injected",
                               at_start[f"chaos.{kind}.injected"], 0)
        back = None
        if injected is not None:
            # A stall's recovery is the first update dispatched after
            # its window, not one already in flight when it began.
            after = injected + (3.0 if kind == "learner_stall" else 0.0)
            back = times.first(counter, times.value_at(
                counter, after, at_start[counter]), after)
        recover[kind] = (None if back is None
                         else round(back - injected, 3))
    print(f"{label} 84x84x4 T={T} B={B}, 16 env servers on shm rings: "
          f"{updates} updates to step {stats['step']} in {phase_s:.1f} s "
          f"(the phase); SPS {stats['sps']:.1f}; injected "
          f"{run['chaos']['injected']}; recovery counters "
          f"{ {k: int(counters.get(k, 0)) for k in expected} } (expected "
          f"{expected}); serving {serving}; replica requests "
          f"{int(counters.get('serving.replica_requests', 0))}, central "
          f"{int(counters.get('serving.central_requests', 0))}; health "
          f"{stats['health']}")
    print(f"{label}: an inference request's wait (central and replica) "
          f"p50 {pct(0.5, *wait):.2f} ms p99 {pct(0.99, *wait):.2f} ms; "
          f"serving queue delay p50 {pct(0.5, 'serving.queue_delay_s'):.2f}"
          f" ms p99 {pct(0.99, 'serving.queue_delay_s'):.2f} ms; replica "
          f"forward host p50 {pct(0.5, 'replica.dispatch_s'):.2f} ms p99 "
          f"{pct(0.99, 'replica.dispatch_s'):.2f} ms; seconds from "
          f"injection to recovery {recover}; launches {counts}; "
          f"telemetry lines {len(lines)}")
    return {label: (counts, bf16)}


def _steady_sps(logs_csv):
    """Env frames per second from the second batch's arrival to the last
    one's, leaving out the env servers' start-up and the first rollouts:
    the learner logs an update's row when it has launched the next
    update, so each row but the last is stamped when a batch came in.
    None below three rows."""
    with open(logs_csv) as f:
        rows = [r for r in csv.DictReader(f) if r.get("step")]
    if len(rows) < 3:
        return None
    first, last = rows[0], rows[-2]
    dt = float(last["_time"]) - float(first["_time"])
    return (int(last["step"]) - int(first["step"])) / dt if dt > 0 else None


def check_checkpoint_round_trip(dev):
    """A deep + LSTM train state on the card, saved and loaded into a
    fresh model and optimizer: params, nu and master bitwise equal, the
    count restored; bf16_train with --opt_impl pallas and f32 with xla."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import monobeast
    from torchbeast_tpu_torch.utils import checkpoint

    path = os.path.join(ROOT, "build", "chip_smoke", "round_trip.ckpt")
    for policy, opt_impl in (("bf16_train", "pallas"), ("f32", "xla")):
        states = []
        for seed in (0, 1):
            flags = monobeast.make_parser().parse_args([
                "--env", "Mock", "--model", "deep", "--use_lstm",
                "--precision", policy, "--opt_impl", opt_impl,
                "--seed", str(seed)])
            model = monobeast.build_model(flags, NUM_ACTIONS, (84, 84, 4),
                                          dev)
            optimizer = learner_lib.make_optimizer(
                monobeast.hparams_from_flags(flags),
                list(model.parameters()))
            gen = torch.Generator(device=dev).manual_seed(seed)
            with torch.no_grad():
                for t in [*optimizer.state.nu,
                          *(optimizer.state.master or [])]:
                    t.copy_(torch.rand(t.shape, device=dev, generator=gen))
            optimizer.state = optimizer.state._replace(count=5 + seed)
            states.append((model, optimizer))
        (m0, o0), (m1, o1) = states
        t0 = time.time()
        checkpoint.save_train_state(path, m0, o0, step=T * B)
        t1 = time.time()
        step = checkpoint.load_train_state(path, m1, o1)["step"]
        t2 = time.time()
        check(step == T * B and o1.state.count == 5,
              f"round trip: step {step}, count {o1.state.count}")
        pairs = [*zip(m0.parameters(), m1.parameters()),
                 *zip(o0.state.nu, o1.state.nu),
                 *zip(o0.state.master or [], o1.state.master or [])]
        check(all(a.dtype == b.dtype and b.is_cuda and torch.equal(a, b)
                  for a, b in pairs),
              f"{policy} {opt_impl}: a leaf differs after the round trip")
        print(f"checkpoint round trip {policy} --opt_impl {opt_impl} on the "
              f"card: {len(pairs)} tensors bitwise equal, "
              f"{os.path.getsize(path)} bytes, save {t1 - t0:.2f} s, load "
              f"{t2 - t1:.2f} s")
    print("msgpack importable on this machine: "
          f"{importlib.util.find_spec('msgpack') is not None} (the port "
          "does not use it)")


# ----------------------------------------------------------------- graphs

# Device kernel name marks of the port's kernels, by wrapper.
KERNEL_MARKS = {"vtrace_targets": "vtrace_targets_kernel",
                "rmsprop_tail": "rmsprop_tail_kernel",
                "pool_bwd": "pool_bwd_kernel",
                "transformer_attention": "attention_fwd_kernel",
                "transformer_attention_bwd": "attention_bwd_kernel"}


def profile_call(fn, windows=3):
    """(the host's CUDA API calls of one fn() by name, without the
    synchronize that ends the window; the device kernels it ran by
    wrapper), by torch.profiler. The first window after start-up can
    miss events, so it is not counted. CUPTI can also drop a kernel's
    record from a later window (seen with the tail's cooperative launch
    inside a graph replay: 0 of 1 and 3 of 4 recorded, the replay's
    results bitwise right), and fn() runs the same kernels every time,
    so each wrapper's count is the most that one of `windows` windows
    recorded; the API calls are the last window's."""
    from torch.profiler import ProfilerActivity, profile
    from torchbeast_tpu_torch.profile_update import api_calls

    path = os.path.join(ROOT, "build", "chip_smoke", "call_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    kernels = dict.fromkeys(KERNEL_MARKS, 0)
    for window in range(windows + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if window == 0:
            continue
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = [ev.get("name", "") for ev in events
                 if ev.get("cat") == "kernel"]
        for w, mark in KERNEL_MARKS.items():
            kernels[w] = max(kernels[w], sum(mark in n for n in names))
    calls = {k: v for k, v in api_calls(events).items()
             if "ynchronize" not in k}
    return calls, kernels


def check_graph_update(dev, label, model_name, policy, k):
    """Two dispatches of the learner's CUDA graph (learner.
    make_update_dispatch: K updates a replay) against 2K eager updates
    (update_body) of a copy from the same state, on the same batches,
    with the LR decay and the entropy anneal moving every update: TF32
    off and cuDNN deterministic, params, nu, the master and every stat
    must be bitwise equal, and the device count must read 2K. One
    replay, profiled: the host's API calls and the port kernels it ran,
    K times the eager update's."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import nest, precision

    pol = precision.get(policy)
    model_g, _ = _param_tree(dev, model_name, policy)
    model_e = copy.deepcopy(model_g)
    hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                             vtrace_impl="pallas", opt_impl="pallas",
                             param_dtype=pol.param_dtype,
                             opt_state_dtype=pol.opt_state_dtype,
                             total_steps=20 * T * B,
                             entropy_cost_final=1e-4)
    opt_g = learner_lib.make_optimizer(hp, list(model_g.parameters()))
    opt_e = learner_lib.make_optimizer(hp, list(model_e.parameters()))
    state = (model_g.initial_state(B, dev) if model_name == "deep"
             else random_cache(model_g, 0, dev))
    state = precision.cast_batch(state, pol.batch_dtype)
    batches = [precision.cast_batch(random_batch(i, dev), pol.batch_dtype)
               for i in range(2 * k)]
    eager = learner_lib.update_body(model_e, opt_e, hp)
    want = [eager(b, state) for b in batches]
    dispatch = learner_lib.make_update_dispatch(model_g, opt_g, hp, k)

    def inputs(d):
        group = batches[d * k:(d + 1) * k]
        if k == 1:
            return group[0], state
        return ({key: torch.stack([b[key] for b in group])
                 for key in group[0]},
                nest.map(lambda s: torch.stack([s] * k), state))

    got = [dispatch(*inputs(d)) for d in range(2)]
    torch.cuda.synchronize()
    check(opt_g.state.count == 2 * k and int(opt_g.device_count) == 2 * k,
          f"{label} K={k}: counts {opt_g.state.count} (host), "
          f"{int(opt_g.device_count)} (device)")
    st_g, st_e = opt_g.state, opt_e.state
    pairs = [*zip(model_g.parameters(), model_e.parameters()),
             *zip(st_g.nu, st_e.nu),
             *zip(st_g.master or [], st_e.master or [])]
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    stats_differ = [
        key for key in want[0]
        if not torch.equal(torch.stack([g[key].reshape(-1) for g in got])
                           .reshape(-1),
                           torch.stack([w[key].float() for w in want]))]
    check(differ == 0 and not stats_differ,
          f"{label} K={k}: {differ} of {len(pairs)} tensors and stats "
          f"{stats_differ} differ between the graph and the eager updates")
    eager_calls, eager_kernels = profile_call(lambda: eager(batches[0], state))
    calls, kernels = profile_call(lambda: dispatch(*inputs(0)))
    for w, n in eager_kernels.items():
        check(kernels[w] == k * n,
              f"{label} K={k}: one replay ran {kernels[w]} {w} kernels, "
              f"one eager update {n}")
    check(calls.get("cudaGraphLaunch", 0) == 1,
          f"{label} K={k}: {calls.get('cudaGraphLaunch', 0)} graph launches "
          "in one dispatch")
    print(f"graph update {label} K={k}: 2 dispatches bitwise equal to "
          f"{2 * k} eager updates ({len(pairs)} tensors, {len(want[0])} "
          f"stats; TF32 off, cuDNN deterministic); one dispatch: "
          f"{sum(calls.values())} host API calls {calls}, against "
          f"{sum(eager_calls.values())} for one eager update; port kernels "
          f"per replay { {w: n for w, n in kernels.items() if n} }")


def check_graph_acting(dev):
    """Acting graphs against eager forwards from the same generator
    state, bitwise: monobeast's step (learner.make_act_step) at B=32 for
    five chained steps (actions, logits, baseline and the LSTM state),
    and polybeast's state-table step at each bucket of
    --max_inference_batch_size 32 (the captured table against an eager
    twin on the same weights; the outputs, then every slot's state)."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch.runtime.inference import (
        default_buckets, pad_advance, pad_slots)
    from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable

    model, _ = _param_tree(dev, "deep", "f32")
    gens = [torch.Generator(device=dev).manual_seed(5) for _ in range(2)]
    act = learner_lib.make_act_step(model, dev, gens[0])
    host = {k: v[0].cpu().numpy() for k, v in random_batch(1, dev).items()}
    s_g = s_e = model.initial_state(B, dev)
    for i in range(5):
        out_g, s_g = act(host, s_g)
        with torch.no_grad():
            out_e, s_e = learner_lib.act_body(
                model, {k: torch.as_tensor(host[k]).to(dev)
                        for k in learner_lib.MODEL_INPUT_KEYS}, s_e, gens[1])
        same = [torch.equal(a, b) for a, b in (*zip(out_g, out_e),
                                               *zip(s_g, s_e))]
        check(all(same), f"monobeast acting graph step {i}: {same} "
              "(action, logits, baseline, h, c) equal to the eager step")
    calls, _ = profile_call(lambda: act(host, s_g)[0].action.cpu())
    print(f"graph acting monobeast deep+LSTM B={B}: 5 chained steps bitwise "
          f"equal to eager (actions, logits, baseline, state); one step "
          f"{sum(calls.values())} host API calls {calls}")

    slots, buckets = 40, default_buckets(32)
    gens = [torch.Generator(device=dev).manual_seed(6) for _ in range(2)]
    tables = []
    for gen in gens:
        def act_fn(ctx, env, state, gen=gen):
            out, new_state = learner_lib.act_body(
                model, {k: env[k][0] for k in learner_lib.MODEL_INPUT_KEYS},
                state, gen)
            return {"action": out.action[None].to(torch.int32),
                    "policy_logits": out.policy_logits[None],
                    "baseline": out.baseline[None]}, new_state
        tables.append(DeviceStateTable(model.initial_state(1, dev), slots,
                                       act_fn, batch_dim=1))
    captured, eager_table = tables
    rng = np.random.default_rng(2)

    def env(n):
        return {"frame": rng.integers(0, 256, (1, n, 84, 84, 4), np.uint8),
                "reward": rng.standard_normal((1, n)).astype(np.float32),
                "done": rng.random((1, n)) < 0.1,
                "last_action": rng.integers(0, NUM_ACTIONS, (1, n)).astype(
                    np.int32)}

    captured.capture(buckets, env, gens[0])
    for b in buckets:
        n = max(1, b - 1) if b > 2 else b  # padded rows at most buckets
        ids = pad_slots(rng.choice(slots, n, replace=False), b,
                        captured.trash_slot)
        advance = pad_advance(rng.random(n) < 0.8, b)
        e = {k: np.concatenate([v, np.repeat(v[:, -1:], b - n, 1)], 1)
             for k, v in env(n).items()}
        got = captured.fetch(captured.step(ids, advance, e), n)
        want = eager_table.fetch(eager_table.step(ids, advance, e), n)
        check(all(np.array_equal(got[k], want[k]) for k in want),
              f"polybeast acting graph at bucket {b}: outputs differ")
    for slot in range(slots):
        check(all(np.array_equal(a, c) for a, c in zip(
            captured.read_slot(slot), eager_table.read_slot(slot))),
            f"polybeast acting graph: slot {slot}'s state differs")
    print(f"graph acting polybeast state table deep+LSTM: buckets {buckets} "
          f"bitwise equal to the eager table (actions, logits, baseline; "
          f"all {slots} slots' states)")


def check_graph_replica(dev):
    """The state table's replica graphs (one per bucket of
    --max_inference_batch_size 32, bound to a replica params buffer and
    captured beside the central graphs) against an eager twin table with
    its own buffer, from the same generator state: at each bucket, the
    outputs and then every slot's state bitwise, before and after one
    snapshot refresh (a new version the buffers load before acting)."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch.runtime.inference import (
        default_buckets, pad_advance, pad_slots)
    from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable
    from torchbeast_tpu_torch.serving import PolicySnapshotStore
    from torchbeast_tpu_torch.telemetry.metrics import MetricsRegistry

    model, _ = _param_tree(dev, "deep", "f32")
    store = PolicySnapshotStore(1, registry=MetricsRegistry())
    store.note_update(0)
    store.publish(0, list(model.parameters()))
    slots, buckets = 40, default_buckets(32)
    gens = [torch.Generator(device=dev).manual_seed(8) for _ in range(2)]
    central_gen = torch.Generator(device=dev).manual_seed(9)

    def forward(acting_model, gen):
        def act(env, state):
            out, new_state = learner_lib.act_body(
                acting_model,
                {k: env[k][0] for k in learner_lib.MODEL_INPUT_KEYS},
                state, gen)
            return {"action": out.action[None].to(torch.int32),
                    "policy_logits": out.policy_logits[None],
                    "baseline": out.baseline[None]}, new_state
        return act

    tables = []
    for gen in gens:
        replica = copy.deepcopy(model).requires_grad_(False)
        central = forward(model, central_gen)
        table = DeviceStateTable(
            model.initial_state(1, dev), slots,
            lambda ctx, env, state, central=central: central(env, state),
            batch_dim=1)
        table.bind_context(forward(replica, gen),
                           list(replica.parameters()))
        tables.append(table)
    captured, eager_table = tables
    rng = np.random.default_rng(4)

    def env(n):
        return {"frame": rng.integers(0, 256, (1, n, 84, 84, 4), np.uint8),
                "reward": rng.standard_normal((1, n)).astype(np.float32),
                "done": rng.random((1, n)) < 0.1,
                "last_action": rng.integers(0, NUM_ACTIONS, (1, n)).astype(
                    np.int32)}

    t0 = time.time()
    captured.capture(buckets, env, central_gen)
    captured.capture_context(buckets, env, gens[0])
    capture_s = time.time() - t0
    for version in (0, 1):
        if version:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0.01 * torch.randn_like(p))
            store.note_update(1)
            store.publish(1, list(model.parameters()))
        context = store.latest()
        check(context[0] == version, f"snapshot version {context[0]}")
        for b in buckets:
            n = max(1, b - 1) if b > 2 else b
            ids = pad_slots(rng.choice(slots, n, replace=False), b,
                            captured.trash_slot)
            advance = pad_advance(rng.random(n) < 0.8, b)
            e = {k: np.concatenate([v, np.repeat(v[:, -1:], b - n, 1)], 1)
                 for k, v in env(n).items()}
            got = captured.fetch(captured.step(ids, advance, e, context), n)
            want = eager_table.fetch(
                eager_table.step(ids, advance, e, context), n)
            check(all(np.array_equal(got[k], want[k]) for k in want),
                  f"replica graph at bucket {b}, snapshot {version}: "
                  "outputs differ from the eager twin")
            check(captured.context_version == version,
                  f"replica buffer holds {captured.context_version}")
        for slot in range(slots):
            check(all(np.array_equal(a, c) for a, c in zip(
                captured.read_slot(slot), eager_table.read_slot(slot))),
                f"replica graph, snapshot {version}: slot {slot} differs")
    print(f"graph acting replica state table deep+LSTM: buckets {buckets} "
          f"captured beside the central graphs in {capture_s:.1f} s, bitwise "
          f"equal to the eager twin before and after a snapshot refresh "
          f"(actions, logits, baseline; all {slots} slots' states)")


# ----------------------------------------------------------------- parity

# bf16 parity (bf16_compute, bf16_train): the bf16 forward and backward of
# the convolutions and products run the same cuDNN/cuBLAS kernels in both
# updates; what differs is the port's kernels against their plain
# versions: the attention forward's bf16 out by one ulp here and there,
# the attention backward's Delta from that bf16 out, the tail's bf16 nu
# by one ulp where two f32 values straddle a rounding boundary. Each
# leaf's change of its f32 weights (the master under bf16_train) and its
# nu within a limit (in norm) of the plain update's, and the stats within
# a relative limit, set per model from what an H100 read: the deep model,
# whose pool backward is exact and whose forward has no port kernel, read
# 7.1e-7 (0 at bf16_compute) and stats equal; the transformer read 1.63e-2
# (nu of block_0.k.bias at bf16_compute, a gradient near 0 in exact
# arithmetic), its stats within rtol 1e-2 (largest gap 1.77).
PARITY_BF16 = {"deep+LSTM": (1e-5, 1e-5), "transformer": (3e-2, 1e-2)}


def _norm_rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_update_parity(ops, dev, label, model_k, state, policy="f32"):
    """One learner update of `model_k` from `state` with the kernels and
    one of its copy with the plain versions, on the same random batch, at
    the precision `policy`."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import precision

    pol = precision.get(policy)
    batch = precision.cast_batch(random_batch(0, dev), pol.batch_dtype)
    state = precision.cast_batch(state, pol.batch_dtype)
    hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                             vtrace_impl="pallas", opt_impl="pallas",
                             param_dtype=pol.param_dtype,
                             opt_state_dtype=pol.opt_state_dtype)
    model_p = copy.deepcopy(model_k)
    start = [p.detach().to(torch.float32, copy=True)
             for p in model_k.parameters()]
    results = []
    for model, plain in ((model_k, False), (model_p, True)):
        optimizer = learner_lib.make_optimizer(hp, list(model.parameters()))
        step = learner_lib.update_body(model, optimizer, hp)
        if plain:
            with ops.plain_on_device():
                stats = step(batch, state)
        else:
            stats = step(batch, state)
        torch.cuda.synchronize()
        results.append((list(model.named_parameters()), optimizer.state,
                        stats))
    (pk, ok_, sk), (pp, op_, sp) = results
    bf16 = policy != "f32"
    worst, failed = (0.0, ""), []
    if bf16:
        limit, stol = PARITY_BF16[label]
        if pol.param_dtype == "bf16":
            for st, named in ((ok_, pk), (op_, pp)):
                check(all(torch.equal(p, m.to(BF16))
                          for (_, p), m in zip(named, st.master)),
                      f"{label} {policy}: params are not bf16(master)")
            wk, wp = ok_.master, op_.master
        else:
            wk, wp = [p.detach() for _, p in pk], [p.detach() for _, p in pp]
        for (name, _), s0, mk, mp, nk, npl in zip(
                pk, start, wk, wp, ok_.nu, op_.nu):
            for what, ei in (("weights change", _norm_rel(mk - s0, mp - s0)),
                             ("nu", _norm_rel(nk.float(), npl.float()))):
                worst = max(worst, (ei, f"{what} {name}"))
                if not ei <= limit:
                    failed.append(f"{what} {name} ({ei:.3g})")
        tol, atol_stats = f"{limit} in norm", 0.0
    else:
        for (name, a), (_, b), na, nb in zip(pk, pp, ok_.nu, op_.nu):
            for what, x, y in (("param", a, b), ("nu", na, nb)):
                ei, ok = close(x.detach(), y.detach(), 1e-5, 1e-8)
                worst = max(worst, (ei, f"{what} {name}"))
                if not ok:
                    failed.append(f"{what} {name} ({ei:.3g})")
        tol, stol, atol_stats = "rtol 1e-5, atol 1e-8", 1e-5, 1e-6
    es, stat_failed = 0.0, []
    for k in sk:
        ei, ok = close(sk[k].float(), sp[k].float(), stol, atol_stats)
        es = max(es, ei)
        if not ok:
            stat_failed.append(f"{k} {float(sk[k])} vs {float(sp[k])}")
    what = ("weights' change/nu norm-relative" if bf16
            else "params/nu max_abs")
    print(f"parity: one {label} update at {policy}, kernels vs plain on the "
          f"card: {what} err {worst[0]:.3g} at {worst[1]} ({tol}), stats "
          f"max_abs_err {es:.3g} (rtol {stol}, atol {atol_stats})")
    check(not failed, f"{label} {policy} update parity: outside "
                      f"tolerance: {failed}")
    check(not stat_failed, f"{label} {policy} update parity: stats "
                           f"{stat_failed}")


def main(argv):
    kernels_only = argv == ["--kernels-only"]
    vtrace_only = argv == ["--vtrace-only"]
    serving_only = argv == ["--serving-only"]
    if argv and not (kernels_only or vtrace_only or serving_only):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from torchbeast_tpu_torch import ops
    from torchbeast_tpu_torch.ops import _build

    os.environ["TBT_POOL_PALLAS"] = "1"
    dev = torch.device("cuda", 0)
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    import sysconfig
    import threading

    from torchbeast_tpu_torch.runtime import native_build

    include = sysconfig.get_paths()["include"]
    print(f"python include {include}: Python.h "
          f"{'present' if os.path.isfile(os.path.join(include, 'Python.h')) else 'MISSING'}")
    # The runtime core compiles with the host C++ compiler while nvcc
    # builds the kernels.
    core_build = {}

    def build_core():
        t = time.time()
        try:
            core_build["path"] = native_build.build()
        except BaseException as e:  # noqa: BLE001  re-raised below
            core_build["error"] = e
        core_build["s"] = time.time() - t

    core_thread = threading.Thread(target=build_core)
    core_thread.start()
    t0 = time.time()
    path = _build.build()
    _build.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s")
    core_thread.join()
    if "error" in core_build:
        raise core_build["error"]
    native_build.load()
    print(f"build: {os.path.relpath(core_build['path'], ROOT)} (the runtime "
          f"core) in {core_build['s']:.1f} s")
    entry = ""
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = kernel_label(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {entry}: {line.strip()}")

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernel checks: TF32 off for matmul and cuDNN")
    savedir = os.path.join(ROOT, "build", "chip_smoke")
    if serving_only:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        check_graph_replica(dev)
        torch.backends.cudnn.deterministic = False
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        for native in (False, True):
            run_polybeast_chaos(ops, savedir, native)
        return 0
    if vtrace_only:
        print(json.dumps({"kernels": [check_vtrace(ops, dev)]}))
        return 0
    kernels = [check_vtrace(ops, dev), check_opt(ops, dev, "deep"),
               check_opt(ops, dev, "transformer"), check_pool(ops, dev),
               *check_attention(ops, dev),
               check_opt(ops, dev, "deep", "bf16_train"),
               check_opt(ops, dev, "transformer", "bf16_train"),
               check_pool(ops, dev, BF16), *check_attention(ops, dev, BF16)]
    torch.cuda.empty_cache()
    for k in kernels:
        lib = ("-" if k["library_ms"] is None
               else f"{k['library_ms']:.4f}")
        print(f"timing {k['name']}: {k['ms']:.4f} ms (median of 20), bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}), plain "
              f"{k['plain_ms']:.4f} ms, library {lib} ms")

    if kernels_only:
        print(json.dumps({"kernels": kernels}))
        return 0
    # Graph against eager, bitwise: the learner's dispatch at K=1 and K=4,
    # the acting steps of both drivers.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for k in (1, 4):
        for label, model_name, policy in (
                ("deep+LSTM", "deep", "f32"),
                ("deep+LSTM bf16_train", "deep", "bf16_train"),
                ("transformer", "transformer", "f32")):
            check_graph_update(dev, label, model_name, policy, k)
            torch.cuda.empty_cache()
    check_graph_acting(dev)
    check_graph_replica(dev)
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32

    by_path = {path[0]: run_main_path(ops, savedir, path) for path in PATHS}
    by_path.update(run_polybeast(ops, savedir))
    by_path.update(run_polybeast(ops, savedir, native=True))
    by_path.update(run_polybeast(ops, savedir, k=2))
    for native in (False, True):
        by_path.update(run_polybeast_chaos(ops, savedir, native))
    check_checkpoint_round_trip(dev)
    for k in kernels:
        # A bf16 row counts its variant's launches; an f32 row the rest.
        wrapper = k.get("wrapper", k["name"])
        k["launches_by_path"] = {
            p: (bf16.get(wrapper, 0) if k.get("bf16")
                else counts[wrapper] - bf16.get(wrapper, 0))
            for p, (counts, bf16) in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for policy in ("f32", "bf16_compute", "bf16_train"):
        model, _ = _param_tree(dev, "deep", policy)
        check_update_parity(ops, dev, "deep+LSTM", model,
                            model.initial_state(B, dev), policy)
        model, _ = _param_tree(dev, "transformer", policy)
        check_update_parity(ops, dev, "transformer", model,
                            random_cache(model, 0, dev), policy)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
