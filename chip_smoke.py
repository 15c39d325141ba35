#!/usr/bin/env python3
"""Smoke test of the PyTorch port (torchbeast_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only | --vtrace-only]

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing the final result line:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the port's CUDA kernels built from the checkout's sources
   (torchbeast_tpu_torch/ops/_build.py), timed;
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
4. main paths: `monobeast.train` through the port's own parser, every
   kernel switch on, T=80, B=32, 3 updates each, at full width:
   (a) deep ResNet + LSTM (84x84x4 frames, 16/32/32 trunk, fc and LSTM
   256); (b) the transformer policy (84x84x4 frames, 2 layers, d_model
   128, 4 heads, memory 64) with --attention_impl pallas; (c), (d) the
   same two at --precision bf16_train. The launch counts are set to 0
   before each path and read after it; each kernel the path is meant to
   launch must show a count above 0 (at bf16_train, every launch of a
   kernel with a bf16 variant must be a bf16 launch, counted apart),
   every pool backward launch must have taken the kernel's 16-byte path
   (the trunk hands it channels_last tensors, uncopied), and every loss
   stat must be finite;
5. parity: one learner update of each model from the same weights and
   batch with the kernels and with the plain versions on the card (TF32
   off, cuDNN deterministic), at f32, bf16_compute and bf16_train;
   params, RMSprop state and loss stats must agree, at the tolerances
   printed.

Then one JSON line with every kernel's numbers, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX or of the JAX package.
"""

import copy
import json
import os
import re
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
    B, NUM_ACTIONS, T, random_batch, random_cache)

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
                kw = dict(lr=4.8e-4 * (1 - step / 10), momentum=momentum,
                          masters=master, **hyper)
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
    step = lambda: opt.rmsprop_tail(p, grads, nu, None, lr=1e-9,  # noqa
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
# (label, flags, the kernels the path must launch, its precision policy).
# At bf16_train every kernel but V-trace (which the reference keeps in
# f32) must launch its bf16 variant.
PATHS = (
    ("deep+LSTM", DEEP_ARGS, DEEP_KERNELS, "f32"),
    ("transformer", TRANSFORMER_ARGS, TRANSFORMER_KERNELS, "f32"),
    ("deep+LSTM bf16_train", DEEP_ARGS, DEEP_KERNELS, "bf16_train"),
    ("transformer bf16_train", TRANSFORMER_ARGS, TRANSFORMER_KERNELS,
     "bf16_train"),
)


def run_main_path(ops, savedir, path):
    """Train 3 updates of one path; return its launch counts, all and
    bf16."""
    from torchbeast_tpu_torch import monobeast

    label, model_args, expected, policy = path
    flags = monobeast.make_parser().parse_args([
        "--env", "Mock", *model_args,
        "--num_actors", str(B), "--batch_size", str(B),
        "--unroll_length", str(T), "--vtrace_impl", "pallas",
        "--opt_impl", "pallas", "--serial_envs", "--precision", policy,
        "--total_steps", str(3 * T * B), "--savedir", savedir,
        "--xpid", f"chip_smoke_{model_args[1]}_{policy}",
    ])
    ops.reset_launch_counts()
    t0 = time.time()
    stats = monobeast.train(flags)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    for name in expected:
        check(counts[name] > 0, f"{label} path launched {name} "
                                f"{counts[name]} times")
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
    print(f"main path {label} 84x84x4 T={T} B={B}: 3 updates in "
          f"{wall:.1f} s; SPS {stats['sps']:.1f}; median update "
          f"{stats['update_ms_median']:.2f} ms; launches {counts}; bf16 "
          f"launches {bf16}; total_loss {stats['total_loss']:.4f}")
    return counts, bf16


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
    if argv and not (kernels_only or vtrace_only):
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

    t0 = time.time()
    path = _build.build()
    _build.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {time.time() - t0:.1f} s")
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
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    savedir = os.path.join(ROOT, "build", "chip_smoke")
    by_path = {path[0]: run_main_path(ops, savedir, path) for path in PATHS}
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
