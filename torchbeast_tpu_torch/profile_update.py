"""Where the time of the port's learner update and acting step goes on the
GPU, at one of the port's two configurations, both with 84x84x4 frames,
6 actions (MockEnv), T=80, B=32, --vtrace_impl pallas --opt_impl pallas:
deep ResNet + LSTM with TBT_POOL_PALLAS=1 (the default), or the
transformer policy at full width with --attention_impl pallas; at the
precision policy --precision (default f32; bf16_train casts the params,
the batch and the agent state as the driver does).

    python -m torchbeast_tpu_torch.profile_update [deep|transformer]
        [--precision f32|bf16_compute|bf16_train]

Prints the card (nvidia-smi name and power limit), then one JSON line:
the median update time (CUDA events around each update), the median
acting step time (host clock around one synchronized T=1, B=32 forward;
the transformer acts from a cache about 70% valid),
and from a torch.profiler window over UPDATES updates the device time
per update by kernel name (top entries, and every one of the port's own
kernels with its time per call) and by group (the port's own kernels,
convolutions, matrix products, the rest). The device's busy
share is that device time over the unprofiled median update time (the
profiler itself slows the host's launches down). Weights and batch are
random, made from SEED. Needs a CUDA device.

T, B, NUM_ACTIONS, random_batch and random_cache are the configurations'
shape, batch and transformer state, shared with chip_smoke.py.
"""

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from torchbeast_tpu_torch import learner as learner_lib
from torchbeast_tpu_torch import precision
from torchbeast_tpu_torch.models import create_model

T, B = 80, 32
NUM_ACTIONS = 6  # MockEnv
UPDATES, WARMUP, SEED, TOP = 10, 3, 0, 15

# Substrings of device kernel names -> group, tried in order. The port's
# kernels are csrc/'s vtrace_targets_kernel, rmsprop_*, pool_bwd_kernel
# and attention_* (the port runs no library attention kernel). cuDNN's
# convolutions carry a direction (fprop/dgrad/wgrad) or "conv" in their
# names, or run inside cudnn:: (its layout conversions too); cuBLAS's
# Hopper products are sm90_xmma_gemm_*, so a bare "xmma" key would file
# them under convolutions, and its bf16 ones nvjet_*.
GROUPS = (
    ("port kernels", ("vtrace_targets_kernel", "rmsprop_",
                      "pool_bwd_kernel", "attention_")),
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


def main(model_name="deep", policy="f32"):
    if not torch.cuda.is_available():
        raise RuntimeError("profile_update needs a CUDA device")
    if model_name not in ("deep", "transformer"):
        raise ValueError(f"model {model_name!r}: deep or transformer")
    os.environ["TBT_POOL_PALLAS"] = "1"
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)

    pol = precision.get(policy)
    dtypes = dict(dtype=pol.compute_dtype, head_dtype=pol.head_dtype)
    torch.manual_seed(SEED)
    if model_name == "deep":
        model = create_model("deep", NUM_ACTIONS, use_lstm=True, **dtypes)
        config = {"model": "deep", "use_lstm": True, "pool_kernel": True}
    else:
        model = create_model("transformer", NUM_ACTIONS,
                             attention_impl="pallas", **dtypes)
        config = {"model": "transformer", "attention_impl": "pallas"}
    model = precision.cast_params(model.to(device), pol)
    if model_name == "deep":
        state = model.initial_state(B, device)
    else:
        state = random_cache(model, SEED, device)
    hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                             vtrace_impl="pallas", opt_impl="pallas",
                             param_dtype=pol.param_dtype,
                             opt_state_dtype=pol.opt_state_dtype)
    optimizer = learner_lib.make_optimizer(hp, list(model.parameters()))
    update = learner_lib.update_body(model, optimizer, hp)
    # The acting step takes the f32 batch and state, as the driver does;
    # the update the staged ones, cast by the policy.
    host_batch, act_state = random_batch(SEED, device), state
    batch = precision.cast_batch(host_batch, pol.batch_dtype)
    state = precision.cast_batch(state, pol.batch_dtype)

    for _ in range(WARMUP):
        update(batch, state)
    torch.cuda.synchronize()
    update_ms = []
    for _ in range(UPDATES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        update(batch, state)
        end.record()
        torch.cuda.synchronize()
        update_ms.append(start.elapsed_time(end))

    act = learner_lib.make_act_step(model, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    env = {k: v[0].cpu().numpy() for k, v in host_batch.items()}
    act_ms = []
    for i in range(WARMUP + UPDATES):
        t0 = time.perf_counter()
        out, act_state = act(gen, env, act_state)
        out.action.cpu()
        if i >= WARMUP:
            act_ms.append(1e3 * (time.perf_counter() - t0))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(UPDATES):
            update(batch, state)
        torch.cuda.synchronize()

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
        groups[g] = groups.get(g, 0.0) + us / 1e3 / UPDATES
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    print(json.dumps({
        "card": card,
        "config": {**config, "T": T, "B": B, "frames": [84, 84, 4],
                   "vtrace_impl": "pallas", "opt_impl": "pallas",
                   "precision": policy},
        "update_ms_median": statistics.median(update_ms),
        "update_ms_all": update_ms,
        "act_ms_median": statistics.median(act_ms),
        "profiled_updates": UPDATES,
        "device_ms_per_update": device_us / 1e3 / UPDATES,
        # The profiler slows the host's launches down, so the busy share
        # divides the profiled device time by the unprofiled update time.
        "device_busy_share": device_us / 1e3 / UPDATES
        / statistics.median(update_ms),
        "launches_per_update": sum(v[1] for v in kernels.values())
        / UPDATES,
        "ms_per_update_by_group": groups,
        "top_kernels": [
            {"name": n[:120], "ms_per_update": us / 1e3 / UPDATES,
             "calls_per_update": c / UPDATES}
            for n, (us, c) in top
        ],
        # Every launch of the port's own kernels, however small.
        "port_kernels": [
            {"name": n[:120], "ms_per_update": us / 1e3 / UPDATES,
             "calls_per_update": c / UPDATES, "ms_per_call": us / 1e3 / c}
            for n, (us, c) in sorted(kernels.items())
            if _group(n) == "port kernels"
        ],
    }))


def cli():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("model", nargs="?", default="deep",
                        choices=["deep", "transformer"])
    parser.add_argument("--precision", default="f32",
                        choices=precision.CHOICES)
    args = parser.parse_args()
    main(args.model, args.precision)


if __name__ == "__main__":
    cli()
