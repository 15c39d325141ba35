"""Single-host IMPALA trainer on one GPU (counterpart of
torchbeast_tpu/monobeast.py).

Acting is centrally batched: env workers only step environments, every
env step is one `[1, B]` policy forward on the card, and every unroll
ends in updates of the same module the actors read, so the policy lag is
zero. The update step runs the hand-written kernels that the reference's
Pallas switches select: --vtrace_impl pallas (V-trace targets),
--opt_impl pallas (the fused RMSprop tail), on the transformer
--attention_impl pallas (the fused attention, forward and backward; it
runs in every acting step too) and, on the deep model, TBT_POOL_PALLAS=1
in the environment (the max-pool backward). --precision bf16_compute and
bf16_train (and the deprecated --model_dtype bfloat16) run the bf16
variants of those kernels (torchbeast_tpu_torch/precision.py).

The parser takes every flag of the reference with the same name, type,
default and choices, plus --disable_cuda. A flag whose feature the port
does not have yet still parses; set to anything but its default it
raises NotImplementedError naming the ROADMAP.md item that brings it.

The trainer runs on the first CUDA device. Without one it raises, unless
--disable_cuda asks for the CPU.

Run:  python -m torchbeast_tpu_torch.monobeast --env Mock --model deep \\
          --use_lstm --vtrace_impl pallas --opt_impl pallas
      python -m torchbeast_tpu_torch.monobeast --env Mock \\
          --model transformer --attention_impl pallas \\
          --vtrace_impl pallas --opt_impl pallas --precision bf16_train
"""

import argparse
import functools
import logging
import statistics
import time

import numpy as np
import torch

from torchbeast_tpu_torch import learner as learner_lib
from torchbeast_tpu_torch import nest, precision, weights
from torchbeast_tpu_torch.envs import create_env, num_actions_of
from torchbeast_tpu_torch.envs.environment import Environment
from torchbeast_tpu_torch.envs.vec import ProcessEnvPool, SerialEnvPool
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.rollout import (
    PipelinedRolloutCollector,
    RolloutCollector,
    to_host,
)
from torchbeast_tpu_torch.utils import FileWriter

log = logging.getLogger("torchbeast_tpu_torch.monobeast")


def _configure_logging():
    logging.basicConfig(
        format=(
            "[%(levelname)s:%(process)d %(module)s:%(lineno)d "
            "%(asctime)s] %(message)s"
        ),
        level=logging.INFO,
    )


_LATER = "(not in the port yet; see ROADMAP.md)"


def make_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", type=str, default="PongNoFrameskip-v4",
                        help="Mock, Counting, Catch or Memory[-L<n>] "
                             "(Atari ids: " + _LATER + ").")
    parser.add_argument("--mode", default="train",
                        choices=["train", "test"],
                        help="test: " + _LATER)
    parser.add_argument("--xpid", default=None, help="Experiment id.")
    parser.add_argument("--savedir", default="~/logs/torchbeast_tpu",
                        help="Root dir for experiment data.")
    parser.add_argument("--num_actors", type=int, default=8,
                        help="Parallel environments (= acting batch).")
    parser.add_argument("--total_steps", type=int, default=100000,
                        help="Total environment frames to train for.")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="Learner batch size.")
    parser.add_argument("--vtrace_impl", default="associative",
                        choices=["sequential", "associative", "pallas"],
                        help="V-trace recursion: a log-depth scan (the "
                             "default), a loop over t, or the CUDA "
                             "kernel csrc/vtrace.cu ('pallas').")
    parser.add_argument("--unroll_length", type=int, default=80,
                        help="The unroll length (time dimension).")
    parser.add_argument("--model", default="shallow",
                        choices=["shallow", "deep", "mlp", "pipelined_mlp",
                                 "transformer", "pipelined_transformer"],
                        help="Model family: shallow (AtariNet), deep "
                             "(IMPALA ResNet) or transformer (KV-cache "
                             "attention); the others " + _LATER)
    parser.add_argument("--use_lstm", action="store_true",
                        help="Use LSTM in the agent model.")
    parser.add_argument("--precision", default="f32",
                        choices=["f32", "bf16_compute", "bf16_train"],
                        help="Precision policy (torchbeast_tpu_torch/"
                             "precision.py): f32 everywhere; bf16_compute "
                             "runs the trunk in bfloat16; bf16_train also "
                             "the core and heads, with bf16-resident "
                             "params (f32 master), a bf16 RMSprop second "
                             "moment and a bf16 staged batch.")
    parser.add_argument("--model_dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="Deprecated alias: bfloat16 maps to "
                             "--precision bf16_compute (with a warning); "
                             "conflicts with --precision bf16_train.")
    parser.add_argument("--factored_opt_state", action="store_true",
                        help="Factored RMSprop second moment (row/col "
                             "EMAs per matrix; an approximation; --opt_impl "
                             "xla only).")
    parser.add_argument("--trunk_channels", default="",
                        help="Deep-trunk widths as a comma list (e.g. "
                             "32,64,64). Default: 16/32/32.")
    parser.add_argument("--serial_envs", action="store_true",
                        help="Step envs in-process (tests/cheap envs).")
    parser.add_argument("--attention_impl", default="dense",
                        choices=["dense", "pallas"],
                        help="Transformer attention body: 'dense' (a "
                             "materialized mask) or 'pallas' (the CUDA "
                             "kernels csrc/attention.cu).")
    parser.add_argument("--sequence_parallel", type=int, default=0,
                        help=_LATER)
    parser.add_argument("--pipeline_parallel", type=int, default=0,
                        help=_LATER)
    parser.add_argument("--pipeline_microbatches", type=int, default=0,
                        help=_LATER)
    parser.add_argument("--pipeline_stages", type=int, default=0,
                        help=_LATER)
    parser.add_argument("--num_experts", type=int, default=0, help=_LATER)
    parser.add_argument("--expert_parallel", type=int, default=0,
                        help=_LATER)
    parser.add_argument("--sp_strategy", default="ring",
                        choices=["ring", "ulysses"], help=_LATER)
    parser.add_argument("--ring_schedule", default="contiguous",
                        choices=["contiguous", "zigzag"], help=_LATER)
    parser.add_argument("--num_learner_devices", type=int, default=1,
                        help="Data-parallel learner; > 1 " + _LATER)
    parser.add_argument("--device_split", default="", help=_LATER)
    parser.add_argument("--fleet", default=None, help=_LATER)
    parser.add_argument("--min_live_hosts", type=int, default=1,
                        help=_LATER)
    parser.add_argument("--transformer_remat", action="store_true",
                        help=_LATER)
    parser.add_argument("--remat", default=None,
                        help="Rematerialization plan " + _LATER)
    parser.add_argument("--hbm_budget_gb", type=float, default=0.0,
                        help=_LATER)
    parser.add_argument("--opt_impl", default="xla",
                        choices=["xla", "pallas"],
                        help="Optimizer tail: 'xla' runs the torch form of "
                             "the reference's optax chain; 'pallas' the "
                             "fused CUDA kernel csrc/rmsprop_tail.cu.")
    parser.add_argument("--overlap_collect", action="store_true",
                        help="Lag-1 acting behind the learner " + _LATER)
    parser.add_argument("--pipelined_collect", dest="pipelined_collect",
                        action="store_true", default=True,
                        help="Lag-1 pipelined rollout collection "
                             "(default): per env step only the action "
                             "crosses to the host.")
    parser.add_argument("--no_pipelined_collect", dest="pipelined_collect",
                        action="store_false",
                        help="Synchronous collection.")
    parser.add_argument("--superstep_k", type=int, default=1,
                        help="K updates per dispatch; > 1 " + _LATER)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--env_seed", type=int, default=None,
                        help="Base seed for stochastic envs; env i draws "
                             "from env_seed+i.")
    parser.add_argument("--max_env_restarts", type=int, default=10,
                        help="Respawn budget for crashed process-pool "
                             "env workers (0 = fail fast).")
    parser.add_argument("--checkpoint_interval_s", type=int, default=600,
                        help="Checkpoints " + _LATER)
    parser.add_argument("--learner_stall_timeout_s", type=float,
                        default=300.0,
                        help="Learner stall watchdog " + _LATER)
    parser.add_argument("--entropy_cost", type=float, default=0.0006)
    parser.add_argument("--entropy_cost_final", type=float, default=None,
                        help="Linearly anneal the entropy cost to this "
                             "value over total_steps.")
    parser.add_argument("--baseline_cost", type=float, default=0.5)
    parser.add_argument("--discounting", type=float, default=0.99)
    parser.add_argument("--reward_clipping", default="abs_one",
                        choices=["abs_one", "none"])
    parser.add_argument("--loss", default="vtrace",
                        choices=["vtrace", "impact"],
                        help="Objective; impact " + _LATER)
    parser.add_argument("--impact_clip", type=float, default=0.2,
                        help=_LATER)
    parser.add_argument("--replay_reuse", type=int, default=1, help=_LATER)
    parser.add_argument("--target_refresh_updates", type=int, default=8,
                        help=_LATER)
    parser.add_argument("--learning_rate", type=float, default=4.8e-4)
    parser.add_argument("--alpha", type=float, default=0.99,
                        help="RMSProp smoothing constant.")
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--epsilon", type=float, default=0.01,
                        help="RMSProp epsilon.")
    parser.add_argument("--grad_norm_clipping", type=float, default=40.0)
    parser.add_argument("--num_test_episodes", type=int, default=10,
                        help=_LATER)
    parser.add_argument("--profile_dir", default=None, help=_LATER)
    parser.add_argument("--telemetry", dest="telemetry",
                        action="store_true", default=True,
                        help="Telemetry series " + _LATER + "; the port "
                             "emits none.")
    parser.add_argument("--no_telemetry", dest="telemetry",
                        action="store_false",
                        help="Accepted: the port emits no telemetry.")
    parser.add_argument("--telemetry_port", type=int, default=0,
                        help=_LATER)
    parser.add_argument("--telemetry_host", default="127.0.0.1",
                        help=_LATER)
    parser.add_argument("--trace_path", default=None, help=_LATER)
    parser.add_argument("--disable_cuda", action="store_true",
                        help="Run on the CPU (the port's only flag the "
                             "reference lacks; without it and without a "
                             "CUDA device the trainer raises).")
    return parser


# Flags whose feature is outside the port so far -> the ROADMAP.md Queue 1
# item that brings it. Each must stay at its parser default.
NOT_IN_PORT = {
    "mode": "checkpoints",
    "sequence_parallel": "the transformer family",
    "pipeline_parallel": "the transformer family",
    "pipeline_microbatches": "the transformer family",
    "pipeline_stages": "the transformer family",
    "num_experts": "the transformer family",
    "expert_parallel": "the transformer family",
    "sp_strategy": "the transformer family",
    "ring_schedule": "the transformer family",
    "num_learner_devices": "data parallel and the fleet",
    "device_split": "serving",
    "fleet": "data parallel and the fleet",
    "min_live_hosts": "data parallel and the fleet",
    "transformer_remat": "stage remat",
    "remat": "stage remat",
    "hbm_budget_gb": "stage remat",
    "overlap_collect": "overlap and supersteps",
    "superstep_k": "overlap and supersteps",
    "checkpoint_interval_s": "checkpoints",
    "learner_stall_timeout_s": "telemetry",
    "loss": "IMPACT",
    "impact_clip": "IMPACT",
    "replay_reuse": "IMPACT",
    "target_refresh_updates": "IMPACT",
    "num_test_episodes": "checkpoints",
    "profile_dir": "telemetry",
    "telemetry_port": "telemetry",
    "telemetry_host": "telemetry",
    "trace_path": "telemetry",
}


def check_flags(flags) -> None:
    """Raise NotImplementedError for a flag set to a feature the port
    does not have yet."""
    defaults = make_parser().parse_args([])
    for dest, item in NOT_IN_PORT.items():
        value = getattr(flags, dest, getattr(defaults, dest))
        if value != getattr(defaults, dest):
            raise NotImplementedError(
                f"--{dest} {value!r} is not in the port yet: ROADMAP.md "
                f"Queue 1 item '{item}'"
            )


def select_device(flags) -> torch.device:
    """The first CUDA device, or the CPU when --disable_cuda asks for it.
    Never a silent fallback."""
    if getattr(flags, "disable_cuda", False):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --disable_cuda to run on "
            "the CPU"
        )
    return torch.device("cuda", 0)


def hparams_from_flags(flags) -> learner_lib.HParams:
    policy = precision.resolve_flags(flags)
    return learner_lib.HParams(
        discounting=flags.discounting,
        baseline_cost=flags.baseline_cost,
        entropy_cost=flags.entropy_cost,
        entropy_cost_final=getattr(flags, "entropy_cost_final", None),
        reward_clipping=flags.reward_clipping,
        learning_rate=flags.learning_rate,
        rmsprop_alpha=flags.alpha,
        rmsprop_eps=flags.epsilon,
        rmsprop_momentum=flags.momentum,
        grad_norm_clipping=flags.grad_norm_clipping,
        total_steps=flags.total_steps,
        unroll_length=flags.unroll_length,
        batch_size=flags.batch_size,
        vtrace_impl=getattr(flags, "vtrace_impl", "associative"),
        opt_state_dtype=policy.opt_state_dtype,
        param_dtype=policy.param_dtype,
        opt_factored=getattr(flags, "factored_opt_state", False),
        opt_impl=getattr(flags, "opt_impl", "xla"),
        loss=getattr(flags, "loss", "vtrace"),
        impact_clip=getattr(flags, "impact_clip", 0.2),
        replay_reuse=max(1, getattr(flags, "replay_reuse", 1) or 1),
    )


def _make_pool(flags, num_envs):
    # functools.partial (not a lambda): ProcessEnvPool pickles the factory
    # into spawn-context workers.
    env_seed = getattr(flags, "env_seed", None)
    env_fns = [
        functools.partial(
            create_env, flags.env,
            seed=None if env_seed is None else env_seed + i,
        )
        for i in range(num_envs)
    ]
    if flags.serial_envs:
        return SerialEnvPool(env_fns)
    return ProcessEnvPool(env_fns, max_restarts=flags.max_env_restarts)


def _probe_env(flags):
    """One throwaway env instance -> (num_actions, frame shape)."""
    probe = create_env(flags.env)
    n = num_actions_of(probe)
    frame = Environment(probe).initial()["frame"]
    if hasattr(probe, "close"):
        probe.close()
    return int(n), tuple(frame.shape)


def _trunk_channels(flags):
    spec = getattr(flags, "trunk_channels", "")
    if not spec:
        return {}
    if flags.model != "deep":
        raise ValueError("--trunk_channels applies to --model deep only")
    try:
        widths = tuple(int(c) for c in spec.split(","))
    except ValueError:
        widths = ()
    if len(widths) != 3 or any(w < 1 for w in widths):
        raise ValueError(
            f"--trunk_channels {spec!r} must be three positive "
            "comma-separated ints (e.g. 32,64,64)"
        )
    return {"trunk_channels": widths}


def _attention_impl(flags):
    impl = getattr(flags, "attention_impl", "dense")
    if impl == "dense":
        return {}
    if flags.model != "transformer":
        raise ValueError(
            "--attention_impl applies to --model transformer only")
    return {"attention_impl": impl}


def build_model(flags, num_actions, frame_shape, device):
    """The model on `device`, its initial weights drawn from --seed
    without touching the global RNG state, computing in the precision
    policy's dtypes, its params cast to the policy's resident dtype (the
    optimizer is built after, from the cast params)."""
    policy = precision.resolve_flags(flags)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(flags.seed)
        model = create_model(
            flags.model, num_actions=num_actions, use_lstm=flags.use_lstm,
            frame_shape=frame_shape, dtype=policy.compute_dtype,
            head_dtype=policy.head_dtype, **_trunk_channels(flags),
            **_attention_impl(flags),
        )
    return precision.cast_params(model.to(device), policy)


def to_device(batch, device, batch_dtype=None):
    """numpy [T+1, B, ...] batch -> tensors on `device`, float32 leaves
    cast to `batch_dtype` on the host first (precision.cast_batch)."""
    host = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return {
        k: v.to(device, non_blocking=True)
        for k, v in precision.cast_batch(host, batch_dtype).items()
    }


def train(flags):
    """Train; returns the last flushed stats, plus the run's "sps" and
    "update_ms_median" (the median time of one update: CUDA events on the
    card, the host clock on the CPU)."""
    check_flags(flags)
    if flags.num_actors % flags.batch_size != 0:
        raise ValueError(
            "num_actors must be a multiple of batch_size in the sync trainer "
            f"(got {flags.num_actors} vs {flags.batch_size})"
        )
    device = select_device(flags)
    if flags.xpid is None:
        flags.xpid = "torchbeast-tpu-torch-%s" % time.strftime(
            "%Y%m%d-%H%M%S"
        )
    plogger = FileWriter(
        xpid=flags.xpid, xp_args=vars(flags), rootdir=flags.savedir
    )

    hp = hparams_from_flags(flags)
    batch_dtype = precision.resolve_flags(flags).batch_dtype
    num_actions, frame_shape = _probe_env(flags)
    B = flags.num_actors
    T = flags.unroll_length
    model = build_model(flags, num_actions, frame_shape, device)
    optimizer = learner_lib.make_optimizer(
        hp, list(model.parameters()),
        layouts=weights.jax_layouts(model) if hp.opt_factored else None)
    update_step = learner_lib.update_body(model, optimizer, hp)
    act_step = learner_lib.make_act_step(model, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(flags.seed + 2)
    pipelined = getattr(flags, "pipelined_collect", True)
    log.info("Training on %s", device)

    pool = _make_pool(flags, B)
    step = 0
    stats = {}
    update_ms = []
    pending = None  # (timers and device stats of one collect, step)
    try:

        def policy(env_output, agent_state):
            out, new_state = act_step(generator, env_output, agent_state)
            # The lag-1 collector copies outputs to the host itself.
            return (out if pipelined else to_host(out)), new_state

        collector_cls = (
            PipelinedRolloutCollector if pipelined else RolloutCollector
        )
        collector = collector_cls(
            pool, policy, model.initial_state(B, device), unroll_length=T
        )

        def flush_stats(entry):
            timers, device_stats, at_step = entry
            keys = list(device_stats[0])
            # One device -> host copy for every update of the collect.
            rows = torch.stack([
                torch.stack([s[k].float() for k in keys])
                for s in device_stats
            ]).cpu().numpy()
            for t in timers:
                update_ms.append(
                    t[0].elapsed_time(t[1]) if device.type == "cuda"
                    else 1000 * (t[1] - t[0])
                )
            out = learner_lib.episode_stat_postprocess(
                {k: rows[:, j] for j, k in enumerate(keys)}
            )
            out["step"] = at_step
            plogger.log(out)
            return out

        start_time = last_log_time = time.time()
        last_log_step = step
        while step < flags.total_steps:
            batch, initial_agent_state = collector.collect()
            device_stats, timers = [], []
            for i in range(0, B, flags.batch_size):
                sub = to_device(
                    {k: v[:, i : i + flags.batch_size]
                     for k, v in batch.items()},
                    device, batch_dtype,
                )
                # Batch is axis 1 of every state leaf (the transformer's
                # state nests a (k, v, valid) tuple per layer).
                sub_state = precision.cast_batch(nest.map(
                    lambda s: s[:, i : i + flags.batch_size],
                    initial_agent_state,
                ), batch_dtype)
                if device.type == "cuda":
                    t0 = torch.cuda.Event(enable_timing=True)
                    t1 = torch.cuda.Event(enable_timing=True)
                    t0.record()
                    device_stats.append(update_step(sub, sub_state))
                    t1.record()
                else:
                    t0 = time.perf_counter()
                    device_stats.append(update_step(sub, sub_state))
                    t1 = time.perf_counter()
                timers.append((t0, t1))
                step += T * flags.batch_size
            if pending is not None:
                stats = flush_stats(pending)
            pending = (timers, device_stats, step)

            now = time.time()
            if now - last_log_time > 5:
                sps = (step - last_log_step) / (now - last_log_time)
                last_log_time, last_log_step = now, step
                log.info(
                    "Steps %d @ %.1f SPS. Loss %s. %s", step, sps,
                    f"{stats['total_loss']:.4f}"
                    if "total_loss" in stats else "--",
                    f"Return {stats['mean_episode_return']:.1f}."
                    if "mean_episode_return" in stats else "",
                )
        if pending is not None:
            stats = flush_stats(pending)
            pending = None
        elapsed = time.time() - start_time
        successful = True
    except BaseException:
        successful = False
        raise
    finally:
        plogger.close(successful=successful)
        pool.close()
    stats["sps"] = step / elapsed if elapsed > 0 else 0.0
    stats["update_ms_median"] = (
        statistics.median(update_ms) if update_ms else 0.0
    )
    log.info("Learning finished after %d steps.", step)
    return stats


def main(flags):
    _configure_logging()
    return train(flags)  # --mode test raises in check_flags


def cli():
    main(make_parser().parse_args())


if __name__ == "__main__":
    cli()
