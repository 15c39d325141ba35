"""Anakin: the fully on-device IMPALA trainer for device envs (counterpart
of torchbeast_tpu/anakin.py).

The Podracer "Anakin" architecture (arXiv:2104.06272): when the env itself
runs on the device, the whole actor-learner iteration runs there too. One
iteration is T acting forwards (learner.act_body at T=1), T steps of the
batched device envs (envs/device_env.py), the [T+1, B] batch assembly,
V-trace, the losses, the backward and the optimizer (learner.update_body).
The reference jits it into one XLA program; on the card the port captures
it into one CUDA graph (graphs.CapturedIteration) and replays it, with no
host in the loop: the carry, the params and the optimizer's state are the
graph's static buffers, updated in place. On the CPU the same body runs
eagerly.

The rollout keeps the host collectors' batch layout and pairing: slot 0
is the boundary step (the carry's env and agent outputs), and the agent
output at slot i is computed from the env output at slot i-1, so the
learner's compute_loss is the drivers' own. `grad_norm` is the gradient's
norm before clipping. The entropy anneal reads the optimizer's count on
the device.

Where the reference keeps a JAX key in the carry, the port keeps none:
the envs' resets and the sampled actions draw from one torch.Generator on
the device, seeded from --seed and registered with the iteration's graph.
Fresh weights are drawn from --seed as the drivers draw theirs.

The parser takes every flag of the reference with the same name, type,
default and choices, plus --disable_cuda. The trainer runs on the first
CUDA device; without one it raises, unless --disable_cuda asks for the
CPU. --num_devices N > 1 shards the envs along B over N devices (the
reference's mesh branch): the initial carry is the one-device run's,
split, each device acts and steps its own shard from a generator of its
own (shard 0 keeps the run's, shard i draws from --seed + i) into its own
batch and gradient, the lead sums the gradients and applies the update,
and every replica takes the lead's params (parallel/dp.py). On the card
each device's part of the iteration is one CUDA graph (its rollout,
forward and backward) and the lead's sum and update one more.
--model pipelined_mlp runs its stage
tower sequentially at its default depth (models/pipelined.py), as the
reference's anakin does. --num_experts N makes the transformer's FFN a
mixture of N experts (models/moe.py) whose load-balance loss joins the
objective; with --num_devices > 1 every forward of the iteration, the T
acting forwards as well as the learner's, routes over the whole batch,
as the reference's one jitted iteration does: the shards exchange their
routing counts in each MoE layer (parallel/dp.py), run in lockstep, and
the iteration runs eagerly.

The checkpoint {savedir}/{xpid}/model.ckpt is the reference's file
(params, opt_state, step, flags, stats; utils/checkpoint.py), written
every --checkpoint_interval_s and at exit, and resumed from at start, so
either package resumes the other's. SIGTERM takes the same clean path as
Ctrl-C (utils/preempt.py); logs.csv gets a row every
--log_interval_updates iterations.

Run:  python -m torchbeast_tpu_torch.anakin --env Catch --total_steps 200000
"""

import argparse
import contextlib
import functools
import logging
import os
import time
from typing import Any, NamedTuple

import torch

from torchbeast_tpu_torch import graphs
from torchbeast_tpu_torch import learner as learner_lib
from torchbeast_tpu_torch import nest, parallel
from torchbeast_tpu_torch.envs.device_env import create_device_env
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.monobeast import hparams_from_flags, select_device
from torchbeast_tpu_torch.utils import FileWriter, install_preemption_handler
from torchbeast_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_train_state,
)

log = logging.getLogger("torchbeast_tpu_torch.anakin")

AGENT_KEYS = ("action", "policy_logits", "baseline")


def _configure_logging():
    """Called from main(), not at import."""
    logging.basicConfig(
        format=(
            "[%(levelname)s:%(process)d %(module)s:%(lineno)d "
            "%(asctime)s] %(message)s"
        ),
        level=logging.INFO,
    )


def _agent_out_dict(out):
    return {key: getattr(out, key) for key in AGENT_KEYS}


class ActorCarry(NamedTuple):
    """Cross-iteration actor state, every leaf a [B, ...] device tensor
    (the agent state in its model's layout): the envs' accounted state,
    the last env and agent outputs (the next batch's boundary slot) and
    the agent state entering the next unroll. No key: see the module
    docstring."""

    env_state: Any  # device_env.AccountedState
    env_out: Any  # dict of [B, ...]
    agent_out: Any  # dict of [B, ...]
    agent_state: Any


def make_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", default="Catch")
    parser.add_argument("--xpid", default=None)
    parser.add_argument("--savedir", default="~/logs/torchbeast_tpu")
    parser.add_argument("--total_steps", type=int, default=200000)
    parser.add_argument("--batch_size", type=int, default=64,
                        help="Parallel on-device environments.")
    parser.add_argument("--unroll_length", type=int, default=16)
    parser.add_argument("--model", default="mlp",
                        choices=["mlp", "shallow", "deep", "pipelined_mlp",
                                 "transformer"])
    parser.add_argument("--use_lstm", action="store_true")
    parser.add_argument("--num_experts", type=int, default=0,
                        help="Transformer-only: top-2 MoE FFN with N "
                             "experts (load-balance loss in objective).")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--num_devices", type=int, default=1,
                        help="Data-parallel devices (the CUDA devices, "
                             "or the CPU's "
                             "--xla_force_host_platform_device_count of "
                             "XLA_FLAGS under --disable_cuda); batch_size "
                             "must divide by N.")
    parser.add_argument("--checkpoint_interval_s", type=int, default=600)
    parser.add_argument("--log_interval_updates", type=int, default=20)
    # Loss/optimizer knobs (reference defaults).
    parser.add_argument("--entropy_cost", type=float, default=0.0006)
    parser.add_argument("--entropy_cost_final", type=float, default=None,
                        help="Linearly anneal entropy cost to this over "
                             "total_steps (default: constant).")
    parser.add_argument("--baseline_cost", type=float, default=0.5)
    parser.add_argument("--discounting", type=float, default=0.99)
    parser.add_argument("--reward_clipping", default="abs_one",
                        choices=["abs_one", "none"])
    parser.add_argument("--learning_rate", type=float, default=4.8e-4)
    parser.add_argument("--alpha", type=float, default=0.99)
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--epsilon", type=float, default=0.01)
    parser.add_argument("--grad_norm_clipping", type=float, default=40.0)
    parser.add_argument("--disable_cuda", action="store_true",
                        help="Run on the CPU (the port's only flag the "
                             "reference lacks; without it and without a "
                             "CUDA device the trainer raises).")
    return parser


def _policy_step(model, env_out, agent_state, generator):
    """One T=1 acting forward on [B, ...] env outputs, sampling from
    `generator`."""
    inputs = {k: env_out[k] for k in learner_lib.MODEL_INPUT_KEYS}
    with torch.no_grad():
        out, new_state = learner_lib.act_body(model, inputs, agent_state,
                                              generator)
    return _agent_out_dict(out), new_state


def make_collect(env, model, unroll_length: int, generator, routing=None):
    """The T-step rollout (the reference's scan of rollout_step):

        carry -> (batch {key: [T+1, B, ...]}, next carry)

    Slot 0 of the batch is the boundary step (the carry's env and agent
    outputs); slot i pairs env output i with the agent output computed
    from env output i-1. The batch lives in buffers made at the first
    call and rewritten by every later one (inside a CUDA graph, static
    buffers of the graph), `collect.buffers`; the next carry's tensors
    are new. `routing()`, when given, is the context of each acting
    forward (a data shard's whole-batch MoE routing scope,
    parallel.ParallelLearner.routing)."""
    T = unroll_length
    buffers = {}

    def collect(carry: ActorCarry):
        first = {**carry.env_out, **carry.agent_out}
        if not buffers:
            buffers.update({
                k: torch.empty((T + 1,) + tuple(v.shape), dtype=v.dtype,
                               device=v.device)
                for k, v in first.items()})
        for k, v in first.items():
            buffers[k][0].copy_(v)
        env_state, env_out = carry.env_state, carry.env_out
        agent_state = carry.agent_state
        for t in range(1, T + 1):
            with routing() if routing else contextlib.nullcontext():
                agent_out, agent_state = _policy_step(
                    model, env_out, agent_state, generator)
            env_state, env_out = env.step(env_state, agent_out["action"],
                                          generator)
            for k, v in {**env_out, **agent_out}.items():
                buffers[k][t].copy_(v)
        return dict(buffers), ActorCarry(env_state, env_out, agent_out,
                                         agent_state)

    collect.buffers = buffers
    return collect


def make_train_step(env, model, optimizer, hp: learner_lib.HParams,
                    generator):
    """One iteration: the T-step collect, then learner.update_body on its
    batch from the agent state that entered the unroll.

        carry -> stats

    The params and the optimizer's state are updated in place, and the
    carry's tensors are overwritten with the next carry (so the same
    carry object, a CUDA graph's static buffers, feeds every call)."""
    collect = make_collect(env, model, hp.unroll_length, generator)
    update = learner_lib.update_body(model, optimizer, hp)

    def train_step(carry: ActorCarry):
        batch, next_carry = collect(carry)
        stats = update(batch, carry.agent_state)
        with torch.no_grad():
            torch._foreach_copy_(nest.flatten(carry),
                                 nest.flatten(next_carry))
        return stats

    return train_step


def make_iteration_dispatch(env, model, optimizer, hp, generator, carry):
    """() -> stats of one iteration over `carry`: on a CUDA device one
    CUDA graph (graphs.CapturedIteration, captured at the first call),
    on the CPU the eager step."""
    step = make_train_step(env, model, optimizer, hp, generator)
    if generator.device.type == "cuda":
        return graphs.CapturedIteration(step, carry, optimizer, generator)
    return lambda: step(carry)


def split_carry(carry: ActorCarry, devices) -> list:
    """The carry's B envs split in order over `devices`, one ActorCarry
    each (copies): B is axis 0 of the env leaves and axis 1 of the agent
    state's, as in the learner batch."""
    n = len(devices)

    def part(tree, axis, i):
        return nest.map(
            lambda t: t.chunk(n, dim=axis)[i].to(devices[i]).clone(), tree)

    return [ActorCarry(part(carry.env_state, 0, i), part(carry.env_out, 0, i),
                       part(carry.agent_out, 0, i),
                       part(carry.agent_state, 1, i)) for i in range(n)]


def make_parallel_iteration(env, learner, hp, generators, carries,
                            capture=None):
    """() -> stats of one data-parallel iteration (parallel.ShardedStep):
    shard i collects T steps from carries[i] with its replica and
    generators[i], computes its gradient on that batch from the agent
    state that entered the unroll, and takes its next carry in place;
    then the lead sums, applies and syncs. On the card each shard's part
    is one CUDA graph on its device (its generator registered, its carry
    put back after the warm-up) and the lead's one more; `capture=False`
    runs the eager twin. A MoE model's shards run in lockstep, eagerly,
    each acting forward and the learner forward in a routing scope of
    their own (learner.routing). `collects[i].buffers` holds shard i's
    last batch (make_collect)."""
    shard_fns = []
    collects = []
    for i, (replica, gen, carry) in enumerate(
            zip(learner.replicas, generators, carries)):
        collect = make_collect(env, replica, hp.unroll_length, gen,
                               routing=functools.partial(learner.routing,
                                                         i))
        collects.append(collect)

        def shard(i=i, collect=collect, carry=carry):
            batch, next_carry = collect(carry)
            grads, vec = learner.grads(i, batch, carry.agent_state)
            with torch.no_grad():
                torch._foreach_copy_(nest.flatten(carry),
                                     nest.flatten(next_carry))
            return grads, vec

        shard_fns.append(shard)
    step = parallel.ShardedStep(
        learner, shard_fns, generators=generators,
        restores=[nest.flatten(c) for c in carries], capture=capture)
    step.collects = collects
    return step


def initial_carry(env, model, batch_size: int, generator) -> ActorCarry:
    """Reset all envs and prime the boundary agent output (its state
    advance discarded, the collector convention), drawing from
    `generator` on the envs' device. The reference also initializes the
    params here; the port's module holds its own."""
    device = generator.device
    env_state, env_out = env.initial(batch_size, generator, device)
    agent_state = model.initial_state(batch_size, device)
    agent_out, _ = _policy_step(model, env_out, agent_state, generator)
    return ActorCarry(env_state, env_out, agent_out, agent_state)


def build_model(flags, env, device):
    """The model on `device`, its fresh weights drawn from --seed without
    touching the global RNG state."""
    extra = {"num_experts": flags.num_experts} if flags.num_experts else {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(flags.seed)
        model = create_model(
            flags.model, num_actions=env.num_actions,
            use_lstm=flags.use_lstm, frame_shape=env.frame_shape, **extra,
        )
    return model.to(device)


class Setup(NamedTuple):
    env: Any
    model: Any
    optimizer: Any
    hp: learner_lib.HParams
    generator: torch.Generator
    carry: ActorCarry


def check_num_devices(flags) -> int:
    """--num_devices, checked as the reference checks it."""
    n = flags.num_devices
    if n > 1 and flags.batch_size % n != 0:
        raise ValueError(
            f"batch_size {flags.batch_size} not divisible by "
            f"num_devices {n}"
        )
    return max(1, n)


def setup(flags, device) -> Setup:
    """Everything an iteration needs, as train() builds it on `device`:
    the wrapped device env, the model, the optimizer over its params, the
    hyperparameters (monobeast's from the same flags), the generator
    seeded from --seed, and the initial carry drawn from it."""
    env = create_device_env(flags.env)
    model = build_model(flags, env, device)
    hp = hparams_from_flags(flags)
    optimizer = learner_lib.make_optimizer(hp, list(model.parameters()))
    generator = torch.Generator(device=device)
    generator.manual_seed(flags.seed)
    carry = initial_carry(env, model, flags.batch_size, generator)
    return Setup(env, model, optimizer, hp, generator, carry)


def make_dispatch(flags, setup_: Setup):
    """() -> stats of one iteration of the run: make_iteration_dispatch
    on one device; with --num_devices N > 1 make_parallel_iteration over
    the first N devices of the run's platform, the carry split over them
    (build it after a resume: the replicas copy the lead's params)."""
    env, model, optimizer, hp, generator, carry = setup_
    n = check_num_devices(flags)
    if n == 1:
        return make_iteration_dispatch(env, model, optimizer, hp, generator,
                                       carry)
    device = generator.device
    mesh = parallel.create_mesh(n, devices=parallel.visible_devices(
        device.type))
    learner = parallel.ParallelLearner(model, optimizer, hp, mesh)
    generators = [generator]
    for i, d in enumerate(mesh.local_devices[1:], start=1):
        generators.append(torch.Generator(device=d))
        generators[-1].manual_seed(flags.seed + i)
    log.info("Anakin over %d devices", n)
    return make_parallel_iteration(env, learner, hp, generators,
                                   split_carry(carry, mesh.local_devices))


def train(flags):
    """Train, resuming from {savedir}/{xpid}/model.ckpt when it exists.
    Returns the last logged stats plus "step" and this run's "sps". The
    last iteration's stats are logged at exit when the interval did not
    log them (the reference's logs.csv ends at the last interval), so a
    run shorter than --log_interval_updates still writes logs.csv."""
    device = select_device(flags)
    check_num_devices(flags)
    setup_ = setup(flags, device)
    env, model, optimizer, hp, generator, carry = setup_
    if flags.xpid is None:
        flags.xpid = "anakin-%s" % time.strftime("%Y%m%d-%H%M%S")
    plogger = FileWriter(
        xpid=flags.xpid, xp_args=vars(flags), rootdir=flags.savedir
    )
    checkpoint_path = os.path.join(
        os.path.expanduser(flags.savedir), flags.xpid, "model.ckpt"
    )
    step = 0
    if os.path.exists(checkpoint_path):
        step = load_train_state(checkpoint_path, model, optimizer)["step"]
        log.info("Resuming preempted job at step %d", step)
    train_step = make_dispatch(flags, setup_)

    frames_per_update = flags.unroll_length * flags.batch_size
    start_time = last_log_time = last_checkpoint = time.time()
    start_step = last_log_step = step
    stats_host = {}
    unlogged = None  # the last iteration's stats, when not logged yet

    def log_stats(stats):
        # The only host read of the device's stats.
        out = learner_lib.episode_stat_postprocess(stats)
        out["step"] = step
        plogger.log(out)
        return out

    successful = True
    try:
        update = 0
        while step < flags.total_steps:
            unlogged = train_step()
            step += frames_per_update
            update += 1
            if update % flags.log_interval_updates:
                continue
            stats_host, unlogged = log_stats(unlogged), None
            now = time.time()
            if now - last_log_time > 5:
                sps = (step - last_log_step) / (now - last_log_time)
                last_log_time, last_log_step = now, step
                log.info(
                    "Steps %d @ %.1f SPS. Loss %.4f. %s",
                    step, sps, stats_host.get("total_loss", float("nan")),
                    f"Return {stats_host['mean_episode_return']:.2f}."
                    if "mean_episode_return" in stats_host else "",
                )
            if now - last_checkpoint > flags.checkpoint_interval_s:
                save_train_state(checkpoint_path, model, optimizer,
                                 step=step, flags=vars(flags),
                                 stats=stats_host)
                last_checkpoint = now
    except KeyboardInterrupt:
        pass
    except BaseException:
        successful = False
        raise
    finally:
        elapsed = time.time() - start_time
        try:
            if unlogged is not None and successful:
                stats_host = log_stats(unlogged)
            save_train_state(checkpoint_path, model, optimizer, step=step,
                             flags=vars(flags), stats=stats_host)
        except Exception:
            # A device fault mid-iteration must not also lose the
            # logger's close.
            log.exception("Final checkpoint failed")
        plogger.close(successful=successful)
    log.info("Learning finished after %d steps.", step)
    stats_host["step"] = step
    stats_host["sps"] = (step - start_step) / elapsed if elapsed > 0 else 0.0
    return stats_host


def main(flags):
    _configure_logging()
    return train(flags)


def cli():
    install_preemption_handler()  # SIGTERM -> clean checkpointed exit
    main(make_parser().parse_args())


if __name__ == "__main__":
    cli()
