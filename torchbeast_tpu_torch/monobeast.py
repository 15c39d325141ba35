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

--num_experts N replaces the transformer's FFN with a top-2 mixture of N
experts (models/moe.py), whose load-balance loss joins the objective and
is reported as aux_loss; the routing stays f32 under every precision
policy. --expert_parallel K > 1 splits each MoE layer's experts over K
devices (parallel/ep.py, the reference's 1-D `expert` mesh): the layer
runs expert group j on device j and sums the groups' outputs; params and
optimizer state stay whole on the first device and the update is the
one-device one, as the reference's. Acting goes through the same split:
across cards each acting forward would send every other group its
experts' weights (2 MiB a layer and group at the full width's d 128, ff
512, 4 experts a group, f32) and its share of the dispatched tokens, and
take back its outputs; on one card (every group on it) nothing moves.

--model pipelined_mlp and --model pipelined_transformer (models/
pipelined.py, models/transformer_pp.py) run their stage-stacked towers
sequentially on one device without --pipeline_parallel, as the
reference does; --pipeline_stages sets the tower's depth (the MLP's
stages, the transformer's layers). --pipeline_parallel P > 1 runs the
tower as a GPipe pipeline over the first P devices (parallel/pp.py, the
reference's 1-D `pipe` mesh) in --pipeline_microbatches microbatches
(0: one per device), k passes for --pipeline_stages k x P; the update is
the one-device one (the fused tail included), its params whole on the
first device, and acting batches that do not divide into the
microbatches take the sequential tower. The reference's checks come
first (check_pp_flags). On one card the update and acting steps stay
CUDA graphs; a pipeline over several cards runs them eagerly.
--sequence_parallel P > 1 shards the transformer's unroll axis over
the first P devices (the reference's 1-D `seq` mesh; with
--expert_parallel K > 1 the seq x expert mesh over P x K devices): each
block's learner attention runs the ring (--ring_schedule contiguous or
zigzag) or Ulysses (--sp_strategy ulysses) over them (ops/attention.py),
acting at T=1 the dense path; the update is the one-device one, the
fused tail included, its params whole on the first device. The
reference's checks come first (check_sp_flags): the transformer only,
dense attention, Ulysses with the contiguous schedule and a head count
that divides by P, and unroll_length + 1 divisible by P (2P under the
zigzag). On one card the update stays one CUDA graph; seq devices on
several cards run it eagerly.

--num_learner_devices N > 1 is the reference's plain data-parallel sync
learner (parallel/dp.py): each update's batch_size columns split over N
devices, one model replica each, the shard gradients summed on the lead
device, which applies the --opt_impl xla chain once and hands the params
to every replica. The reference's checks come first: batch_size must
divide by N, SP/EP/PP above 1 need polybeast's composite meshes, and
--opt_impl pallas is refused. A MoE model routes over the whole batch
(the shards exchange their routing counts in every MoE layer, and the
update runs eagerly; parallel/dp.py). Acting and checkpoints read the lead
replica, which is the run's model. --fleet raises the reference's
ValueError (the sync trainer is single-host).

--device_split (runtime/placement.py, the reference's grammar and
errors) splits the devices into inference slices and learner devices:
acting runs on the first inference device, from a copy of the params
taken after each collect's updates (lag 0, as time-shared), and the
update on the learner devices (one: the one-device update pinned there;
more: the data-parallel learner over exactly them). The split moves the
work without changing it: its run is bitwise the time-shared one from
the same seed. --opt_impl pallas is refused under it, as the reference
refuses it; on a single visible device the split degrades to the
time-shared path with the reference's warning.

--loss impact trains the IMPACT surrogate (ops/impact.py) against a
target network (learner.TargetNetwork) refreshed every
--target_refresh_updates updates, and --replay_reuse K' dispatches each
learner batch K' times. --model mlp and --env tbt/MiniAtari-v0 (or a
real Atari id, with ale_py) need gymnasium only on the Atari branch.

The parser takes every flag of the reference with the same name, type,
default and choices, plus --disable_cuda. Every feature of the
reference's flags is in the port.

The trainer runs on the first CUDA device. Without one it raises, unless
--disable_cuda asks for the CPU.

Telemetry is the reference's (telemetry/driver.py): the registry's
series land in {xpid}/telemetry.jsonl on the 5 s log cadence and at
exit, under the reference's names; --telemetry_port serves them as
Prometheus text, --trace_path writes the tracer's spans, and
--profile_dir a torch.profiler trace (utils/prof.DeviceTrace). The
`learner.remat_plan` static is the run's remat plan and the
`learner.hbm_bytes_per_update` gauge the bytes one update accesses
(precision.count_bytes). `learner.mesh_shape` is {"data": N, "model": 1}
for the learner's N data shards (1 without --num_learner_devices).

--remat {auto,all,none,<spec>}, --hbm_budget_gb and --transformer_remat
set the model's remat levers (runtime/remat_plan.py): `auto` measures
candidate plans on the card and takes the first, in order of recompute,
whose peak fits the budget. Unset, every activation is kept.

Run:  python -m torchbeast_tpu_torch.monobeast --env Mock --model deep \\
          --use_lstm --vtrace_impl pallas --opt_impl pallas
      python -m torchbeast_tpu_torch.monobeast --env Mock \\
          --model transformer --attention_impl pallas \\
          --vtrace_impl pallas --opt_impl pallas --precision bf16_train
"""

import argparse
import contextlib
import copy
import functools
import logging
import os
import statistics
import time
from typing import Optional

import numpy as np
import torch

from torchbeast_tpu_torch import learner as learner_lib
from torchbeast_tpu_torch import nest, parallel, precision, telemetry, weights
from torchbeast_tpu_torch.envs import create_env, num_actions_of
from torchbeast_tpu_torch.envs.environment import Environment
from torchbeast_tpu_torch.envs.vec import ProcessEnvPool, SerialEnvPool
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.models.transformer import set_seq_devices
from torchbeast_tpu_torch.parallel import pp
from torchbeast_tpu_torch.resilience import LearnerWatchdog, PipelineHealth
from torchbeast_tpu_torch.runtime import placement, remat_plan
from torchbeast_tpu_torch.rollout import (
    PipelinedRolloutCollector,
    RolloutCollector,
    to_host,
)
from torchbeast_tpu_torch.utils import (
    FileWriter,
    Timings,
    install_preemption_handler,
)
from torchbeast_tpu_torch.utils.prof import DeviceTrace
from torchbeast_tpu_torch.utils.checkpoint import (
    load_params,
    load_train_state,
    save_train_state,
)

log = logging.getLogger("torchbeast_tpu_torch.monobeast")


def _configure_logging():
    logging.basicConfig(
        format=(
            "[%(levelname)s:%(process)d %(module)s:%(lineno)d "
            "%(asctime)s] %(message)s"
        ),
        level=logging.INFO,
    )




def make_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--env", type=str, default="PongNoFrameskip-v4",
                        help="Mock, Counting, Catch, Memory[-L<n>], "
                             "tbt/MiniAtari-v0 or a gymnasium Atari id "
                             "(needs ale_py).")
    parser.add_argument("--mode", default="train",
                        choices=["train", "test"],
                        help="test: greedy episodes from the run's "
                             "checkpoint.")
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
                             "(IMPALA ResNet), mlp, transformer "
                             "(KV-cache attention), or the stage-stacked "
                             "pipelined_mlp and pipelined_transformer "
                             "(their towers run sequentially on one "
                             "device).")
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
                        help="Shard the transformer's unroll (time) axis "
                             "over N devices (ring or Ulysses attention "
                             "over a `seq` mesh; model=transformer only, "
                             "unroll_length+1 divisible by N; acting "
                             "runs the dense path).")
    parser.add_argument("--pipeline_parallel", type=int, default=0,
                        help="Run the pipelined_mlp / "
                             "pipelined_transformer tower as a GPipe "
                             "pipeline over N devices (a `pipe` mesh "
                             "axis).")
    parser.add_argument("--pipeline_microbatches", type=int, default=0,
                        help="Microbatches per pipelined forward "
                             "(0, the default, means one per pipeline "
                             "device).")
    parser.add_argument("--pipeline_stages", type=int, default=0,
                        help="Tower depth of the pipelined families "
                             "(pipelined_mlp: stages, "
                             "pipelined_transformer: layers); 0 keeps "
                             "the model's default.")
    parser.add_argument("--num_experts", type=int, default=0,
                        help="Replace the transformer's FFN with a top-2 "
                             "mixture of N experts (model=transformer "
                             "only; adds a sown load-balance loss).")
    parser.add_argument("--expert_parallel", type=int, default=0,
                        help="Shard the MoE experts over N devices (an "
                             "`expert` mesh axis; needs --num_experts "
                             "divisible by N).")
    parser.add_argument("--sp_strategy", default="ring",
                        choices=["ring", "ulysses"],
                        help="Sequence-parallel strategy: the K/V ring "
                             "or all-to-all head sharding (ulysses; "
                             "needs num_heads divisible by N).")
    parser.add_argument("--ring_schedule", default="contiguous",
                        choices=["contiguous", "zigzag"],
                        help="Ring attention block schedule (zigzag "
                             "balances causal work; unroll_length+1 "
                             "divisible by 2N).")
    parser.add_argument("--num_learner_devices", type=int, default=1,
                        help="Data-parallel learner over N devices (the "
                             "CUDA devices, or the CPU's "
                             "--xla_force_host_platform_device_count of "
                             "XLA_FLAGS under --disable_cuda); "
                             "batch_size must divide by N.")
    parser.add_argument("--device_split", default="",
                        help="Sebulba device split (runtime/placement."
                             "py): 'auto' or 'inf=K,learn=rest|M'. In "
                             "the sync trainer the split pins the "
                             "acting forward to the first inference "
                             "device (policy params copied there "
                             "device-to-device at each rebind) and runs "
                             "the learner update on the learner devices "
                             "(data-parallel over more than one): "
                             "collect and learn stop contending for one "
                             "device's compute. Empty = time-shared; a "
                             "single-device process degrades to it with "
                             "a warning. The full per-slice serving "
                             "split (pinned slot tables, snapshot "
                             "publication) lives in the async driver.")
    parser.add_argument("--fleet", default=None,
                        help="The async driver's (polybeast); refused "
                             "here, as the reference refuses it.")
    parser.add_argument("--min_live_hosts", type=int, default=1,
                        help="The fleet's host floor (polybeast's "
                             "--fleet); unused by the sync trainer.")
    parser.add_argument("--transformer_remat", action="store_true",
                        help="DEPRECATED spelling of --remat with the "
                             "transformer blocks stage at 'all' "
                             "(conflicts with an explicit --remat).")
    parser.add_argument("--remat", default=None,
                        help="Rematerialization plan over the model's "
                             "remat-able stages (runtime/remat_plan.py: "
                             "the ResNet trunk's per-stage none/front/"
                             "all, the transformer's block remat, the "
                             "LSTM core): 'auto' picks the "
                             "minimum-recompute plan whose measured peak "
                             "(the CUDA allocator's) fits "
                             "--hbm_budget_gb; 'all'/'none' force every "
                             "stage; 'stage0=front,stage1=all,core=none' "
                             "pins per stage. Default: every activation "
                             "kept (transformer blocks per "
                             "--transformer_remat). The chosen plan is "
                             "logged and exported as the "
                             "learner.remat_plan telemetry static.")
    parser.add_argument("--hbm_budget_gb", type=float, default=0.0,
                        help="Device-memory envelope for --remat auto, "
                             "in GiB, covering one live update dispatch "
                             "(params + optimizer state + staged batch "
                             "+ activations and workspaces). 0 = the "
                             "card's total memory (the host's on the "
                             "CPU).")
    parser.add_argument("--opt_impl", default="xla",
                        choices=["xla", "pallas"],
                        help="Optimizer tail: 'xla' runs the torch form of "
                             "the reference's optax chain; 'pallas' the "
                             "fused CUDA kernel csrc/rmsprop_tail.cu.")
    parser.add_argument("--overlap_collect", action="store_true",
                        help="Act on params that are one dispatched "
                             "unroll-batch behind the learner head, so the "
                             "update chain (on its own CUDA stream) hides "
                             "behind env stepping. Default off = zero "
                             "policy lag.")
    parser.add_argument("--pipelined_collect", dest="pipelined_collect",
                        action="store_true", default=True,
                        help="Lag-1 pipelined rollout collection "
                             "(default): per env step only the action "
                             "crosses to the host.")
    parser.add_argument("--no_pipelined_collect", dest="pipelined_collect",
                        action="store_false",
                        help="Synchronous collection.")
    parser.add_argument("--superstep_k", type=int, default=1,
                        help="K learner updates per dispatch (one CUDA "
                             "graph); must divide num_actors / "
                             "batch_size.")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--env_seed", type=int, default=None,
                        help="Base seed for stochastic envs; env i draws "
                             "from env_seed+i.")
    parser.add_argument("--max_env_restarts", type=int, default=10,
                        help="Respawn budget for crashed process-pool "
                             "env workers (0 = fail fast).")
    parser.add_argument("--checkpoint_interval_s", type=int, default=600,
                        help="Seconds between checkpoints (one more is "
                             "written at exit).")
    parser.add_argument("--learner_stall_timeout_s", type=float,
                        default=300.0,
                        help="No update within this many seconds degrades "
                             "health and dumps the thread stacks; 0 "
                             "disables the watchdog.")
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
                        help="Objective family: IMPALA V-trace (the "
                             "default) or the IMPACT clipped "
                             "target-network surrogate (ops/impact.py), "
                             "lag-tolerant, for --replay_reuse.")
    parser.add_argument("--impact_clip", type=float, default=0.2,
                        help="IMPACT surrogate clip epsilon "
                             "(--loss impact).")
    parser.add_argument("--replay_reuse", type=int, default=1,
                        help="Consume each collected batch K' times "
                             "(--loss impact; 1 = on-policy). The "
                             "schedule clock scales with it.")
    parser.add_argument("--target_refresh_updates", type=int, default=8,
                        help="Refresh the IMPACT target network every "
                             "N optimizer updates (--loss impact).")
    parser.add_argument("--learning_rate", type=float, default=4.8e-4)
    parser.add_argument("--alpha", type=float, default=0.99,
                        help="RMSProp smoothing constant.")
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--epsilon", type=float, default=0.01,
                        help="RMSProp epsilon.")
    parser.add_argument("--grad_norm_clipping", type=float, default=40.0)
    parser.add_argument("--num_test_episodes", type=int, default=10,
                        help="Episodes of --mode test.")
    parser.add_argument("--profile_dir", default=None,
                        help="If set, capture a torch.profiler trace "
                             "here (trace.json).")
    telemetry.add_arguments(parser)
    parser.add_argument("--disable_cuda", action="store_true",
                        help="Run on the CPU (the port's only flag the "
                             "reference lacks; without it and without a "
                             "CUDA device the trainer raises).")
    return parser


# Sequence-parallel options, and the reference's refusal of each without
# a `seq` mesh (monobeast.py:479-494), raised by both drivers.
SEQUENCE_PARALLEL_ONLY = {
    "ring_schedule": (
        "contiguous",
        "--ring_schedule only takes effect with --sequence_parallel > 1 "
        "(no ring attention runs without a seq mesh)"),
    "sp_strategy": (
        "ring",
        "--sp_strategy only takes effect with --sequence_parallel > 1 (no "
        "sequence-parallel attention runs without a seq mesh)"),
}


def check_parallel_flags(flags) -> None:
    """The reference's checks of the parallelism flags that one device can
    answer: --ring_schedule and --sp_strategy away from their defaults
    without --sequence_parallel > 1 raise its ValueError."""
    if getattr(flags, "sequence_parallel", 0) <= 1:
        for dest, (default, message) in SEQUENCE_PARALLEL_ONLY.items():
            if getattr(flags, dest, default) != default:
                raise ValueError(message)


def check_sp_flags(flags) -> None:
    """The reference's checks of --sequence_parallel P > 1 that the flags
    answer (monobeast.py:495-531): the transformer only, dense attention,
    Ulysses only with the contiguous schedule, and unroll_length + 1
    divisible by P (2P under the zigzag). The head count is checked on
    the built model (check_sp_heads)."""
    seq_par = getattr(flags, "sequence_parallel", 0) or 0
    if seq_par <= 1:
        return
    if flags.model != "transformer":
        raise ValueError(
            "--sequence_parallel needs --model transformer (the "
            "conv+LSTM families have no sequence-sharded formulation)"
        )
    if getattr(flags, "attention_impl", "dense") != "dense":
        raise ValueError(
            "--attention_impl pallas and --sequence_parallel are "
            "mutually exclusive (the ring path replaces the fused "
            "kernel on the learner forward)"
        )
    ring_schedule = getattr(flags, "ring_schedule", "contiguous")
    if getattr(flags, "sp_strategy", "ring") == "ulysses":
        if ring_schedule != "contiguous":
            raise ValueError(
                "--ring_schedule applies to --sp_strategy ring only"
            )
        divisor = seq_par
    else:
        divisor = 2 * seq_par if ring_schedule == "zigzag" else seq_par
    if (flags.unroll_length + 1) % divisor != 0:
        raise ValueError(
            f"--sequence_parallel {seq_par} "
            f"({ring_schedule}) requires unroll_length+1 divisible "
            f"by {divisor} (got {flags.unroll_length + 1})"
        )


def check_sp_heads(flags, model) -> None:
    """The reference's check of Ulysses' head count on the constructed
    model (monobeast.py:752-767)."""
    seq_par = getattr(flags, "sequence_parallel", 0) or 0
    if (seq_par > 1 and getattr(flags, "sp_strategy", "ring") == "ulysses"
            and model.num_heads % seq_par != 0):
        raise ValueError(
            f"--sp_strategy ulysses requires num_heads "
            f"({model.num_heads}) divisible by --sequence_parallel "
            f"{seq_par} (heads are the sharded resource)"
        )


def place_sequence_parallel(model, mesh, flags) -> None:
    """Run `model`'s blocks sequence-parallel over the seq devices of
    `mesh`'s first data row with the flags' schedule and strategy
    (models/transformer.set_seq_devices), logging the layout."""
    set_seq_devices(model, mesh.seq_devices(0),
                    getattr(flags, "ring_schedule", "contiguous"),
                    getattr(flags, "sp_strategy", "ring"))
    log.info("Sequence parallel: %s (%s) over %s",
             getattr(flags, "sp_strategy", "ring"),
             getattr(flags, "ring_schedule", "contiguous"),
             mesh.seq_devices(0))


def check_moe_flags(flags) -> None:
    """The reference's MoE flag checks (monobeast.py:558-559 and 673-678;
    the transformer-only one is create_model's, which comes first there):
    --expert_parallel needs --num_experts, which must divide by it."""
    expert_par = getattr(flags, "expert_parallel", 0) or 0
    num_experts = getattr(flags, "num_experts", 0)
    if expert_par and not num_experts:
        raise ValueError("--expert_parallel needs --num_experts")
    if (expert_par > 1 and flags.model == "transformer"
            and num_experts % expert_par != 0):
        raise ValueError(
            f"--num_experts {num_experts} not divisible by "
            f"--expert_parallel {expert_par}"
        )


PIPELINED_MODELS = ("pipelined_mlp", "pipelined_transformer")
# The pipelined transformer's default depth (PipelinedTransformerNet's
# num_layers), the default stage count of its pipeline.
PIPELINED_TRANSFORMER_LAYERS = 4


def check_pp_combination(flags) -> None:
    """The reference's refusal of --pipeline_parallel > 1 with SP or EP
    (monobeast.py:560-571)."""
    pipe_par = getattr(flags, "pipeline_parallel", 0) or 0
    if pipe_par > 1 and (
        (getattr(flags, "sequence_parallel", 0) or 0) > 1
        or (getattr(flags, "expert_parallel", 0) or 0) > 1
    ):
        raise ValueError(
            "--pipeline_parallel cannot combine with "
            "--sequence_parallel or --expert_parallel (the pipeline "
            "schedule owns its mesh; SP x EP do compose with each other "
            "and with data parallelism)"
        )


def pipeline_stages(flags) -> int:
    """The tower's depth under --pipeline_parallel P > 1: --pipeline_stages,
    else P for the MLP (one stage a device) and the model's own depth for
    the transformer (an architecture choice the device count must not
    change)."""
    pipe_par = getattr(flags, "pipeline_parallel", 0) or 0
    default = (PIPELINED_TRANSFORMER_LAYERS
               if flags.model == "pipelined_transformer" else pipe_par)
    return getattr(flags, "pipeline_stages", 0) or default


def check_pp_flags(flags, mesh, batch_axis: Optional[str] = None
                   ) -> Optional[int]:
    """The reference's checks of --pipeline_parallel P > 1 on `mesh`, the
    pipe mesh its model will run over (monobeast.py:579-654, in its
    order, after check_pp_combination): a pipelined model, the stage
    count a multiple of P, --pipeline_microbatches >= 0, and the learner
    batch divisible into the microbatches (and each microbatch's rows
    over `batch_axis` on polybeast's composite mesh). Returns the
    microbatch count to set (None: one per pipe device)."""
    pipe_par = getattr(flags, "pipeline_parallel", 0) or 0
    if pipe_par <= 1:
        return None
    n_stages = pipeline_stages(flags)
    if n_stages % pipe_par != 0:
        raise ValueError(
            f"--pipeline_stages {n_stages} must be a multiple of "
            f"--pipeline_parallel {pipe_par}"
        )
    n_mb = getattr(flags, "pipeline_microbatches", 0)
    if n_mb < 0:
        raise ValueError(
            f"--pipeline_microbatches {n_mb} must be >= 0 "
            "(0 means the default: one microbatch per pipeline "
            "device)"
        )
    n_mb = n_mb or None
    if flags.model == "pipelined_transformer":
        quantity, what = flags.batch_size, "batch_size"
    else:  # pipelined_mlp microbatches over flattened T*B tokens
        quantity = (flags.unroll_length + 1) * flags.batch_size
        what = "(unroll_length+1)*batch_size"
    if not pp.can_pipeline(mesh, quantity, n_microbatches=n_mb,
                           batch_axis=batch_axis):
        m_eff = pp.default_n_microbatches(mesh, "pipe", n_mb)
        raise ValueError(
            f"--pipeline_parallel {pipe_par} requires {what} "
            f"(= {quantity}) divisible by the microbatch "
            f"count ({m_eff}; --pipeline_microbatches overrides the "
            "one-per-device default), and each microbatch's rows by "
            "the data axis when composing with DP — otherwise the "
            "learner step would silently run the sequential fallback"
        )
    return n_mb


def check_pipelined_model(flags) -> None:
    """The reference's refusal of --pipeline_parallel > 1 for a family
    without a stage tower (monobeast.py:579-585)."""
    if flags.model not in PIPELINED_MODELS:
        raise ValueError(
            "--pipeline_parallel needs --model pipelined_mlp or "
            "pipelined_transformer (the other families have no "
            "stage-uniform tower to pipeline)"
        )


def pipe_mesh(device, flags):
    """The reference's 1-D pipe mesh of a one-device learner
    (--pipeline_parallel P > 1): the first P devices of `device`'s
    platform, with _make_1d_mesh's error, as a (data=1, pipe=P) Mesh,
    after the reference's model check; None without
    --pipeline_parallel > 1."""
    n = getattr(flags, "pipeline_parallel", 0) or 0
    if n <= 1:
        return None
    check_pipelined_model(flags)
    devices = parallel.visible_devices(device.type)
    if len(devices) < n:
        raise ValueError(
            f"--pipeline_parallel {n} but only {len(devices)} devices are "
            "visible"
        )
    return parallel.create_mesh(devices=devices[:n], pipe_parallelism=n)


def check_dp_flags(flags) -> int:
    """--num_learner_devices, with the reference's checks of the sync
    trainer's DP (monobeast.py:810-834), made before any side effect:
    plain DP only, batch_size divisible by the devices, no fused tail.
    Returns the device count."""
    n_dev = getattr(flags, "num_learner_devices", 1)
    if n_dev > 1:
        if any(
            (getattr(flags, f, 0) or 0) > 1
            for f in ("sequence_parallel", "expert_parallel",
                      "pipeline_parallel")
        ):
            raise ValueError(
                "--num_learner_devices in the sync trainer is plain DP; "
                "composing DP with SP/EP/PP needs the async driver's "
                "composite meshes (polybeast)"
            )
        if flags.batch_size % n_dev != 0:
            raise ValueError(
                f"batch_size {flags.batch_size} not divisible by "
                f"num_learner_devices {n_dev}"
            )
        if getattr(flags, "opt_impl", "xla") == "pallas":
            raise ValueError(parallel.dp.PALLAS_REFUSAL)
    return max(1, n_dev)


SPLIT_PALLAS_REFUSAL = (
    "--opt_impl pallas does not compose with --device_split "
    "yet (the fused tail is a per-chip kernel)"
)


def resolve_split(flags, device, parallel_flags):
    """--device_split resolved over `device`'s platform's visible devices
    (parallel.visible_devices, read at call time) and checked with the
    reference's composition rules (placement.validate_split_composition
    over `parallel_flags`), before any side effect; None for no split,
    and for the single-device degradation (with the reference's
    warning)."""
    split = placement.resolve_device_split(
        getattr(flags, "device_split", ""),
        parallel.visible_devices(device.type))
    placement.validate_split_composition(flags, split, parallel_flags)
    return split


def learner_mesh(device, n_dev: int, expert_par: int = 1,
                 model_par: int = 1, pipe_par: int = 1, seq_par: int = 1):
    """The learner's data (x model x seq x pipe x expert) mesh over the
    first n_dev x the inner axes' devices of `device`'s platform
    (parallel.create_mesh, with the reference's "visible" error); its
    lead is `device` (select_device's: cuda:0, or the CPU)."""
    return parallel.create_mesh(
        n_dev * expert_par * model_par * pipe_par * seq_par,
        model_parallelism=model_par, expert_parallelism=expert_par,
        pipe_parallelism=pipe_par, seq_parallelism=seq_par,
        devices=parallel.visible_devices(device.type))


def seq_mesh(device, flags):
    """The reference's mesh of a one-device learner under
    --sequence_parallel P > 1: the 1-D `seq` mesh over the first P
    devices of `device`'s platform (with _make_1d_mesh's error), or with
    --expert_parallel K > 1 the (data=1, seq=P, expert=K) mesh over
    P x K; None without SP."""
    n = getattr(flags, "sequence_parallel", 0) or 0
    if n <= 1:
        return None
    ep = getattr(flags, "expert_parallel", 0) or 0
    devices = parallel.visible_devices(device.type)
    if ep > 1:
        return parallel.create_mesh(n * ep, devices=devices,
                                    expert_parallelism=ep,
                                    seq_parallelism=n)
    if len(devices) < n:
        raise ValueError(
            f"--sequence_parallel {n} but only {len(devices)} devices are "
            "visible"
        )
    return parallel.create_mesh(devices=devices[:n], seq_parallelism=n)


def expert_mesh(device, flags):
    """The reference's 1-D expert mesh of a one-device learner
    (--expert_parallel K > 1 without a learner mesh): the first K
    devices of `device`'s platform, with _make_1d_mesh's error, as a
    (data=1, expert=K) Mesh; None without --expert_parallel > 1 (and
    under SP, whose seq x expert mesh seq_mesh builds)."""
    n = getattr(flags, "expert_parallel", 0) or 0
    if n <= 1 or (getattr(flags, "sequence_parallel", 0) or 0) > 1:
        return None
    devices = parallel.visible_devices(device.type)
    if len(devices) < n:
        raise ValueError(
            f"--expert_parallel {n} but only {len(devices)} devices are "
            "visible"
        )
    return parallel.create_mesh(devices=devices[:n], expert_parallelism=n)


def place_experts(model, mesh) -> None:
    """Split `model`'s MoE layers over the expert devices of `mesh`'s
    first data row (parallel.set_expert_devices), logging the layout."""
    n = parallel.set_expert_devices(model, mesh.expert_devices(0))
    log.info("Expert parallel: %d expert leaves split over %s", n,
             mesh.expert_devices(0))


def check_flags(flags) -> None:
    """The reference's errors for the fleet and the parallelism flags
    (check_parallel_flags)."""
    if getattr(flags, "fleet", None):
        raise ValueError(
            "--fleet needs the async driver (polybeast): the sync "
            "trainer is single-host by design"
        )
    check_moe_flags(flags)
    check_pp_combination(flags)
    check_sp_flags(flags)
    check_parallel_flags(flags)


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


def _num_experts(flags):
    n = getattr(flags, "num_experts", 0)
    return {"num_experts": n} if n else {}


def _pipeline_stages(flags):
    """--pipeline_stages as the pipelined family's depth kwarg, as the
    reference keeps it without --pipeline_parallel (a silently different
    stage count would make checkpoints shape-incompatible with a later
    pipelined run); under --pipeline_parallel > 1 pipeline_stages'."""
    if flags.model not in PIPELINED_MODELS:
        return {}
    n = (pipeline_stages(flags)
         if (getattr(flags, "pipeline_parallel", 0) or 0) > 1
         else getattr(flags, "pipeline_stages", 0))
    if not n:
        return {}
    return {("num_layers" if flags.model == "pipelined_transformer"
             else "num_stages"): n}


def _create_model(flags, num_actions, frame_shape, device, **levers):
    policy = precision.resolve_flags(flags)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(flags.seed)
        model = create_model(
            flags.model, num_actions=num_actions, use_lstm=flags.use_lstm,
            frame_shape=frame_shape, dtype=policy.compute_dtype,
            head_dtype=policy.head_dtype, **_trunk_channels(flags),
            **_attention_impl(flags), **_num_experts(flags),
            **_pipeline_stages(flags), **levers,
        )
    return precision.cast_params(model.to(device), policy)


def resolve_remat_plan(flags, num_actions, frame_shape, device):
    """The run's remat plan (runtime/remat_plan.resolve_from_flags: --remat,
    --hbm_budget_gb, --transformer_remat), memoized: every later call with
    the same flags returns it at no cost. `--remat auto` runs candidate
    models built as build_model builds the real one (on `device`, from
    --seed), one dispatch each, and frees them."""
    if getattr(flags, "transformer_remat", False) and flags.model not in (
            "transformer", "pipelined_transformer"):
        raise ValueError(
            "--transformer_remat applies to the transformer families "
            "only (the conv trunk's levers are --remat's, "
            "models/resnet.py `remat`)"
        )
    return remat_plan.resolve_from_flags(
        flags, hparams_from_flags(flags), num_actions, frame_shape,
        torch.uint8, precision.resolve_flags(flags),
        build_model=lambda kw: _create_model(
            flags, num_actions, frame_shape, device, **kw),
    )


def build_model(flags, num_actions, frame_shape, device):
    """The model on `device`, its initial weights drawn from --seed
    without touching the global RNG state, computing in the precision
    policy's dtypes, its params cast to the policy's resident dtype (the
    optimizer is built after, from the cast params), its remat levers set
    from the run's plan (resolve_remat_plan). Every model instance of a
    run is built here or copied from one that was."""
    plan = resolve_remat_plan(flags, num_actions, frame_shape, device)
    if (flags.model in PIPELINED_MODELS
            and (getattr(flags, "pipeline_parallel", 0) or 0) <= 1):
        log.info("--model %s without --pipeline_parallel: the stage tower "
                 "runs sequentially on one device", flags.model)
    return _create_model(
        flags, num_actions, frame_shape, device,
        **remat_plan.model_kwargs(flags.model, plan.assignment))


def to_device(batch, device, batch_dtype=None):
    """numpy [T+1, B, ...] batch -> tensors on `device`, float32 leaves
    cast to `batch_dtype` on the host first (precision.cast_batch). On the
    card each leaf goes through pinned memory, so the copy is queued on
    the current stream without waiting for its earlier work."""
    host = precision.cast_batch(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in batch.items()}, batch_dtype)
    if device.type == "cpu":
        return host
    return {k: v.pin_memory().to(device, non_blocking=True)
            for k, v in host.items()}


def check_superstep(flags) -> int:
    """--superstep_k, checked as the reference checks it: K must divide
    the learner sub-batches of a collect."""
    k = getattr(flags, "superstep_k", 1)
    if k < 1:
        raise ValueError(f"--superstep_k must be >= 1, got {k}")
    if (flags.num_actors // flags.batch_size) % k != 0:
        # Each collect's sub-batches must split into whole supersteps:
        # a fixed-K dispatch cannot take a partial group, and carrying
        # sub-batches across collects would change the policy lag.
        raise ValueError(
            f"--superstep_k {k} must divide the "
            f"{flags.num_actors // flags.batch_size} learner sub-batches "
            "per collect (num_actors / batch_size)"
        )
    return k


def train(flags):
    """Train, resuming from {savedir}/{xpid}/model.ckpt when it exists
    and checkpointing there every --checkpoint_interval_s and at exit
    (also on KeyboardInterrupt, which SIGTERM becomes under cli()).
    Returns the last flushed stats, plus this run's "sps" (env frames),
    "learn_sps" (frames learned from), "updates" (optimizer updates) and
    "update_ms_median" (the median time
    of one update: CUDA events around each dispatch of inputs already
    staged on the card, the host clock on the CPU, divided by the
    dispatch's --superstep_k updates).

    --loss impact adds the target network (learner.TargetNetwork): its
    forward runs once per fresh learner batch (one CUDA graph replay on
    the card), and a refresh is due between reuse groups only, so every
    batch trains against one target version. --replay_reuse K'
    dispatches each staged batch K' times; env frames advance on the
    first pass only.

    On the card each learner dispatch (one update, or --superstep_k of
    them) and each acting step replays one captured CUDA graph
    (learner.make_update_dispatch, learner.make_act_step). With
    --overlap_collect the updates run on a learner stream and acting
    reads its own copy of the params, which takes the chain head
    dispatched before each collect (policy lag 1); without it acting
    reads the learner's params after each collect's updates (lag 0)."""
    n_dev = check_dp_flags(flags)
    check_flags(flags)
    if flags.num_actors % flags.batch_size != 0:
        raise ValueError(
            "num_actors must be a multiple of batch_size in the sync trainer "
            f"(got {flags.num_actors} vs {flags.batch_size})"
        )
    K = check_superstep(flags)
    overlap = bool(getattr(flags, "overlap_collect", False))
    device = select_device(flags)
    split = resolve_split(flags, device, ("sequence_parallel",
                                          "expert_parallel",
                                          "pipeline_parallel"))
    if split is not None and getattr(flags, "opt_impl", "xla") == "pallas":
        raise ValueError(SPLIT_PALLAS_REFUSAL)
    # Under the split the learner owns the learner devices: one gives the
    # one-device path pinned there, more a data-parallel mesh over
    # exactly them; acting moves to the first inference device.
    mesh = None
    act_device = learn_device = device
    if split is not None:
        act_device = torch.device(split.inference_devices[0])
        if len(split.learner_devices) > 1:
            mesh = parallel.create_mesh(devices=list(split.learner_devices))
            learn_device = mesh.lead
        else:
            learn_device = torch.device(split.learner_devices[0])
        if learn_device.type == "cuda":
            torch.cuda.set_device(learn_device)
    elif n_dev > 1:
        mesh = learner_mesh(device, n_dev)
    sp_mesh = seq_mesh(device, flags)
    ep_mesh = expert_mesh(device, flags) or (
        sp_mesh if sp_mesh is not None and "expert" in sp_mesh.shape
        else None)
    pp_mesh = pipe_mesh(device, flags)
    n_microbatches = (check_pp_flags(flags, pp_mesh) if pp_mesh is not None
                      else None)
    # A pipeline over several cards cannot be one CUDA graph.
    capture = (False if any(m is not None and m.spans_cards()
                            for m in (pp_mesh, sp_mesh)) else None)
    if flags.xpid is None:
        flags.xpid = "torchbeast-tpu-torch-%s" % time.strftime(
            "%Y%m%d-%H%M%S"
        )
    plogger = FileWriter(
        xpid=flags.xpid, xp_args=vars(flags), rootdir=flags.savedir
    )
    checkpoint_path = _checkpoint_path(flags, flags.xpid)
    # Telemetry: stage latencies, the learner batch-size distribution and
    # the dispatch queue's occupancy land in {xpid}/telemetry.jsonl on
    # the 5 s log cadence.
    tele = telemetry.DriverTelemetry(
        flags, plogger.paths["telemetry"], driver="monobeast")
    reg = tele.registry
    inner_mesh = sp_mesh or ep_mesh
    tele.set_static("learner.mesh_shape", (mesh or inner_mesh).shape
                    if mesh or inner_mesh else {"data": 1, "model": 1})
    if split is not None:
        tele.set_static("device_split", split.describe())

    hp = hparams_from_flags(flags)
    batch_dtype = precision.resolve_flags(flags).batch_dtype
    num_actions, frame_shape = _probe_env(flags)
    B = flags.num_actors
    T = flags.unroll_length
    model = build_model(flags, num_actions, frame_shape, learn_device)
    check_sp_heads(flags, model)
    # The resolved remat plan rides every telemetry line as a static.
    plan = remat_plan.last_plan()
    if plan is not None:
        tele.set_static("learner.remat_plan", plan.summary())
    optimizer = learner_lib.make_optimizer(
        hp, list(model.parameters()),
        layouts=weights.jax_layouts(model) if hp.opt_factored else None)
    step = 0
    stats = {}
    if os.path.exists(checkpoint_path):
        restored = load_train_state(checkpoint_path, model, optimizer)
        step, stats = restored["step"], restored["stats"]
        log.info("Resuming preempted job, current stats:\n%s", stats)
    if ep_mesh is not None:
        place_experts(model, ep_mesh)
    if sp_mesh is not None:
        place_sequence_parallel(model, sp_mesh, flags)
    if pp_mesh is not None:
        pp.set_pipeline(model, pp_mesh, n_microbatches)
        log.info("Pipeline parallel: %d stages over %s, %d microbatches%s",
                 pipeline_stages(flags), pp_mesh.pipe_devices(0),
                 pp.default_n_microbatches(pp_mesh, "pipe", n_microbatches),
                 " (eager: the pipeline spans cards)" if capture is False
                 else "")
    if mesh is not None:
        update = parallel.make_parallel_update_step(
            model, optimizer, hp, mesh, superstep_k=K)
        log.info("Sync learner data-parallel over %d devices%s",
                 mesh.shape["data"],
                 " (device split)" if split is not None else "")
    else:
        update = learner_lib.make_update_dispatch(model, optimizer, hp, K,
                                                  capture=capture)
    dispatch = learner_lib.instrument_update_step(
        update, registry=reg, superstep_k=K)
    # Lag 0: acting reads the learner's params, updated in place on the
    # same stream; under the split a copy on the acting device, refreshed
    # after each collect's updates. Lag 1: its own copy, refreshed after
    # each collect.
    act_model = (copy.deepcopy(model).to(act_device).requires_grad_(False)
                 if overlap or split is not None else model)
    act_params, learn_params = (list(act_model.parameters()),
                                list(model.parameters()))
    if split is not None:
        log.info("Acting pinned to inference device %s", act_device)
    learner_stream = (torch.cuda.Stream(learn_device)
                      if overlap and learn_device.type == "cuda" else None)
    generator = torch.Generator(device=act_device)
    generator.manual_seed(flags.seed + 2)
    act_step = learner_lib.make_act_step(act_model, act_device, generator,
                                         capture=capture)
    pipelined = getattr(flags, "pipelined_collect", True)
    log.info("Training on %s (superstep_k %d, overlap_collect %s)",
             learn_device, K, overlap)
    # --replay_reuse K': every staged batch is dispatched K' times
    # (IMPACT's sample reuse); env frames advance on its first pass only.
    reuse = hp.replay_reuse
    # The IMPACT target network (--loss impact): a full-precision copy of
    # the params stamped every --target_refresh_updates updates under the
    # "learner.target" namespace, version 0 (the init params) before any
    # update, so the first batches train at ratio 1.
    target = None
    if hp.loss == "impact":
        refresh = max(1, flags.target_refresh_updates or 1)
        if mesh is None:
            target = learner_lib.TargetNetwork(model, refresh, superstep_k=K,
                                               registry=reg)
        else:
            # One target network per shard, each forward on its shard's
            # device.
            target = parallel.ShardedTarget(update, refresh, superstep_k=K,
                                            registry=reg)
        log.info("IMPACT loss: target network refresh every %d updates, "
                 "replay reuse %d", target.store.refresh_updates, reuse)
    updates_done = 0  # the target store's version clock, in updates

    pool = _make_pool(flags, B)
    # The sync trainer has no monitor thread: the watchdog makes a wedged
    # collect (dead env worker, hung device) visible as DEGRADED health
    # and a thread-stack dump.
    watchdog = LearnerWatchdog(flags.learner_stall_timeout_s,
                               health=PipelineHealth(registry=reg),
                               registry=reg).start()
    timings = Timings(registry=reg if tele.enabled else None,
                      prefix="driver.")
    h_batch_size = reg.histogram("learner.batch_size")
    g_dispatch_q = reg.gauge("dispatch_queue.depth")
    g_sps = reg.gauge("learner.sps")
    g_env_sps = reg.gauge("learner.env_sps")
    g_learn_sps = reg.gauge("learner.learn_sps")
    # env_sps counts unique env frames, learn_sps frames consumed by
    # updates: env_sps x --replay_reuse in steady state.
    reg.gauge("learner.sample_reuse").set(reuse)
    update_ms = []
    pending = None  # (timers, device stats, step, done event) of a collect
    head = None  # --overlap_collect: event after the last dispatch
    start_time = time.time()
    start_step = step
    device_trace = None
    try:

        def policy(env_output, agent_state):
            out, new_state = act_step(env_output, agent_state)
            # The lag-1 collector copies outputs to the host itself.
            return (out if pipelined else to_host(out)), new_state

        collector_cls = (
            PipelinedRolloutCollector if pipelined else RolloutCollector
        )
        collector = collector_cls(
            pool, policy, act_model.initial_state(B, act_device),
            unroll_length=T
        )

        def flush_stats(entry):
            timers, device_stats, at_step, done = entry
            if done is not None:
                done.synchronize()
            keys = list(device_stats[0])
            # One device -> host copy for every update of the collect.
            rows = torch.stack([
                torch.stack([s[k].float() for k in keys])
                for s in device_stats
            ]).cpu().numpy()
            dispatch.count_host_sync()
            for t in timers:
                update_ms.append((
                    t[0].elapsed_time(t[1]) if learn_device.type == "cuda"
                    else 1000 * (t[1] - t[0])) / K)
            out = learner_lib.episode_stat_postprocess(
                {k: rows[:, j] for j, k in enumerate(keys)}
            )
            out["step"] = at_step
            plogger.log(out)
            return out

        def adopt_head():
            """--overlap_collect: acting takes the chain head dispatched
            before the collect that just ended; it had that whole collect
            to finish, so acting does not wait on it, and the updates
            dispatched next hide behind the next collect the same way."""
            if head is not None:
                torch.cuda.current_stream(act_device).wait_event(head)
            with torch.no_grad():
                torch._foreach_copy_(act_params, learn_params)

        def dispatch_timed(sub, sub_state):
            if learn_device.type != "cuda":
                t0 = time.perf_counter()
                out = dispatch(sub, sub_state)
                return out, (t0, time.perf_counter())
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = dispatch(sub, sub_state)
            t1.record()
            return out, (t0, t1)

        start_time = last_log_time = last_checkpoint_time = time.time()
        last_log_step = step
        learn_step = step * reuse  # on resume: the split is not saved
        last_log_learn_step = learn_step
        device_trace = DeviceTrace(flags.profile_dir)
        while step < flags.total_steps:
            timings.reset()
            batch, initial_agent_state = collector.collect()
            timings.time("collect")
            if overlap:
                adopt_head()
            device_stats, timers = [], []
            with _on_stream(learner_stream, initial_agent_state):
                # Split the [T+1, num_actors] unroll into learner batches
                # of batch_size columns; with supersteps, K consecutive
                # sub-batches stack into one [K, T+1, batch_size] dispatch,
                # applied in the order the per-update loop would.
                group = K * flags.batch_size
                for i in range(0, B, group):
                    if K > 1:
                        sub, sub_state = learner_lib.stack_superstep_columns(
                            batch, initial_agent_state, K, flags.batch_size,
                            offset=i)
                    else:
                        sub = {k: v[:, i : i + flags.batch_size]
                               for k, v in batch.items()}
                        # Batch is axis 1 of every state leaf (the
                        # transformer's state nests a (k, v, valid) tuple
                        # per layer).
                        sub_state = nest.map(
                            lambda s: s[:, i : i + flags.batch_size],
                            initial_agent_state)
                    sub = to_device(sub, learn_device, batch_dtype)
                    sub_state = precision.cast_batch(
                        nest.map(lambda t: t.to(learn_device), sub_state),
                        batch_dtype)
                    if target is not None:
                        # Once per fresh batch: its K' passes train
                        # against one target version.
                        sub = target.merge(sub, sub_state)
                    for r in range(reuse):
                        stats_k, timer = dispatch_timed(sub, sub_state)
                        device_stats.append(stats_k)
                        timers.append(timer)
                        for _ in range(K):
                            h_batch_size.observe(flags.batch_size)
                        watchdog.ping()
                        updates_done += K
                        if r == 0:
                            step += K * T * flags.batch_size
                        learn_step += K * T * flags.batch_size
                    if target is not None:
                        # Between reuse groups only.
                        target.maybe_refresh(updates_done, learn_params)
                if split is not None and not overlap:
                    # The rebind: acting takes this collect's updates
                    # (lag 0, as time-shared), queued behind them.
                    with torch.no_grad():
                        torch._foreach_copy_(act_params, learn_params)
                done = None
                if learn_device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                    if overlap:
                        head = done
            if pending is not None:
                stats = flush_stats(pending)
            pending = (timers, device_stats, step, done)
            timings.time("learn")

            now = time.time()
            if now - last_log_time > 5:
                sps = (step - last_log_step) / (now - last_log_time)
                learn_sps = (learn_step - last_log_learn_step) / (
                    now - last_log_time)
                last_log_time, last_log_step = now, step
                last_log_learn_step = learn_step
                g_sps.set(sps)
                g_env_sps.set(sps)
                g_learn_sps.set(learn_sps)
                # Dispatched-unflushed updates at this instant.
                g_dispatch_q.set(len(pending[0]) * K if pending else 0)
                tele.write(extra={"step": step})
                log.info(
                    "Steps %d @ %.1f SPS. Loss %s. %s", step, sps,
                    f"{stats['total_loss']:.4f}"
                    if "total_loss" in stats else "--",
                    f"Return {stats['mean_episode_return']:.1f}."
                    if "mean_episode_return" in stats else "",
                )
            if now - last_checkpoint_time > flags.checkpoint_interval_s:
                _synchronize(learn_device)
                save_train_state(checkpoint_path, model, optimizer,
                                 step=step, flags=vars(flags), stats=stats)
                last_checkpoint_time = now
        successful = True
    except KeyboardInterrupt:
        log.info("Interrupted; saving final checkpoint.")
        successful = True
    except BaseException:
        successful = False
        raise
    finally:
        watchdog.stop()
        # Flush the one-collect-delayed stats so the final checkpoint and
        # the return value are current even on interrupt (guarded: a
        # device error may surface here instead of at launch).
        if pending is not None:
            try:
                stats = flush_stats(pending)
            except Exception:
                log.exception("Could not flush final stats")
            pending = None
        g_dispatch_q.set(0)  # everything flushed (or abandoned) now
        elapsed = time.time() - start_time
        _synchronize(learn_device)
        if device_trace is not None:
            device_trace.stop()
        save_train_state(checkpoint_path, model, optimizer, step=step,
                         flags=vars(flags), stats=stats)
        tele.shutdown(step=step)
        plogger.close(successful=successful)
        pool.close()
    stats["sps"] = (step - start_step) / elapsed if elapsed > 0 else 0.0
    stats["update_ms_median"] = (
        statistics.median(update_ms) if update_ms else 0.0
    )
    stats["updates"] = updates_done
    # Frames learned from: env frames x --replay_reuse.
    stats["learn_sps"] = (updates_done * T * flags.batch_size / elapsed
                          if elapsed > 0 else 0.0)
    log.info("Learning finished after %d steps.", step)
    return stats


@contextlib.contextmanager
def _on_stream(stream, inputs):
    """Run the learner's dispatches on `stream` (None: the current one),
    after the work already queued on the current stream; `inputs`
    (tensors made there) stay allocated until `stream` has read them."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    for t in nest.flatten(inputs):
        t.record_stream(stream)
    with torch.cuda.stream(stream):
        yield


def _synchronize(device):
    """Wait for every stream of the card (a checkpoint reads the params
    and optimizer state the learner stream writes)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _checkpoint_path(flags, xpid):
    return os.path.join(os.path.expanduser(flags.savedir), xpid,
                        "model.ckpt")


def test(flags):
    """Greedy evaluation episodes (sample_action=False) from the params
    of the run's checkpoint ({savedir}/{xpid}/model.ckpt, or
    {savedir}/latest/ when --xpid is unset; either driver's, of any
    --opt_impl). Without a checkpoint it warns and tests the random init.
    Returns the episodes' returns."""
    check_flags(flags)
    device = select_device(flags)
    checkpoint_path = _checkpoint_path(flags, flags.xpid or "latest")
    num_actions, frame_shape = _probe_env(flags)
    model = build_model(flags, num_actions, frame_shape, device)
    if os.path.exists(checkpoint_path):
        load_params(checkpoint_path, model)
        log.info("Loaded checkpoint from %s", checkpoint_path)
    else:
        log.warning("No checkpoint at %s; testing random init.",
                    checkpoint_path)

    # Same seed contract as training: --env_seed pins the eval env's
    # draw stream so repeated evaluations of a checkpoint reproduce.
    env = Environment(
        create_env(flags.env, seed=getattr(flags, "env_seed", None))
    )
    returns = []
    observation = env.initial()
    agent_state = model.initial_state(1, device)
    with torch.no_grad():
        while len(returns) < flags.num_test_episodes:
            inputs = {
                k: torch.as_tensor(np.asarray(observation[k])[None, None])
                .to(device)
                for k in learner_lib.MODEL_INPUT_KEYS
            }
            out, agent_state = model(inputs, agent_state,
                                     sample_action=False)
            observation = env.step(int(out.action[0, 0]))
            if observation["done"]:
                returns.append(float(observation["episode_return"]))
                log.info("Episode ended after %d steps. Return: %.1f",
                         int(observation["episode_step"]), returns[-1])
    env.close()
    log.info(
        "Average returns over %i episodes: %.1f",
        len(returns), sum(returns) / len(returns),
    )
    return returns


def main(flags):
    _configure_logging()
    if flags.mode == "train":
        return train(flags)
    return test(flags)


def cli():
    install_preemption_handler()  # SIGTERM -> clean checkpointed exit
    main(make_parser().parse_args())


if __name__ == "__main__":
    cli()
