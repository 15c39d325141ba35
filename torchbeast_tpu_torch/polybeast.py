"""Scalable async IMPALA learner on one GPU (the port of
torchbeast_tpu/polybeast.py).

The runtime is the reference's: env servers in processes of their own
(polybeast_env.py), an ActorPool of socket actor loops feeding a
DynamicBatcher, whose inference threads run a bucket-padded acting
forward on the card through the device-resident state table
(runtime/state_table.py) for recurrent models; completed rollouts flow
through a BatchingQueue (backpressure) and a prefetcher that stages them
on the card (on a copy stream of its own) into the learner thread, which
runs the port's update step (learner.make_update_dispatch: one update, or
--superstep_k of them over a [K, T+1, B] stack that a BatchArena
assembles) with the hand-written kernels that --vtrace_impl pallas,
--opt_impl pallas and TBT_POOL_PALLAS=1 select.

The queue, the batcher and the actor pool are the port's C++ core
(runtime/native.py, built at first use from csrc/native/: the actor
loops, the batcher and the queue run GIL-free in C++ threads), or their
Python versions (runtime/queues.py, runtime/actor_pool.py), as the
reference's tri-state picks: --native_runtime requires the core and
raises when it cannot be built, --no_native_runtime takes the Python
pool, and the default takes the core and falls back to the Python pool,
logging why, when it cannot be built. --native_server serves the envs
with the core's C++ env server.

On the card every learner dispatch and every acting forward replays one
captured CUDA graph: the learner's, and one per inference bucket (the
state table's whole step, or the forward alone without the table), all
captured before the first thread starts, since a capture fails while
another thread launches CUDA work.

The port's update changes the learner's parameters in place, so acting
reads a separate copy of the model: after each dispatch the learner
copies its parameters into it under the state lock, on the stream of the
update (the reference rebinds its `infer_params` there). Every acting
forward runs under the same lock, so no forward sees a half-copied
update. The learner and acting launch on the device's default stream.

--device_split (runtime/placement.py, parallel/sebulba.py; the
reference's grammar, checks and errors) splits the devices into inference
slices and learner devices. The learner runs on the learner devices: one
takes the one-device update pinned there (the fused tail included), more
the data-parallel learner over exactly them. No central batcher: each
slice has its own batcher (a core DynamicBatcher behind the core's
SliceRouter on the native runtime), a copy of the acting model on its
device as its snapshot buffer, a state table pinned there, and
--num_inference_threads serving loops, all on a CUDA stream of the
slice's own; actors hash to slices by slot. The learner publishes a bf16
snapshot of its params every --replica_refresh_updates updates (every
update by default, version 0 before serving starts), each slice copies a
version to its device once, after the publish's event, and stamps each
reply's policy_lag; a slice takes no lock of the learner's. On the card
each slice's acting steps are graphs of their own, captured with the
learner's before the threads start. A single visible device degrades to
the time-shared path with the reference's warning; a multi-process run
refuses the split with the reference's ValueError.

Checkpoints are the reference's own files (utils/checkpoint.py): one
every --checkpoint_interval_s and one at exit, also on SIGTERM under
cli() (and under train() when a --chaos_plan plans `preempt_sigterm`);
a run resumes from {savedir}/{xpid}/model.ckpt when it exists,
whichever package wrote it. `--mode test` runs monobeast's greedy test.

Telemetry is the reference's (telemetry/driver.py): {xpid}/telemetry.jsonl
on every monitor tick and at exit, --telemetry_port, --trace_path and
--profile_dir (a torch.profiler trace). On the native runtime the core's
series fold into the registry from a tick callback
(runtime/native.NativeTelemetryFolder). Each line carries the run's
remat plan (the `learner.remat_plan` static) and the
`learner.hbm_bytes_per_update` gauge, as monobeast's do.

--num_experts N gives --model transformer a mixture-of-experts FFN
(models/moe.py), built by monobeast.build_model like every other model
instance here, so the acting copy, the bf16 snapshots and the replicas
carry the expert leaves; its load-balance loss joins the objective and is
reported as aux_loss. --expert_parallel K > 1 splits each MoE layer's
experts over an `expert` mesh axis (parallel/ep.py): with
--num_learner_devices N > 1 the learner mesh is the reference's
composite data N x expert K grid, expert innermost (each data row's
replica runs its experts on its row's K devices; bf16_train and
--factored_opt_state raise the reference's RuntimeError there), and
with N = 1 the reference's 1-D expert mesh under the one-device update.
Acting reads the lead replica, whose layers run on the first row's
expert devices.

--num_learner_devices N > 1 makes the learner the reference's plain
data-parallel one (parallel/dp.py): each dispatch's batch splits over N
devices, one model replica each, whose gradients the lead device sums
and applies with the --opt_impl xla chain before every replica takes the
lead's params. Acting, snapshots and checkpoints read the lead replica
(the reference's local_view). --coordinator_address host:port (or the
TORCHBEAST_COORDINATOR, TORCHBEAST_NUM_PROCESSES and
TORCHBEAST_PROCESS_ID variables) joins several processes in one
torch.distributed group (nccl on the card, gloo under --disable_cuda):
every process runs its own env servers, actors and inference on
batch_size / processes rows, all of them run the same number of
collective updates (the gradient sum is all-reduced), the lead process
alone checkpoints, and the others log under {xpid}-host{rank}. The
reference's multi-host checks come first (an explicit --xpid, N above 1
and divisible by the processes, batch_size divisible too).

--sequence_parallel P > 1 shards the transformer's unroll axis over a
`seq` mesh axis (monobeast's checks and ops): alone, the one-device
learner over monobeast.seq_mesh; with --num_learner_devices N > 1 the
reference's composite data N x seq P (x expert K) grid, each data row's
replica running its attention over its row's seq devices (the fused
tail refused there, as on every learner mesh). The acting copy runs the
dense path.

--fleet host=<rank>/<n>,coord=<host:port> (fleet/) makes this process
host <rank> of an n-host fleet: each host runs its own env servers (on
its host-scoped addresses and env seeds), actors and inference over
batch_size / n rows. The learner composes by parallel.fleet_strategy,
from the device: on CUDA ("xla", the reference's name) the hosts join
one torch.distributed group at coord (NCCL; a group the caller has
already joined is taken as it is) and the learner mesh's data axis runs
host-major over every host's learner devices; on the CPU ("wire") each
host updates alone and the fleet coordinator averages the params after
every dispatch. With more than one host the coordinator's control plane
(coord's port + 1) carries heartbeats (a remote incident a sticky
fleet.host<r> on the lead), host loss (sticky fleet.host<r>_lost above
--min_live_hosts, a halt of every host below it), and the lead's policy
snapshots into the remotes' stores. The lead alone checkpoints; the
others log under {xpid}-host{rank}. The reference's checks come first
(an explicit --xpid, batch_size divisible by the hosts, a data-only
mesh, not with --coordinator_address).

--remat, --hbm_budget_gb and --transformer_remat are monobeast's
(runtime/remat_plan.py): the plan is resolved once, and the learner's
model, the acting copy, the IMPACT target network and the replica model
are all built from it (each copy keeps the levers; under torch.no_grad()
no region is recomputed, so acting is the same under every plan).

The serving tier (serving/) on both runtimes: --request_deadline_ms arms
the admission gate (the Python AdmissionController on the Python
batcher, the core's own gate under --native_runtime), whose sheds the
actors re-submit; --replica_refresh_updates N publishes a bf16 snapshot
of the acting params every N updates, which a replica serving thread
answers requests from through the state table's replica graphs, stamping
each reply's policy_lag, behind a router (the core's ReplicaRouter under
--native_runtime, serving/replica.ReplicaRouter otherwise) that falls
back to the central path past --max_policy_lag. --chaos_plan arms the
fault injector (resilience/chaos.py) on either runtime.

--loss impact trains the IMPACT surrogate (ops/impact.py) against a
target network (learner.TargetNetwork: a second model instance, its
forward one CUDA graph of its own on the card), whose outputs join each
dispatch's batch; the target runs per dispatch, so replay handouts see
the current target, and is refreshed after a dispatch when
--target_refresh_updates are due. --replay_reuse K' hands each staged
batch out K' times through the arena (runtime/queues.BatchArena, a
unit-column one at K=1); env frames advance on the fresh handout only,
and the run ends at --total_steps once the last batch's replays are
learned from. Under impact the replica tier is armed every 10 updates
unless --replica_refresh_updates says otherwise.

The parser takes every flag of the reference with the same name, type,
default and choices, plus --disable_cuda. Every feature of the
reference's flags is in the port.

Run:  python -m torchbeast_tpu_torch.polybeast --env Mock --use_lstm \\
          --num_servers 16 --batch_size 32 --vtrace_impl pallas \\
          --opt_impl pallas
"""

import argparse
import dataclasses
import contextlib
import copy
import logging
import os
import queue as stdlib_queue
import signal
import statistics
import threading
import time

import numpy as np
import torch

from torchbeast_tpu_torch import graphs
from torchbeast_tpu_torch import learner as learner_lib
from torchbeast_tpu_torch import nest, polybeast_env, precision, telemetry
from torchbeast_tpu_torch import monobeast, parallel, weights
from torchbeast_tpu_torch.fleet import (
    FleetCoordinator,
    compose_fleet_mesh_devices,
    fleet_rendezvous,
    parse_fleet_spec,
)
from torchbeast_tpu_torch.models.transformer import set_seq_devices
from torchbeast_tpu_torch.resilience import (
    ChaosController,
    FaultPlan,
    InferenceSupervisor,
    LearnerWatchdog,
    PipelineHealth,
)
from torchbeast_tpu_torch.runtime import native, remat_plan, wire
from torchbeast_tpu_torch.runtime.actor_pool import ActorPool
from torchbeast_tpu_torch.runtime.inference import (
    default_buckets,
    inference_loop,
    to_device,
    to_host,
)
from torchbeast_tpu_torch.runtime.queues import (
    BatchArena,
    BatchingQueue,
    DevicePrefetcher,
    DynamicBatcher,
)
from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable
from torchbeast_tpu_torch.serving import (
    AdmissionController,
    PolicySnapshotStore,
    ReplicaRouter,
    ReplicaServingHooks,
)
from torchbeast_tpu_torch.utils import (
    FileWriter,
    Timings,
    install_preemption_handler,
)
from torchbeast_tpu_torch.utils.checkpoint import (
    load_train_state,
    save_train_state,
)
from torchbeast_tpu_torch.utils.prof import DeviceTrace

log = logging.getLogger("torchbeast_tpu_torch.polybeast")



def _configure_logging():
    """Called from main(), not at import."""
    logging.basicConfig(
        format=(
            "[%(levelname)s:%(process)d %(module)s:%(lineno)d "
            "%(asctime)s] %(message)s"
        ),
        level=logging.INFO,
    )


def make_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pipes_basename", default="unix:/tmp/torchbeast_tpu",
                        help="Env-server addresses: unix:/path, "
                             "host:baseport or shm:/path.")
    # beastlint: disable=FLAG-PARITY  poly derives the default from --num_servers; mono has no servers
    parser.add_argument("--num_actors", type=int, default=None,
                        help="Actor loops (default: one per server).")
    parser.add_argument("--num_servers", type=int, default=4)
    parser.add_argument("--env", type=str, default="PongNoFrameskip-v4",
                        help="Mock, Counting, Catch, Memory[-L<n>], "
                             "tbt/MiniAtari-v0 or a gymnasium Atari id "
                             "(needs ale_py).")
    parser.add_argument("--mode", default="train", choices=["train", "test"],
                        help="test: greedy episodes from the run's "
                             "checkpoint (monobeast's test).")
    parser.add_argument("--num_test_episodes", type=int, default=10)
    parser.add_argument("--xpid", default=None)
    parser.add_argument("--start_servers", dest="start_servers",
                        action="store_true", default=True,
                        help="Spawn local env servers (the combined "
                             "launcher mode).")
    parser.add_argument("--no_start_servers", dest="start_servers",
                        action="store_false",
                        help="Connect to externally launched servers.")
    parser.add_argument("--savedir", default="~/logs/torchbeast_tpu")
    parser.add_argument("--total_steps", type=int, default=100000)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--vtrace_impl", default="associative",
                        choices=["sequential", "associative", "pallas"],
                        help="V-trace recursion: a log-depth scan (the "
                             "default), a loop over t, or the CUDA "
                             "kernel csrc/vtrace.cu ('pallas').")
    parser.add_argument("--unroll_length", type=int, default=80)
    # beastlint: disable=FLAG-PARITY  paper defaults differ: polybeast trains the deep IMPALA net, monobeast the shallow one
    parser.add_argument("--model", default="deep",
                        choices=["shallow", "deep", "mlp", "pipelined_mlp",
                                 "transformer", "pipelined_transformer"],
                        help="shallow (AtariNet), deep (IMPALA ResNet), "
                             "mlp, transformer, or the stage-stacked "
                             "pipelined_mlp and pipelined_transformer "
                             "(their towers run sequentially on one "
                             "device, at their default depths).")
    parser.add_argument("--use_lstm", action="store_true")
    parser.add_argument("--precision", default="f32",
                        choices=["f32", "bf16_compute", "bf16_train"],
                        help="Precision policy (torchbeast_tpu_torch/"
                             "precision.py).")
    parser.add_argument("--model_dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="Deprecated alias of --precision "
                             "bf16_compute.")
    parser.add_argument("--factored_opt_state", action="store_true",
                        help="Factored RMSprop second moment (--opt_impl "
                             "xla only).")
    parser.add_argument("--trunk_channels", default="",
                        help="Deep-trunk widths as a comma list.")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--env_seed", type=int, default=None,
                        help="Base seed for stochastic envs (server i "
                             "seeds from env_seed + i*1000).")
    parser.add_argument("--num_inference_threads", type=int, default=2)
    # Tri-state: None (default) = native-first with a logged fallback to
    # the Python pool when the core cannot be built; True = the core is
    # required (a run asking for it never reports Python-pool numbers);
    # False = the Python pool.
    parser.add_argument("--native_runtime", dest="native_runtime",
                        action="store_true", default=None,
                        help="Require the C++ queues, batcher and actor "
                             "pool (the port's core, built at first use "
                             "from torchbeast_tpu_torch/csrc/native/); a "
                             "core that cannot be built is an error. The "
                             "default (neither flag) takes the core and "
                             "falls back to the Python pool, logging "
                             "why, when it cannot be built.")
    parser.add_argument("--no_native_runtime", dest="native_runtime",
                        action="store_false",
                        help="The Python queues, batcher and actor pool "
                             "(the semantic reference).")
    parser.add_argument("--native_server", action="store_true",
                        help="Serve environments with the core's C++ "
                             "EnvServer (combined-launcher mode only).")
    parser.add_argument("--max_server_restarts", type=int, default=10,
                        help="Respawn budget for dead env servers.")
    parser.add_argument("--sequence_parallel", type=int, default=0,
                        help="Shard the transformer's unroll (time) axis "
                             "over N devices (ring or Ulysses attention "
                             "over a `seq` mesh; model=transformer only, "
                             "unroll_length+1 divisible by N; acting "
                             "runs the dense path).")
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
    parser.add_argument("--pipeline_parallel", type=int, default=0,
                        help="Run the pipelined_mlp / "
                             "pipelined_transformer tower as a GPipe "
                             "pipeline over N devices (a `pipe` mesh "
                             "axis, inside the data axis with "
                             "--num_learner_devices > 1).")
    parser.add_argument("--pipeline_microbatches", type=int, default=0,
                        help="Microbatches per pipelined forward "
                             "(default: one per pipeline device).")
    parser.add_argument("--num_experts", type=int, default=0,
                        help="Replace the transformer's FFN with a top-2 "
                             "mixture of N experts (model=transformer "
                             "only; adds a sown load-balance loss).")
    parser.add_argument("--expert_parallel", type=int, default=0,
                        help="Shard the MoE experts over N devices (an "
                             "`expert` mesh axis, inside the data axis "
                             "with --num_learner_devices > 1).")
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
    parser.add_argument("--tensor_parallel", type=int, default=0,
                        help="Megatron-split the transformer's blocks "
                             "over N devices (a `model` mesh axis inside "
                             "the data axis; --model transformer "
                             "only).")
    parser.add_argument("--device_split", default="",
                        help="Sebulba device split (runtime/placement."
                             "py): partition the devices into "
                             "dedicated inference slices + learner "
                             "devices, so acting batches never "
                             "time-share a device with the update step. "
                             "'auto' pins 1 of every 4 devices to "
                             "inference; 'inf=K,learn=rest' (or "
                             "learn=M) pins exactly. Each inference "
                             "device is one slice with its own batcher "
                             "and pinned DeviceStateTable; actors hash "
                             "statically to slices (slot state never "
                             "migrates); slices serve versioned "
                             "snapshots copied device-to-device from "
                             "the PolicySnapshotStore (--replica_"
                             "refresh_updates sets the cadence, default "
                             "every update; --max_policy_lag "
                             "degradation applies per slice). The "
                             "learner runs on the remaining devices, "
                             "data-parallel over more than one "
                             "(batch_size divisible by their count). "
                             "Empty = the time-shared path; a "
                             "single-device process degrades to it with "
                             "a warning.")
    parser.add_argument("--admission_depth_factor", type=int, default=4,
                        help="Admission-gate queue-depth bound as a "
                             "multiple of --max_inference_batch_size: "
                             "with --request_deadline_ms armed, requests "
                             "arriving while the serving queue already "
                             "holds factor * max_batch pending rows are "
                             "shed.")
    parser.add_argument("--continuous_batching", dest="continuous_batching",
                        action="store_true", default=True,
                        help="Native runtime only; the Python batcher "
                             "ignores it.")
    parser.add_argument("--no_continuous_batching",
                        dest="continuous_batching", action="store_false",
                        help="Native runtime only.")
    parser.add_argument("--num_learner_devices", type=int, default=1,
                        help="Data-parallel learner over N devices (in "
                             "all, over every process); batch_size must "
                             "divide by N.")
    parser.add_argument("--coordinator_address", default=None,
                        help="host:port of process 0 of a multi-process "
                             "run (torch.distributed; the process count "
                             "and id come from TORCHBEAST_NUM_PROCESSES "
                             "and TORCHBEAST_PROCESS_ID).")
    parser.add_argument("--fleet", default=None,
                        help="Multi-host fleet membership (fleet/"
                             "topology.py): 'host=<rank>/<n>,coord="
                             "<host:port>' names this host's rank, the "
                             "fleet size and the rendezvous (the "
                             "process group on CUDA; port+1 carries the "
                             "control plane: heartbeats, snapshots, "
                             "param sync). On the CPU the hosts compose "
                             "by synchronous parameter averaging "
                             "(parallel/dp.py fleet_strategy). Unset: "
                             "one host.")
    parser.add_argument("--min_live_hosts", type=int, default=1,
                        help="Fleet degradation floor (--fleet runs): "
                             "losing a host marks the fleet DEGRADED "
                             "(sticky fleet.host<r>_lost) while at "
                             "least this many hosts stay live; below "
                             "it every host checkpoints and exits.")
    parser.add_argument("--device_agent_state", dest="device_agent_state",
                        action="store_true", default=True,
                        help="Keep recurrent agent state in the "
                             "device-resident slot table (default).")
    parser.add_argument("--no_device_agent_state",
                        dest="device_agent_state", action="store_false",
                        help="Agent state rides every inference request "
                             "and reply.")
    parser.add_argument("--prewarm_inference", action="store_true",
                        help="Run every inference bucket once before "
                             "actors connect.")
    parser.add_argument("--max_inference_batch_size", type=int, default=64)
    parser.add_argument("--inference_timeout_ms", type=float, default=100)
    parser.add_argument("--request_deadline_ms", type=float, default=0.0,
                        help="Arm the admission gate (serving/"
                             "admission.py): requests that would queue "
                             "past this deadline, or arrive while the "
                             "queue is at its depth bound, are shed "
                             "with a typed ShedError the actor "
                             "re-submits after backoff. The same number "
                             "is the SLO target of the telemetry `slo` "
                             "block. 0 = no admission control.")
    parser.add_argument("--replica_refresh_updates", type=int, default=0,
                        help="Serve acting requests from versioned bf16 "
                             "policy snapshots published every N "
                             "updates (serving/), recording each "
                             "request's policy_lag into the rollout. "
                             "0 = central serving only.")
    parser.add_argument("--max_policy_lag", type=int, default=20,
                        help="Replica staleness budget: past it the "
                             "replica degrades to the central path.")
    parser.add_argument("--max_frame_bytes", type=int,
                        default=wire.DEFAULT_MAX_FRAME_BYTES,
                        help="Reject wire frames longer than this before "
                             "allocating.")
    parser.add_argument("--superstep_k", type=int, default=1,
                        help="K learner updates per dispatch (one CUDA "
                             "graph) over a [K, T+1, B] arena stack.")
    parser.add_argument("--max_learner_queue_size", type=int, default=None,
                        help="Backpressure bound (default: batch_size).")
    parser.add_argument("--actor_connect_timeout_s", type=float,
                        default=600.0,
                        help="Per-attempt actor connect deadline.")
    parser.add_argument("--max_actor_reconnects", type=int, default=3,
                        help="Reconnects per actor (with jittered "
                             "backoff) on env-server transport failure.")
    parser.add_argument("--min_live_actors", type=int, default=1,
                        help="Below this many live actor loops the run "
                             "checkpoints and exits (health HALTED).")
    parser.add_argument("--inference_restart_budget", type=int, default=3,
                        help="Rebuilds of a poisoned state table before "
                             "the pipeline halts.")
    parser.add_argument("--learner_stall_timeout_s", type=float,
                        default=300.0,
                        help="No update within this many seconds degrades "
                             "health and dumps diagnostics; 0 disables.")
    parser.add_argument("--chaos_plan", default=None,
                        help="Arm a deterministic fault-injection plan "
                             "(JSON, resilience/chaos.py). Injected "
                             "faults are counted in telemetry so "
                             "recovery can be asserted exactly "
                             "(python -m torchbeast_tpu_torch.chaos_run).")
    parser.add_argument("--checkpoint_interval_s", type=int, default=600)
    telemetry.add_arguments(parser)
    parser.add_argument("--entropy_cost", type=float, default=0.0006)
    parser.add_argument("--entropy_cost_final", type=float, default=None,
                        help="Linearly anneal the entropy cost to this "
                             "over total_steps.")
    parser.add_argument("--baseline_cost", type=float, default=0.5)
    parser.add_argument("--discounting", type=float, default=0.99)
    parser.add_argument("--reward_clipping", default="abs_one",
                        choices=["abs_one", "none"])
    parser.add_argument("--loss", default="vtrace",
                        choices=["vtrace", "impact"],
                        help="Objective family: IMPALA V-trace (the "
                             "default) or the IMPACT clipped "
                             "target-network surrogate (ops/impact.py), "
                             "lag-tolerant, for --replay_reuse. Under "
                             "impact the default --replica_refresh_updates "
                             "relaxes to every 10 updates.")
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
    parser.add_argument("--alpha", type=float, default=0.99)
    parser.add_argument("--momentum", type=float, default=0.0)
    parser.add_argument("--epsilon", type=float, default=0.01)
    parser.add_argument("--grad_norm_clipping", type=float, default=40.0)
    parser.add_argument("--profile_dir", default=None,
                        help="If set, capture a torch.profiler trace "
                             "here (trace.json).")
    parser.add_argument("--disable_cuda", action="store_true",
                        help="Run on the CPU (the port's only flag the "
                             "reference lacks; without it and without a "
                             "CUDA device the trainer raises).")
    return parser


XPID_REFUSAL = (
    "multi-host runs need an explicit --xpid (the timestamp default would "
    "differ per host and break checkpoint resume)")


def _above_one(flags, dest) -> bool:
    return (getattr(flags, dest, 0) or 0) > 1


FLEET_COORDINATOR_REFUSAL = (
    "--fleet and --coordinator_address are exclusive: the "
    "fleet's coord= endpoint IS the rendezvous address"
)


def check_fleet_refusal(flags):
    """--fleet parsed (fleet.parse_fleet_spec, the reference's grammar
    errors) and checked as the reference checks it (polybeast.py:
    568-615): not with --coordinator_address; with more than one host an
    explicit --xpid, the global batch divisible by the hosts and a
    data-only learner mesh. Returns the FleetSpec, or None."""
    spec = parse_fleet_spec(getattr(flags, "fleet", None))
    if spec is None:
        return None
    if flags.coordinator_address:
        raise ValueError(FLEET_COORDINATOR_REFUSAL)
    num_hosts = spec.num_hosts
    if num_hosts <= 1:
        return spec
    if flags.xpid is None:
        raise ValueError(XPID_REFUSAL)
    if flags.batch_size % num_hosts != 0:
        raise ValueError(
            f"--batch_size {flags.batch_size} (global) must be "
            f"divisible by the fleet's {num_hosts} hosts"
        )
    if any(_above_one(flags, f) for f in (
            "expert_parallel", "sequence_parallel", "tensor_parallel",
            "pipeline_parallel")):
        raise ValueError(
            "--fleet composes a data-only learner mesh; it does "
            "not compose with --expert_parallel/--sequence_"
            "parallel/--tensor_parallel/--pipeline_parallel yet"
        )
    return spec


def check_tp_flags(flags) -> None:
    """The reference's checks of --tensor_parallel > 1
    (polybeast.py:815-830): the transformer only, and not with SP or
    PP."""
    if not _above_one(flags, "tensor_parallel"):
        return
    if flags.model != "transformer":
        raise ValueError(
            "--tensor_parallel needs --model transformer (the "
            "Megatron pairing targets its projection/FFN layout)"
        )
    if _above_one(flags, "sequence_parallel") or _above_one(
            flags, "pipeline_parallel"):
        raise ValueError(
            "--tensor_parallel composes with --num_learner_devices "
            "and --expert_parallel, not with --sequence_parallel or "
            "--pipeline_parallel (their shard_maps leave the "
            "`model` axis unmentioned, which would force gathers of "
            "the head-sharded projections every layer)"
        )


def check_flags(flags):
    """The reference's errors for the parallelism flags, before any side
    effect: the fleet's (returns its FleetSpec, or None), the TP checks,
    the MoE checks, PP with SP or EP (monobeast.check_pp_combination),
    the SP checks (monobeast.check_sp_flags) and monobeast.
    check_parallel_flags'."""
    spec = check_fleet_refusal(flags)
    check_tp_flags(flags)
    monobeast.check_moe_flags(flags)
    monobeast.check_pp_combination(flags)
    monobeast.check_sp_flags(flags)
    monobeast.check_parallel_flags(flags)
    return spec


# The reference's refusal of --device_split across processes without its
# fleet (polybeast.py:681-687).
SPLIT_MULTIHOST_REFUSAL = (
    "--device_split with bare --coordinator_address "
    "multi-host is not supported: use --fleet host=<rank>/"
    "<n>,coord=<addr> — the fleet plane composes the split "
    "per host over DCN (fleet/topology.py)"
)


def effective_replica_refresh_updates(flags) -> int:
    """Resolved --replica_refresh_updates. An explicit value always
    wins. Under --loss impact the default relaxes to every 10 updates:
    the clipped surrogate absorbs the extra policy lag. V-trace keeps the
    default 0 (central serving only)."""
    explicit = getattr(flags, "replica_refresh_updates", 0) or 0
    if explicit > 0:
        return explicit
    if getattr(flags, "loss", "vtrace") == "impact":
        return 10
    return 0


def _probe_env_via_server(flags, address, timeout_s: float = 60.0):
    """(num_actions, frame shape) from a running env server, or from a
    local probe when none answers in time (the local env id is the
    same)."""
    from torchbeast_tpu_torch.runtime import transport as transport_lib

    deadline = time.monotonic() + timeout_s
    last_error = None
    while time.monotonic() < deadline:
        stream = None
        try:
            stream = transport_lib.connect_transport(
                address, timeout_s=min(5.0, timeout_s),
                recv_timeout_s=5.0,
            )
            step = stream.recv()
            if not isinstance(step, dict) or step.get("type") == "error":
                last_error = RuntimeError(f"server replied {step!r:.200}")
                step = None  # drop transport-buffer views before close
                break
            if "num_actions" not in step:
                last_error = KeyError(
                    "server does not advertise num_actions"
                )
                step = None
                break
            frame_shape = tuple(np.asarray(step["frame"]).shape)
            num_actions = int(step["num_actions"])
            step = None
            return num_actions, frame_shape
        except (OSError, TimeoutError) as e:  # not up yet: retry
            last_error = e
            time.sleep(0.2)
        except wire.WireError as e:
            last_error = e
            break
        finally:
            if stream is not None:
                stream.close()
    log.warning(
        "Could not probe env spec from %s (%s); probing locally.",
        address, last_error,
    )
    return monobeast._probe_env(flags)


def _counter_values(reg, names):
    return {name: reg.counter(name).value() for name in names}


def select_runtime(flags):
    """The port's core for --native_runtime (and auto), else None: the
    reference's tri-state. An explicit --native_runtime, or
    --native_server, raises with the builder's message when the core
    cannot be built; auto logs it and takes the Python pool."""
    pref = getattr(flags, "native_runtime", None)
    if getattr(flags, "native_server", False):
        native.require("--native_server")
    if pref is False:
        log.info("Using the Python runtime (--no_native_runtime).")
        return None
    if pref is True:
        core = native.require("--native_runtime")
    else:
        core = native.import_native()
        reason = native.gap_reason(core)
        if reason is not None:
            log.warning("Native runtime unavailable (%s); falling back to "
                        "the Python pool.", reason)
            return None
    log.info("Using the native (C++) runtime: %s", core.__file__)
    return core


def train(flags):
    """Train; returns the last flushed stats, plus "sps" (env frames per
    second of this run), "learn_sps" (frames learned from per second:
    env frames x --replay_reuse), "update_interval_ms_median" (between CUDA
    events recorded before and after each update on the default stream,
    which the acting forwards share, so their kernels in between count
    too; the host clock on the CPU), "updates", "inference_batch_mean"
    (rows per acting forward), "runtime" ("native" or "python"),
    "actor_pool" (the pool's class), the health summary and, under
    --chaos_plan, the injector's summary ("chaos")."""
    fleet = check_flags(flags)
    superstep_k = getattr(flags, "superstep_k", 1)
    if superstep_k < 1:
        raise ValueError(f"--superstep_k must be >= 1, got {superstep_k}")
    if flags.admission_depth_factor < 1:
        raise ValueError("--admission_depth_factor must be >= 1, got "
                         f"{flags.admission_depth_factor}")
    device = monobeast.select_device(flags)
    backend = "nccl" if device.type == "cuda" else "gloo"
    strategy = None
    if fleet is not None:
        # On CUDA the hosts join one process group ("xla"); on the CPU
        # none ("wire": the control plane averages the params).
        strategy = parallel.fleet_strategy(device)
        if strategy == "xla" and torch.distributed.is_initialized():
            _check_existing_group(fleet)
            joined = False
        else:
            fleet_rendezvous(fleet, strategy, backend=backend)
            joined = strategy == "xla"
    else:
        # No-op (with a log line) when no coordinator is configured by
        # flag or TORCHBEAST_COORDINATOR.
        joined = parallel.initialize_distributed(
            flags.coordinator_address, backend=backend)
    try:
        return _train(flags, device, fleet, strategy)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _check_existing_group(fleet) -> None:
    """A process group the caller joined before train() (a worker script
    choosing its own backend) serves the fleet's learner when it has the
    fleet's hosts and this host's rank; else the fleet raises."""
    dist = torch.distributed
    world, rank = dist.get_world_size(), dist.get_rank()
    if (world, rank) != (fleet.num_hosts, fleet.host_rank):
        raise ValueError(
            f"--fleet host={fleet.host_rank}/{fleet.num_hosts} but the "
            f"process group joined before it has rank {rank} of {world}")
    log.info("Fleet rendezvous: the process group already joined (%s, "
             "%d hosts)", dist.get_backend(), world)


def check_multihost_flags(flags, proc_count: int) -> None:
    """The reference's checks of a multi-process run (polybeast.py:
    616-647): an explicit --xpid, a learner over more than one device
    and divisible by the processes, a global batch divisible by them."""
    if proc_count <= 1:
        return
    if flags.xpid is None:
        raise ValueError(XPID_REFUSAL)
    if flags.num_learner_devices <= 1:
        raise ValueError(
            "multi-host runs need --num_learner_devices > 1 (each "
            "host training single-device would silently diverge)"
        )
    if flags.num_learner_devices % proc_count != 0:
        raise ValueError(
            f"--num_learner_devices {flags.num_learner_devices} must "
            f"be divisible by the {proc_count} processes"
        )
    if flags.batch_size % proc_count != 0:
        raise ValueError(
            f"--batch_size {flags.batch_size} (global) must be "
            f"divisible by the {proc_count} processes"
        )


def _check_pipe_model(flags, mesh, batch_axis):
    """The reference's pipeline checks on the composite (data x pipe)
    learner mesh (monobeast.check_pipelined_model, then
    monobeast.check_pp_flags over `batch_axis`); the microbatch count."""
    monobeast.check_pipelined_model(flags)
    return monobeast.check_pp_flags(flags, mesh, batch_axis)


@dataclasses.dataclass(frozen=True)
class _HostDevice:
    """A device of a fleet host, as fleet.compose_fleet_mesh_devices
    reads one (its owner's rank, an id)."""

    process_index: int
    id: int
    device: torch.device


def _fleet_learner_mesh(fleet, flags, device):
    """The process-group fleet's learner mesh: every host's split
    resolved over its devices with the same spec, the learner group
    host-major (fleet.compose_fleet_mesh_devices; hosts are uniform, so
    this host's devices stand for each host's), the mesh over this
    host's part of it, its data axis spanning the hosts' group."""
    local = parallel.visible_devices(device.type)
    tagged = [_HostDevice(r, i, d) for r in range(fleet.num_hosts)
              for i, d in enumerate(local)]
    _, learners = compose_fleet_mesh_devices(
        fleet, getattr(flags, "device_split", ""), tagged)
    return parallel.create_mesh(devices=[
        d.device for d in learners if d.process_index == fleet.host_rank])


def _train(flags, device, fleet=None, strategy=None):
    """train's body, inside the process group when one was joined."""
    superstep_k = getattr(flags, "superstep_k", 1)
    proc_count = parallel.process_count()
    # One host identity for every host-scoped convention (xpid suffix,
    # pipe addresses, env seeds): the fleet rank when --fleet names one,
    # else the process index; the wire strategy keeps proc_count 1 while
    # the fleet spans n_hosts runtimes.
    n_hosts = fleet.num_hosts if fleet is not None else proc_count
    host_rank = (fleet.host_rank if fleet is not None
                 else parallel.process_index())
    is_lead = host_rank == 0
    if fleet is None:
        check_multihost_flags(flags, proc_count)
    # The device split, resolved and checked before any side effect; None
    # is the time-shared path (the single-device degradation included).
    split = monobeast.resolve_split(
        flags, device, ("expert_parallel", "sequence_parallel",
                        "pipeline_parallel", "tensor_parallel"))
    if split is not None and proc_count > 1 and fleet is None:
        raise ValueError(SPLIT_MULTIHOST_REFUSAL)
    n_dev = flags.num_learner_devices
    expert_par = max(1, getattr(flags, "expert_parallel", 0) or 0)
    tensor_par = max(1, getattr(flags, "tensor_parallel", 0) or 0)
    pipe_par = max(1, getattr(flags, "pipeline_parallel", 0) or 0)
    seq_par = max(1, getattr(flags, "sequence_parallel", 0) or 0)
    mesh = ep_mesh = pp_mesh = sp_mesh = None
    if fleet is not None and strategy == "xla":
        # One mesh whose data axis runs host-major over every host's
        # learner devices.
        mesh = _fleet_learner_mesh(fleet, flags, device)
        device = mesh.lead
        if device.type == "cuda":
            torch.cuda.set_device(device)
    elif split is not None:
        # The split's learner: plain DP over exactly its learner devices,
        # or the one-device learner pinned to its one. From here on
        # `device` is the learner's.
        if len(split.learner_devices) > 1:
            mesh = parallel.create_mesh(devices=list(split.learner_devices))
            device = mesh.lead
        else:
            device = torch.device(split.learner_devices[0])
        if device.type == "cuda":
            torch.cuda.set_device(device)
    elif n_dev > 1 or tensor_par > 1:
        # The reference's composite mesh: data x (model | seq | pipe |
        # expert) over num_learner_devices x inner devices.
        mesh = monobeast.learner_mesh(device, n_dev, expert_par,
                                      tensor_par, pipe_par, seq_par)
    n_microbatches = None
    if mesh is not None and pipe_par > 1:
        n_microbatches = _check_pipe_model(flags, mesh, "data")
    local_rows = flags.batch_size // n_hosts
    if mesh is not None:
        if fleet is not None and strategy == "wire":
            # The wire strategy's mesh is host-local: it shards this
            # host's rows, not the fleet's batch.
            if local_rows % mesh.shape["data"] != 0:
                raise ValueError(
                    f"per-host batch rows {local_rows} not divisible by "
                    f"the local learner mesh's data axis "
                    f"({mesh.shape['data']})"
                )
        elif flags.batch_size % mesh.shape["data"] != 0:
            raise ValueError(
                f"batch_size {flags.batch_size} not divisible by "
                f"the learner mesh's data axis ({mesh.shape['data']})"
            )
        if getattr(flags, "opt_impl", "xla") == "pallas":
            raise ValueError(
                "--opt_impl pallas does not compose with the sharded "
                "learner meshes yet (the fused tail is a per-chip "
                "kernel; its sharded-update story is the Sebulba "
                "item's)"
            )
        if (expert_par > 1 or tensor_par > 1) and (
            precision.resolve_flags(flags).param_dtype == "bf16"
            or getattr(flags, "factored_opt_state", False)
        ):
            raise RuntimeError(
                "--precision bf16_train / --factored_opt_state do "
                "not compose with --expert_parallel/--tensor_"
                "parallel yet (optimizer-state sharding rules need "
                "a params-mirroring state tree)"
            )
    else:
        sp_mesh = monobeast.seq_mesh(device, flags)
        ep_mesh = monobeast.expert_mesh(device, flags) or (
            sp_mesh if sp_mesh is not None and "expert" in sp_mesh.shape
            else None)
        pp_mesh = monobeast.pipe_mesh(device, flags)
        if pp_mesh is not None:
            n_microbatches = monobeast.check_pp_flags(flags, pp_mesh)
    # Before the env servers start: with --native_server each of them
    # loads the core, which is then built once, here.
    core = select_runtime(flags)
    if flags.xpid is None:
        flags.xpid = "polybeast-tpu-torch-%s" % time.strftime(
            "%Y%m%d-%H%M%S")
    plogger = FileWriter(
        xpid=flags.xpid if is_lead else f"{flags.xpid}-host{host_rank}",
        xp_args=vars(flags), rootdir=flags.savedir
    )
    # Telemetry: one process-wide registry every runtime stage writes
    # into; snapshots append to {xpid}/telemetry.jsonl on the monitor
    # cadence.
    tele = telemetry.DriverTelemetry(
        flags, plogger.paths["telemetry"], driver="polybeast")
    telemetry_on = tele.enabled
    reg = tele.registry
    # Host identity on every line: multi-host analyses join the
    # per-host telemetry.jsonl files on these two statics.
    tele.set_static("host_rank", host_rank)
    tele.set_static("fleet_size", n_hosts)
    if fleet is not None:
        tele.set_static("fleet", dict(fleet.describe(), strategy=strategy))
    inner_mesh = sp_mesh or ep_mesh
    mesh_shape = dict((mesh or inner_mesh).shape if mesh or inner_mesh
                      else {"data": 1, "model": 1})
    if fleet is not None and strategy == "wire":
        # The wire strategy composes the hosts outside the mesh: the
        # logical data width is the host's times the hosts, what one
        # process-group mesh would report.
        mesh_shape["data"] *= n_hosts
    tele.set_static("learner.mesh_shape", mesh_shape)
    if split is not None:
        tele.set_static("device_split", split.describe())
    health = PipelineHealth(registry=reg)
    chaos = None
    if flags.chaos_plan:
        chaos = ChaosController(FaultPlan.from_json(flags.chaos_plan),
                                registry=reg)
    # The fleet's control plane: heartbeats and health folding, the
    # snapshot publication and (wire strategy) the param-sync rounds.
    # start() blocks until every host is connected, before the servers
    # spawn, so a host that cannot join fails without leaking processes.
    # A one-host fleet has no control plane to run.
    fleet_coord = None
    if fleet is not None and fleet.num_hosts > 1:
        fleet_coord = FleetCoordinator(
            fleet, health, strategy,
            min_live_hosts=getattr(flags, "min_live_hosts", 1),
            registry=reg)
        fleet_coord.start()
    # Every host resumes from the lead's checkpoint (a shared savedir).
    checkpoint_path = monobeast._checkpoint_path(flags, flags.xpid)
    num_actors = flags.num_actors or flags.num_servers
    # Each host's actors reach its own env servers.
    pipes_basename = polybeast_env.host_scoped_basename(
        flags.pipes_basename, host_rank, flags.num_servers)
    addresses = [
        polybeast_env.server_address(pipes_basename, i % flags.num_servers)
        for i in range(num_actors)
    ]
    # B: this host's rows of each learner batch (the global batch over
    # the hosts); the step clock counts the global batch's frames.
    T, B = flags.unroll_length, local_rows
    global_rows = flags.batch_size

    # Any failure from the instant the server group exists until the main
    # try/finally below takes over must not leak the spawned processes.
    server_procs = []
    server_supervisor = None
    try:
        if flags.start_servers:
            env_seed = flags.env_seed
            if env_seed is not None:
                # Past every seed a host's servers derive (i*1000 +
                # stream): hosts share --env_seed but never a stream.
                env_seed += host_rank * flags.num_servers * 1000
            server_supervisor = polybeast_env.ServerSupervisor(
                flags, pipes_basename=pipes_basename, env_seed=env_seed,
                max_restarts=flags.max_server_restarts,
            )
            server_procs = server_supervisor.processes
            server_supervisor.start_watch()
            if chaos is not None:
                chaos.attach_servers(server_supervisor)
            time.sleep(0.5)
        elif flags.env_seed is not None:
            log.warning(
                "--env_seed has no effect with --no_start_servers: pass "
                "it to each polybeast_env launch instead."
            )

        hp = monobeast.hparams_from_flags(flags)
        policy = precision.resolve_flags(flags)
        num_actions, frame_shape = _probe_env_via_server(flags, addresses[0])
        model = monobeast.build_model(flags, num_actions, frame_shape, device)
        monobeast.check_sp_heads(flags, model)
        # The resolved remat plan rides every telemetry line as a static.
        plan = remat_plan.last_plan()
        if plan is not None:
            tele.set_static("learner.remat_plan", plan.summary())
        optimizer = learner_lib.make_optimizer(
            hp, list(model.parameters()),
            layouts=weights.jax_layouts(model) if hp.opt_factored else None)
        step, stats = 0, {}
        if os.path.exists(checkpoint_path):
            restored = load_train_state(checkpoint_path, model, optimizer)
            step, stats = restored["step"], restored["stats"]
            log.info("Resuming preempted job, current stats:\n%s", stats)
        if ep_mesh is not None:
            monobeast.place_experts(model, ep_mesh)
        if sp_mesh is not None or (mesh is not None and "seq" in mesh.shape):
            # Replica i of a composite mesh takes its row's seq devices
            # (parallel/dp.py), and the schedule from this one.
            monobeast.place_sequence_parallel(model, sp_mesh or mesh, flags)
        if pp_mesh is not None:
            parallel.set_pipeline(model, pp_mesh, n_microbatches)
        elif mesh is not None and pipe_par > 1:
            # Each data row's replica runs its own GPipe over its row's
            # pipe devices (ParallelLearner hands each its Mesh.row).
            parallel.set_pipeline(model, mesh.row(0), n_microbatches)
        if mesh is not None:
            parallel.check_consistent_restore(mesh, step,
                                              list(model.parameters()))
            dispatch = parallel.make_parallel_update_step(
                model, optimizer, hp, mesh, superstep_k=superstep_k)
            log.info("Parallel learner: data=%d%s (%d processes)%s",
                     mesh.shape["data"],
                     (f" x model={tensor_par}" if tensor_par > 1 else "")
                     + (f" x pipe={pipe_par}" if pipe_par > 1 else "")
                     + (f" x expert={expert_par}" if expert_par > 1
                        else "")
                     + (f" x seq={seq_par}" if seq_par > 1 else ""),
                     proc_count,
                     " eagerly: a data row spans cards"
                     if mesh.spans_cards() else "")
        else:
            dispatch = learner_lib.make_update_dispatch(
                model, optimizer, hp, superstep_k,
                capture=(False if any(m is not None and m.spans_cards()
                                      for m in (pp_mesh, sp_mesh))
                         else None))
        update = learner_lib.instrument_update_step(
            dispatch, registry=reg, superstep_k=superstep_k)

        # The acting copy: inference never reads the learner's params,
        # which the update changes in place.
        act_model = copy.deepcopy(model).requires_grad_(False)
        # Acting runs the one-device forward of the learner's params: no
        # model or pipe devices, so its graphs stay on the card the
        # actors are served from (the same arithmetic, row by row).
        parallel.set_model_devices(act_model, None)
        set_seq_devices(act_model, None)
        if pipe_par > 1:
            parallel.set_pipeline(act_model, None)
        act_params = list(act_model.parameters())
        learn_params = list(model.parameters())
        generator = torch.Generator(device=device)
        # A fleet's hosts draw their own actions.
        generator.manual_seed(flags.seed + (host_rank if fleet else 0))

        # --replay_reuse K': the arena hands each staged batch out K'
        # times; env frames advance on its first handout only, the learn
        # clock on every one (on resume: the split is not saved).
        replay_reuse = hp.replay_reuse
        state = {"step": step, "learn_step": step * replay_reuse,
                 "stats": dict(stats)}
        # The IMPACT target network (--loss impact): a full-precision
        # copy of the params stamped every --target_refresh_updates
        # updates, version 0 before any update; its forward runs per
        # dispatch, so replay handouts see the current target.
        target = None
        if hp.loss == "impact":
            refresh = max(1, flags.target_refresh_updates or 1)
            if mesh is None:
                target = learner_lib.TargetNetwork(
                    model, refresh, superstep_k=superstep_k, registry=reg)
            else:
                # One target network per shard, each forward on its
                # shard's device.
                target = parallel.ShardedTarget(
                    dispatch, refresh, superstep_k=superstep_k,
                    registry=reg)
            log.info("IMPACT loss: target network refresh every %d "
                     "updates, replay reuse %d",
                     target.store.refresh_updates, replay_reuse)
        learner_done = threading.Event()
        # Guards state, the acting copy's params and the generator: every
        # acting forward launches under it, and the learner copies new
        # params in under it.
        state_lock = threading.Lock()
        # Serializes an update (params changed in place) against a
        # checkpoint's read of params and optimizer state.
        update_lock = threading.Lock()

        # Admission control + deadline-aware load shedding on the
        # central inference path (serving/admission.py), armed by
        # --request_deadline_ms. The depth bound is
        # --admission_depth_factor x the max batch.
        deadline_ms = flags.request_deadline_ms or 0.0
        shed_depth = (flags.admission_depth_factor
                      * flags.max_inference_batch_size
                      if deadline_ms > 0 else None)
        slo_target_s = deadline_ms / 1000.0 if deadline_ms > 0 else None
        admission = None
        if deadline_ms > 0 and core is None:
            admission = AdmissionController(
                deadline_ms=deadline_ms, max_queue_depth=shed_depth,
                registry=reg)
        # The core's classes take no telemetry_name: NativeTelemetryFolder
        # folds their series in (below), and the inference loop observes
        # the batch sizes of a batcher without instruments. The core's
        # batcher gates admission in C++ (actor threads never touch
        # Python on a shed); its counters fold into serving.* too.
        if core is not None:
            queue_cls, batcher_cls = core.BatchingQueue, core.DynamicBatcher
            queue_tm = {}
            batcher_tm = {"continuous": flags.continuous_batching}
            if deadline_ms > 0:
                batcher_tm.update({
                    "request_deadline_ms": deadline_ms,
                    "shed_max_queue_depth": shed_depth,
                    "slo_target_ms": deadline_ms,
                })
        else:
            queue_cls, batcher_cls = BatchingQueue, DynamicBatcher
            queue_tm = {"telemetry_name": "learner_queue"}
            batcher_tm = {"telemetry_name": "inference",
                          "admission": admission}
        learner_queue = queue_cls(
            batch_dim=1, minimum_batch_size=B, maximum_batch_size=B,
            maximum_queue_size=flags.max_learner_queue_size or B,
            check_inputs=True, **queue_tm,
        )
        # The split has no central batcher: each inference slice owns
        # one (parallel/sebulba.py, built below).
        inference_batcher = None
        if split is None:
            inference_batcher = batcher_cls(
                batch_dim=1, minimum_batch_size=1,
                maximum_batch_size=flags.max_inference_batch_size,
                timeout_ms=flags.inference_timeout_ms, **batcher_tm,
            )
        model_keys = learner_lib.MODEL_INPUT_KEYS

        def _forward_with(acting_model, gen, env_d, agent_state):
            """One acting forward of `acting_model` on [1, n] inputs on
            the card, sampling from `gen`; outputs as the wire carries
            them (int32 actions, f32 logits/baseline)."""
            inputs = {k: env_d[k][0] for k in model_keys}
            with torch.no_grad():
                out, new_state = learner_lib.act_body(
                    acting_model, inputs, agent_state, gen)
            outputs = {
                "action": out.action[None].to(torch.int32),
                "policy_logits": out.policy_logits[None].float(),
                "baseline": out.baseline[None].float(),
            }
            return outputs, new_state

        def _forward(env_d, agent_state):
            return _forward_with(act_model, generator, env_d, agent_state)

        def _act(env_d, agent_state):
            with state_lock:
                return _forward(env_d, agent_state)

        # The path without the state table on the card: one graph per
        # bucket of the forward alone (agent state in and out through
        # static buffers), captured below.
        act_graphs = {}

        def act_fn(env_outputs, agent_state, batch_size):
            """The path without the state table (agent state rides each
            request): host nests in, tensors out (the inference loop
            brings them back in one copy)."""
            env = {k: env_outputs[k] for k in model_keys}
            if act_graphs:
                with state_lock:
                    return act_graphs[batch_size](
                        {"env": env, "state": agent_state})
            return _act(to_device(env, device),
                        to_device(agent_state, device))

        # Snapshotted policy replicas (serving/): the learner publishes
        # a bf16 snapshot of the acting params every
        # --replica_refresh_updates updates; a replica serving thread
        # answers from the latest one through its own params buffer
        # (the replica model, allocated once), loaded when a batch
        # brings a version it does not hold yet, and samples from a
        # generator of its own.
        # Under --loss impact the default arms them every 10 updates.
        # Under the split the slices are the snapshot serving (a store
        # refreshed every --replica_refresh_updates, every update by
        # default, below); no replica tier beside them.
        refresh_updates = effective_replica_refresh_updates(flags)
        snapshot_store = replica_hooks = replica_model = None
        if split is None and refresh_updates > 0:
            snapshot_store = PolicySnapshotStore(refresh_updates,
                                                 registry=reg)
            # Version 0 = the initial params, published before serving
            # starts so the replica path is never empty-handed.
            snapshot_store.note_update(0)
            snapshot_store.publish(0, act_params)
            replica_hooks = ReplicaServingHooks(
                snapshot_store, max_policy_lag=flags.max_policy_lag,
                rng_seed=flags.seed + 7919, health=health, batch_dim=1,
                registry=reg, device=device)
            replica_model = copy.deepcopy(act_model).requires_grad_(False)

        def _replica_forward(env_d, agent_state):
            return _forward_with(replica_model, replica_hooks.generator,
                                 env_d, agent_state)

        replica_act_graphs = {}
        replica_loaded = [None]  # the version the replica model holds

        def _replica_act_fn(env_outputs, agent_state, batch_size, ctx):
            """The replica twin of act_fn (stateless models; the state
            table loads a stateful model's context itself)."""
            env = {k: env_outputs[k] for k in model_keys}
            version, params = ctx
            with state_lock:
                if replica_loaded[0] != version:
                    with torch.no_grad():
                        torch._foreach_copy_(
                            list(replica_model.parameters()),
                            nest.flatten(params))
                    replica_loaded[0] = version
                if replica_act_graphs:
                    return replica_act_graphs[batch_size](
                        {"env": env, "state": agent_state})
                return _replica_forward(to_device(env, device),
                                        to_device(agent_state, device))

        # The chaos learner_stall gate (the shared-chip overload model):
        # consulted at the learner's dispatch and in every serving loop;
        # None when chaos is unarmed.
        throttle = chaos.throttle if chaos is not None else None
        state_table = None
        initial_state = act_model.initial_state(1, device)
        stateful_acting = flags.device_agent_state and bool(
            nest.flatten(initial_state))
        sebulba = native_slice_router = None
        if split is not None:
            sebulba, native_slice_router, snapshot_store = _split_serving(
                flags, split, core, batcher_tm, act_model, learn_params,
                initial_state if stateful_acting else None, _forward_with,
                model_keys, num_actors, refresh_updates, health, reg,
                admission, throttle, tele)
            state_table = sebulba.state_tables
        elif stateful_acting:
            state_table = DeviceStateTable(
                initial_state, num_slots=num_actors,
                act_fn=lambda ctx, env_d, s: _act(env_d, s),
                batch_dim=1,
                input_filter=lambda env: {k: env[k] for k in model_keys},
            )
            if replica_model is not None:
                state_table.bind_context(
                    _replica_forward, list(replica_model.parameters()))

        if chaos is not None:
            chaos.attach_state_table(state_table)

            def _chaos_step():
                with state_lock:
                    return state["step"]

            chaos.set_step_fn(_chaos_step)

        # Per-env-step wire accounting of the acting path: gauges and a
        # static `acting_path` block on every telemetry line.
        env_up = (int(np.prod(frame_shape)) + 4 + 1 + 4 + 4 + 4)
        state_bytes = sum(t.numel() * t.element_size()
                          for t in nest.flatten(initial_state))
        out_down = 4 + 4 * num_actions + 4  # action, logits, baseline
        if state_table is not None:
            bytes_up, bytes_down = env_up + 4 + 1, out_down
        else:
            bytes_up = env_up + state_bytes
            bytes_down = out_down + state_bytes
        acting_mode = "device_table" if state_table is not None else "host"
        reg.gauge("acting.bytes_per_step_up").set(bytes_up)
        reg.gauge("acting.bytes_per_step_down").set(bytes_down)
        tele.set_static("acting_path", {
            "agent_state": acting_mode,
            "bytes_per_step_up": bytes_up,
            "bytes_per_step_down": bytes_down,
        })
        log.info("Acting path: agent_state=%s", acting_mode)

        buckets = default_buckets(flags.max_inference_batch_size)
        slice_capture_s = []
        if device.type == "cuda":
            t0 = time.time()
            # Every graph is captured here, before the first thread starts.
            dummy = _dummy_learner_inputs(
                T, B, superstep_k, frame_shape, num_actions,
                to_host(model.initial_state(B, device)), policy.batch_dtype,
                policy_lag=replica_model is not None or split is not None,
                impact=target is not None)
            if target is not None:
                # The target forward's graph; the update's static batch
                # holds the two target leaves.
                target.capture(*nest.map(lambda t: t.to(device), dummy))
            dispatch.capture(*dummy)
            n_graphs = len(buckets)
            if sebulba is not None:
                # One graph per bucket on each slice, on its device and
                # stream, bound to its snapshot buffer.
                n_graphs = 0
                for stack in sebulba.stacks:
                    t_slice = time.time()
                    n_graphs += stack.capture(
                        buckets, lambda b: _dummy_env_outputs(b, frame_shape),
                        lambda b: to_host(act_model.initial_state(b, device)))
                    slice_capture_s.append(time.time() - t_slice)
                    log.info("Captured slice %d's %d acting graphs on %s in "
                             "%.2fs", stack.index, len(buckets), stack.device,
                             slice_capture_s[-1])
            elif state_table is not None:
                state_table.capture(
                    buckets, lambda b: _dummy_env_outputs(b, frame_shape),
                    generator, replay_lock=state_lock)
                if replica_model is not None:
                    state_table.capture_context(
                        buckets,
                        lambda b: _dummy_env_outputs(b, frame_shape),
                        replica_hooks.generator)
                    n_graphs += len(buckets)
            else:
                acting = [(act_graphs, _forward, generator)]
                if replica_model is not None:
                    acting.append((replica_act_graphs, _replica_forward,
                                   replica_hooks.generator))
                for into, forward, gen in acting:
                    for b in buckets:
                        into[b] = graphs.CapturedAct(
                            lambda static, f=forward: f(static["env"],
                                                        static["state"]),
                            {"env": _dummy_env_outputs(b, frame_shape),
                             "state": to_host(act_model.initial_state(
                                 b, device))},
                            device, gen)
                n_graphs = len(buckets) * len(acting)
            log.info("Captured the learner's and %d acting CUDA graphs in "
                     "%.1fs", n_graphs, time.time() - t0)
        elif flags.prewarm_inference:
            t0 = time.time()
            for b in buckets:
                dummy = _dummy_env_outputs(b, frame_shape)
                if sebulba is not None:
                    for stack in sebulba.stacks:
                        _prewarm_slice(stack, b, dummy, to_host(
                            act_model.initial_state(b, device)))
                elif state_table is not None:
                    # All-trash slots, advance=False: no real slot moves.
                    state_table.step(
                        np.full(b, state_table.trash_slot, np.int64),
                        np.zeros(b, bool), dummy)
                else:
                    act_fn(dummy,
                           to_host(act_model.initial_state(b, device)), b)
            log.info("Prewarmed %d inference buckets in %.1fs",
                     len(buckets), time.time() - t0)

        # The replica serving tier: its batcher, the router in front of
        # both batchers, and its serving loop.
        replica_batcher = replica_router = None
        loop_hooks = replica_hooks
        if replica_hooks is not None:
            if core is not None:
                # The core's ReplicaRouter answers replica-first with
                # central fallback, gated by a flag the hooks push (per
                # served batch and per monitor tick) instead of a GIL
                # round trip per request; a degraded replica sees no
                # batches, so only the tick can re-arm it.
                replica_batcher = core.DynamicBatcher(
                    batch_dim=1, minimum_batch_size=1,
                    maximum_batch_size=flags.max_inference_batch_size,
                    timeout_ms=flags.inference_timeout_ms, **batcher_tm)
                replica_router = core.ReplicaRouter(
                    central=inference_batcher, replica=replica_batcher)
                replica_router.set_serving(replica_hooks.serving_ok())
                tele.add_tick_callback(
                    lambda: replica_router.set_serving(
                        replica_hooks.serving_ok()))
                loop_hooks = _FlagSyncHooks(replica_hooks, replica_router)
            else:
                replica_batcher = DynamicBatcher(
                    batch_dim=1, minimum_batch_size=1,
                    maximum_batch_size=flags.max_inference_batch_size,
                    timeout_ms=flags.inference_timeout_ms,
                    telemetry_name="replica", admission=admission)
                replica_router = ReplicaRouter(
                    inference_batcher, replica_batcher, replica_hooks,
                    registry=reg)
            log.info("Replica serving armed: refresh every %d updates, "
                     "max policy lag %d (%s routing)", refresh_updates,
                     flags.max_policy_lag,
                     "native" if core is not None else "python")

        def _serve_loop():
            if device.type == "cuda":
                torch.cuda.set_device(device)
            inference_loop(
                inference_batcher,
                act_fn,
                flags.max_inference_batch_size,
                lock=None,
                pipelined=flags.num_inference_threads == 1,
                state_table=state_table,
                throttle_fn=throttle,
            )

        def _replica_loop():
            if device.type == "cuda":
                torch.cuda.set_device(device)
            inference_loop(
                replica_batcher,
                None if state_table is not None else _replica_act_fn,
                flags.max_inference_batch_size,
                lock=None,
                pipelined=False,
                state_table=state_table,
                serving_hooks=loop_hooks,
                throttle_fn=throttle,
                telemetry_prefix="replica",
            )

        # Replica and slice loops ride the same supervisor: they share
        # the (sharded) state table, so poison recovery rebuilds once and
        # restarts every serving thread under one budget.
        if sebulba is not None:
            # --num_inference_threads loops PER SLICE, each draining only
            # its slice's batcher.
            slice_loops = [
                loop for loop in sebulba.loop_fns
                for _ in range(max(1, flags.num_inference_threads))]
            infer_supervisor = InferenceSupervisor(
                slice_loops[0], num_threads=1, state_table=state_table,
                restart_budget=flags.inference_restart_budget,
                health=health, registry=reg,
                extra_loop_fns=slice_loops[1:])
        else:
            infer_supervisor = InferenceSupervisor(
                _serve_loop,
                num_threads=flags.num_inference_threads,
                state_table=state_table,
                restart_budget=flags.inference_restart_budget,
                health=health,
                registry=reg,
                extra_loop_fns=([_replica_loop]
                                if replica_hooks is not None else None),
            )
        # The batcher-shaped surface the pool talks to: the slice router
        # under the split (the core's with the native pool), the replica
        # router when replicas are armed, else the central batcher.
        if sebulba is not None:
            serving_frontend = (native_slice_router
                                if native_slice_router is not None
                                else sebulba.router)
        elif replica_router is not None:
            serving_frontend = replica_router
        else:
            serving_frontend = inference_batcher
        # The monitor's depth: the central batcher's, or the slices'
        # summed under the split.
        serving_depth = (inference_batcher.size
                         if inference_batcher is not None
                         else serving_frontend.size)
        pool_kwargs = {}
        if state_table is not None:
            # The C++ pool calls reset / initial_state_host / read_slot
            # on the table under the GIL, as the Python pool does.
            pool_kwargs["state_table"] = state_table
        if core is None:
            # SLO breach accounting lives actor-side in the Python pool
            # (the core counts breaches batcher-side).
            pool_kwargs["slo_target_s"] = slo_target_s
        if replica_hooks is not None or sebulba is not None:
            # Rollouts mixing replica and central replies stay
            # well-formed: a missing policy_lag leaf is zeros.
            pool_kwargs["record_policy_lag"] = True
        # Chaos interposition on either runtime: the Python pool wraps
        # each fresh transport in a FaultingTransport; the core builds
        # its FaultHooks, which the controller drives through the pool's
        # chaos_* methods.
        if chaos is not None:
            if core is not None:
                pool_kwargs["fault_hooks"] = True
            else:
                pool_kwargs["transport_wrap"] = chaos.wrap_transport
        actors = (core.ActorPool if core is not None else ActorPool)(
            unroll_length=T,
            learner_queue=learner_queue,
            inference_batcher=serving_frontend,
            env_server_addresses=addresses,
            initial_agent_state=to_host(initial_state),
            max_reconnects=flags.max_actor_reconnects,
            connect_timeout_s=flags.actor_connect_timeout_s,
            max_frame_bytes=flags.max_frame_bytes,
            **pool_kwargs,
        )
        if chaos is not None and core is not None:
            chaos.attach_native_pool(actors)
        if core is not None and telemetry_on:
            # The core has no registry access: its per-request stamps
            # and wire / step / queue / admission counters fold into the
            # Python runtime's series on every exported line, the final
            # one included.
            slice_kwargs = {}
            if native_slice_router is not None:
                # The slices' admission counters fold into serving.*,
                # their depths and routed counts into the Python
                # router's inference.slice.<i>.* series.
                slice_kwargs = {
                    "slice_batchers": [s.batcher for s in sebulba.stacks],
                    "slice_router": native_slice_router}
            tele.add_tick_callback(native.NativeTelemetryFolder(
                reg, pool=actors, batcher=inference_batcher,
                queue=learner_queue, slo_target_s=slo_target_s,
                replica_batcher=replica_batcher,
                replica_router=replica_router, fleet=fleet_coord,
                **slice_kwargs).tick)
        elif fleet_coord is not None and telemetry_on:
            # The Python runtime: the folder runs for the fleet fold
            # alone (remote hosts' heartbeat gauges as host<r>.*).
            tele.add_tick_callback(
                native.NativeTelemetryFolder(reg, fleet=fleet_coord).tick)
        if telemetry_on:
            # Fresh liveness gauges and the per-connection SLO block on
            # every exported line: the p99 of actor.request_rtt_s
            # against the admission gate's deadline, and the breaches.
            g_live = reg.gauge("actor.live")
            tele.add_tick_callback(lambda: g_live.set(actors.live_actors()))
            h_rtt = reg.histogram("actor.request_rtt_s")
            c_breach = reg.counter("slo.rtt_breaches")

            def _slo_tick():
                tele.set_static("slo", {
                    "target_s": slo_target_s,
                    "p99_s": round(h_rtt.percentile(0.99), 6),
                    "breaches": int(c_breach.value()),
                })

            tele.add_tick_callback(_slo_tick)
        actor_thread = threading.Thread(
            target=actors.run, daemon=True, name="actorpool"
        )

        def _stall_diagnostics():
            return {
                "learner_queue": learner_queue.size(),
                "inference_batcher": serving_depth(),
                "live_actors": actors.live_actors(),
            }

        watchdog = LearnerWatchdog(
            flags.learner_stall_timeout_s, health=health,
            dump_fn=_stall_diagnostics, registry=reg,
        )
        timings = Timings(
            registry=reg if telemetry_on else None, prefix="learner."
        )

        copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

        def _place(item):
            """Stage one learner batch (or a [K, ...] arena stack) on the
            card: pinned host memory, copied on the prefetcher's own
            stream, float leaves cast to the policy's batch dtype there.
            Returns (batch, state, event after the copy) for
            _take_staged."""
            host = {
                "batch": item["batch"],
                "initial_agent_state": item["initial_agent_state"],
            }
            copied = None
            if copy_stream is not None:
                torch.cuda.set_device(device)
            if arena is not None and superstep_k == 1:
                # --replay_reuse at K=1: the arena stages [1, T+1, B]
                # stacks (its slots are what replay re-serves); the K=1
                # update takes [T+1, B] batches (a view, not a copy).
                host = nest.map(lambda a: a[0], host)
            with (torch.cuda.stream(copy_stream) if copy_stream is not None
                  else contextlib.nullcontext()):
                staged = to_device(host, device)
                batch = precision.cast_batch(staged["batch"],
                                             policy.batch_dtype)
                agent_state = precision.cast_batch(
                    staged["initial_agent_state"], policy.batch_dtype)
                if copy_stream is not None:
                    copied = torch.cuda.Event()
                    copied.record(copy_stream)
            return batch, agent_state, copied

        def _take_staged(staged):
            """The learner's side of _place: its stream waits for the
            copy, and the staged tensors stay allocated until that stream
            has read them."""
            batch, agent_state, copied = staged
            if copied is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(copied)
                for t in nest.flatten((batch, agent_state)):
                    t.record_stream(stream)
            return batch, agent_state

        # Superstep mode: rollouts drain straight into [K, T+1, B, ...]
        # host arena stacks and the prefetcher stages one K-batch copy a
        # dispatch. A slot is released at its dispatch's stats flush, so
        # the pool is the prefetch depth + a filling slot + the two
        # dispatched-unflushed supersteps. --replay_reuse rides the same
        # arena (K=1 gets a unit-column one): a slot is handed out K'
        # times before it is refilled, each handout staged anew.
        prefetch_depth = 2
        arena = None
        if superstep_k > 1 or replay_reuse > 1:
            arena = BatchArena(
                k=superstep_k, rows=B, batch_dim=1,
                pool=prefetch_depth + 3, telemetry_name="learner_queue",
                replay_reuse=replay_reuse,
            )
        prefetcher = DevicePrefetcher(
            learner_queue, _place, depth=prefetch_depth,
            telemetry_name="prefetch", arena=arena,
        )
        update_interval_ms = []
        learner_errors = []
        updates_done = [0]  # the snapshot store's version clock

        if fleet_coord is not None:
            if not is_lead and snapshot_store is not None:
                # A remote's store takes the lead's snapshots (applied on
                # the coordinator's reader thread) into the acting
                # model's parameter list.
                fleet_coord.attach_snapshot_store(snapshot_store, act_model)

            def _fleet_stats():
                # The recovery counters the lead folds into the fleet
                # verdict (an env-server restart or actor reconnect here
                # is a sticky fleet.host<r> on the lead).
                with state_lock:
                    at_updates = updates_done[0]
                return {
                    "updates": int(at_updates),
                    "restarts": int(server_supervisor.restarts
                                    if server_supervisor is not None
                                    else 0),
                    "reconnects": int(actors.reconnect_count()),
                }

            fleet_coord.set_stats_source(_fleet_stats)
            fleet_coord.set_gauges_source(
                lambda: parallel.slice_gauge_snapshot(reg))
        # Rows per acting forward, over the central loops or the slices'.
        prefixes = (["inference"] if sebulba is None else
                    [f"inference.slice.{s.index}" for s in sebulba.stacks])
        counters = tuple(f"{p}.{c}" for p in prefixes
                         for c in ("batches", "rows"))
        counts_at_start = _counter_values(reg, counters)

        def learner_loop():
            if device.type == "cuda":
                torch.cuda.set_device(device)
            try:
                _learner_loop_body()
            except BaseException as e:
                learner_errors.append(e)
                raise
            finally:
                if fleet_coord is not None:
                    # Leave the fleet's param-sync rounds, so slower hosts
                    # stop waiting on this learner.
                    fleet_coord.learner_done()
                learner_done.set()

        def _learner_loop_body():
            # One-update-delayed stats fetch: the previous update's stats
            # come to the host after the current one is launched, so the
            # host never waits for the card between updates.
            # Under supersteps each dispatch carries K updates and [K]
            # stats, so this one delayed sync covers K updates.
            pending = None  # (device stats, step after, timer, release)
            # Replay handouts still owed by the last fresh batch: the run
            # ends at --total_steps env frames once they are learned from.
            owed = 0

            def merge(batch, agent_state):
                # --loss impact: the target network's forward, inside the
                # timed interval (it is part of the IMPACT update).
                if target is None:
                    return batch
                return target.merge(batch, agent_state)

            def flush(entry):
                device_stats, at_step, timer, release = entry
                keys = list(device_stats)
                row = torch.stack(
                    [device_stats[k].float() for k in keys]).cpu().numpy()
                update.count_host_sync()
                if release is not None:
                    # The stats arrived, so the dispatch that read the
                    # arena stack is done: its slot may be rewritten.
                    release()
                update_interval_ms.append(
                    timer[0].elapsed_time(timer[1]) if device.type == "cuda"
                    else 1000 * (timer[1] - timer[0]))
                s = learner_lib.episode_stat_postprocess(
                    dict(zip(keys, row)))
                s["step"] = at_step
                s["learner_queue_size"] = learner_queue.size()
                with state_lock:
                    state["stats"] = s
                plogger.log(s)

            while True:
                timings.reset()
                try:
                    staged = prefetcher.get(timeout=1.0)
                except stdlib_queue.Empty:
                    if not prefetcher.is_alive():
                        break
                    continue
                release = None
                if arena is not None:
                    staged, release = staged
                # Replay handouts carry release.fresh == False: they
                # advance the learn clock but not the env frames.
                fresh = release is None or release.fresh
                owed = replay_reuse - 1 if fresh else owed - 1
                batch, initial_agent_state = _take_staged(staged)
                timings.time("dequeue")
                if throttle is not None:
                    # The chaos learner_stall gate: the busy-card stall
                    # at the dispatch site (no-op outside a window).
                    throttle()
                with update_lock:
                    if device.type == "cuda":
                        t0 = torch.cuda.Event(enable_timing=True)
                        t1 = torch.cuda.Event(enable_timing=True)
                        t0.record()
                        train_stats = update(
                            merge(batch, initial_agent_state),
                            initial_agent_state)
                        t1.record()
                    else:
                        t0 = time.perf_counter()
                        train_stats = update(
                            merge(batch, initial_agent_state),
                            initial_agent_state)
                        t1 = time.perf_counter()
                    if fleet_coord is not None and strategy == "wire":
                        # The wire strategy's parameter composition: one
                        # synchronous fleet-mean round a dispatch (from
                        # equal params, averaging the updated params is
                        # averaging the gradients of an SGD step; each
                        # host's RMSprop state stays its own, the
                        # reference's approximation). None: the round
                        # degraded, keep this host's params.
                        synced = fleet_coord.sync_params(learn_params, model)
                        if synced is not None:
                            with torch.no_grad():
                                torch._foreach_copy_(learn_params, synced)
                            if mesh is not None:
                                dispatch.learner.sync()
                    with state_lock:
                        # Publish: the acting copy takes the new params
                        # (bf16_train: the bf16 resident ones), queued
                        # on the stream after the update. Under the split
                        # the slices act from snapshots alone.
                        if sebulba is None:
                            with torch.no_grad():
                                torch._foreach_copy_(act_params,
                                                     learn_params)
                        # Global frames: every process ran this
                        # collective dispatch.
                        if fresh:
                            state["step"] += superstep_k * T * global_rows
                        state["learn_step"] += superstep_k * T * global_rows
                        now_step = state["step"]
                        updates_done[0] += superstep_k
                        # A versioned snapshot when one is due (a
                        # dropped refresh stays due): its bf16 cast is
                        # queued behind the copy above (the update, under
                        # the split, whose slices copy it from their own
                        # streams after the cast's event).
                        # A remote fleet host serves the lead's policy,
                        # which the wire feeds its store (note_update
                        # still advances the head, so policy_lag is the
                        # wire's delay).
                        published = None
                        served = (act_params if sebulba is None
                                  else learn_params)
                        if (snapshot_store is not None
                                and snapshot_store.note_update(
                                    updates_done[0])
                                and (fleet_coord is None or is_lead)
                                and snapshot_store.publish(
                                    updates_done[0], served)):
                            published = updates_done[0]
                    if fleet_coord is not None and published is not None:
                        # The lead fans its publish out to the remotes,
                        # outside the acting lock (this thread alone
                        # writes the published params).
                        fleet_coord.publish_snapshot(published, served,
                                                     model)
                    if target is not None:
                        # A full-precision target refresh when one is
                        # due, queued behind the update.
                        target.maybe_refresh(updates_done[0], learn_params)
                watchdog.ping()
                if pending is not None:
                    flush(pending)
                pending = (train_stats, now_step, (t0, t1), release)
                timings.time("learn")
                if now_step >= flags.total_steps and owed <= 0:
                    break
            if pending is not None:
                flush(pending)

        learner_thread = threading.Thread(
            target=learner_loop, daemon=True, name="learner"
        )
    except BaseException:
        if server_supervisor is not None:
            server_supervisor.stop()  # before terminate: no resurrect-mid-reap
        polybeast_env.reap_group(server_procs)
        if fleet_coord is not None:
            fleet_coord.shutdown()
        raise

    def checkpoint():
        if not is_lead:  # the lead process alone writes the checkpoint
            return
        with update_lock:
            with state_lock:
                at_step, at_stats = state["step"], dict(state["stats"])
            save_train_state(checkpoint_path, model, optimizer,
                             step=at_step, flags=vars(flags),
                             stats=at_stats)

    # A planned preempt_sigterm takes the checkpoint-and-exit path under
    # train() too, as it does under cli(): SIGTERM raises
    # KeyboardInterrupt in the main thread for this run.
    restore_sigterm = None
    if chaos is not None and any(
            f.kind == "preempt_sigterm" for f in chaos.plan.faults):
        previous = signal.getsignal(signal.SIGTERM)
        if install_preemption_handler():
            restore_sigterm = previous

    # From the first thread start on, this try/finally owns all cleanup.
    start_time = time.time()
    start_step = state["step"]
    successful = False
    device_trace = None
    try:
        infer_supervisor.start()
        actor_thread.start()
        prefetcher.start()
        learner_thread.start()
        watchdog.start()
        if chaos is not None:
            chaos.start()
        device_trace = DeviceTrace(flags.profile_dir)

        num_live_floor = max(1, min(flags.min_live_actors, num_actors))
        degraded_dead = 0
        last_checkpoint = time.time()
        last_step, last_time = state["step"], time.time()
        last_learn_step = state["learn_step"]
        while not learner_done.is_set():
            # A finished learner or a halt cuts the 5 s tick short.
            tick_end = time.time() + 5
            while (time.time() < tick_end and not health.is_halted
                   and not learner_done.wait(timeout=0.25)):
                pass
            if learner_done.is_set():
                break
            live = actors.live_actors()
            dead = num_actors - live
            if dead > degraded_dead and actors.errors:
                degraded_dead = dead
                health.degrade(
                    f"{dead}/{num_actors} actors retired "
                    f"(last error: {actors.errors[-1]})",
                    key="actor_attrition", sticky=True,
                )
            if live < num_live_floor:
                health.halt(f"live actors {live} below --min_live_actors "
                            f"{num_live_floor}")
            if (not actor_thread.is_alive() and live > 0
                    and not health.is_halted and not learner_done.is_set()):
                raise RuntimeError("Actor pool exited unexpectedly")
            if infer_supervisor.errors:
                raise RuntimeError(
                    "Inference thread failed"
                ) from infer_supervisor.errors[0]
            if health.is_halted:
                log.error(
                    "Pipeline HALTED (%s); checkpointing and exiting "
                    "cleanly.",
                    "; ".join(r for _, r in health.reasons()[-3:]),
                )
                break
            with state_lock:
                now_step = state["step"]
                now_learn_step = state["learn_step"]
                stats_now = dict(state["stats"])
            now = time.time()
            sps = (now_step - last_step) / (now - last_time)
            learn_sps = (now_learn_step - last_learn_step) / (now - last_time)
            last_step, last_time = now_step, now
            last_learn_step = now_learn_step
            if telemetry_on:
                # Set here, not in the queues: the core's queues carry
                # no instruments. env_sps counts unique env frames,
                # learn_sps frames learned from (x --replay_reuse).
                reg.gauge("learner.sps").set(sps)
                reg.gauge("learner.env_sps").set(sps)
                reg.gauge("learner.learn_sps").set(learn_sps)
                reg.gauge("learner.sample_reuse").set(replay_reuse)
                reg.gauge("learner_queue.depth").set(learner_queue.size())
                reg.gauge("inference.depth").set(serving_depth())
                tele.write(extra={"step": now_step})
            means = timings.means()
            log.info(
                "Step %d @ %.1f SPS. Inference batcher size: %d. "
                "Learner queue size: %d. Loss %.4f. "
                "[dequeue %.0fms learn %.0fms] %s",
                now_step, sps, serving_depth(),
                learner_queue.size(),
                stats_now.get("total_loss", float("nan")),
                1000 * means.get("dequeue", 0.0),
                1000 * means.get("learn", 0.0),
                f"Return {stats_now['mean_episode_return']:.1f}."
                if "mean_episode_return" in stats_now else "",
            )
            if now - last_checkpoint > flags.checkpoint_interval_s:
                checkpoint()
                last_checkpoint = now
        if learner_errors:
            raise RuntimeError("Learner thread failed") from learner_errors[0]
        successful = True
    except KeyboardInterrupt:
        log.info("Interrupted; saving final checkpoint.")
        successful = True
    finally:
        if chaos is not None:
            chaos.stop()
            # The final telemetry line carries the injection ledger the
            # chaos harness audits recovery counters against.
            tele.set_static("chaos", chaos.summary())
        watchdog.stop()
        if device_trace is not None:
            device_trace.stop()
        # Shutdown in the reference's order: close the batchers + queue,
        # join the actors, then the threads.
        closers = [learner_queue]
        if inference_batcher is not None:
            closers.insert(0, inference_batcher)
        if sebulba is not None:
            # Every slice's batcher, so each slice's loops end cleanly.
            closers = [s.batcher for s in sebulba.stacks] + closers
        if replica_batcher is not None:
            closers.insert(1, replica_batcher)
        for closer in closers:
            try:
                closer.close()
            except RuntimeError:
                pass
        actor_thread.join(timeout=10)
        prefetcher.close()
        prefetcher.join(timeout=10)
        learner_thread.join(timeout=10)
        infer_supervisor.join(timeout=10)
        elapsed = time.time() - start_time
        checkpoint()
        # The last line; its tick callbacks fold the core's series in
        # once more before the stats below read the registry.
        tele.shutdown(step=state["step"])
        plogger.close(successful=successful)
        if server_supervisor is not None:
            server_supervisor.stop()  # before terminate: no resurrect-mid-reap
        polybeast_env.reap_group(server_procs)
        if fleet_coord is not None:
            # After the last telemetry write (its fold reads the remote
            # gauges) and the reap: a clean "bye", so the departure
            # counts as done, not lost.
            fleet_coord.shutdown()
        if restore_sigterm is not None:
            signal.signal(signal.SIGTERM, restore_sigterm)
    log.info(
        "Learning finished after %d steps (health %s).",
        state["step"], health.state_name,
    )
    stats = dict(state["stats"])
    stats["sps"] = (state["step"] - start_step) / elapsed if elapsed else 0.0
    stats["update_interval_ms_median"] = (
        statistics.median(update_interval_ms) if update_interval_ms
        else 0.0)
    stats["updates"] = len(update_interval_ms)
    stats["learn_sps"] = (updates_done[0] * T * global_rows / elapsed
                          if elapsed else 0.0)
    counts = _counter_values(reg, counters)
    batches = sum(counts[c] - counts_at_start[c] for c in counters
                  if c.endswith(".batches"))
    rows = sum(counts[c] - counts_at_start[c] for c in counters
               if c.endswith(".rows"))
    stats["inference_batch_mean"] = rows / batches if batches else 0.0
    stats["server_restarts"] = (
        server_supervisor.restarts if server_supervisor is not None else 0
    )
    stats["runtime"] = "native" if core is not None else "python"
    stats["actor_pool"] = f"{type(actors).__module__}.{type(actors).__name__}"
    stats["health"] = health.state_name
    stats["health_reasons"] = health.reasons()
    stats["actor_reconnects"] = int(actors.reconnect_count())
    stats["inference_restarts"] = infer_supervisor.restarts
    if sebulba is not None:
        stats["slice_capture_s"] = slice_capture_s
    if chaos is not None:
        stats["chaos"] = chaos.summary()
    return stats


def _split_serving(flags, split, core, batcher_tm, act_model, learn_params,
                   initial_state, forward_with, model_keys, num_actors,
                   refresh_updates, health, reg, admission, throttle, tele):
    """The device split's serving (parallel/sebulba.py): the snapshot
    store, version 0 (the learner's initial params) published before
    serving starts and refreshed every --replica_refresh_updates (every
    update by default); one stack per inference slice, each acting with a
    copy of the acting model on its device (the snapshot buffer) through
    a pinned state table, or the forward alone without one
    (`initial_state` None); on the native runtime a core DynamicBatcher a
    slice behind the core's SliceRouter, whose lag transitions the
    monitor tick drives. Returns (serving, the core's router or None,
    the store)."""
    store = PolicySnapshotStore(max(1, refresh_updates), registry=reg)
    store.note_update(0)
    store.publish(0, learn_params)
    batcher_factory = None
    if core is not None:
        def batcher_factory(i, name):
            return core.DynamicBatcher(
                batch_dim=1, minimum_batch_size=1,
                maximum_batch_size=flags.max_inference_batch_size,
                timeout_ms=flags.inference_timeout_ms, **batcher_tm)
    serving = parallel.build_sebulba_serving(
        split, store, num_slots=num_actors,
        max_batch_size=flags.max_inference_batch_size,
        timeout_ms=flags.inference_timeout_ms,
        max_policy_lag=flags.max_policy_lag, rng_seed=flags.seed,
        slice_model=lambda d: copy.deepcopy(act_model).to(d),
        initial_state=initial_state,
        act_fn=forward_with,
        input_filter=lambda env: {k: env[k] for k in model_keys},
        health=health, registry=reg, admission=admission,
        throttle_fn=throttle, batcher_factory=batcher_factory)
    router = None
    if core is not None:
        # Slot-hash fan-out in C++ over the slices' core batchers, the
        # Python SliceRouter's assignment bit for bit (splitmix64).
        router = core.SliceRouter(slices=[s.batcher for s in serving.stacks])
        if tele.enabled:
            def _slice_health_tick():
                for stack in serving.stacks:
                    stack.hooks.serving_ok()

            tele.add_tick_callback(_slice_health_tick)
    if tele.enabled:
        tele.add_tick_callback(serving.gauge_tick(reg))
    log.info("Sebulba serving: %d slice(s) on %s, snapshot refresh every %d "
             "update(s), max policy lag %d (%s routing)", split.n_slices,
             [str(d) for d in split.inference_devices],
             max(1, refresh_updates), flags.max_policy_lag,
             "native" if core is not None else "python")
    return serving, router, store


def _prewarm_slice(stack, b, env, state):
    """--prewarm_inference on the CPU under the split: one slice step at
    bucket `b` from the slice's snapshot (all-trash slots, advance False,
    on the table path: no real slot moves)."""
    ctx, _ = stack.hooks.begin_batch()
    if stack.state_table is not None:
        stack.state_table.step(
            np.full(b, stack.state_table.trash_slot, np.int64),
            np.zeros(b, bool), env, context=ctx)
    else:
        stack.act(env, state, b, ctx)


class _FlagSyncHooks:
    """The native replica loop's hooks: every begin_batch pushes the lag
    gate's verdict to the core's ReplicaRouter before picking the
    snapshot, so the C++ routing decision trails the lag budget by one
    batch at most."""

    def __init__(self, hooks, router):
        self._hooks = hooks
        self._router = router

    def begin_batch(self):
        self._router.set_serving(self._hooks.serving_ok())
        return self._hooks.begin_batch()


def _dummy_learner_inputs(T, B, k, frame_shape, num_actions, agent_state,
                          batch_dtype, policy_lag=False, impact=False):
    """Zero learner inputs of one dispatch, as the prefetcher stages them
    (the wire's dtypes, float leaves cast to `batch_dtype`): a [T+1, B]
    batch and `agent_state` (a host state nest at B), stacked [K, ...]
    when k > 1. With `policy_lag` the batch carries the int32 leaf the
    pool records under replica serving (the update does not read it);
    with `impact` the target network's two f32 outputs. The learner
    graph's capture takes them."""
    env = _dummy_env_outputs(B, frame_shape)
    batch = {key: np.repeat(v, T + 1, axis=0) for key, v in env.items()}
    batch.update({
        "episode_return": np.zeros((T + 1, B), np.float32),
        "episode_step": np.zeros((T + 1, B), np.int32),
        "action": np.zeros((T + 1, B), np.int32),
        "policy_logits": np.zeros((T + 1, B, num_actions), np.float32),
        "baseline": np.zeros((T + 1, B), np.float32),
    })
    if policy_lag:
        batch["policy_lag"] = np.zeros((T + 1, B), np.int32)
    tree = (batch, agent_state)
    if k > 1:
        tree = nest.map(lambda v: np.stack([v] * k), tree)
    tree = nest.map(lambda v: torch.from_numpy(np.asarray(v)), tree)
    batch, agent_state = (precision.cast_batch(t, batch_dtype)
                          for t in tree)
    if impact:
        lead = (k,) if k > 1 else ()
        batch[learner_lib.TARGET_LOGITS_KEY] = torch.zeros(
            lead + (T + 1, B, num_actions))
        batch[learner_lib.TARGET_BASELINE_KEY] = torch.zeros(
            lead + (T + 1, B))
    return batch, agent_state


def _dummy_env_outputs(batch_size, frame_shape):
    """Zero env outputs [1, batch_size, ...] (the prewarm's input)."""
    return {
        "frame": np.zeros((1, batch_size) + tuple(frame_shape), np.uint8),
        "reward": np.zeros((1, batch_size), np.float32),
        "done": np.ones((1, batch_size), bool),
        "last_action": np.zeros((1, batch_size), np.int32),
    }


def main(flags):
    _configure_logging()
    if flags.mode == "test":
        check_flags(flags)
        return monobeast.test(flags)
    return train(flags)


def cli():
    install_preemption_handler()  # SIGTERM -> clean checkpointed exit
    main(make_parser().parse_args())


if __name__ == "__main__":
    cli()
