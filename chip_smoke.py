#!/usr/bin/env python3
"""Smoke test of the PyTorch port (torchbeast_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only | --vtrace-only | --serving-only
                           | --impact-only | --remat-only | --anakin-only
                           | --pipelined-only | --dp-only | --ep-only
                           | --split-only | --tp-pp-only
                           | --sp-fleet-only | --v2lite-tail-only]

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
   timed on both models' parameter trees, and in f32 on the v2lite.learn
   cell's tree (DeepSeek-V2-Lite cut to 5 layers and 32 held experts:
   75 leaves, more than 64, and 1.37 B params, the gradients drawn on
   the card; with --v2lite-tail-only alone after the builds); the
   attention forward is timed
   at the learner shape (T=81) and the acting shape (T=1); the attention
   backward is also checked at a shape beyond one block of its kernel
   (T=300, D=64) and must give identical bits on two calls; the device
   kernels of one call of the tail and of the backward are counted with
   torch.profiler. Each kernel with a bf16 variant (the tail, the pool
   backward, the attention forward and backward) has a second row, its
   bf16 variant against the plain version in bf16, checked, timed and
   counted the same way. The LSTM recurrence (forward and backward step
   kernels) is checked at a layer of the shallow and of the deep
   network's core, at the learner's T + 1 steps and at the acting shape,
   timed a layer forward and back beside its plain version, and each
   network's update graph counts its launches (2 (T + 1) a layer) and is
   timed with the kernels and with the plain recurrence. With
   --kernels-only the script stops here and prints the kernels line (to
   compare two trees' kernels on one card);
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
   twin, bitwise, before and after one snapshot refresh. --loss impact:
   the deep + LSTM IMPACT update graph at K=1 and K=4 the same way, each
   batch carrying a lagged target network's outputs, one profiled
   replay running V-trace 1, the tail 1 and pool_bwd 3 kernels an
   update as one eager update does, with the target forward's graph and
   the update's timed; and the target forward's own graph (bound to the
   target params buffer) against an eager twin, bitwise, before and
   after one refresh.
   4r. remat plans (runtime/remat_plan.py), same settings: deep + LSTM
   at f32 under the default plan (every activation kept), `all`, the
   three trunk fronts and the LSTM core alone, at bf16_train under the
   default and `all`, and the transformer with --attention_impl pallas
   under the default and blocks=all. Each plan prints the allocator's
   peak over one eager dispatch (the planner's oracle, which run again on
   the same candidate must leave nothing more on the card) and its
   bytes accessed, the median of 10 replays of its update graph, the
   port kernels one replay launched (V-trace 1, the tail 1, pool_bwd 3;
   the transformer's attention forwards 2, or 4 under blocks=all, and
   backwards 2) and whether the params after one update are bitwise
   equal to the default plan's, which they must be; the deep model's
   `all` must peak below its default. Then the deep f32 update graph
   under the default and `all` at the training settings, interleaved,
   with each plan's peak at those settings;
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
   after the builds; (m) monobeast deep + LSTM with --loss impact
   --replay_reuse 2 --target_refresh_updates 2 for 3 collects (6
   updates): the launches per update as above, one target forward per
   fresh batch, learner.target.snapshots_published at the reference's
   cadence, 3*T*B env frames and twice that learned from; (n) polybeast
   deep + LSTM with --loss impact --replay_reuse 2 on the Python pool
   and on the core with --native_server: 3 updates from 2 batches (the
   run ends at the dispatch of the last fresh batch, before its replay,
   as the reference's does) with the launch checks, one target forward
   a dispatch, replicas armed by the impact default (a refresh every 10
   updates), then a resume from the checkpoint for one more batch (1
   update); it prints the update counts it checked, SPS, learn SPS and
   the median update interval; (o) monobeast --model mlp --use_lstm on
   84x84x4 Mock frames, 2 updates, V-trace and the tail launched. With --impact-only
   the script runs only this slice's phases 4, 5 (m)-(o) and 6, after
   the builds; (p) monobeast deep + LSTM with --remat auto and
   --hbm_budget_gb at what is allocated when it starts plus the midpoint
   of the default's and `all`'s footprints at the training settings
   (measured after 4r), 4
   updates: the plan neither none nor all-remat, its measured peak within
   the budget, the launch and loss checks, telemetry.jsonl carrying the
   plan (source auto, the size of its table) and
   learner.hbm_bytes_per_update; polybeast deep + LSTM with --remat all,
   4 updates, on the Python pool and on the core: the launch checks and
   the same telemetry; (q) polybeast deep without --use_lstm (no state
   table) with --replica_refresh_updates 1 --max_policy_lag 20, 4
   updates on each runtime: the replica thread serves requests and every
   stamped policy_lag is within 20. 4r, the training-settings timing and
   (p)-(q) run right after phase 4, before (a); with --remat-only the
   script runs only these after the builds;
6. parity: one learner update of each model from the same weights and
   batch with the kernels and with the plain versions on the card (TF32
   off, cuDNN deterministic), at f32, bf16_compute and bf16_train, and
   the deep + LSTM IMPACT update (a lagged target's outputs on the
   batch) at f32 and bf16_train; params, RMSprop state and loss stats
   must agree, at the tolerances printed. The LSTM recurrence runs its
   kernels on both sides (check_lstm holds them to their plain version).
7. Anakin and the MoE transformer (run after 5k in the full script; with
   --anakin-only alone after the builds): the pool backward at the deep
   trunk's stages on the device envs' frames (Catch's 10x5x1, Memory's
   4x1x1, N = 17 x 64), exact against its plain version, Catch's timed
   as a kernel row; the anakin iteration graph (graphs.
   CapturedIteration: T=16 acting forwards, env steps, the batch and the
   update in one replay) for mlp and for deep + LSTM on Catch, B=64, the
   LR decay and the entropy anneal moving, three replays bitwise equal
   to eager iterations of a twin (TF32 off, cuDNN deterministic: stats,
   params, nu, carry, the generator's state), pool_bwd 3 a replay on the
   deep model, each printing its host API calls and port kernels a
   replay and its ms; the learning runs of the reference's anakin tests
   through anakin's own parser (Catch mlp > 0.5 at 200k steps; Memory
   LSTM > 0.6 and feed-forward < 0.5 at 1M; the Memory transformer with
   --num_experts 4 > 0.6 at 600k), each printing SPS and wall time,
   then resumed from its checkpoint for one more log interval; monobeast
   --model transformer --num_experts 8 at full width with every kernel
   switch, f32 and bf16_train, 3 updates each with the launch checks of
   5 and a non-zero aux_loss; polybeast --num_experts 4 on the C++ core,
   3 updates; and the MoE update's parity, kernels against plain, at f32
   and bf16_train as in 6.
8. The pipelined families, their towers run sequentially (run after 7;
   with --pipelined-only alone after the builds): the RMSprop tail on the
   pipelined_transformer tree (4 layers, d_model 128, 4 heads, memory
   64; 4.41 M params) at f32 and bf16_train and on the pipelined_mlp +
   LSTM tree (4 stages of d_model 128), checked and timed as kernel rows
   as in 3; TF32 off and cuDNN deterministic, the update graph at K=1
   against eager updates bitwise as in 4, one eager update launching
   V-trace 1 and the tail 1, its dispatch timed, and the update with the
   kernels against its plain twin as in 6, for pipelined_transformer f32
   and bf16_train and pipelined_mlp + LSTM f32; --remat all on the
   pipelined transformer against the default plan (params after one
   update bitwise, the same launches); the anakin pipelined_mlp
   iteration graph on Catch against its eager twin as in 7; then, at the
   training settings, monobeast on the same three (3 updates each, the
   launch checks of 5), polybeast pipelined_transformer on the C++ core
   (3 updates, SPS and update interval), and the converter: monobeast
   --model pipelined_transformer --pipeline_stages 2 for 3 updates, its
   checkpoint turned to the sequential layout (utils/convert.py), whose
   weights give --model transformer --attention_impl pallas the
   pipelined model's logits on one batch (2 attention launches, TF32
   off, within DENSE_VS_KERNEL), then resumed by monobeast as that
   transformer for one more update with every transformer kernel
   launched.
9. The data-parallel learner (run after 8; with --dp-only alone after
   the builds, printing the paths' launches as one JSON line): (a) the
   CUDA device count; on one card monobeast.train with
   --num_learner_devices 2 must raise the reference's "visible"
   ValueError, with two or more it trains 3 updates (V-trace 2 and
   pool_bwd 6 an update, the tail none). Then TF32 off and cuDNN
   deterministic, deep + LSTM f32 at T=80, B=32: (b) the DP update with
   two shards of 16 rows, both on cuda:0 through the explicit device
   list, against the one-device update on all 32 rows over 2 updates
   (the LR decay and the entropy anneal moving): params within rtol
   2e-3 / atol 2e-5 (the reference's DP tolerance; the largest
   difference printed), total_loss within rtol 2e-4, both replicas
   bitwise equal, V-trace 2, pool_bwd 6 and the tail 0 launches an
   update, the DP graphs bitwise equal to their eager twin, the update's
   ms with 2 shards and with 1 (again at the training settings, both
   dispatches captured anew under them) and the host API calls of a DP
   dispatch beside the one-device one's; (c) (b) again in a torch.distributed
   NCCL group of world size 1, its all-reduce captured in the lead's
   graph, bitwise equal to (b); (d) one K=2 DP dispatch bitwise equal to
   (b)'s two K=1 dispatches; (e) (b) for the transformer with
   --attention_impl pallas (attention forward 4 and backward 4 an
   update); (f) anakin's Catch iteration (deep + LSTM, T=16, B=64) with
   two shards on the card: its graphs bitwise equal to their eager twin
   over 3 iterations, pool_bwd 6 an iteration, and the first
   iteration's update against the one-device update on the 64 columns
   its shards collected, at (b)'s tolerances.
10. Expert parallelism and the MoE transformer under the data-parallel
   learner (run after 9; with --ep-only alone after the builds, printing
   the paths' launches as one JSON line): TF32 off and cuDNN
   deterministic, the full-width transformer with --num_experts 8
   (top-2, d_ff 512; 2592 tokens an update, 810 slots an expert) at
   T=80, B=32, --attention_impl pallas, --vtrace_impl pallas, RMSprop
   eps 1.0, every shard on cuda:0 through the explicit device list: for
   each (data, expert) layout of EP_LAYOUTS (data 2 and 4; 1x2 and 2x2)
   at f32, and those the reference allows at bf16_train (data 2, data 4,
   1x2: its polybeast refuses bf16_train on a data x expert mesh), 2
   updates against the one-device MoE update (one CUDA graph) on the
   same batches from the same weights: params within phase 9's rtol
   2e-3 / atol 2e-5 (at bf16_train the f32 masters so, the bf16 params
   within one bf16 ulp), aux_loss within rtol 2e-4 (a bf16 ulp at
   bf16_train), total_loss within rtol 2e-4 (2e-2 at bf16_train), each
   update's kept assignments equal to the one-device rule on the shards'
   own router probabilities (exactly), its dropped assignments within
   1e-3 of the assignments of the one device's (a near tie may round the
   other way over fewer rows; bf16_train's second update 1e-2), every
   replica bitwise equal to the lead, V-trace once,
   the attention forward and backward twice (one a layer) a data shard
   an update and the tail never; each layout's update ms beside the one
   device's; each layout with an expert axis (1x2, 2x2) held to the
   sharded storage of polybeast's learner mesh: every row's params and
   row 0's optimizer state (nu, the f32 master) by slot equal to what
   the merged EP and TP rules place there, the allocator's bytes after
   the build printed, and (f32) on one eager update each V-trace and
   attention call against its plain version on its own inputs (V-trace
   bit for bit, the attention forward rtol 1e-5 / atol 1e-6, its
   backward rtol 1e-4 / atol 1e-5); then data 2 at f32 again in a
   torch.distributed NCCL group of world size 1 (its routing counts
   all_gathered on the group), bitwise equal to the run without a
   group; then, the drivers' device list [cuda:0] * 4 (restored after),
   polybeast --num_experts 4 --expert_parallel 2 --num_learner_devices 2
   on the Python pool and on the core and the pool run's checkpoint
   resumed on one device on the core, each run's acting copy bitwise the
   learner's assembled params after every publish.
11. The device split and remote replica serving (run after 10; with
   --split-only alone after the builds, printing the paths' launches as
   one JSON line): deep + LSTM at T=80, B=32, TBT_POOL_PALLAS=1,
   --vtrace_impl pallas. (a) On the one visible card, monobeast and
   polybeast given --device_split inf=1,learn=rest through their parsers
   log the reference's degradation warning and train the time-shared
   path with its launches. Then the drivers' device list
   (parallel.visible_devices) is replaced by [cuda:0] * 3, and restored
   after (c2), so the split's slices and learner share the one card:
   (b) TF32 off and cuDNN deterministic, monobeast --device_split
   inf=1,learn=1 trains 3 updates bitwise equal to the time-shared run
   from the same seed (stats, the checkpoint's params and optimizer
   state) with the same launches, --opt_impl pallas raises the
   reference's ValueError, inf=1,learn=2 runs the DP update; (c)
   polybeast --device_split inf=2,learn=1 --opt_impl pallas on the
   Python pool and on the core (16 env servers, two inference threads a
   slice): every slot's row written in its slice_for_slot slice's table
   alone, the per-slice request counters summing to the rows served, the
   core's hash equal to the Python one's, every reply's policy_lag within
   --max_policy_lag, a publish an update, every params buffer a slice
   loaded bitwise the learner's bf16-rounded params of its version, the
   launches of the time-shared path; it prints SPS, the update interval,
   the acting round trip's p50 and p99, each slice's forward host ms and
   graph-capture seconds beside the time-shared run's figures, then the
   same figures of inf=1,learn=1 on the core (one slice) and of
   inf=2,learn=1 without the LSTM on the core (no table: each slice's
   forward a graph over the request's state, requests round-robin over
   the slices, both serving); (c2) a
   state-table acting step timed from launch to reply while the
   learner's update graph replays back to back, on a pinned table's own
   stream and on the default stream; (d) TF32 off, cuDNN deterministic,
   a ReplicaServer on cuda:0 serving the deep acting forward (no LSTM)
   over unix: and shm:, fed by a RemoteSnapshotPublisher, reached
   through a RemoteReplicaBatcher as serving.ReplicaRouter's replica leg
   and through proxy_loop from the core's batcher: replies equal a local
   forward of the same snapshot (actions exact, logits bitwise), lag
   stamps right, the round trip printed.
12. Tensor and pipeline parallelism (run after 11; with --tp-pp-only
   alone after the builds, printing the paths' launches as one JSON
   line), with the drivers' device list (parallel.visible_devices)
   replaced by [cuda:0] * 4 and restored after, so every model, pipe
   and data device is the one card. TF32 off and cuDNN deterministic
   for (a)-(c)'s comparisons, at full width, T=80, B=32, seed 0's
   weights, RMSprop eps 1.0, 2 updates: (a) polybeast's transformer (2
   layers, d 128, 4 heads, memory 64, FFN 512, dense attention) at data
   1 x model 2 and data 2 x model 2 against the one-device update on the
   same batches: params within phase 9's rtol 2e-3 / atol 2e-5,
   total_loss rtol 2e-4, replicas bitwise equal, V-trace once a data
   shard an update and the tail never, each step CUDA graphs, the update
   ms and the host API calls a dispatch beside one device's; (b) the MoE
   transformer (8 experts, --attention_impl pallas) at data 1 x model 2
   x expert 2 against one device at phase 10's tolerances, the attention
   kernels once a head group a layer; (a) and (b) held to the sharded
   storage and their kernel calls to their plain versions as phase 10's
   layouts; (c) the GPipe over 2 pipe devices for pipelined_mlp +
   LSTM (2 stages, M = 2 and 4; 4 stages, two passes) and
   pipelined_transformer (4 layers, two passes; M = 2 and 4) against the
   sequential tower at phase 9's tolerance (the microbatches' products
   over fewer rows may take other cuBLAS kernels), V-trace and the tail
   once an update, both updates' ms; the kernels against their plain
   versions on a pipelined update of each family; a T=1 acting batch of
   3 rows takes the sequential tower (bitwise), one of 32 pipelines.
   Then at the training settings: monobeast --pipeline_parallel 2 for
   pipelined_mlp + LSTM (M 4; --pipeline_stages 4, two passes) and
   pipelined_transformer, polybeast --tensor_parallel 2 with
   --num_learner_devices 1 and 2 on the Python pool and on the core,
   with --expert_parallel 2 and with --coordinator_address (an NCCL
   group of one) on the core, the core's data 1 x model 2 checkpoint
   resumed on one device on the Python pool (each run's acting copy
   bitwise the assembled learner after every publish), and (d) polybeast
   --num_learner_devices 2
   --pipeline_parallel 2 --model pipelined_transformer on the core, each
   2 updates with its launches, SPS and update interval.

13. Sequence parallelism and the fleet (run after 12; with
   --sp-fleet-only alone after the builds, printing the paths' launches
   as one JSON line), with the drivers' device list replaced by
   [cuda:0] * 4 and restored after, so every seq device is the one card.
   TF32 off and cuDNN deterministic for (a)-(b): (a) the ring
   (contiguous and zigzag) and Ulysses, plain and transformer variants,
   at the learner shape over T+1 = 80 steps (B=32, H=4, D=32, M=64), P
   = 2 and 4: forward and the gradients of a fixed cotangent against the
   dense path on the card, each one's ms beside the dense path's; (b)
   monobeast's transformer (dense attention) over seq 2 with the ring,
   the zigzag ring and Ulysses, and seq 2 x expert 2 (8 experts), T=79,
   B=32, 2 updates each in one CUDA graph against the one-device update
   (params within phase 9's tolerance, total_loss rtol 2e-4), V-trace
   and the tail once an update, held against their plain versions on an
   SP update, the update ms beside one device's; then monobeast.train
   from its parser with --sequence_parallel 2 at --unroll_length 79,
   V-trace and the tail on (the ring, --ring_schedule zigzag,
   --sp_strategy ulysses, --num_experts 8 --expert_parallel 2), each
   run's counts reset just before it: the driver's seq mesh, every block
   on the path, the update one CUDA graph, V-trace and the tail launched
   each update. Then (c) polybeast --sequence_parallel 2 alone on the
   core (the tail on) and data 2 x seq 2 on the Python pool and on the
   core (SPS, the update interval) and (d) the fleet: a one-host fleet
   (--fleet host=0/1) in an NCCL group of one on the core; a snapshot of CUDA params through
   the wire into a store on the card, bitwise a local publish; two hosts
   as two processes on cuda:0 (chip_smoke.py --fleet-host), mlp + LSTM
   on Mock, in a gloo group both join first (NCCL refuses two ranks on
   one GPU), ending with equal params, the remote applying the lead's
   snapshots; the same two hosts in the driver's NCCL group, its outcome
   and NCCL's words printed; the wire strategy (chosen by the worker)
   with the remote SIGKILLed: at --min_live_hosts 1 the lead DEGRADED
   with a sticky fleet.host1_lost, checkpointing at SIGTERM; three hosts
   at --min_live_hosts 3 with one killed: the lead and the survivor
   HALTED, the lead checkpointed; the gloo group's remote killed, the
   lead's outcome and its time after the kill printed (watched 60 s);
   and chaos_run --selftest --hosts 2 (chip_smoke.py --fleet-chaos: its
   remote a --fleet-host process, both hosts in a gloo group), its
   verdict ok.

Then one JSON line with every kernel's numbers, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of JAX or of the JAX package.
"""

import contextlib
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
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# The slice's shape and random batch, shared with the port's profiler.
from torchbeast_tpu_torch.profile_update import (  # noqa: E402
    B, MODEL_CONFIGS, NUM_ACTIONS, T, polybeast_argv, random_batch,
    random_cache)

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


def pool_stages(pool, gen, dev, n, shapes, dtype, tag):
    """pool_bwd at each trunk stage's input (H, W, C) of `shapes`, N=`n`,
    exact against the plain version and timed beside it, PyTorch's
    backward and the bound: (max |err|, the summed times, the stages)."""
    err = 0.0
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    stages = []
    for H, W, C in shapes:
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
    return err, tot, stages


def check_pool(ops, dev, dtype=torch.float32):
    """pool_bwd per trunk stage at the main path's N, in `dtype` (f32, or
    bf16: the bf16 variant, 8 channels a 16-byte access); exact against
    the plain version, which adds (and in bf16 rounds) in its order."""
    from torchbeast_tpu_torch.ops import pool

    gen = torch.Generator(device=dev).manual_seed(0)
    tag = "" if dtype == torch.float32 else "_bf16"
    err, tot, stages = pool_stages(pool, gen, dev, (T + 1) * B, STAGES,
                                   dtype, tag)

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


# The v2lite.learn cell's cut of DeepSeek-V2-Lite
# (portbench/configs/deepseek_v2_lite.json): 75 leaves, 1,370,939,911
# params, drawn on the card.
V2LITE_CUT = {"num_layers": 5, "experts_held": 32, "memory_len": 1024}


def _param_tree(dev, name="deep", policy="f32", **levers):
    """A model of profile_update.MODEL_CONFIGS (deep + LSTM, the
    transformer with the attention kernel, the pipelined transformer, the
    pipelined MLP + LSTM) or deepseek_v2_lite at V2LITE_CUT, at full
    width, random from seed 0, built at the precision `policy` (its
    params cast to the resident dtype) with the remat `levers`
    (runtime/remat_plan.model_kwargs), and a copy of its parameters."""
    from torchbeast_tpu_torch import precision
    from torchbeast_tpu_torch.models import create_model

    pol = precision.get(policy)
    torch.manual_seed(0)
    config = (dict(V2LITE_CUT, device=dev) if name == "deepseek_v2_lite"
              else MODEL_CONFIGS[name])
    model = create_model(name, NUM_ACTIONS, **config,
                         dtype=pol.compute_dtype, head_dtype=pol.head_dtype,
                         **levers)
    model = precision.cast_params(model.to(dev), pol)
    return model, [p.detach().clone() for p in model.parameters()]


def _agent_state(model, name, dev):
    """The update's agent state: a random cache about 70% valid for the
    transformer families, the zero LSTM state otherwise."""
    if "transformer" in name:
        return random_cache(model, 0, dev)
    return model.initial_state(B, dev)


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
    master beside bf16 params, so the bf16 row has no library time. A tree
    above 2**28 params draws its gradients on the card, from a generator
    of the card's seeded as the CPU one is."""
    from torchbeast_tpu_torch.ops import opt

    model, params0 = _param_tree(dev, tree, policy)
    bf16 = policy == "bf16_train"
    n_params = sum(p.numel() for p in params0)
    ragged = sum(p.numel() % 4 != 0 for p in params0)
    draw_on = dev if n_params > 2 ** 28 else torch.device("cpu")
    g_cpu = torch.Generator(device=draw_on).manual_seed(1)
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
        # Each gradient in its param's own layout (the trunk's convs are
        # channels_last, the stacked [L, ...] leaves contiguous).
        grads = [[torch.empty_like(p).copy_(
            gscale * torch.randn(p.shape, generator=g_cpu, device=draw_on))
            for p in params0] for _ in range(steps)]
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
        del runs, grads, sk, pk, mk, nk, momk, sp, pp, mp, npl, momp, pairs
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
# An f32 LSTM core also launches the recurrence kernels, 2 (T + 1) a layer
# an update; a bf16_train core never.
DEEP_F32_KERNELS = DEEP_KERNELS + ("lstm_layer",)
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
# (m) IMPACT: 3 collects, each staged batch dispatched twice (6 updates),
# the target refreshed every 2 updates; (o) the mlp model, whose path
# has no pool.
IMPACT_ARGS = DEEP_ARGS + ["--loss", "impact", "--replay_reuse", "2",
                           "--target_refresh_updates", "2"]
MLP_ARGS = ["--model", "mlp", "--use_lstm"]
PATHS = (
    ("deep+LSTM", DEEP_ARGS, DEEP_F32_KERNELS, "f32", 3),
    ("transformer", TRANSFORMER_ARGS, TRANSFORMER_KERNELS, "f32", 3),
    ("deep+LSTM bf16_train", DEEP_ARGS, DEEP_KERNELS, "bf16_train", 3),
    ("transformer bf16_train", TRANSFORMER_ARGS, TRANSFORMER_KERNELS,
     "bf16_train", 3),
    ("deep+LSTM superstep_k 4 overlap_collect",
     DEEP_ARGS + SUPERSTEP_ARGS, DEEP_F32_KERNELS, "f32", 12),
    ("deep+LSTM impact replay_reuse 2", IMPACT_ARGS, DEEP_F32_KERNELS, "f32",
     6),
    ("mlp+LSTM", MLP_ARGS, ("vtrace_targets", "rmsprop_tail", "lstm_layer"),
     "f32", 2),
)


def time_impact_update(dev):
    """The deep + LSTM IMPACT update's two graphs at the training
    settings (TF32 as PyTorch defaults it, cuDNN free to choose): one
    target forward and one update, each timed over CUDA-event runs, and
    the target's share of the two."""
    from torchbeast_tpu_torch import learner as learner_lib

    model, _ = _param_tree(dev, "deep", "f32")
    hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                             vtrace_impl="pallas", opt_impl="pallas",
                             loss="impact")
    opt = learner_lib.make_optimizer(hp, list(model.parameters()))
    dispatch = learner_lib.make_update_dispatch(model, opt, hp)
    forward = learner_lib.make_target_forward(lagged_target(model))
    state = model.initial_state(B, dev)
    batch = impact_batch(forward, random_batch(0, dev), state)
    update_ms = time_ms(lambda: dispatch(batch, state))
    target_ms = time_ms(lambda: forward(batch, state))
    print(f"IMPACT update deep+LSTM, training settings (TF32 "
          f"{torch.backends.cudnn.allow_tf32} for cuDNN): target forward "
          f"graph {target_ms:.3f} ms, update graph {update_ms:.3f} ms; "
          f"the target's share of the two "
          f"{target_ms / (target_ms + update_ms):.3f}")


def target_published(updates_per_group, groups, refresh):
    """learner.target.snapshots_published of the reference's cadence:
    version 0, then a publish at the end of each group of updates when
    `refresh` or more have passed since the last one."""
    published, last, version = 1, 0, 0
    for _ in range(groups):
        version += updates_per_group
        if version - last >= refresh:
            published, last = published + 1, version
    return published


def run_main_path(ops, savedir, path, unroll=T):
    """Train one path's updates of `unroll` steps; return its launch
    counts, all and bf16. Every dispatch replays a CUDA graph; each
    replay adds the port kernels its capture counted, so the counts are
    launches on the card."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import monobeast, telemetry

    label, model_args, expected, policy, updates = path
    parse = monobeast.make_parser().parse_args
    reuse = parse(model_args).replay_reuse
    flags = parse([
        "--env", "Mock", "--num_actors", str(B), *model_args,
        "--batch_size", str(B),
        "--unroll_length", str(unroll), "--vtrace_impl", "pallas",
        "--opt_impl", "pallas", "--serial_envs", "--precision", policy,
        "--total_steps", str(updates * unroll * B // reuse),
        "--savedir", savedir,
        "--xpid", "chip_smoke_" + re.sub(r"\W+", "_", label),
    ])
    # A checkpoint left by an earlier run of this script would resume.
    shutil.rmtree(os.path.join(savedir, flags.xpid), ignore_errors=True)
    published = telemetry.get_registry().counter(
        "learner.target.snapshots_published")
    published_before = published.value()
    ops.reset_launch_counts()
    learner_lib.TargetNetwork.forwards = 0
    t0 = time.time()
    stats = monobeast.train(flags)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    forwards = learner_lib.TargetNetwork.forwards
    check(stats["updates"] == updates and stats["step"] == updates * unroll
          * B // reuse, f"{label}: {stats['updates']} updates over "
          f"{stats['step']} env frames")
    if flags.loss == "impact":
        # One fresh batch a collect (num_actors = batch_size): one target
        # forward each, a refresh due between reuse groups.
        fresh = updates // reuse
        check(forwards == fresh, f"{label}: {forwards} target forwards for "
                                 f"{fresh} fresh batches")
        want = target_published(reuse, fresh, flags.target_refresh_updates)
        got = published.value() - published_before
        check(got == want, f"{label}: {got} target snapshots published, "
                           f"the reference's cadence gives {want}")
        print(f"main path {label}: {fresh} target forwards, {int(got)} "
              f"target versions, {stats['step']} env frames, "
              f"{stats['updates'] * T * B} frames learned from; learn SPS "
              f"{stats['learn_sps']:.1f}")
    for name in expected:
        # The deep trunk's backward pools three times an update; the LSTM
        # core's one layer steps unroll + 1 times forward and back.
        per_update = {"pool_bwd": 3, "lstm_layer": 2 * (unroll + 1)}.get(
            name, 1)
        check(counts[name] >= per_update * updates,
              f"{label} path launched {name} {counts[name]} times in "
              f"{updates} updates")
        if name in bf16:
            want = counts[name] if policy == "bf16_train" else 0
            check(bf16[name] == want, f"{label} path: {bf16[name]} of "
                  f"{counts[name]} {name} launches were bf16")
    if policy == "bf16_train":
        check(counts["lstm_layer"] == 0, f"{label} path: a bf16 core "
              f"launched the f32 recurrence {counts['lstm_layer']} times")
    # The trunk hands the pool backward its tensors as they are (no layout
    # copy); every launch must have found them channels_last and aligned.
    vector = ops.pool_bwd.vector_launches
    check(vector == counts["pool_bwd"], f"{label} path: {vector} of "
          f"{counts['pool_bwd']} pool_bwd launches took the 16-byte path")
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm"):
        check(key in stats and np.isfinite(stats[key]),
              f"{label} loss stat {key} = {stats.get(key)}")
    if "--num_experts" in model_args:
        check(stats["aux_loss"] > 0, f"{label}: aux_loss {stats['aux_loss']}")
    print(f"main path {label} 84x84x4 T={unroll} B={B}: {updates} updates "
          f"in {wall:.1f} s; SPS {stats['sps']:.1f}; median update "
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


def run_polybeast_impact(ops, savedir, native):
    """(n) polybeast deep + LSTM with --loss impact --replay_reuse 2 on
    the Python pool, or on the core with --native_runtime
    --native_server: (1) two batches, the first handed out twice and the
    second once (3 updates: the run ends at the first dispatch whose env
    frames reach --total_steps, as the reference's does), every update
    launching V-trace and the tail at least once and the pool backward
    at least three times, one target forward a dispatch, replicas armed
    by the impact default (a refresh every 10 updates, without
    --replica_refresh_updates), finite losses, HEALTHY, a checkpoint;
    (2) the same xpid for one more batch: it resumes from the checkpoint
    and runs its 1 update. Prints the update counts checked, SPS, learn
    SPS and the median update interval. Returns the launch counts of (1)
    and (2)."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import polybeast, telemetry

    xpid = "chip_smoke_polybeast_impact" + ("_native" if native else "")
    label = (POLY_LABEL + " impact replay_reuse 2"
             + (" native runtime" if native else ""))
    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    base = polybeast_argv(savedir, xpid) + ["--loss", "impact",
                                            "--replay_reuse", "2"]
    if native:
        base[base.index("--no_native_runtime")] = "--native_runtime"
        base.append("--native_server")
    runtime = "native" if native else "python"
    parse = polybeast.make_parser().parse_args
    reg = telemetry.get_registry()
    replica_published = reg.counter("serving.snapshots_published")
    lines = _Lines()
    logging.getLogger("torchbeast_tpu_torch").addHandler(lines)
    logging.getLogger("torchbeast_tpu_torch").setLevel(logging.INFO)
    by_path, runs = {}, []
    try:
        for run_label, batches, want_updates in ((label, 2, 3),
                                                 (label + " resume", 3, 1)):
            lines.lines.clear()
            before = replica_published.value()
            ops.reset_launch_counts()
            learner_lib.TargetNetwork.forwards = 0
            t0 = time.time()
            stats = polybeast.train(parse(base + [
                "--total_steps", str(batches * T * B)]))
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
            by_path[run_label] = (counts, bf16)
            updates = stats["updates"]
            check(updates == want_updates and stats["step"] == batches * T
                  * B, f"{run_label}: {updates} updates to step "
                  f"{stats['step']}")
            for name, per_update in (("vtrace_targets", 1),
                                     ("rmsprop_tail", 1), ("pool_bwd", 3)):
                check(counts[name] >= per_update * updates,
                      f"{run_label}: {counts[name]} {name} launches in "
                      f"{updates} updates")
            check(ops.pool_bwd.vector_launches == counts["pool_bwd"],
                  f"{run_label}: pool_bwd launches off the 16-byte path")
            forwards = learner_lib.TargetNetwork.forwards
            check(forwards == updates, f"{run_label}: {forwards} target "
                                       f"forwards in {updates} dispatches")
            for key in ("total_loss", "pg_loss", "baseline_loss",
                        "entropy_loss", "grad_norm"):
                check(key in stats and np.isfinite(stats[key]),
                      f"{run_label} loss stat {key} = {stats.get(key)}")
            check(stats["health"] == "HEALTHY" and stats["runtime"] ==
                  runtime, f"{run_label}: health {stats['health']}, "
                  f"runtime {stats['runtime']}")
            armed = [m for m in lines.lines if m.startswith(
                "Replica serving armed: refresh every 10 updates")]
            check(armed and replica_published.value() > before,
                  f"{run_label}: replicas not armed by the impact default")
            check(os.path.exists(os.path.join(savedir, xpid, "model.ckpt")),
                  f"{run_label}: no checkpoint")
            print(f"{run_label} 84x84x4 T={T} B={B}, 16 env servers: "
                  f"{updates} updates to step {stats['step']} (the "
                  f"reference's {want_updates}) in {wall:.1f} "
                  f"s; SPS {stats['sps']:.1f}; learn SPS "
                  f"{stats['learn_sps']:.1f}; median update interval on the "
                  f"shared stream {stats['update_interval_ms_median']:.2f} "
                  f"ms; {forwards} target forwards; replicas armed ("
                  f"{int(replica_published.value() - before)} snapshots); "
                  f"launches {counts}; total_loss {stats['total_loss']:.4f}")
            runs.append((stats, lines.lines[:]))
    finally:
        logging.getLogger("torchbeast_tpu_torch").removeHandler(lines)
    (first, _), (second, logged) = runs
    resumed = [m for m in logged if m.startswith("Resuming preempted job")]
    check(resumed and f"'step': {first['step']}" in resumed[0],
          f"{label}: the second run did not resume from step "
          f"{first['step']}")
    print(f"{label}: resumed from step {first['step']} to {second['step']}")
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
                "transformer_attention_bwd": "attention_bwd_kernel",
                "lstm_layer": "lstm_step_"}


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


def lagged_target(model, seed=1, scale=0.01):
    """A copy of `model` whose params moved by `scale` of a standard
    normal from seed `seed`: a target network lagging the learner."""
    target = copy.deepcopy(model).requires_grad_(False)
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for p in target.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen,
                                       device=p.device).to(p.dtype))
    return target


def impact_batch(target_forward, batch, state):
    """`batch` with the IMPACT target outputs of `target_forward`."""
    from torchbeast_tpu_torch import learner as learner_lib

    logits, baseline = target_forward(batch, state)
    return {**batch, learner_lib.TARGET_LOGITS_KEY: logits,
            learner_lib.TARGET_BASELINE_KEY: baseline}


def check_graph_update(dev, label, model_name, policy, k, impact=False,
                       per_update=None):
    """Two dispatches of the learner's CUDA graph (learner.
    make_update_dispatch: K updates a replay) against 2K eager updates
    (update_body) of a copy from the same state, on the same batches,
    with the LR decay and the entropy anneal moving every update: TF32
    off and cuDNN deterministic, params, nu, the master and every stat
    must be bitwise equal, and the device count must read 2K. One
    replay, profiled: the host's API calls and the port kernels it ran,
    K times the eager update's, which must launch each kernel of
    `per_update` as often as it says. With `impact`, --loss impact: each
    batch carries the outputs of a lagged target network (the same for
    both), and the target forward's graph and the update's are timed.
    Returns the median ms of one dispatch (CUDA events)."""
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
                             entropy_cost_final=1e-4,
                             loss="impact" if impact else "vtrace")
    opt_g = learner_lib.make_optimizer(hp, list(model_g.parameters()))
    opt_e = learner_lib.make_optimizer(hp, list(model_e.parameters()))
    state = precision.cast_batch(_agent_state(model_g, model_name, dev),
                                 pol.batch_dtype)
    batches = [precision.cast_batch(random_batch(i, dev), pol.batch_dtype)
               for i in range(2 * k)]
    if impact:
        label += " impact"
        target = lagged_target(model_g)
        target_eager = learner_lib.target_forward_body(target)
        batches = [impact_batch(target_eager, b, state) for b in batches]
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
    expected = dict(per_update or {})
    if impact:
        expected.update(vtrace_targets=1, rmsprop_tail=1, pool_bwd=3)
    for w, n in expected.items():
        check(eager_kernels[w] == n,
              f"{label}: one eager update ran {eager_kernels[w]} {w} "
              f"kernels, not {n}")
    print(f"graph update {label} K={k}: 2 dispatches bitwise equal to "
          f"{2 * k} eager updates ({len(pairs)} tensors, {len(want[0])} "
          f"stats; TF32 off, cuDNN deterministic); one dispatch: "
          f"{sum(calls.values())} host API calls {calls}, against "
          f"{sum(eager_calls.values())} for one eager update; port kernels "
          f"per replay { {w: n for w, n in kernels.items() if n} }")
    if impact:
        graph_forward = learner_lib.make_target_forward(target, k)
        stacked = inputs(0)
        update_ms = time_ms(lambda: dispatch(*stacked)) / k
        target_ms = time_ms(lambda: graph_forward(*stacked)) / k
        print(f"graph update {label} K={k}, per update: target forward "
              f"graph {target_ms:.3f} ms, update graph {update_ms:.3f} "
              f"ms; the target's share of the two "
              f"{target_ms / (target_ms + update_ms):.3f}")
        return update_ms
    return time_ms(lambda: dispatch(*inputs(0))) / k


def check_graph_target(dev):
    """The IMPACT target network's forward (learner.TargetNetwork: a CUDA
    graph of its own, bound to its params buffer) against an eager twin
    on the same params, bitwise, on two batches at version 0 and again
    after one refresh (the learner's params moved, then published as
    version 8 and loaded into the buffer). Each forward is one replay."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch.telemetry.metrics import MetricsRegistry

    model, _ = _param_tree(dev, "deep", "f32")
    target = learner_lib.TargetNetwork(model, 8, registry=MetricsRegistry())
    twin = copy.deepcopy(model).requires_grad_(False)
    eager = learner_lib.target_forward_body(twin)
    state = model.initial_state(B, dev)
    forwards = learner_lib.TargetNetwork.forwards
    for version in (0, 8):
        if version:
            moved = lagged_target(model, seed=2)
            with torch.no_grad():
                torch._foreach_copy_(list(model.parameters()),
                                     list(moved.parameters()))
                torch._foreach_copy_(list(twin.parameters()),
                                     list(moved.parameters()))
            check(not target.maybe_refresh(version - 1, model.parameters())
                  and target.maybe_refresh(version, model.parameters()),
                  "the target refresh was not due at 8 updates")
        for seed in (0, 1):
            batch = random_batch(seed, dev)
            got = target.outputs(batch, state)
            want = eager(batch, state)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"target forward graph at version {version}, batch "
                  f"{seed}: outputs differ from the eager twin")
    n = learner_lib.TargetNetwork.forwards - forwards
    check(n == 4, f"{n} target forwards counted for 4")
    print("graph target forward deep+LSTM: bitwise equal to its eager twin "
          "on 2 batches at version 0 and after a refresh to version 8 "
          f"(logits {tuple(got[0].shape)}, baseline {tuple(got[1].shape)})")


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
PARITY_BF16 = {"deep+LSTM": (1e-5, 1e-5), "transformer": (3e-2, 1e-2),
               "transformer num_experts 8": (3e-2, 1e-2),
               "pipelined_transformer": (3e-2, 1e-2)}


def _norm_rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# The kernels the update parity check runs plain in its twin: all but the
# LSTM recurrence (check_update_parity).
PARITY_PLAIN = ("vtrace_targets", "rmsprop_tail", "pool_bwd",
                "transformer_attention")


def check_update_parity(ops, dev, label, model_k, state, policy="f32",
                        impact=False, batch=None):
    """One learner update of `model_k` from `state` with the kernels and
    one of its copy with the plain versions, on the same random batch
    (`batch`, default random_batch(0)), at the precision `policy`; with
    `impact` under --loss impact, the batch carrying a lagged target
    network's outputs. The LSTM recurrence runs its kernels in both:
    its 81 steps summed in another order than cuBLAS's move the trunk's
    params after one update by up to about 1e-7, past this check's atol,
    and check_lstm holds the kernels to their plain version on their
    own."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import precision

    pol = precision.get(policy)
    if batch is None:
        batch = random_batch(0, dev)
    batch = precision.cast_batch(batch, pol.batch_dtype)
    state = precision.cast_batch(state, pol.batch_dtype)
    hp = learner_lib.HParams(unroll_length=batch["reward"].shape[0] - 1,
                             batch_size=B,
                             vtrace_impl="pallas", opt_impl="pallas",
                             param_dtype=pol.param_dtype,
                             opt_state_dtype=pol.opt_state_dtype,
                             loss="impact" if impact else "vtrace")
    if impact:
        batch = impact_batch(learner_lib.target_forward_body(
            lagged_target(model_k)), batch, state)
    model_p = copy.deepcopy(model_k)
    start = [p.detach().to(torch.float32, copy=True)
             for p in model_k.parameters()]
    results = []
    for model, plain in ((model_k, False), (model_p, True)):
        optimizer = learner_lib.make_optimizer(hp, list(model.parameters()))
        step = learner_lib.update_body(model, optimizer, hp)
        if plain:
            with ops.plain_on_device(*PARITY_PLAIN):
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
    if impact:
        label += " impact"
    print(f"parity: one {label} update at {policy}, kernels vs plain on the "
          f"card: {what} err {worst[0]:.3g} at {worst[1]} ({tol}), stats "
          f"max_abs_err {es:.3g} (rtol {stol}, atol {atol_stats})")
    check(not failed, f"{label} {policy} update parity: outside "
                      f"tolerance: {failed}")
    check(not stat_failed, f"{label} {policy} update parity: stats "
                           f"{stat_failed}")


# ------------------------------------------------------------------- LSTM

# The recurrence kernels (ops/lstm.py, csrc/lstm.cu): one layer of the
# shallow network's core (H=519, odd: unaligned rows) and of the deep one's
# (H=256), at the learner's T + 1 steps with a gradient and at the acting
# shape (T=1) without.
LSTM_CASES = (("shallow", 519, T + 1, True), ("deep", 256, T + 1, True),
              ("shallow acting", 519, 1, False),
              ("deep acting", 256, 1, False))
LSTM_NAMES = ("h_seq", "h_T", "c_T", "d x_proj", "d h0", "d c0",
              "d weight_hh")


def lstm_inputs(steps, hidden, seed, dev):
    """x_proj, notdone (dones at 5%), h0, c0 and weight_hh of a layer."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    done = torch.rand(steps, B, generator=g) < 0.05
    xs = (torch.randn(steps, B, 4 * hidden, generator=g), (~done).float(),
          0.5 * torch.randn(B, hidden, generator=g),
          0.5 * torch.randn(B, hidden, generator=g),
          hidden ** -0.5 * torch.randn(4 * hidden, hidden, generator=g))
    return [x.to(dev) for x in xs]


def lstm_run(lstm, xs, weights, grad):
    """The layer's outputs and, with `grad`, the gradients of x_proj, h0,
    c0 and weight_hh of the outputs weighted by `weights`."""
    leaves = [x if i == 1 else x.detach().requires_grad_(grad)
              for i, x in enumerate(xs)]
    with torch.set_grad_enabled(grad):
        outs = list(lstm.lstm_layer(*leaves))
        if not grad:
            return outs
        loss = sum((o * w).sum() for o, w in zip(outs, weights))
        return outs + list(torch.autograd.grad(
            loss, [leaves[i] for i in (0, 2, 3, 4)]))


def lstm_update_launches(ops, dev, name, layers):
    """lstm_layer launches per replay of the full-width `name` + LSTM
    update graph, and its median replay ms with the kernels and with the
    recurrence's plain version."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch.models import create_model

    ms = {}
    for plain in (False, True):
        torch.manual_seed(0)
        model = create_model(name, NUM_ACTIONS, use_lstm=True).to(dev)
        hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                                 vtrace_impl="pallas", opt_impl="pallas")
        opt = learner_lib.make_optimizer(hp, list(model.parameters()))
        batch, state = random_batch(0, dev), model.initial_state(B, dev)
        with (ops.plain_on_device("lstm_layer") if plain
              else contextlib.nullcontext()):
            dispatch = learner_lib.make_update_dispatch(model, opt, hp)
            dispatch.capture(batch, state)
        per = dispatch.launches_per_replay.get("lstm_layer", 0)
        want = 0 if plain else 2 * (T + 1) * layers
        check(per == want, f"lstm {name}: {per} recurrence launches a "
                           f"replay, want {want}")
        if not plain:
            launches = per
        ms["plain" if plain else "kernel"] = time_ms(
            lambda: dispatch(batch, state))
        del model, opt, dispatch
        _free_card()
    return launches, ms


def check_lstm(ops, dev):
    """The recurrence kernels against their plain version on the card at
    LSTM_CASES (rtol 1e-4 / atol 1e-5: f32 summed in another order, step
    after step), bitwise over two calls; one layer timed forward alone
    (T + 1 launches) and back alone (T + 1, outside the products after the
    loop), kernel beside plain and beside the bound; the launches and the
    update's time on the main path of the shallow and the deep network."""
    from torchbeast_tpu_torch.ops import _build, lstm

    err = 0.0
    for label, hidden, steps, grad in LSTM_CASES:
        xs = lstm_inputs(steps, hidden, 0, dev)
        g = torch.Generator(device="cpu").manual_seed(1)
        weights = [torch.randn(s, generator=g).to(dev) for s in (
            (steps, B, hidden), (B, hidden), (B, hidden))]
        got = lstm_run(lstm, xs, weights, grad)
        again = lstm_run(lstm, xs, weights, grad)
        with ops.plain_on_device("lstm_layer"):
            want = lstm_run(lstm, xs, weights, grad)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"lstm {label}: two calls differ")
        for what, a, b in zip(LSTM_NAMES, got, want):
            e, ok = close(a, b, 1e-4, 1e-5)
            err = max(err, e)
            check(ok, f"lstm {label} {what}: kernel differs from plain, "
                      f"max |err| {e}")
    print(f"kernel lstm_layer: within rtol 1e-4 / atol 1e-5 of plain at "
          f"{', '.join(c[0] for c in LSTM_CASES)} (max |err| {err:.3g}), "
          "bitwise over two calls")

    timings = {}
    for label, hidden, steps, _ in LSTM_CASES[:2]:
        x_proj, notdone, h0, c0, w = lstm_inputs(steps, hidden, 0, dev)
        fwd = time_ms(lambda: lstm._forward(x_proj, notdone, h0, c0, w,
                                            keep_gates=True))
        _, _, _, c_seq, gates = lstm._forward(x_proj, notdone, h0, c0, w,
                                              keep_gates=True)
        dy = torch.randn(steps, B, hidden, device=dev)
        dc, dgates = torch.zeros_like(c0), torch.empty_like(gates)
        lib, stream = _build.library(), lstm._stream(x_proj)
        bwd = time_ms(lambda: lib.tbt_lstm_bwd(
            notdone.data_ptr(), w.data_ptr(), gates.data_ptr(),
            c_seq.data_ptr(), c0.data_ptr(), dy.data_ptr(), None,
            dc.data_ptr(), dgates.data_ptr(), steps, B, hidden, stream))
        with torch.no_grad():
            plain_fwd = time_ms(lambda: lstm.lstm_layer_plain(
                x_proj, notdone, h0, c0, w))
        leaves = [x.detach().requires_grad_() for x in (x_proj, h0, c0, w)]
        outs = lstm.lstm_layer_plain(leaves[0], notdone, *leaves[1:])
        plain_bwd = time_ms(lambda: torch.autograd.grad(
            outs[0], leaves, dy, retain_graph=True))
        # Each operand read once and each result written once, f32:
        # forward x_proj, notdone, W, h0 and c0 in, h_seq, c_seq, gates,
        # h_T and c_T out; back notdone, W, gates, c_seq, dy, c0 and dc
        # in, dgates and dc out. The product: 2 B 4H H a step.
        bh, b4, w4 = B * hidden, 4 * B * hidden, 4 * hidden * hidden
        fwd_bound = bound_ms(
            4 * (steps * (b4 + B + 2 * bh + b4) + w4 + 4 * bh),
            2 * steps * b4 * hidden)
        bwd_bound = bound_ms(
            4 * (steps * (B + b4 + 2 * bh + b4) + w4 + 3 * bh),
            2 * (steps - 1) * b4 * hidden)
        timings[label] = {
            "fwd_ms": fwd, "bwd_ms": bwd, "plain_fwd_ms": plain_fwd,
            "plain_bwd_ms": plain_bwd, "fwd_step_us": 1e3 * fwd / steps,
            "bwd_step_us": 1e3 * bwd / steps,
            "fwd_bound_ms": fwd_bound[0], "bwd_bound_ms": bwd_bound[0],
            "bound_by": fwd_bound[1]}
        print(f"kernel lstm_layer {label} H={hidden} T+1={steps} B={B}: "
              f"forward {fwd:.4f} ms ({1e3 * fwd / steps:.2f} us a step), "
              f"backward kernels {bwd:.4f} ms ({1e3 * bwd / steps:.2f} us "
              f"a step); bound {fwd_bound[0]:.4f} / {bwd_bound[0]:.4f} ms "
              f"({fwd_bound[1]}); plain forward {plain_fwd:.4f} ms, plain "
              f"backward {plain_bwd:.4f} ms")
    updates = {}
    for name, layers in (("shallow", 2), ("deep", 1)):
        launches, ms = lstm_update_launches(ops, dev, name, layers)
        updates[name] = {"launches_per_update": launches, **ms}
        print(f"main path {name}+LSTM update graph T={T} B={B}: "
              f"{launches} lstm_layer launches a replay; median update "
              f"{ms['kernel']:.3f} ms, with the plain recurrence "
              f"{ms['plain']:.3f} ms")
    shallow = timings["shallow"]
    return {
        "name": "lstm_layer", "route": "cuda",
        "source": "torchbeast_tpu_torch/csrc/lstm.cu",
        "replaces": "none (flax OptimizedLSTMCell under lax.scan, XLA)",
        "max_abs_err": err,
        "ms": shallow["fwd_ms"] + shallow["bwd_ms"],
        "plain_ms": shallow["plain_fwd_ms"] + shallow["plain_bwd_ms"],
        "bound_ms": shallow["fwd_bound_ms"] + shallow["bwd_bound_ms"],
        "bound_by": shallow["bound_by"], "library_ms": None,
        "layers": timings, "updates": updates,
    }


# ------------------------------------------------------------------ remat

# 4r. The plans each model is run under: the default (--remat unset, every
# activation kept), all, the three trunk fronts, the LSTM core alone.
FRONTS = "stage0=front,stage1=front,stage2=front,core=none"
CORE_ONLY = "stage0=none,stage1=none,stage2=none,core=all"
REMAT_PLANS = {
    ("deep", "f32"): (("default", None), ("all", "all"), ("fronts", FRONTS),
                      ("core=all", CORE_ONLY)),
    ("deep", "bf16_train"): (("default", None), ("all", "all")),
    ("transformer", "f32"): (("default", None), ("all", "all")),
}
REMAT_REPLAYS = 10


def _free_card():
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def check_remat_update(ops, dev, model_name, policy, label, spec):
    """One plan of 4r: the allocator's peak over one eager dispatch (the
    planner's oracle, runtime/remat_plan.superstep_cost_fn, as --remat
    auto measures it) and the bytes it accesses; then the plan's update
    graph (learner.make_update_dispatch) captured, its launches of each
    port kernel in one replay, the params after that one update, and the
    median update time over REMAT_REPLAYS replays."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import precision
    from torchbeast_tpu_torch.profile_update import remat_levers
    from torchbeast_tpu_torch.runtime import remat_plan

    pol = precision.get(policy)
    assignment, levers = remat_levers(
        model_name, MODEL_CONFIGS[model_name].get("use_lstm", False), spec)
    hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                             vtrace_impl="pallas", opt_impl="pallas",
                             param_dtype=pol.param_dtype,
                             opt_state_dtype=pol.opt_state_dtype)
    resident = _free_card()
    cost_fn = remat_plan.superstep_cost_fn(
        lambda kw: _param_tree(dev, model_name, policy, **kw)[0], hp, 1,
        remat_plan.learner_batch_structs(hp, NUM_ACTIONS, (84, 84, 4),
                                         torch.uint8, pol.batch_dtype),
        B, model_name)
    peak, accessed = cost_fn(assignment)
    check(peak is not None, f"remat {label} {spec}: the oracle failed")
    # A plan's first run may allocate what a library keeps (a workspace
    # for an op or a thread it meets first); the same candidate run again
    # must then leave nothing more on the card.
    first = _free_card()
    cost_fn(assignment)
    left = _free_card() - first
    model, _ = _param_tree(dev, model_name, policy, **levers)
    optimizer = learner_lib.make_optimizer(hp, list(model.parameters()))
    state = precision.cast_batch(_agent_state(model, model_name, dev),
                                 pol.batch_dtype)
    batch = precision.cast_batch(random_batch(0, dev), pol.batch_dtype)
    dispatch = learner_lib.make_update_dispatch(model, optimizer, hp)
    dispatch.capture(batch, state)
    ops.reset_launch_counts()
    dispatch(batch, state)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    params = [p.detach().clone() for p in model.parameters()]
    ms = time_ms(lambda: dispatch(batch, state), reps=REMAT_REPLAYS)
    del model, optimizer, dispatch, batch, state
    _free_card()
    return {"peak": peak, "accessed": accessed, "ms": ms,
            "launches": launches, "params": params, "left": left,
            "assignment": remat_plan.spell(assignment)}


def run_remat_graphs(ops, dev, plans=REMAT_PLANS):
    """4r (TF32 off, cuDNN deterministic, TBT_POOL_PALLAS=1): each plan of
    `plans` (REMAT_PLANS: the deep + LSTM model at f32 and bf16_train and
    the transformer with --attention_impl pallas; phase 8: the pipelined
    transformer), one line each. Every plan's params after one update
    must equal the default's bitwise, its launches per update be the
    default's (the transformer's attention forwards 2 -> 4 under
    blocks=all, its backwards 2; an f32 LSTM core's recurrence kernels
    2 (T + 1) unless the plan remats the core), and the deep model's `all`
    must peak below its default. A rematted f32 core steps the plain
    cell, so such a plan is held to the default run with the recurrence's
    plain version. Returns {(model, policy): {plan: result}}."""
    want = {"deep": {"default": {"vtrace_targets": 1, "rmsprop_tail": 1,
                                 "pool_bwd": 3}},
            "pipelined_transformer": {"default": {"vtrace_targets": 1,
                                                  "rmsprop_tail": 1}},
            "transformer": {
                "default": {"vtrace_targets": 1, "rmsprop_tail": 1,
                            "transformer_attention": 2,
                            "transformer_attention_bwd": 2},
                "all": {"vtrace_targets": 1, "rmsprop_tail": 1,
                        "transformer_attention": 4,
                        "transformer_attention_bwd": 2}}}
    results = {}
    for (model_name, policy), model_plans in plans.items():
        label = ({"deep": "deep+LSTM"}.get(model_name, model_name)
                 + ("" if policy == "f32" else f" {policy}"))
        got = results[(model_name, policy)] = {}
        lstm_f32 = (policy == "f32"
                    and MODEL_CONFIGS[model_name].get("use_lstm", False))
        plain_core = None
        for plan, spec in model_plans:
            r = got[plan] = check_remat_update(ops, dev, model_name, policy,
                                               label, spec)
            base = got["default"]
            launches = dict(want[model_name].get(
                plan, want[model_name]["default"]))
            if lstm_f32 and "core=all" in r["assignment"]:
                if plain_core is None:
                    with ops.plain_on_device("lstm_layer"):
                        plain_core = check_remat_update(
                            ops, dev, model_name, policy, label, None)
                base = plain_core
            elif lstm_f32:
                launches["lstm_layer"] = 2 * (T + 1)
            equal = all(torch.equal(a, b)
                        for a, b in zip(r["params"], base["params"]))
            print(f"remat {label} {plan} ({r['assignment']}): peak "
                  f"{r['peak'] / 2**30:.3f} GiB ({int(r['peak'])} bytes, "
                  f"the allocator's), bytes accessed "
                  f"{r['accessed'] / 2**30:.3f} GiB; update graph median "
                  f"{r['ms']:.3f} ms over {REMAT_REPLAYS} replays; launches "
                  f"per update {r['launches']}; params after one update "
                  f"{'bitwise equal to' if equal else 'DIFFER from'} the "
                  "default's" + (" with the plain recurrence"
                                 if base is plain_core else ""))
            check(r["launches"] == launches,
                  f"remat {label} {plan}: launches {r['launches']}, want "
                  f"{launches}")
            check(r["left"] == 0, f"remat {label} {plan}: a second oracle "
                                  f"run left {r['left']} bytes more on the "
                                  "card")
            check(equal, f"remat {label} {plan}: params after one update "
                         "differ from the default plan's")
        for r in got.values():
            del r["params"]
        if model_name == "deep":
            check(got["all"]["peak"] < got["default"]["peak"],
                  f"remat {label}: all peaks at {got['all']['peak']}, the "
                  f"default at {got['default']['peak']}")
    return results


def time_remat_training(dev):
    """The deep + LSTM f32 update graph at the training settings (TF32 as
    PyTorch defaults it, cuDNN free to choose) under the default plan and
    under `all`, timed over CUDA-event runs in one process, interleaved;
    and each plan's peak under these settings through the planner's
    oracle, as --remat auto measures it in a training run (cuDNN's
    choice of algorithms, and so its workspaces, follows the settings).
    Returns {plan: the peak less what was allocated before the oracle
    ran}: the dispatch's own footprint, which the budget of 5p adds to
    what is allocated when its run starts (each graph captured so far
    left its streams' cuBLAS workspaces behind)."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch.profile_update import remat_levers
    from torchbeast_tpu_torch.runtime import remat_plan

    hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                             vtrace_impl="pallas", opt_impl="pallas")
    times, peaks = {}, {}
    for plan in ("default", "all", "default", "all"):
        assignment, levers = remat_levers(
            "deep", True, None if plan == "default" else plan)
        model, _ = _param_tree(dev, "deep", "f32", **levers)
        optimizer = learner_lib.make_optimizer(hp, list(model.parameters()))
        state = model.initial_state(B, dev)
        batch = random_batch(0, dev)
        dispatch = learner_lib.make_update_dispatch(model, optimizer, hp)
        times.setdefault(plan, []).append(
            time_ms(lambda: dispatch(batch, state)))
        del model, optimizer, dispatch
        _free_card()
        if plan not in peaks:
            resident = torch.cuda.memory_allocated()
            peaks[plan] = remat_plan.superstep_cost_fn(
                lambda kw: _param_tree(dev, "deep", "f32", **kw)[0], hp, 1,
                remat_plan.learner_batch_structs(hp, NUM_ACTIONS,
                                                 (84, 84, 4)),
                B, "deep")(assignment)[0] - resident
    print(f"remat update deep+LSTM f32, training settings (TF32 "
          f"{torch.backends.cudnn.allow_tf32} for cuDNN): default "
          f"{times['default']} ms, all {times['all']} ms (two timings "
          f"each, interleaved); all / default "
          f"{min(times['all']) / min(times['default']):.3f}; peaks above "
          f"what was allocated before: default "
          f"{peaks['default'] / 2**30:.3f} GiB, all "
          f"{peaks['all'] / 2**30:.3f} GiB (the allocator's)")
    return peaks


def run_remat_auto(ops, savedir, budget_bytes):
    """5p (monobeast): deep + LSTM with --remat auto --hbm_budget_gb at
    `budget_bytes` for 4 updates: the plan is neither none nor all-remat,
    its measured peak within the budget, the run trains (the launch and
    loss checks of run_main_path), and telemetry.jsonl carries the plan
    (source auto, the table's size) and the bytes-accessed gauge."""
    from torchbeast_tpu_torch import telemetry
    from torchbeast_tpu_torch.runtime import remat_plan

    gb = budget_bytes / 2**30
    label = "deep+LSTM remat auto"
    resident = _free_card()
    path = (label, DEEP_ARGS + ["--remat", "auto", "--hbm_budget_gb",
                                repr(gb)], DEEP_KERNELS, "f32", 4)
    counts = run_main_path(ops, savedir, path)
    plan = remat_plan.last_plan()
    stages = remat_plan.stages_for("deep", True)
    check(plan is not None and plan.source == "auto",
          f"{label}: plan {plan and plan.source}")
    print(f"{label}: budget {gb:.3f} GiB ({budget_bytes:.0f} bytes; "
          f"{resident} bytes resident before); chose "
          f"{remat_plan.spell(plan.assignment)} at peak "
          f"{plan.peak_bytes / 2**30:.3f} GiB after {len(plan.table)} "
          "candidates: "
          f"{[(r['assignment'], r['peak_bytes']) for r in plan.table]}")
    check(plan.assignment not in (remat_plan.no_remat(stages),
                                  remat_plan.all_remat(stages)),
          f"{label}: chose {remat_plan.spell(plan.assignment)}")
    check(plan.peak_bytes <= budget_bytes,
          f"{label}: peak {plan.peak_bytes} above the budget {budget_bytes}")
    xpid = "chip_smoke_" + re.sub(r"\W+", "_", label)
    last = telemetry.read_jsonl(os.path.join(savedir, xpid,
                                             "telemetry.jsonl"))[-1]
    static = last.get("learner.remat_plan", {})
    check(static.get("source") == "auto" and static.get("evaluated")
          == len(plan.table) > 0, f"{label}: static {static}")
    gauge = last["gauges"].get("learner.hbm_bytes_per_update", 0)
    check(gauge > 0, f"{label}: learner.hbm_bytes_per_update {gauge}")
    print(f"{label}: learner.hbm_bytes_per_update {gauge:.0f}")
    return {label: counts}


def run_polybeast_remat(ops, savedir, native):
    """5p (polybeast): deep + LSTM with --remat all for 4 updates on the
    Python pool or the core: every update launches V-trace, the tail and
    the pool backward three times (16-byte path), the losses are finite,
    and the last telemetry line carries the plan (source all) and the
    bytes-accessed gauge."""
    from torchbeast_tpu_torch import polybeast, telemetry

    label = "polybeast deep+LSTM remat all" + (" native runtime" if native
                                               else "")
    xpid = "chip_smoke_remat" + ("_native" if native else "")
    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    argv = polybeast_argv(savedir, xpid) + ["--remat", "all",
                                            "--total_steps", str(4 * T * B)]
    if native:
        argv[argv.index("--no_native_runtime")] = "--native_runtime"
    ops.reset_launch_counts()
    stats = polybeast.train(polybeast.make_parser().parse_args(argv))
    torch.cuda.synchronize()
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    updates = stats["updates"]
    check(updates >= 4, f"{label}: {updates} updates")
    for name, per_update in (("vtrace_targets", 1), ("rmsprop_tail", 1),
                             ("pool_bwd", 3)):
        check(counts[name] >= per_update * updates,
              f"{label}: {counts[name]} {name} launches in {updates} "
              "updates")
    check(ops.pool_bwd.vector_launches == counts["pool_bwd"],
          f"{label}: not every pool_bwd launch took the 16-byte path")
    for key in ("total_loss", "grad_norm"):
        check(np.isfinite(stats[key]), f"{label}: {key} {stats[key]}")
    last = telemetry.read_jsonl(os.path.join(savedir, xpid,
                                             "telemetry.jsonl"))[-1]
    static = last.get("learner.remat_plan", {})
    gauge = last["gauges"].get("learner.hbm_bytes_per_update", 0)
    check(static.get("source") == "all" and gauge > 0,
          f"{label}: static {static}, gauge {gauge}")
    print(f"{label} 84x84x4 T={T} B={B}: {updates} updates; SPS "
          f"{stats['sps']:.1f}; median update interval "
          f"{stats['update_interval_ms_median']:.2f} ms; launches {counts};"
          f" plan {static['assignment']}; learner.hbm_bytes_per_update "
          f"{gauge:.0f}")
    return {label: (counts, bf16)}


def run_polybeast_stateless(ops, savedir, native):
    """5q: polybeast deep WITHOUT --use_lstm (no state table: the agent
    state rides each request), --replica_refresh_updates 1
    --max_policy_lag 20, 4 updates on the Python pool or the core: the
    replica thread serves requests through its own graphs, and every
    policy_lag stamped into a learner batch is within the budget."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import polybeast, telemetry

    label = "polybeast deep stateless replicas" + (" native runtime"
                                                   if native else "")
    xpid = "chip_smoke_stateless" + ("_native" if native else "")
    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    argv = polybeast_argv(savedir, xpid)
    argv.remove("--use_lstm")
    argv += ["--replica_refresh_updates", "1", "--max_policy_lag", "20",
             "--total_steps", str(4 * T * B)]
    if native:
        argv[argv.index("--no_native_runtime")] = "--native_runtime"
        argv.append("--native_server")
    lags = []
    instrument = learner_lib.instrument_update_step

    def recording(update, **kwargs):
        def wrapped(batch, state):
            lags.append(batch["policy_lag"].clone())
            return update(batch, state)

        return instrument(wrapped, **kwargs)

    reg = telemetry.get_registry()
    before = {n: reg.counter(n).value() for n in (
        "serving.replica_requests", "serving.central_requests")}
    ops.reset_launch_counts()
    learner_lib.instrument_update_step = recording
    try:
        stats = polybeast.train(polybeast.make_parser().parse_args(argv))
    finally:
        learner_lib.instrument_update_step = instrument
    torch.cuda.synchronize()
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    served = {n: reg.counter(n).value() - v for n, v in before.items()}
    check(stats["updates"] >= 4 and stats["health"] == "HEALTHY",
          f"{label}: {stats['updates']} updates, health {stats['health']}")
    check(served["serving.replica_requests"] > 0,
          f"{label}: the replica thread served no request ({served})")
    check(lags and all(lag.dtype == torch.int32 for lag in lags),
          f"{label}: no policy_lag stamped")
    worst = max(int(lag.max()) for lag in lags)
    check(worst <= 20, f"{label}: a policy_lag of {worst} above 20")
    last = telemetry.read_jsonl(os.path.join(savedir, xpid,
                                             "telemetry.jsonl"))[-1]
    check(last.get("acting_path", {}).get("agent_state") == "host",
          f"{label}: acting path {last.get('acting_path')}")
    for name, per_update in (("vtrace_targets", 1), ("rmsprop_tail", 1),
                             ("pool_bwd", 3)):
        check(counts[name] >= per_update * stats["updates"],
              f"{label}: {counts[name]} {name} launches")
    print(f"{label} 84x84x4 T={T} B={B}: {stats['updates']} updates; SPS "
          f"{stats['sps']:.1f}; replica requests "
          f"{int(served['serving.replica_requests'])}, central "
          f"{int(served['serving.central_requests'])}; policy_lag max "
          f"{worst} over {len(lags)} batches (budget 20); launches {counts}")
    return {label: (counts, bf16)}


# ----------------------------------------------------------------- anakin

# The device envs' pool inputs (H, W, C) in the deep trunk: Catch's 10x5x1
# frames and Memory's 4x1x1, at N = (T+1) * B of the reference's anakin
# defaults (T=16, B=64).
ANAKIN_T, ANAKIN_B = 16, 64
ANAKIN_STAGES = {"Catch": ((10, 5, 16), (5, 3, 32), (3, 2, 32)),
                 "Memory": ((4, 1, 16), (2, 1, 32), (1, 1, 32))}


def check_pool_anakin(ops, dev):
    """pool_bwd at the deep trunk's stages on the device envs' frames
    (anakin --model deep with TBT_POOL_PALLAS=1), exact against the plain
    version; the row times Catch's three stages."""
    from torchbeast_tpu_torch.ops import pool

    gen = torch.Generator(device=dev).manual_seed(0)
    n = (ANAKIN_T + 1) * ANAKIN_B
    err, tot, stages = pool_stages(pool, gen, dev, n, ANAKIN_STAGES["Catch"],
                                   torch.float32, " anakin Catch")
    e_mem, _, _ = pool_stages(pool, gen, dev, n, ANAKIN_STAGES["Memory"],
                              torch.float32, " anakin Memory")
    return {
        "name": "pool_bwd_anakin_catch", "wrapper": "pool_bwd",
        "bf16": False, "route": "cuda",
        "source": "torchbeast_tpu_torch/csrc/pool_bwd.cu",
        "replaces": "torchbeast_tpu/ops/pallas_pool.py:54",
        "max_abs_err": max(err, e_mem), "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes", "library_ms": tot["library_ms"],
        "stages": stages,
    }


# (label, flags): the reference's defaults (B=64, T=16) on Catch, the LR
# decay and the entropy anneal moving every iteration.
ANAKIN_GRAPHS = (
    ("anakin mlp Catch", ["--model", "mlp"]),
    ("anakin deep+LSTM Catch", ["--model", "deep", "--use_lstm"]),
)
ANAKIN_REPLAYS = 3


def check_anakin_graph(ops, dev, label, model_args):
    """ANAKIN_REPLAYS replays of the anakin iteration graph (graphs.
    CapturedIteration) against as many eager iterations of a twin from
    the same params, optimizer state, carry and generator state: TF32
    off and cuDNN deterministic, every stat, param, RMSprop nu, carry
    leaf and the generator's state must be bitwise equal. Prints the
    host's API calls and the port kernels of one replay, and the
    iteration's ms (median of 20 CUDA-event runs)."""
    from torchbeast_tpu_torch import anakin, nest
    from torchbeast_tpu_torch import learner as learner_lib

    argv = ["--env", "Catch", *model_args, "--total_steps",
            str(100 * ANAKIN_T * ANAKIN_B), "--entropy_cost_final", "1e-4"]
    env, model, opt, hp, gen, carry = anakin.setup(
        anakin.make_parser().parse_args(argv), dev)
    twin = copy.deepcopy(model)
    opt_e = learner_lib.make_optimizer(hp, list(twin.parameters()))
    gen_e = torch.Generator(device=dev)
    gen_e.set_state(gen.get_state())
    carry_e = nest.map(torch.clone, carry)
    eager = anakin.make_train_step(env, twin, opt_e, hp, gen_e)
    dispatch = anakin.make_iteration_dispatch(env, model, opt, hp, gen,
                                              carry)
    dispatch.capture()
    ops.reset_launch_counts()
    got = [dispatch() for _ in range(ANAKIN_REPLAYS)]
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    want = [eager(carry_e) for _ in range(ANAKIN_REPLAYS)]
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        for key in w:
            check(torch.equal(g[key], w[key].float()),
                  f"{label} iteration {i}: stat {key} {float(g[key])} vs "
                  f"{float(w[key])}")
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        check(torch.equal(p, q), f"{label}: param {name} differs")
    for a, b in zip(opt.state.nu, opt_e.state.nu):
        check(torch.equal(a, b), f"{label}: nu differs")
    for a, b in zip(nest.flatten(carry), nest.flatten(carry_e)):
        check(torch.equal(a, b), f"{label}: a carry leaf differs")
    check(torch.equal(gen.get_state(), gen_e.get_state()),
          f"{label}: the generators' states differ")
    check(opt.state.count == ANAKIN_REPLAYS
          and int(opt.device_count) == ANAKIN_REPLAYS,
          f"{label}: counts {opt.state.count} / {int(opt.device_count)}")
    per_replay = dispatch.launches_per_replay
    pools = 3 if "deep" in model_args else 0
    check(per_replay.get("pool_bwd", 0) == pools
          and counts["pool_bwd"] == pools * ANAKIN_REPLAYS,
          f"{label}: pool_bwd {per_replay} per replay, {counts['pool_bwd']} "
          f"in {ANAKIN_REPLAYS} replays")
    calls, kernels = profile_call(dispatch)
    ms = time_ms(dispatch)
    eager_ms = time_ms(lambda: eager(carry_e), reps=5)
    frames = ANAKIN_T * ANAKIN_B
    print(f"graph {label} T={ANAKIN_T} B={ANAKIN_B}: {ANAKIN_REPLAYS} "
          f"replays bitwise equal to eager iterations (stats, params, nu, "
          f"carry, generator); host API calls per replay "
          f"{sum(calls.values())} {calls}; port kernels per replay "
          f"{per_replay} (profiled {kernels}); iteration {ms:.3f} ms "
          f"({frames / ms * 1e3:.0f} frames/s), eager {eager_ms:.3f} ms")
    return {label: (counts, bf16)}


# Phase 5: learning runs on the card, the reference test's settings and
# thresholds (tests/test_anakin.py:72-206): (label, flags, mean episode
# return above (+1) or below (-1) the threshold).
ANAKIN_RUNS = (
    ("anakin Catch mlp",
     ["--env", "Catch", "--batch_size", "32", "--unroll_length", "9",
      "--learning_rate", "2e-3", "--entropy_cost", "0.01",
      "--total_steps", "200000", "--log_interval_updates", "5"], 1, 0.5),
    ("anakin Memory LSTM",
     ["--env", "Memory", "--use_lstm", "--batch_size", "64",
      "--unroll_length", "12", "--learning_rate", "1e-3", "--total_steps",
      "1000000", "--log_interval_updates", "100"], 1, 0.6),
    ("anakin Memory feed-forward",
     ["--env", "Memory", "--batch_size", "64", "--unroll_length", "12",
      "--learning_rate", "1e-3", "--total_steps", "1000000",
      "--log_interval_updates", "100"], -1, 0.5),
    ("anakin Memory transformer num_experts 4",
     ["--env", "Memory", "--model", "transformer", "--num_experts", "4",
      "--batch_size", "64", "--unroll_length", "12", "--learning_rate",
      "5e-4", "--entropy_cost", "0.02", "--total_steps", "600000",
      "--log_interval_updates", "100"], 1, 0.6),
)


def run_anakin(ops, savedir, label, argv, sign, threshold):
    """anakin.train through its own parser on the card: the return must
    clear the threshold (sign +1: above, -1: below); then the same xpid
    for one more log interval must resume from the checkpoint."""
    from torchbeast_tpu_torch import anakin

    xpid = "chip_smoke_" + re.sub(r"\W+", "_", label)
    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    parse = anakin.make_parser().parse_args
    base = argv + ["--savedir", savedir, "--xpid", xpid,
                   "--checkpoint_interval_s", "100000"]
    flags = parse(base)
    ops.reset_launch_counts()
    t0 = time.time()
    stats = anakin.train(flags)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    ret = stats.get("mean_episode_return", float("nan"))
    check(stats["step"] >= flags.total_steps,
          f"{label}: stopped at step {stats['step']}")
    check(np.isfinite(stats["total_loss"]),
          f"{label}: total_loss {stats['total_loss']}")
    check(sign * (ret - threshold) > 0,
          f"{label}: mean episode return {ret} is not "
          f"{'above' if sign > 0 else 'below'} {threshold}")
    print(f"{label}: {stats['step']} steps in {wall:.1f} s, SPS "
          f"{stats['sps']:.0f}; mean episode return {ret:.3f} "
          f"({'>' if sign > 0 else '<'} {threshold}); aux_loss "
          f"{stats['aux_loss']:.4g}; launches {counts}")
    more = flags.unroll_length * flags.batch_size * flags.log_interval_updates
    lines = _Lines()
    logging.getLogger("torchbeast_tpu_torch").addHandler(lines)
    logging.getLogger("torchbeast_tpu_torch").setLevel(logging.INFO)
    try:
        # The last --total_steps on a command line wins.
        again = anakin.train(parse(base + [
            "--total_steps", str(stats["step"] + more)]))
    finally:
        logging.getLogger("torchbeast_tpu_torch").removeHandler(lines)
    resumed = f"Resuming preempted job at step {stats['step']}"
    check(resumed in lines.lines and again["step"] == stats["step"] + more,
          f"{label}: the resume logged {lines.lines[:3]} and reached step "
          f"{again['step']}")
    print(f"{label}: resumed at step {stats['step']} and ran to "
          f"{again['step']}, return {again.get('mean_episode_return')}")
    return {label: (counts, bf16)}


# MoE monobeast: the full-width transformer with 8 experts and every kernel
# switch, f32 and bf16_train (run_main_path's paths).
MOE_ARGS = TRANSFORMER_ARGS + ["--num_experts", "8"]
MOE_PATHS = (
    ("transformer num_experts 8", MOE_ARGS, TRANSFORMER_KERNELS, "f32", 3),
    ("transformer num_experts 8 bf16_train", MOE_ARGS, TRANSFORMER_KERNELS,
     "bf16_train", 3),
)


def run_anakin_phases(ops, dev, savedir, tf32):
    """--anakin-only: this slice's phases alone, after the builds: the
    pool kernel at the device envs' shapes (returned as a kernel row),
    the anakin iteration graphs (phase 4), the learning runs, the MoE
    monobeast and polybeast paths (phase 5) and the MoE update parity
    (phase 6). Returns (the kernel row, the paths' launch counts)."""
    row = check_pool_anakin(ops, dev)
    # The graph checks' settings, whatever an earlier phase left.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    by_path = {}
    for label, model_args in ANAKIN_GRAPHS:
        by_path.update(check_anakin_graph(ops, dev, label, model_args))
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    for run in ANAKIN_RUNS:
        by_path.update(run_anakin(ops, savedir, *run))
    for path in MOE_PATHS:
        by_path[path[0]] = run_main_path(ops, savedir, path)
    by_path.update(run_polybeast_core(
        ops, savedir, "polybeast transformer num_experts 4 native runtime",
        ["--model", "transformer"], ["--num_experts", "4"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    for policy in ("f32", "bf16_train"):
        model, _ = _param_tree(dev, "transformer", policy, num_experts=8)
        check_update_parity(ops, dev, "transformer num_experts 8", model,
                            random_cache(model, 0, dev), policy)
    return row, by_path


def run_remat_phases(ops, dev, savedir, tf32):
    """This slice's phases: 4r (TF32 off, cuDNN deterministic), the
    training-settings timing and peaks of default against all, then 5p
    (the auto budget what is allocated when it starts plus the midpoint
    of those two footprints of the deep f32 model, measured at the
    settings the run trains at) and 5q. Returns
    the launch counts of the 5p and 5q runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    results = run_remat_graphs(ops, dev)
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    peaks = time_remat_training(dev)
    by_path = run_remat_auto(ops, savedir, _free_card()
                             + (peaks["default"] + peaks["all"]) / 2)
    for native in (False, True):
        by_path.update(run_polybeast_remat(ops, savedir, native))
    for native in (False, True):
        by_path.update(run_polybeast_stateless(ops, savedir, native))
    return by_path


def run_impact_phases(ops, dev, savedir, tf32):
    """--impact-only: this slice's phases alone, after the builds: the
    IMPACT update graphs and the target forward's graph (phase 4), paths
    (m), (n) and (o) (phase 5), and the IMPACT update parity (phase 6)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for k in (1, 4):
        check_graph_update(dev, "deep+LSTM", "deep", "f32", k, impact=True)
        torch.cuda.empty_cache()
    check_graph_target(dev)
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    for path in PATHS[-2:]:
        run_main_path(ops, savedir, path)
    time_impact_update(dev)
    for native in (False, True):
        run_polybeast_impact(ops, savedir, native)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    for policy in ("f32", "bf16_train"):
        model, _ = _param_tree(dev, "deep", policy)
        check_update_parity(ops, dev, "deep+LSTM", model,
                            model.initial_state(B, dev), policy, impact=True)


# ------------------------------------------------------------- pipelined

# Phase 8: the pipelined families at full width, their towers run
# sequentially (pipelined_transformer: 4 layers, d 128, 4 heads, memory
# 64; pipelined_mlp + LSTM: 4 stages of d 128). Their updates launch
# V-trace and the tail, once each; the transformer's dense attention
# reaches no kernel.
PIPELINED_KERNELS = ("vtrace_targets", "rmsprop_tail")
PER_UPDATE = {"vtrace_targets": 1, "rmsprop_tail": 1}
PP_TRANSFORMER_ARGS = ["--model", "pipelined_transformer"]
PP_MLP_ARGS = ["--model", "pipelined_mlp", "--use_lstm"]
# (label, model, precision policy) of the graph and parity checks, and
# the monobeast paths of the same three (labelled with their policy).
PIPELINED_MODELS = (
    ("pipelined_transformer", "pipelined_transformer", "f32"),
    ("pipelined_transformer", "pipelined_transformer", "bf16_train"),
    ("pipelined_mlp+LSTM", "pipelined_mlp", "f32"),
)


def _with_policy(label, policy):
    return label if policy == "f32" else f"{label} {policy}"


PIPELINED_PATHS = tuple(
    (_with_policy(label, policy),
     PP_TRANSFORMER_ARGS if "transformer" in name else PP_MLP_ARGS,
     PIPELINED_KERNELS, policy, 3)
    for label, name, policy in PIPELINED_MODELS)
# A model's logits with the attention kernel against the dense body (f32,
# TF32 off): PERF.md section 2.
DENSE_VS_KERNEL = dict(rtol=1e-4, atol=1e-5)


def run_polybeast_core(ops, savedir, label, model_args, extra=()):
    """polybeast on the C++ core (--native_runtime), 16 Mock env servers,
    T=80, B=32, V-trace and the tail on, `model_args` and `extra` in
    place of deep + LSTM: three updates, each launching both, finite
    losses (with --num_experts, a non-zero aux_loss), HEALTHY. Prints SPS
    and the median update interval; returns the launch counts."""
    from torchbeast_tpu_torch import polybeast

    xpid = "chip_smoke_" + re.sub(r"\W+", "_", label)
    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    argv = polybeast_argv(savedir, xpid)
    at = argv.index("--model")
    del argv[at:at + 2]
    argv.remove("--use_lstm")
    argv[argv.index("--no_native_runtime")] = "--native_runtime"
    ops.reset_launch_counts()
    t0 = time.time()
    stats = polybeast.train(polybeast.make_parser().parse_args(
        argv + list(model_args) + list(extra)
        + ["--total_steps", str(3 * T * B)]))
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    updates = stats["updates"]
    check(updates >= 3, f"{label}: {updates} updates")
    for name in ("vtrace_targets", "rmsprop_tail"):
        check(counts[name] >= updates, f"{label}: {counts[name]} {name} "
                                       f"launches in {updates} updates")
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm"):
        check(np.isfinite(stats[key]), f"{label} loss stat {key}")
    if "--num_experts" in extra:
        check(stats["aux_loss"] > 0, f"{label}: aux_loss {stats['aux_loss']}")
    check(stats["health"] == "HEALTHY" and stats["runtime"] == "native",
          f"{label}: health {stats['health']}, runtime {stats['runtime']}")
    print(f"{label} 84x84x4 T={T} B={B}: {updates} updates in {wall:.1f} s; "
          f"SPS {stats['sps']:.1f}; median update interval "
          f"{stats['update_interval_ms_median']:.2f} ms; aux_loss "
          f"{stats['aux_loss']:.4g}; launches {counts}")
    return {label: (counts, bf16)}


def run_converted_resume(ops, dev, savedir):
    """The converter on the card: monobeast --model pipelined_transformer
    --pipeline_stages 2 trains 3 updates (a main path: V-trace and the
    tail launched) and checkpoints; utils/convert.py turns the file to
    the sequential layout; that checkpoint drives --model transformer
    --attention_impl pallas to the pipelined model's logits on one batch
    (TF32 off, within DENSE_VS_KERNEL), through the attention kernel;
    then monobeast resumes from it as the transformer for one more
    update. Returns the two runs' launch counts."""
    from torchbeast_tpu_torch import monobeast
    from torchbeast_tpu_torch.models import create_model
    from torchbeast_tpu_torch.utils.checkpoint import load_params
    from torchbeast_tpu_torch.utils.convert import convert_checkpoint

    label = "pipelined_transformer pipeline_stages 2"
    by_path = {label: run_main_path(ops, savedir, (
        label, PP_TRANSFORMER_ARGS + ["--pipeline_stages", "2"],
        PIPELINED_KERNELS, "f32", 3))}
    source = os.path.join(savedir,
                          "chip_smoke_" + re.sub(r"\W+", "_", label),
                          "model.ckpt")
    xpid = "chip_smoke_converted_transformer"
    target = os.path.join(savedir, xpid, "model.ckpt")
    shutil.rmtree(os.path.dirname(target), ignore_errors=True)
    t0 = time.time()
    convert_checkpoint(source, target, "sequential")
    convert_s = time.time() - t0

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipelined = create_model("pipelined_transformer", NUM_ACTIONS,
                             num_layers=2).to(dev)
    sequential = create_model("transformer", NUM_ACTIONS,
                              attention_impl="pallas").to(dev)
    load_params(source, pipelined)
    load_params(target, sequential)
    batch, state = random_batch(0, dev), random_cache(pipelined, 0, dev)
    inputs = {k: batch[k] for k in ("frame", "reward", "done",
                                    "last_action")}
    ops.reset_launch_counts()
    with torch.no_grad():
        want, _ = pipelined(inputs, state, sample_action=False)
        attention_before = ops.launch_counts()["transformer_attention"]
        got, _ = sequential(inputs, state, sample_action=False)
    torch.cuda.synchronize()
    launched = (ops.launch_counts()["transformer_attention"]
                - attention_before)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    err, ok = close(got.policy_logits, want.policy_logits,
                    DENSE_VS_KERNEL["rtol"], DENSE_VS_KERNEL["atol"])
    check(attention_before == 0 and launched == 2,
          f"converted: attention launches {attention_before} on the "
          f"pipelined forward, {launched} on the converted one")
    check(ok and torch.equal(got.action, want.action),
          f"converted checkpoint: logits max |err| {err} against the "
          "pipelined model's")
    print(f"converted checkpoint (convert {convert_s:.2f} s): the "
          f"transformer with --attention_impl pallas ({launched} attention "
          f"launches) gives the pipelined model's logits on one T={T + 1}, "
          f"B={B} batch, max |err| {err:.3g} (rtol "
          f"{DENSE_VS_KERNEL['rtol']}, atol {DENSE_VS_KERNEL['atol']}), "
          "argmax actions equal")

    lines = _Lines()
    logging.getLogger("torchbeast_tpu_torch").addHandler(lines)
    logging.getLogger("torchbeast_tpu_torch").setLevel(logging.INFO)
    ops.reset_launch_counts()
    try:
        stats = monobeast.train(monobeast.make_parser().parse_args([
            "--env", "Mock", "--num_actors", str(B), *TRANSFORMER_ARGS,
            "--batch_size", str(B), "--unroll_length", str(T),
            "--vtrace_impl", "pallas", "--opt_impl", "pallas",
            "--serial_envs", "--total_steps", str(4 * T * B), "--savedir",
            savedir, "--xpid", xpid]))
    finally:
        logging.getLogger("torchbeast_tpu_torch").removeHandler(lines)
    torch.cuda.synchronize()
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    check(any(line.startswith("Resuming preempted job") for line in
              lines.lines) and stats["step"] == 4 * T * B,
          f"converted: the resume reached step {stats['step']}")
    for name in TRANSFORMER_KERNELS:
        check(counts[name] >= 1, f"converted resume: {name} launched "
                                 f"{counts[name]} times")
    check(np.isfinite(stats["total_loss"]),
          f"converted resume: total_loss {stats['total_loss']}")
    print(f"converted checkpoint resumed as --model transformer "
          f"--attention_impl pallas from step {3 * T * B} to {stats['step']}; "
          f"launches {counts}")
    by_path["converted transformer resume"] = (counts, bf16)
    return by_path


def run_pipelined_phases(ops, dev, savedir, tf32):
    """Phase 8 (--pipelined-only alone after the builds): the tail on the
    pipelined trees as kernel rows; TF32 off and cuDNN deterministic, the
    update graph against its eager twin and the kernels against their
    plain versions for each of PIPELINED_MODELS, --remat all against the
    default on the pipelined transformer, and the anakin pipelined_mlp
    iteration graph; then at the training settings the monobeast paths,
    polybeast pipelined_transformer on the core, and the converted
    checkpoint. Returns (the kernel rows, the paths' launch counts)."""
    t0 = time.time()
    rows = [check_opt(ops, dev, "pipelined_transformer"),
            check_opt(ops, dev, "pipelined_transformer", "bf16_train"),
            check_opt(ops, dev, "pipelined_mlp")]
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    by_path = {}
    for label, name, policy in PIPELINED_MODELS:
        ms = check_graph_update(dev, _with_policy(label, policy), name,
                                policy, 1, per_update=PER_UPDATE)
        print(f"graph update {_with_policy(label, policy)}: {ms:.3f} ms a "
              "dispatch (median of 20, TF32 off)")
        model, _ = _param_tree(dev, name, policy)
        check_update_parity(ops, dev, label, model,
                            _agent_state(model, name, dev), policy)
        del model
        torch.cuda.empty_cache()
    run_remat_graphs(ops, dev, {("pipelined_transformer", "f32"): (
        ("default", None), ("all", "all"))})
    by_path.update(check_anakin_graph(ops, dev, "anakin pipelined_mlp Catch",
                                      ["--model", "pipelined_mlp"]))
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    for path in PIPELINED_PATHS:
        by_path[path[0]] = run_main_path(ops, savedir, path)
    by_path.update(run_polybeast_core(
        ops, savedir, "polybeast pipelined_transformer native runtime",
        PP_TRANSFORMER_ARGS))
    by_path.update(run_converted_resume(ops, dev, savedir))
    print(f"phase 8 (pipelined families): {time.time() - t0:.1f} s")
    return rows, by_path


# ------------------------------------------------------------------ phase 9

DP_SHARDS = 2
# Two shards against the whole batch: the reference's own tolerance for
# its DP test (tests/test_parallel.py:89-99), whose sums also run in
# another order. At RMSprop's eps 0.01 the first steps divide each
# gradient by about 0.1 |g| + eps, which turns the order's 1e-7-relative
# gradient differences into percent-sized step differences of a
# cancelling leaf (the deep trunk's fc weight: 6.2e-5 after 2 updates),
# so the DP paths' learner takes eps 1.0, as tests/test_torch_learner.py
# does: the comparison sees the update, not that conditioning.
DP_PARAMS_RTOL, DP_PARAMS_ATOL, DP_LOSS_RTOL = 2e-3, 2e-5, 2e-4
DP_EPS = 1.0
DP_UPDATES = 2


def _dp_hp():
    """The DP paths' learner: V-trace's kernel, the --opt_impl xla chain
    (the sharded learner refuses the fused tail, as the reference does),
    the LR decay and the entropy anneal moving every update."""
    from torchbeast_tpu_torch import learner as learner_lib

    return learner_lib.HParams(unroll_length=T, batch_size=B,
                               vtrace_impl="pallas", opt_impl="xla",
                               total_steps=20 * T * B,
                               entropy_cost_final=1e-4, rmsprop_eps=DP_EPS)


def run_dp_visible(ops, savedir):
    """(a) The visible-device check: monobeast.train through its parser
    with --num_learner_devices 2 raises the reference's "visible"
    ValueError on one card; with two or more it trains 3 updates (the
    launch checks of 5, V-trace twice and pool_bwd six times an update)."""
    from torchbeast_tpu_torch import monobeast

    n = torch.cuda.device_count()
    print(f"phase 9 (a): {n} CUDA device(s) visible")
    xpid = "chip_smoke_dp_visible"
    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    flags = monobeast.make_parser().parse_args([
        "--env", "Mock", "--num_actors", str(B), *DEEP_ARGS,
        "--batch_size", str(B), "--unroll_length", str(T),
        "--vtrace_impl", "pallas", "--serial_envs",
        "--num_learner_devices", "2", "--total_steps", str(3 * T * B),
        "--savedir", savedir, "--xpid", xpid])
    if n < 2:
        try:
            monobeast.train(flags)
        except ValueError as e:
            check("only 1 devices are visible" in str(e),
                  f"(a): the one-card run raised {e!r}")
            print(f"phase 9 (a): monobeast --num_learner_devices 2 on one "
                  f"card raised the reference's ValueError: {e}")
            return {}
        raise SmokeFailure("(a): --num_learner_devices 2 trained on one card")
    ops.reset_launch_counts()
    stats = monobeast.train(flags)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(stats["updates"] == 3 and np.isfinite(stats["total_loss"]),
          f"(a): {stats['updates']} updates, loss {stats['total_loss']}")
    # At least: the counts include the graphs' warm-up updates.
    check(counts["vtrace_targets"] >= 6 and counts["pool_bwd"] >= 18
          and counts["rmsprop_tail"] == 0, f"(a): launches {counts}")
    print(f"phase 9 (a): monobeast on 2 cards, 3 updates; launches {counts}")
    return {"monobeast deep+LSTM num_learner_devices 2":
            (counts, ops.bf16_launch_counts())}


def _dp_twins(dev, name, devices, k=1, capture=None):
    """A DP dispatch over `devices` (parallel.make_parallel_update_step)
    of the full-width model `name` from seed 0's weights."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import parallel

    model, _ = _param_tree(dev, name)
    hp = _dp_hp()
    opt = learner_lib.make_optimizer(hp, list(model.parameters()))
    mesh = parallel.create_mesh(devices=devices)
    dispatch = parallel.make_parallel_update_step(
        model, opt, hp, mesh, superstep_k=k, capture=capture)
    return model, opt, dispatch


def _dp_run(dispatch, batches, state, k=1):
    """The dispatches of `batches` (K at a time), stats stacked [U]."""
    from torchbeast_tpu_torch import nest

    out = []
    for d in range(len(batches) // k):
        group = batches[d * k:(d + 1) * k]
        if k == 1:
            out.append(dispatch(group[0], state))
        else:
            out.append(dispatch(
                {key: torch.stack([b[key] for b in group])
                 for key in group[0]},
                nest.map(lambda s: torch.stack([s] * k), state)))
    torch.cuda.synchronize()
    return {key: torch.cat([o[key].reshape(-1) for o in out])
            for key in out[0]}


def _bitwise(m1, m2):
    """Whether model m1's params equal m2's (a model or a tensor list)."""
    other = m2 if isinstance(m2, list) else list(m2.parameters())
    return all(torch.equal(a, b) for a, b in zip(m1.parameters(), other))


def check_dp_path(ops, dev, label, name, expected, tf32_label, tf32):
    """(b), (e): DP_SHARDS shards of B // DP_SHARDS rows, both on `dev`
    (one card: the explicit device list), against the one-device update
    on all B rows, DP_UPDATES updates of the same batches from the same
    weights: params within DP_PARAMS_RTOL / DP_PARAMS_ATOL (the largest
    relative difference printed), total_loss within DP_LOSS_RTOL, every
    replica bitwise equal to the lead, the kernels launched `expected`
    times an update (the tail never), and the DP graphs bitwise equal to
    their eager twin. Prints both updates' ms and one DP dispatch's host
    API calls. Returns (its launch counts, the DP run's params after its
    updates and its stats, the inputs) for (c) and (d)."""
    from torchbeast_tpu_torch import learner as learner_lib

    devices = [dev] * DP_SHARDS
    batches = [random_batch(i, dev) for i in range(DP_UPDATES)]
    model, opt, dispatch = _dp_twins(dev, name, devices)
    state = _agent_state(model, name, dev)
    # The capture's warm-up runs launch kernels too: count the replays.
    dispatch.capture(batches[0], state)
    ops.reset_launch_counts()
    got = _dp_run(dispatch, batches, state)
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    after = [p.detach().clone() for p in model.parameters()]
    for w, n in expected.items():
        check(counts[w] == n * DP_UPDATES,
              f"{label}: {counts[w]} {w} launches in {DP_UPDATES} updates, "
              f"not {n} an update")
    check(counts["rmsprop_tail"] == 0, f"{label}: the tail launched")
    learner = dispatch.learner
    for params in learner.params[1:]:
        check(all(torch.equal(p, q) for p, q in zip(params,
                                                    learner.params[0])),
              f"{label}: a replica differs from the lead")
    check(opt.state.count == DP_UPDATES
          and all(int(c) == DP_UPDATES for c in learner.counts),
          f"{label}: counts {opt.state.count}, "
          f"{[int(c) for c in learner.counts]}")
    eager_model, _, eager = _dp_twins(dev, name, devices, capture=False)
    want_eager = _dp_run(eager, batches, state)
    check(_bitwise(model, eager_model)
          and all(torch.equal(got[k], want_eager[k].float()) for k in got),
          f"{label}: the DP graphs differ from their eager twin")
    one, _ = _param_tree(dev, name)
    opt1 = learner_lib.make_optimizer(_dp_hp(), list(one.parameters()))
    one_dispatch = learner_lib.make_update_dispatch(one, opt1, _dp_hp())
    want = _dp_run(one_dispatch, batches, state)
    worst = 0.0
    for (pname, p), q in zip(model.named_parameters(), one.parameters()):
        p, q = p.detach(), q.detach()
        err, ok = close(p, q, DP_PARAMS_RTOL, DP_PARAMS_ATOL)
        check(ok, f"{label}: param {pname} max |diff| {err:.3g} beyond "
                  f"rtol {DP_PARAMS_RTOL} / atol {DP_PARAMS_ATOL}")
        worst = max(worst, float(((p - q).abs().max()
                                  / q.abs().max().clamp_min(1e-30))))
    loss_err, ok = close(got["total_loss"], want["total_loss"],
                         DP_LOSS_RTOL, 0.0)
    check(ok, f"{label}: total_loss {got['total_loss'].tolist()} vs "
              f"{want['total_loss'].tolist()}")
    calls, _ = profile_call(lambda: dispatch(batches[0], state))
    one_calls, _ = profile_call(lambda: one_dispatch(batches[0], state))
    dp_ms = time_ms(lambda: dispatch(batches[0], state), reps=10)
    one_ms = time_ms(lambda: one_dispatch(batches[0], state), reps=10)
    # Again at the training settings (TF32 as the run found it, cuDNN
    # free to pick its algorithms), each dispatch captured anew under
    # them (a graph keeps the kernels its capture chose), interleaved.
    checks = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    torch.backends.cudnn.deterministic = False
    try:
        train_dp = _dp_twins(dev, name, devices)[2]
        train_one, _ = _param_tree(dev, name)
        train_one = learner_lib.make_update_dispatch(
            train_one, learner_lib.make_optimizer(
                _dp_hp(), list(train_one.parameters())), _dp_hp())
        train_ms = [time_ms(fn, reps=10) for fn in (
            lambda: train_dp(batches[0], state),
            lambda: train_one(batches[0], state),
            lambda: train_dp(batches[0], state))]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = checks
    print(f"phase 9 {label} T={T} B={B} ({tf32_label}): {DP_SHARDS} shards "
          f"of {B // DP_SHARDS} rows on {dev} against one device on {B}, "
          f"{DP_UPDATES} updates, RMSprop eps {DP_EPS}: params within "
          f"rtol {DP_PARAMS_RTOL} / "
          f"atol {DP_PARAMS_ATOL} (largest difference {worst:.3g} of a "
          f"leaf's largest entry), total_loss within rtol {DP_LOSS_RTOL} "
          f"(max |diff| {loss_err:.3g}); replicas bitwise equal; graphs "
          f"bitwise equal to their eager twin; launches an update "
          f"{ {w: counts[w] // DP_UPDATES for w in counts} }; update "
          f"{dp_ms:.3f} ms with {DP_SHARDS} shards, {one_ms:.3f} ms with "
          f"one (both on one card: the overhead, no speed-up), at the "
          f"training settings {train_ms[0]:.3f} / {train_ms[2]:.3f} ms "
          f"with {DP_SHARDS} shards, {train_ms[1]:.3f} ms with one; host API "
          f"calls a DP dispatch {sum(calls.values())} {calls}, one-device "
          f"{sum(one_calls.values())}")
    return (counts, bf16), after, got, (batches, state)


def check_dp_nccl(dev, name, want_params, want_stats, inputs):
    """(c) (b)'s DP run again inside a torch.distributed NCCL group of
    world size 1 (the lead's reduce and update one CUDA graph with the
    all-reduce captured in it): bitwise equal to (b)."""
    import socket

    from torchbeast_tpu_torch import parallel

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    parallel.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                    backend="nccl")
    try:
        model, _, dispatch = _dp_twins(dev, name, [dev] * DP_SHARDS)
        check(dispatch.learner.group is not None, "(c): no group")
        got = _dp_run(dispatch, *inputs)
        check(dispatch._step._apply_graph is not None,
              "(c): the NCCL reduce was not captured")
        check(_bitwise(model, want_params)
              and all(torch.equal(got[k], want_stats[k]) for k in got),
              "(c): the NCCL group's DP run differs from (b)'s")
    finally:
        torch.distributed.destroy_process_group()
    print(f"phase 9 (c): {name} DP in an NCCL group of world size 1 "
          f"(all-reduce captured in the lead's graph): bitwise equal to (b)")


def check_dp_superstep(dev, name, want_params, want_stats, inputs):
    """(d) One K=2 DP dispatch bitwise equal to (b)'s two K=1 dispatches."""
    model, _, dispatch = _dp_twins(dev, name, [dev] * DP_SHARDS, k=2)
    batches, state = inputs
    got = _dp_run(dispatch, batches, state, k=2)
    check(_bitwise(model, want_params)
          and all(torch.equal(got[k], want_stats[k]) for k in got),
          "(d): the K=2 DP dispatch differs from two K=1 dispatches")
    print(f"phase 9 (d): {name} one K=2 DP dispatch bitwise equal to two "
          f"K=1 dispatches")


def check_dp_anakin(ops, dev, label, model_args):
    """(f) An anakin iteration on Catch at phase 7's shape with two shards
    on the card (the one-device run's initial carry split, shard 1
    drawing from --seed + 1): its graphs (one a shard: its rollout,
    forward and backward; one on the lead: the sum and the update)
    bitwise equal to their eager twin over ANAKIN_REPLAYS iterations
    (stats, params, carries), pool_bwd 3 a shard an iteration; and its
    first iteration's params and total_loss against learner.update_body
    on all B rows of what the two shards collected, from the agent
    state that entered the unroll, at (b)'s tolerances."""
    from torchbeast_tpu_torch import anakin, nest, parallel
    from torchbeast_tpu_torch import learner as learner_lib

    flags = anakin.make_parser().parse_args([
        "--env", "Catch", *model_args, "--total_steps",
        str(100 * ANAKIN_T * ANAKIN_B), "--entropy_cost_final", "1e-4",
        "--epsilon", str(DP_EPS)])
    runs = {}
    for capture in (True, False):
        env, model, opt, hp, gen, carry = anakin.setup(flags, dev)
        start = copy.deepcopy(model)
        state0 = nest.map(torch.clone, carry.agent_state)
        learner = parallel.ParallelLearner(
            model, opt, hp, parallel.create_mesh(devices=[dev, dev]))
        gen1 = torch.Generator(device=dev)
        gen1.manual_seed(flags.seed + 1)
        carries = anakin.split_carry(carry, [dev, dev])
        step = anakin.make_parallel_iteration(env, learner, hp, [gen, gen1],
                                              carries, capture=capture)
        if capture:
            step.capture()
        ops.reset_launch_counts()
        first = step()
        batch = {k: torch.cat([c.buffers[k] for c in step.collects], 1)
                 for k in step.collects[0].buffers}
        after1 = [p.detach().clone() for p in model.parameters()]
        stats = [first] + [step() for _ in range(ANAKIN_REPLAYS - 1)]
        torch.cuda.synchronize()
        runs[capture] = dict(
            model=model, stats=stats, carries=carries, step=step,
            counts=(ops.launch_counts(), ops.bf16_launch_counts()),
            start=start, state0=state0, batch=batch, after1=after1, hp=hp)
    g, e = runs[True], runs[False]
    check(_bitwise(g["model"], e["model"]),
          f"{label}: params differ from the eager twin's")
    for i, (a, b) in enumerate(zip(g["stats"], e["stats"])):
        for key in a:
            check(torch.equal(a[key], b[key]),
                  f"{label} iteration {i}: stat {key} differs from eager")
    check(all(torch.equal(a, b) for a, b in zip(
        nest.flatten(g["carries"]), nest.flatten(e["carries"]))),
        f"{label}: the carries differ from the eager twin's")
    counts = g["counts"][0]
    pools = 3 * DP_SHARDS if "deep" in model_args else 0
    check(counts["pool_bwd"] == pools * ANAKIN_REPLAYS,
          f"{label}: {counts['pool_bwd']} pool_bwd launches in "
          f"{ANAKIN_REPLAYS} iterations")
    opt1 = learner_lib.make_optimizer(g["hp"], list(g["start"].parameters()))
    want = learner_lib.update_body(g["start"], opt1, g["hp"])(
        g["batch"], g["state0"])
    worst = 0.0
    for (pname, q), p in zip(g["start"].named_parameters(), g["after1"]):
        q = q.detach()
        err, ok = close(p, q, DP_PARAMS_RTOL, DP_PARAMS_ATOL)
        check(ok, f"{label}: param {pname} max |diff| {err:.3g} against "
                  "the one-device update of the collected batch")
        worst = max(worst, float(((p - q).abs().max()
                                  / q.abs().max().clamp_min(1e-30))))
    loss_err, ok = close(g["stats"][0]["total_loss"],
                         want["total_loss"].float(), DP_LOSS_RTOL, 0.0)
    check(ok, f"{label}: total_loss {float(g['stats'][0]['total_loss'])} "
              f"vs {float(want['total_loss'])}")
    calls, _ = profile_call(g["step"])
    ms = time_ms(g["step"], reps=5)
    print(f"phase 9 (f) {label} T={ANAKIN_T} B={ANAKIN_B}: {DP_SHARDS} "
          f"shards on {dev}; graphs bitwise equal to their eager twin over "
          f"{ANAKIN_REPLAYS} iterations (stats, params, carries); pool_bwd "
          f"{pools} an iteration; the first iteration against the "
          f"one-device update of its {ANAKIN_B} collected columns: params "
          f"within rtol {DP_PARAMS_RTOL} / atol {DP_PARAMS_ATOL} (largest "
          f"difference {worst:.3g} of a leaf's largest entry), total_loss "
          f"within rtol {DP_LOSS_RTOL} (max |diff| {loss_err:.3g}); "
          f"iteration {ms:.3f} ms; host API calls an iteration "
          f"{sum(calls.values())} {calls}")
    return {f"{label} {DP_SHARDS} shards": g["counts"]}


def run_dp_phases(ops, dev, savedir, tf32):
    """Phase 9 (--dp-only alone after the builds): (a) the visible-device
    check, then TF32 off and cuDNN deterministic: (b) the deep + LSTM DP
    path, (c) its NCCL twin, (d) its K=2 dispatch, (e) the transformer's
    DP path, (f) anakin's DP iteration. Returns the paths' launch
    counts."""
    t0 = time.time()
    by_path = run_dp_visible(ops, savedir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    settings = "TF32 off, cuDNN deterministic"
    counts, model, stats, inputs = check_dp_path(
        ops, dev, "(b) deep+LSTM", "deep",
        {"vtrace_targets": DP_SHARDS, "pool_bwd": 3 * DP_SHARDS}, settings,
        tf32)
    by_path[f"dp deep+LSTM {DP_SHARDS} shards"] = counts
    check_dp_nccl(dev, "deep", model, stats, inputs)
    check_dp_superstep(dev, "deep", model, stats, inputs)
    del model, stats, inputs
    torch.cuda.empty_cache()
    counts, *_ = check_dp_path(
        ops, dev, "(e) transformer", "transformer",
        {"vtrace_targets": DP_SHARDS,
         "transformer_attention": 2 * DP_SHARDS,
         "transformer_attention_bwd": 2 * DP_SHARDS}, settings, tf32)
    by_path[f"dp transformer {DP_SHARDS} shards"] = counts
    torch.cuda.empty_cache()
    by_path.update(check_dp_anakin(ops, dev, "anakin deep+LSTM Catch",
                                   ["--model", "deep", "--use_lstm"]))
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    print(f"phase 9 (data parallel): {time.time() - t0:.1f} s")
    return by_path


# ----------------------------------------------------------------- phase 10

# (data, expert) layouts of the MoE update, and those the reference runs
# at bf16_train (its polybeast refuses bf16_train on a data x expert
# mesh: polybeast.py:1000-1011).
EP_LAYOUTS = ((2, 1), (4, 1), (1, 2), (2, 2))
EP_BF16_LAYOUTS = ((2, 1), (4, 1), (1, 2))
EP_EXPERTS = 8
EP_AUX_RTOL = 2e-4
# Dropped assignments against the one-device update, as a share of the
# assignments (the shards' routing itself is held exactly: see
# check_ep_path).
EP_DROPS_APART = 1e-3
EP_BF16_DROPS_APART = 1e-2  # bf16_train's updates after the first
# bf16_train's loss: the bf16 products of a shard and of the whole batch
# round differently, and the second update starts from params a bf16 ulp
# apart here and there (tests/test_torch_parallel.py's bf16_train DP
# tolerance for the stats).
EP_BF16_LOSS_RTOL = 2e-2
EP_KERNELS = {"vtrace_targets": 1, "transformer_attention": 2,
              "transformer_attention_bwd": 2}  # a data shard an update


def _ep_hp(policy):
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import precision

    pol = precision.get(policy)
    return learner_lib.HParams(
        unroll_length=T, batch_size=B, vtrace_impl="pallas", opt_impl="xla",
        total_steps=20 * T * B, entropy_cost_final=1e-4, rmsprop_eps=DP_EPS,
        param_dtype=pol.param_dtype, opt_state_dtype=pol.opt_state_dtype)


def _whole_batch_kept(probs, top_k, capacity):
    """The one-device rule (models/moe.py) on router probabilities
    [t, E]: the kept mask [t, K, E] of top-k picks, rank-major then token
    order, at most `capacity` an expert."""
    t, E = probs.shape
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :top_k]
    sel = F.one_hot(idx, E).float()
    flat = sel.transpose(0, 1).reshape(top_k * t, E)
    pos = (torch.cumsum(flat, 0) - flat).reshape(top_k, t, E).transpose(0, 1)
    return sel * (pos < capacity)


def _routing_exact(replicas):
    """Whether each MoE layer's kept masks, over the data shards in order,
    equal the one-device rule on the same router probabilities: the
    whole-batch routing of the shards' exchange, free of the shards' and
    the whole batch's own rounding of those probabilities."""
    from torchbeast_tpu_torch.models.moe import MoEFFN

    per_replica = [[m for m in r.modules() if isinstance(m, MoEFFN)]
                   for r in replicas]
    for layers in zip(*per_replica):
        probs = torch.cat([m.last_probs for m in layers])
        kept = torch.cat([m.last_kept for m in layers])
        want = _whole_batch_kept(probs, layers[0].top_k,
                                 layers[0].capacity(probs.shape[0]))
        if not torch.equal(kept, want):
            return False
    return True


def _ep_path(dev, policy, layout, inputs):
    """The MoE transformer's update on one device (layout None: one CUDA
    graph) or over a (data, expert) mesh of `dev` repeated, captured (or
    built) on the first batch, then DP_UPDATES updates counted: (the
    params after them and, at bf16_train, the optimizer's f32 masters,
    copies; the dispatch; stats stacked [U]; launch counts; each update's
    dropped assignments)."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import parallel
    from torchbeast_tpu_torch.models.moe import MoEFFN

    from torchbeast_tpu_torch import ops

    batches, state = inputs
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    model, _ = _param_tree(dev, "transformer", policy,
                           num_experts=EP_EXPERTS)
    hp = _ep_hp(policy)
    opt = learner_lib.make_optimizer(hp, list(model.parameters()))
    if layout is None:
        dispatch = learner_lib.make_update_dispatch(model, opt, hp)
        replicas = [model]
    else:
        data, expert, model_par = (tuple(layout) + (1,))[:3]
        mesh = parallel.create_mesh(
            devices=[dev] * (data * expert * model_par),
            expert_parallelism=expert, model_parallelism=model_par)
        dispatch = parallel.make_parallel_update_step(model, opt, hp, mesh)
        replicas = dispatch.learner.replicas
        torch.cuda.synchronize()
        # The allocator's bytes once the learner is built, before any
        # capture: every replica, its slots and the optimizer's state.
        dispatch.built_bytes = torch.cuda.memory_allocated(dev) - base
    layers = [m for r in replicas for m in r.modules()
              if isinstance(m, MoEFFN)]
    for m in layers:
        m.track_routing = True
    dispatch.capture(batches[0], state)
    ops.reset_launch_counts()
    out, dropped, exact = [], [], []
    for batch in batches:
        out.append(dispatch(batch, state))
        dropped.append(sum(int(m.last_dropped) for m in layers))
        exact.append(_routing_exact(replicas))
    stats = {k: torch.stack([o[k].float() for o in out]) for k in out[0]}
    counts = (ops.launch_counts(), ops.bf16_launch_counts())
    # The one-device trees of the (sharded) params and masters.
    after = {name: p.clone()
             for name, p in parallel.local_view(model).items()}
    master = (None if opt.state.master is None
              else [m.clone() for m in parallel.local_view(
                  model, opt.state.master).values()])
    check(all(exact), f"phase 10 {layout} {policy}: the shards' kept "
                      "assignments differ from the one-device rule on "
                      "their router probabilities")
    return (after, master), dispatch, stats, counts, dropped


def check_ep_path(ops, dev, policy, layout, want, inputs,
                  kernels=EP_KERNELS):
    """One layout of phase 10 against the one-device run `want` (an
    _ep_path result), each kernel launched as often as `kernels` says a
    data shard an update; a third entry of `layout` splits the blocks
    over that many model devices (phase 12 (b)). Returns (its launch
    counts and bf16 launch counts, the path's result, its update ms)."""
    label = (f"phase 10 data {layout[0]} x expert {layout[1]} {policy}"
             if len(layout) == 2 else
             f"phase 12 (b) data {layout[0]} x model {layout[2]} x expert "
             f"{layout[1]} {policy}")
    got = _ep_path(dev, policy, layout, inputs)
    (params, master), dispatch, stats, (counts, _), dropped = got
    (w_params, w_master), _, w_stats, _, w_dropped = want
    data = layout[0]
    for name, n in kernels.items():
        check(counts[name] == n * data * DP_UPDATES,
              f"{label}: {counts[name]} {name} launches in {DP_UPDATES} "
              f"updates, not {n} a data shard an update")
    check(counts["rmsprop_tail"] == 0, f"{label}: the tail launched")
    learner = dispatch.learner
    storage = check_slot_bytes(label, learner, dispatch.built_bytes)
    for replica in learner.params[1:]:
        check(all(torch.equal(p, q) for p, q in zip(replica,
                                                    learner.params[0])),
              f"{label}: a replica differs from the lead")
    if master is None:
        pairs = [(name, p, w_params[name]) for name, p in params.items()]
    else:
        pairs = [(name, m, w) for name, m, w in zip(params, master,
                                                    w_master)]
        for name, p in params.items():
            err, ok = close(p.float(), w_params[name].float(), BF16_ULP,
                            DP_PARAMS_ATOL)
            check(ok, f"{label}: bf16 param {name} max |diff| {err:.3g} "
                      "beyond one bf16 ulp")
    worst = 0.0
    for pname, p, q in pairs:
        p, q = p.float(), q.float()
        err, ok = close(p, q, DP_PARAMS_RTOL, DP_PARAMS_ATOL)
        check(ok, f"{label}: param {pname} max |diff| {err:.3g} beyond "
                  f"rtol {DP_PARAMS_RTOL} / atol {DP_PARAMS_ATOL}")
        worst = max(worst, float(((p - q).abs().max()
                                  / q.abs().max().clamp_min(1e-30))))
    # At bf16_train the router reads activations of bf16 products, which
    # a shard's fewer rows round otherwise: aux_loss, a mean of router
    # probabilities, within a bf16 ulp.
    aux_rtol = EP_AUX_RTOL if master is None else BF16_ULP
    aux_err, ok = close(stats["aux_loss"], w_stats["aux_loss"].float(),
                        aux_rtol, 0.0)
    check(ok and float(stats["aux_loss"][-1]) > 0,
          f"{label}: aux_loss {stats['aux_loss'].tolist()} vs "
          f"{w_stats['aux_loss'].tolist()}")
    loss_rtol = DP_LOSS_RTOL if master is None else EP_BF16_LOSS_RTOL
    loss_err, ok = close(stats["total_loss"], w_stats["total_loss"].float(),
                         loss_rtol, 0.0)
    check(ok, f"{label}: total_loss {stats['total_loss'].tolist()} vs "
              f"{w_stats['total_loss'].tolist()}")
    # The shards' routing is exact on their own router probabilities
    # (_ep_path). Against the one-device update's count, a token whose
    # top-k ties within the last bits of f32 may pick otherwise: a
    # shard's products over fewer rows round differently. A routing that
    # was not the whole batch's (a shard's own capacity) would part by
    # thousands.
    # At bf16_train the second update's routing also reads params a bf16
    # ulp apart here and there.
    assignments = 2 * 2 * T * B  # 2 layers, top-2
    bounds = [EP_DROPS_APART * assignments] + [
        (EP_DROPS_APART if master is None else EP_BF16_DROPS_APART)
        * assignments] * (len(dropped) - 1)
    apart = [abs(a - b) for a, b in zip(dropped, w_dropped)]
    check(all(a <= bound for a, bound in zip(apart, bounds)),
          f"{label}: {dropped} assignments dropped, one device {w_dropped}")
    batches, state = inputs
    ms = time_ms(lambda: dispatch(batches[0], state), reps=10)
    plain = ""
    if policy == "f32" and int(np.prod(layout[1:])) > 1:
        def build():
            from torchbeast_tpu_torch import learner as learner_lib
            from torchbeast_tpu_torch import parallel

            model, _ = _param_tree(dev, "transformer", policy,
                                   num_experts=EP_EXPERTS)
            hp = _ep_hp(policy)
            expert, model_par = (tuple(layout[1:]) + (1,))[:2]
            return (model, learner_lib.make_optimizer(
                hp, list(model.parameters())), hp,
                parallel.create_mesh(
                    devices=[dev] * int(np.prod(layout)),
                    expert_parallelism=expert,
                    model_parallelism=model_par))

        plain = "; " + check_sharded_plain(ops, label, build, inputs)
    print(f"{label}: {int(np.prod(layout))} shards on {dev}, {DP_UPDATES} "
          f"updates against one device: params within rtol "
          f"{DP_PARAMS_RTOL} / atol {DP_PARAMS_ATOL} (largest difference "
          f"{worst:.3g} of a leaf's largest entry{'' if policy == 'f32' else ', f32 masters; bf16 params within a bf16 ulp'}), "
          f"aux_loss within rtol {aux_rtol:.3g} (max |diff| {aux_err:.3g}), "
          f"total_loss within rtol {loss_rtol} (max |diff| "
          f"{loss_err:.3g}); kept assignments = the one-device rule on "
          f"the shards' router probabilities; dropped {dropped} (one "
          f"device {w_dropped}, {apart} apart); replicas "
          f"bitwise equal; launches an update "
          f"{ {k: counts[k] // DP_UPDATES for k in kernels} }; update "
          f"{ms:.3f} ms ({'eager, shards in lockstep' if data > 1 else 'one CUDA graph'}); "
          f"{storage}{plain}")
    return got[3], got, ms


def check_sharded_plain(ops, label, build, inputs) -> str:
    """One eager update of a sharded learner (`build()` -> (model,
    optimizer, hparams, mesh)) with every V-trace and attention call
    recorded; each held against its plain version on that call's own
    inputs, with phase 3's tolerances: V-trace bit for bit, the attention
    forward within rtol 1e-5 / atol 1e-6 and its backward (a fixed
    cotangent) within rtol 1e-4 / atol 1e-5. Returns the line's clause."""
    import types

    from torchbeast_tpu_torch import parallel
    from torchbeast_tpu_torch.models import transformer
    from torchbeast_tpu_torch.ops import losses, vtrace

    batches, state = inputs
    lock = threading.Lock()
    calls = {"vtrace": [], "attention": []}
    kernel_vtrace = vtrace.vtrace_targets
    kernel_attention = transformer.transformer_attention

    def detached(xs):
        return tuple(x.detach().clone() if torch.is_tensor(x) else x
                     for x in xs)

    def recorded_vtrace(*args):
        out = kernel_vtrace(*args)
        with lock:
            calls["vtrace"].append((detached(args), detached(out)))
        return out

    def recorded_attention(*args):
        with lock:
            calls["attention"].append(detached(args))
        return kernel_attention(*args)

    # The callers' names are swapped, not the wrappers' own (which count
    # their launches through their module's name).
    losses.vtrace_lib = types.SimpleNamespace(
        **{**vars(vtrace), "vtrace_targets": recorded_vtrace})
    transformer.transformer_attention = recorded_attention
    try:
        model, opt, hp, mesh = build()
        parallel.make_parallel_update_step(model, opt, hp, mesh,
                                           capture=False)(batches[0], state)
        torch.cuda.synchronize()
    finally:
        losses.vtrace_lib = vtrace
        transformer.transformer_attention = kernel_attention
    del model, opt
    check(calls["vtrace"], f"{label}: no V-trace call on the update")
    for args, out in calls["vtrace"]:
        with ops.plain_on_device():
            want = kernel_vtrace(*args)
        check(all(torch.equal(o, w) for o, w in zip(out, want)),
              f"{label}: V-trace on the sharded update differs from its "
              "plain version")
    err_f = err_b = 0.0
    gen = torch.Generator(device=batches[0]["reward"].device)
    for m, q, k, v, seg, valid, nodone, bias in calls["attention"]:
        gen.manual_seed(0)
        g = torch.randn(q.shape, generator=gen, device=q.device,
                        dtype=q.dtype)
        leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
        outs = []
        for plain in (False, True):
            with (ops.plain_on_device() if plain
                  else contextlib.nullcontext()):
                out = kernel_attention(m, leaves[0], leaves[1], leaves[2],
                                       seg, valid, nodone, leaves[3])
                outs.append((out.detach(),
                             torch.autograd.grad(out, leaves, g)))
        (ok_, gk), (op_, gp) = outs
        e, ok = close(ok_, op_, 1e-5, 1e-6)
        check(ok, f"{label}: attention forward on the sharded update, max "
                  f"|err| {e}")
        err_f = max(err_f, e)
        for a, b_ in zip(gk, gp):
            e, ok = close(a, b_, 1e-4, 1e-5)
            check(ok, f"{label}: attention backward on the sharded update, "
                      f"max |err| {e}")
            err_b = max(err_b, e)
    return (f"on one eager sharded update, each kernel call against its "
            f"plain version on its inputs: V-trace {len(calls['vtrace'])} "
            f"bit for bit, attention {len(calls['attention'])} (forward max "
            f"|err| {err_f:.3g}, rtol 1e-5 / atol 1e-6; backward "
            f"{err_b:.3g}, rtol 1e-4 / atol 1e-5)")


def check_slot_bytes(label, learner, built_bytes) -> str:
    """The learner's sharded storage against the merged EP and TP rules
    on its one-device tree (the reference's polybeast placement): each
    row's params and row 0's optimizer state (nu, the momentum trace,
    the f32 master) hold, at each place, the bytes the rule puts there
    (a split leaf's 1/K on each of its K slots, the replicated leaves on
    the row's device), and no split leaf stays whole. Returns a line
    with the bytes and the allocator's bytes after the build."""
    from torchbeast_tpu_torch.models import sharded
    from torchbeast_tpu_torch.parallel import ep, tp

    shape = learner.mesh.shape
    sizes = {"model": shape["model"], "expert": shape.get("expert", 1)}

    def rule(model, tensors):
        view = sharded.local_view(model, tensors)
        specs = dict(ep._flat(tp.merge_param_shardings(
            ep.expert_param_shardings(sizes["expert"], view),
            tp.transformer_tp_shardings(sizes["model"], view)), specs=True))
        want = {}
        for name, t in view.items():
            spec = specs[tuple(name.split("."))]
            nbytes = t.numel() * t.element_size()
            axis = next((a for a in sizes if a in spec), None)
            places = ([None] if axis is None else
                      [(axis, j) for j in range(sizes[axis])])
            for place in places:
                want[place] = want.get(place, 0) + nbytes // len(places)
        return want

    for i, replica in enumerate(learner.replicas):
        got, want = sharded.slot_bytes(replica), rule(replica, None)
        check(got == want, f"{label}: row {i}'s params by slot {got}, the "
                           f"rule's {want}")
        check(sharded.is_sharded(replica) == (len(got) > 1),
              f"{label}: row {i}'s storage")
    st = learner.optimizer.state
    model = learner.replicas[0]
    state = {}
    for key in ("nu", "mom", "master"):
        tensors = getattr(st, key)
        if tensors is None:
            continue
        got = sharded.slot_bytes(model, tensors)
        want = rule(model, tensors)
        check(got == want, f"{label}: row 0's {key} by slot {got}, the "
                           f"rule's {want}")
        for place, n in got.items():
            state[place] = state.get(place, 0) + n
    mib = 2.0 ** 20
    by_slot = {("row" if k is None else f"{k[0]} {k[1]}"): round(n / mib, 3)
               for k, n in sharded.slot_bytes(model).items()}
    state_by_slot = {("row" if k is None else f"{k[0]} {k[1]}"):
                     round(n / mib, 3) for k, n in state.items()}
    return (f"storage by slot (MiB, row 0) params {by_slot}, optimizer "
            f"state {state_by_slot}, each row's params as the merged rule "
            f"places them; allocator after the build {built_bytes} B")


def check_ep_nccl(dev, want, inputs):
    """Data 2 at f32 again in an NCCL group of world size 1: bitwise equal
    to the run without a group."""
    import socket

    from torchbeast_tpu_torch import parallel

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    parallel.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                    backend="nccl")
    try:
        (params, _), dispatch, stats, _, _ = _ep_path(dev, "f32", (2, 1),
                                                      inputs)
        check(dispatch.learner.group is not None
              and dispatch.learner.exchange.group is not None,
              "phase 10 NCCL: no group")
        (want_params, _), _, want_stats, _, _ = want
        check(all(torch.equal(p, want_params[k]) for k, p in params.items())
              and all(torch.equal(stats[k], want_stats[k]) for k in stats),
              "phase 10 NCCL: the group's MoE DP run differs from the run "
              "without one")
    finally:
        torch.distributed.destroy_process_group()
    print("phase 10 data 2 f32 in an NCCL group of world size 1 (routing "
          "counts all_gathered, gradients all-reduced): bitwise equal to "
          "the run without a group")


def run_ep_phases(ops, dev, savedir, tf32):
    """Phase 10 (--ep-only alone after the builds). Returns the paths'
    launch counts."""
    from torchbeast_tpu_torch import precision

    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    by_path = {}
    print(f"phase 10: {card_line()}")
    for policy, layouts in (("f32", EP_LAYOUTS),
                            ("bf16_train", EP_BF16_LAYOUTS)):
        dtype = precision.get(policy).batch_dtype
        model, _ = _param_tree(dev, "transformer", policy,
                               num_experts=EP_EXPERTS)
        inputs = ([precision.cast_batch(random_batch(i, dev), dtype)
                   for i in range(DP_UPDATES)],
                  precision.cast_batch(_agent_state(model, "transformer",
                                                    dev), dtype))
        del model
        want = _ep_path(dev, policy, None, inputs)
        one_ms = time_ms(lambda: want[1](inputs[0][0], inputs[1]), reps=10)
        print(f"phase 10 one device {policy}: update {one_ms:.3f} ms (one "
              f"CUDA graph), {want[4]} assignments dropped in its updates "
              f"of {2 * 2 * T * B} (2 layers, top-2)")
        for layout in layouts:
            counts, got, _ = check_ep_path(ops, dev, policy, layout,
                                           want, inputs)
            by_path[f"moe data {layout[0]} x expert {layout[1]} "
                    f"{policy}"] = counts
            if policy == "f32" and layout == (2, 1):
                nccl_want = got
            del got
            torch.cuda.empty_cache()
        if policy == "f32":
            check_ep_nccl(dev, nccl_want, inputs)
            del nccl_want
        del want, inputs
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    # polybeast's data 2 x expert 2 learner mesh on both runtimes, its
    # expert kernels sharded, and its checkpoint resumed on one device,
    # with the drivers' device list [cuda:0] * 4 (restored after).
    from torchbeast_tpu_torch import parallel

    visible = parallel.visible_devices
    parallel.visible_devices = lambda platform=None: [dev] * 4
    try:
        moe_args = ["--model", "transformer", "--num_experts", "4"]
        for native in (False, True):
            by_path.update(run_poly_parallel(
                ops, savedir, "polybeast MoE transformer data 2 x expert 2 "
                f"{'core' if native else 'Python pool'}", moe_args,
                ["--expert_parallel", "2", "--num_learner_devices", "2"],
                native, 2))
        by_path.update(run_poly_parallel(
            ops, savedir, "polybeast MoE transformer one device core, "
            "resuming data 2 x expert 2 Python pool", moe_args, [], True,
            1, line="Resuming preempted job",
            resume="polybeast MoE transformer data 2 x expert 2 Python "
                   "pool"))
    finally:
        parallel.visible_devices = visible
    print(f"phase 10 (expert parallel): {time.time() - t0:.1f} s")
    return by_path


# ----------------------------------------------------------------- phase 11

SPLIT_UPDATES = 3
SPLIT_MAX_POLICY_LAG = 20  # polybeast's --max_policy_lag default


def _hist_delta(reg, name, before):
    """(p50, p99) in ms of the samples `name` took since `before` (its
    buckets then), or (nan, nan) without any."""
    from torchbeast_tpu_torch.telemetry.metrics import (
        percentiles_from_buckets)

    buckets = {i: n - before.get(i, 0) for i, n in
               reg.histogram(name).merged().buckets.items()}
    if sum(buckets.values()) <= 0:
        return float("nan"), float("nan")
    p50, p99 = percentiles_from_buckets(buckets, [0.5, 0.99])
    return 1000 * p50, 1000 * p99


def _poly_run(ops, savedir, xpid, extra, native=False, lstm=True):
    """polybeast through its parser at polybeast_argv's settings (16 Mock
    env servers, deep + LSTM (without it with `lstm` False), T=80, B=32,
    V-trace, the tail and pool_bwd on, two inference threads) plus
    `extra`, SPLIT_UPDATES updates, the Python pool or the core. Returns
    a record: stats, launch counts, the
    log lines, the acting round trip's and each forward series' p50/p99
    in ms over this run, the serving counters' deltas."""
    from torchbeast_tpu_torch import polybeast, telemetry

    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    argv = polybeast_argv(savedir, xpid) + list(extra) + [
        "--total_steps", str(SPLIT_UPDATES * T * B)]
    if native:
        argv[argv.index("--no_native_runtime")] = "--native_runtime"
    if not lstm:
        argv.remove("--use_lstm")
    reg = telemetry.get_registry()
    series = ["actor.request_rtt_s", "inference.dispatch_s"] + [
        f"inference.slice.{i}.dispatch_s" for i in range(2)]
    before = {name: dict(reg.histogram(name).merged().buckets)
              for name in series}
    counter_names = ["serving.snapshots_published"] + [
        f"inference.slice.{i}.{c}" for i in range(2)
        for c in ("requests", "rows")]
    counters_before = {c: reg.counter(c).value() for c in counter_names}
    lines = _Lines()
    logger = logging.getLogger("torchbeast_tpu_torch")
    logger.addHandler(lines)
    logger.setLevel(logging.INFO)
    ops.reset_launch_counts()
    t0 = time.time()
    try:
        stats = polybeast.train(polybeast.make_parser().parse_args(argv))
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(lines)
    wall = time.time() - t0
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    updates = stats["updates"]
    check(updates >= SPLIT_UPDATES, f"{xpid}: {updates} updates")
    for name, per_update in (("vtrace_targets", 1), ("rmsprop_tail", 1),
                             ("pool_bwd", 3)):
        check(counts[name] >= per_update * updates,
              f"{xpid}: {counts[name]} {name} launches in {updates} updates")
    check(ops.pool_bwd.vector_launches == counts["pool_bwd"],
          f"{xpid}: pool_bwd launches off the 16-byte path")
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm"):
        check(np.isfinite(stats[key]), f"{xpid} loss stat {key}")
    check(stats["health"] == "HEALTHY", f"{xpid}: health {stats['health']}")
    check(stats["runtime"] == ("native" if native else "python"),
          f"{xpid}: runtime {stats['runtime']}")
    return {"stats": stats, "counts": counts, "bf16": bf16, "wall": wall,
            "lines": lines.lines[:],
            "ms": {name: _hist_delta(reg, name, before[name])
                   for name in series},
            "counters": {c: reg.counter(c).value() - counters_before[c]
                         for c in counter_names},
            "steady_sps": _steady_sps(os.path.join(savedir, xpid,
                                                   "logs.csv"))}


def _poly_line(label, run, slices=0):
    s, ms = run["stats"], run["ms"]
    rtt50, rtt99 = ms["actor.request_rtt_s"]
    forwards = ([ms["inference.dispatch_s"][0]] if not slices else
                [ms[f"inference.slice.{i}.dispatch_s"][0]
                 for i in range(slices)])
    return (f"{label}: {s['updates']} updates in {run['wall']:.1f} s; SPS "
            f"{s['sps']:.1f} (from the second batch {run['steady_sps']}); "
            f"update interval median {s['update_interval_ms_median']:.2f} ms;"
            f" acting round trip p50 {rtt50:.2f} ms p99 {rtt99:.2f} ms; "
            f"forward host ms p50 "
            f"{', '.join(f'{x:.3f}' for x in forwards)}"
            f"{' (per slice)' if slices else ''}; mean inference batch "
            f"{s['inference_batch_mean']:.2f}; launches {run['counts']}")


def split_visible(ops, savedir):
    """(a) One visible card: monobeast and polybeast, each given
    --device_split inf=1,learn=rest through its parser, log the
    reference's degradation warning and train the time-shared path with
    its usual launches. Returns polybeast's run (the Python pool's
    time-shared figures for (c)) and the paths' launch counts."""
    from torchbeast_tpu_torch import monobeast

    n = torch.cuda.device_count()
    if n != 1:
        print(f"phase 11 (a): {n} CUDA devices visible: the split resolves "
              "over them, nothing degrades; (a) skipped")
        return None, {}
    warning = "degrading to the time-shared serving path"
    xpid = "chip_smoke_split_visible_mono"
    shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    flags = monobeast.make_parser().parse_args([
        "--env", "Mock", "--num_actors", str(B), *DEEP_ARGS,
        "--batch_size", str(B), "--unroll_length", str(T),
        "--vtrace_impl", "pallas", "--opt_impl", "pallas", "--serial_envs",
        "--device_split", "inf=1,learn=rest",
        "--total_steps", str(2 * T * B), "--savedir", savedir,
        "--xpid", xpid])
    lines = _Lines()
    logger = logging.getLogger("torchbeast_tpu_torch")
    logger.addHandler(lines)
    ops.reset_launch_counts()
    try:
        stats = monobeast.train(flags)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(lines)
    counts = ops.launch_counts()
    check(any(warning in m for m in lines.lines),
          "(a) monobeast: no degradation warning")
    check(stats["updates"] == 2 and counts["vtrace_targets"] >= 2
          and counts["rmsprop_tail"] >= 2 and counts["pool_bwd"] >= 6,
          f"(a) monobeast: {stats['updates']} updates, launches {counts}")
    by_path = {"split (a) monobeast degraded": (
        counts, ops.bf16_launch_counts())}
    print(f"phase 11 (a): monobeast --device_split inf=1,learn=rest on one "
          f"card warned and trained time-shared: 2 updates, launches "
          f"{counts}")
    run = _poly_run(ops, savedir, "chip_smoke_split_visible_poly",
                    ["--device_split", "inf=1,learn=rest"])
    check(any(warning in m for m in run["lines"]),
          "(a) polybeast: no degradation warning")
    check("slice_capture_s" not in run["stats"],
          "(a) polybeast built slices on one card")
    by_path["split (a) polybeast degraded"] = (run["counts"], run["bf16"])
    print("phase 11 (a): " + _poly_line(
        "polybeast --device_split inf=1,learn=rest on one card warned and "
        "trained time-shared", run))
    return run, by_path


def _same_tree(a, b):
    """Bitwise equal nests of arrays (checkpoint payloads)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    x, y = np.asarray(a), np.asarray(b)
    return x.dtype == y.dtype and x.shape == y.shape and (
        x.tobytes() == y.tobytes())


def split_monobeast(ops, savedir):
    """(b) monobeast with every device on cuda:0 (the caller's device
    list): --device_split inf=1,learn=1 trains SPLIT_UPDATES updates
    bitwise equal to the time-shared run from the same seed (stats and
    the checkpoint's params and optimizer state), with the same launches
    (V-trace 1, pool_bwd 3 an update); --opt_impl pallas raises the
    reference's ValueError; inf=1,learn=2 runs the data-parallel update
    (V-trace 2, pool_bwd 6, the tail none an update)."""
    from torchbeast_tpu_torch import monobeast
    from torchbeast_tpu_torch.utils.checkpoint import read_payload

    def run(xpid, extra):
        shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
        flags = monobeast.make_parser().parse_args([
            "--env", "Mock", "--num_actors", str(B), *DEEP_ARGS,
            "--batch_size", str(B), "--unroll_length", str(T),
            "--vtrace_impl", "pallas", "--serial_envs",
            "--total_steps", str(SPLIT_UPDATES * T * B),
            "--savedir", savedir, "--xpid", xpid, *extra])
        ops.reset_launch_counts()
        t0 = time.time()
        stats = monobeast.train(flags)
        torch.cuda.synchronize()
        return (stats, ops.launch_counts(), ops.bf16_launch_counts(),
                read_payload(os.path.join(savedir, xpid, "model.ckpt")),
                time.time() - t0)

    shared = run("chip_smoke_split_mono_shared", [])
    split = run("chip_smoke_split_mono_split",
                ["--device_split", "inf=1,learn=1"])
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm", "step", "updates"):
        check(shared[0][key] == split[0][key],
              f"(b) monobeast split {key} {split[0][key]} against "
              f"{shared[0][key]} time-shared")
    for part in ("params", "opt_state"):
        check(_same_tree(shared[3][part], split[3][part]),
              f"(b) monobeast split: checkpoint {part} differ from the "
              "time-shared run's")
    counts = split[1]
    check(counts == shared[1] and counts["vtrace_targets"]
          >= SPLIT_UPDATES and counts["pool_bwd"] >= 3 * SPLIT_UPDATES,
          f"(b) launches {counts} against time-shared {shared[1]}")
    print(f"phase 11 (b): monobeast --device_split inf=1,learn=1, every "
          f"device cuda:0: {SPLIT_UPDATES} updates bitwise equal to the "
          f"time-shared run (stats, params, optimizer state); launches "
          f"{counts} (time-shared {shared[1]}); update median "
          f"{split[0]['update_ms_median']:.2f} ms (time-shared "
          f"{shared[0]['update_ms_median']:.2f}); SPS {split[0]['sps']:.1f} "
          f"({shared[0]['sps']:.1f})")
    try:
        run("chip_smoke_split_mono_pallas",
            ["--device_split", "inf=1,learn=1", "--opt_impl", "pallas"])
    except ValueError as e:
        check("does not compose with --device_split" in str(e),
              f"(b) --opt_impl pallas raised {e!r}")
        print(f"phase 11 (b): --opt_impl pallas under the split raised the "
              f"reference's ValueError: {e}")
    else:
        raise SmokeFailure("(b): --opt_impl pallas trained under the split")
    dp = run("chip_smoke_split_mono_dp", ["--device_split", "inf=1,learn=2"])
    dp_counts = dp[1]
    check(dp[0]["updates"] == SPLIT_UPDATES
          and np.isfinite(dp[0]["total_loss"])
          and dp_counts["vtrace_targets"] >= 2 * SPLIT_UPDATES
          and dp_counts["pool_bwd"] >= 6 * SPLIT_UPDATES
          and dp_counts["rmsprop_tail"] == 0,
          f"(b) inf=1,learn=2: {dp[0]['updates']} updates, launches "
          f"{dp_counts}")
    print(f"phase 11 (b): monobeast --device_split inf=1,learn=2: the DP "
          f"learner over 2 shards on cuda:0, {SPLIT_UPDATES} updates, "
          f"update median {dp[0]['update_ms_median']:.2f} ms; launches "
          f"{dp_counts}")
    return {"split (b) monobeast inf=1,learn=1": (counts, split[2]),
            "split (b) monobeast inf=1,learn=2": (dp_counts, dp[2])}


class _SplitRecorder:
    """Phase 11 (c)'s instruments, patched in around one run: the
    serving polybeast builds, every publish's bf16 tree (kept on the
    card: a publish makes fresh tensors and never changes them), a clone
    of each slice's params buffer after each load (on the slice's
    stream, no sync), and every reply's policy_lag stamp."""

    def __init__(self):
        from torchbeast_tpu_torch import nest, parallel
        from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable
        from torchbeast_tpu_torch.serving import snapshot
        from torchbeast_tpu_torch.serving.replica import ReplicaServingHooks

        self.serving, self.published, self.loads, self.lags = [], {}, [], []
        self._patches = []
        recorder = self

        def patch(owner, name, make):
            original = getattr(owner, name)
            self._patches.append((owner, name, original))
            setattr(owner, name, make(original))

        def build(original):
            def wrapped(*args, **kwargs):
                serving = original(*args, **kwargs)
                recorder.serving.append(serving)
                return serving
            return wrapped

        def publish(original):
            def wrapped(store, version, params):
                ok = original(store, version, params)
                if ok:
                    recorder.published[version] = nest.flatten(store._bf16)
                return ok
            return wrapped

        def load(original):
            def wrapped(table, context):
                before = table._context_version
                original(table, context)
                if table._context_version != before:
                    recorder.loads.append(
                        (table, context[0],
                         [t.clone() for t in table._context_params]))
            return wrapped

        def begin(original):
            def wrapped(hooks):
                ctx, annotate = original(hooks)

                def stamped(outputs, n):
                    out = annotate(outputs, n)
                    recorder.lags.append(int(np.max(out["policy_lag"])))
                    return out
                return ctx, stamped
            return wrapped

        patch(parallel, "build_sebulba_serving", build)
        patch(snapshot.PolicySnapshotStore, "publish", publish)
        patch(DeviceStateTable, "_load_context", load)
        patch(ReplicaServingHooks, "begin_batch", begin)

    def restore(self):
        for owner, name, original in reversed(self._patches):
            setattr(owner, name, original)


def split_polybeast(ops, savedir, shared_python):
    """(c) polybeast --device_split inf=2,learn=1 --opt_impl pallas with
    every device on cuda:0 (the caller's device list), on the Python pool
    and on the core, at polybeast_argv's settings: each slot's requests
    reached its slice_for_slot slice alone (the other slice's table never
    wrote the slot's row), the per-slice counters sum to every request
    served, the core's hash equals the Python one's for every slot, every
    reply's policy_lag within --max_policy_lag, at least one publish an
    update, every params buffer a slice loaded bitwise the learner's
    bf16-rounded params of that version, and the launches those of the
    time-shared path; printed beside the time-shared run at the same
    settings (the Python pool's from (a))."""
    from torchbeast_tpu_torch import nest
    from torchbeast_tpu_torch.runtime import native_build, placement

    core = native_build.load()
    split = placement.DeviceSplit("chip", (torch.device("cuda", 0),) * 2,
                                  (torch.device("cuda", 0),))
    check(all(core.slice_for_slot(s, 2) == split.slice_for_slot(s)
              for s in range(-64, 4096)),
          "(c) the core's slot hash differs from the Python router's")
    by_path = {}
    for native in (False, True):
        runtime = "core" if native else "Python pool"
        recorder = _SplitRecorder()
        try:
            run = _poly_run(
                ops, savedir, f"chip_smoke_split_poly_{int(native)}",
                ["--device_split", "inf=2,learn=1"], native=native)
        finally:
            recorder.restore()
        stats, counters = run["stats"], run["counters"]
        check(len(recorder.serving) == 1, f"(c) {runtime}: no slices built")
        serving = recorder.serving[0]
        num_actors = serving.state_tables.num_slots
        for stack in serving.stacks:
            rows = [t.detach() for t in nest.flatten(
                stack.state_table._rows)]
            for slot in range(num_actors):
                written = any(bool(t.select(1, slot).abs().sum() > 0)
                              for t in rows)
                owner = split.slice_for_slot(slot) == stack.index
                check(written == owner,
                      f"(c) {runtime}: slot {slot}'s row in slice "
                      f"{stack.index}'s table {'never' if owner else 'was'}"
                      " written")
        # Every routed request is served as one row, but for at most one
        # in flight an actor when the run closes the slices' batchers.
        requests = sum(counters[f"inference.slice.{i}.requests"]
                       for i in range(2))
        rows_served = sum(counters[f"inference.slice.{i}.rows"]
                          for i in range(2))
        check(rows_served > 0 and 0 <= requests - rows_served <= num_actors,
              f"(c) {runtime}: {requests} requests routed, {rows_served} "
              "rows served")
        check(recorder.lags and max(recorder.lags) <= SPLIT_MAX_POLICY_LAG,
              f"(c) {runtime}: policy_lag max "
              f"{max(recorder.lags, default=None)}")
        published = counters["serving.snapshots_published"]
        check(published >= stats["updates"] + 1,
              f"(c) {runtime}: {published} publishes in {stats['updates']}"
              " updates")
        check(recorder.loads, f"(c) {runtime}: no slice loaded a snapshot")
        for table, version, buffer in recorder.loads:
            want = recorder.published.get(version)
            check(want is not None and all(
                torch.equal(b, w.to(b.dtype)) for b, w in zip(buffer, want)),
                f"(c) {runtime}: a slice's params at version {version} are "
                "not the learner's bf16-rounded params")
        capture = stats["slice_capture_s"]
        check(len(capture) == 2, f"(c) {runtime}: capture {capture}")
        if native:
            shared = _poly_run(ops, savedir, "chip_smoke_split_poly_shared1",
                               [], native=True)
        elif shared_python is not None:
            shared = shared_python
        else:
            shared = _poly_run(ops, savedir, "chip_smoke_split_poly_shared0",
                               [])
        # The same launches an update, and the same launches outside the
        # updates (warm-up and capture), so the check holds whatever the
        # two runs' update counts are.
        for name, per_update in (("vtrace_targets", 1), ("rmsprop_tail", 1),
                                 ("pool_bwd", 3)):
            extra = run["counts"][name] - per_update * stats["updates"]
            shared_extra = (shared["counts"][name]
                            - per_update * shared["stats"]["updates"])
            check(extra == shared_extra,
                  f"(c) {runtime}: {name} {run['counts'][name]} launches in "
                  f"{stats['updates']} updates against "
                  f"{shared['counts'][name]} in "
                  f"{shared['stats']['updates']} time-shared")
        by_path[f"split (c) polybeast inf=2,learn=1 {runtime}"] = (
            run["counts"], run["bf16"])
        print("phase 11 (c): " + _poly_line(
            f"polybeast --device_split inf=2,learn=1 --opt_impl pallas on "
            f"the {runtime}, every device cuda:0", run, slices=2)
            + f"; per-slice graph capture s "
            f"{', '.join(f'{x:.2f}' for x in capture)}; requests per slice "
            f"{[counters[f'inference.slice.{i}.requests'] for i in range(2)]}"
            f"; policy_lag max {max(recorder.lags)} over "
            f"{len(recorder.lags)} replies; {published} publishes; "
            f"{len(recorder.loads)} snapshot loads bitwise the published "
            "bf16 params")
        print("phase 11 (c): " + _poly_line(
            f"time-shared at the same settings on the {runtime}", shared))
    # One slice on the core: the time-shared path's batching (every
    # actor's requests in one batcher) with the slice's stream.
    one = _poly_run(ops, savedir, "chip_smoke_split_poly_one",
                    ["--device_split", "inf=1,learn=1"], native=True)
    check(len(one["stats"]["slice_capture_s"]) == 1,
          "(c) inf=1,learn=1 built no slice")
    by_path["split (c) polybeast inf=1,learn=1 core"] = (one["counts"],
                                                         one["bf16"])
    print("phase 11 (c): " + _poly_line(
        "polybeast --device_split inf=1,learn=1 --opt_impl pallas on the "
        "core, every device cuda:0", one, slices=1))
    # Without the LSTM: no state table, each slice's forward a graph of
    # its own over the request's state, slot-less requests round-robin.
    recorder = _SplitRecorder()
    try:
        flat = _poly_run(ops, savedir, "chip_smoke_split_poly_stateless",
                         ["--device_split", "inf=2,learn=1"], native=True,
                         lstm=False)
    finally:
        recorder.restore()
    rows = [flat["counters"][f"inference.slice.{i}.rows"] for i in range(2)]
    check(recorder.serving[0].state_tables is None and min(rows) > 0,
          f"(c) stateless: rows a slice {rows}")
    check(recorder.lags and max(recorder.lags) <= SPLIT_MAX_POLICY_LAG,
          f"(c) stateless: policy_lag max {max(recorder.lags, default=None)}")
    by_path["split (c) polybeast inf=2,learn=1 deep core"] = (
        flat["counts"], flat["bf16"])
    print("phase 11 (c): " + _poly_line(
        "polybeast deep (no LSTM) --device_split inf=2,learn=1 on the "
        "core, every device cuda:0", flat, slices=2)
        + f"; rows a slice {rows}")
    return by_path


def measure_slice_stream(dev):
    """(c2) What the split's stream buys on one card, measured directly:
    the deep + LSTM learner's update graph (T=80, B=32) replays back to
    back on the default stream from a thread while a state-table acting
    step at B=32 (one captured replica graph: the gather, the acting
    forward, the scatter) is timed on the host from launch to its reply,
    on a table pinned to the card (its own stream, as a slice's) and on an
    unpinned one (the default stream, behind the learner's work, as the
    time-shared path's). Prints each one's p50/p99 beside the step alone
    and the update's time."""
    import threading

    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable

    model, _ = _param_tree(dev, "deep", "f32")
    hp = learner_lib.HParams(unroll_length=T, batch_size=B,
                             vtrace_impl="pallas", opt_impl="pallas",
                             total_steps=10 ** 9)
    update = learner_lib.make_update_dispatch(
        model, learner_lib.make_optimizer(hp, list(model.parameters())), hp,
        1)
    batch, state = random_batch(0, dev), _agent_state(model, "deep", dev)
    update(batch, state)  # the capture
    torch.cuda.synchronize()
    actor = copy.deepcopy(model).requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(5)

    def env(n):
        return {"frame": rng.integers(0, 256, (1, n, 84, 84, 4), np.uint8),
                "reward": np.zeros((1, n), np.float32),
                "done": np.zeros((1, n), bool),
                "last_action": np.zeros((1, n), np.int32)}

    def act(env_d, agent_state):
        out, new_state = learner_lib.act_body(
            actor, {k: env_d[k][0] for k in learner_lib.MODEL_INPUT_KEYS},
            agent_state, gen)
        return {"action": out.action[None].to(torch.int32),
                "policy_logits": out.policy_logits[None]}, new_state

    tables = {}
    for label, pin in (("own stream", dev), ("default stream", None)):
        table = DeviceStateTable(actor.initial_state(1, dev), B,
                                 lambda ctx, e, s: None, batch_dim=1,
                                 device=pin)
        table.bind_context(act, list(actor.parameters()))
        table.capture_context([B], env, gen)
        tables[label] = table
    context = (0, list(actor.parameters()))
    e = env(B)

    def step_ms(table, reps=40):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            table.fetch(table.step(np.arange(B), np.ones(B, bool), e,
                                   context), B)
            times.append(1000 * (time.perf_counter() - t0))
        return np.percentile(times, 50), np.percentile(times, 99)

    alone = {label: step_ms(t) for label, t in tables.items()}
    stop = threading.Event()
    updates = []

    def learn():
        torch.cuda.set_device(dev)
        while not stop.is_set():
            t0 = time.perf_counter()
            update(batch, state)
            torch.cuda.current_stream(dev).synchronize()
            updates.append(1000 * (time.perf_counter() - t0))

    learner = threading.Thread(target=learn)
    learner.start()
    try:
        time.sleep(0.2)
        busy = {label: step_ms(t) for label, t in tables.items()}
    finally:
        stop.set()
        learner.join(60)
    check(not learner.is_alive(), "(c2) the learner thread did not end")
    print(f"phase 11 (c2): a state-table acting step at B={B} (deep+LSTM, "
          f"one graph) while the learner's update graph replays back to "
          f"back (update median {statistics.median(updates):.2f} ms over "
          f"{len(updates)}): on its own stream p50 "
          f"{busy['own stream'][0]:.2f} ms p99 {busy['own stream'][1]:.2f} "
          f"ms; on the default stream p50 {busy['default stream'][0]:.2f} ms "
          f"p99 {busy['default stream'][1]:.2f} ms; alone "
          f"{alone['own stream'][0]:.2f} / {alone['default stream'][0]:.2f} "
          "ms p50")
    return busy, alone


def check_replica_server(dev):
    """(d) A ReplicaServer on cuda:0 serving the deep acting forward (no
    LSTM, greedy actions) over unix: and shm:, fed by a
    RemoteSnapshotPublisher and reached through a RemoteReplicaBatcher as
    the replica leg of serving.ReplicaRouter, then through proxy_loop from
    the core's batcher behind the core's ReplicaRouter: its replies equal
    a local forward of the same published snapshot (actions exact, logits
    and baseline bitwise, B=32), lag stamps right (3 behind the head, then
    0), the round trip's median printed."""
    import tempfile
    import threading

    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import nest
    from torchbeast_tpu_torch.runtime import native_build
    from torchbeast_tpu_torch.runtime.inference import to_device
    from torchbeast_tpu_torch.runtime.queues import DynamicBatcher
    from torchbeast_tpu_torch.serving import (
        PolicySnapshotStore, ReplicaRouter, ReplicaServingHooks)
    from torchbeast_tpu_torch.serving import replica_server as rs
    from torchbeast_tpu_torch.telemetry.metrics import MetricsRegistry

    from torchbeast_tpu_torch.models import create_model

    def build(seed):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return create_model("deep", NUM_ACTIONS).to(
                dev).requires_grad_(False)

    published = build(11)
    server_model, local_model = build(12), build(13)
    server_params = list(server_model.parameters())
    loaded = [None]

    def forward(acting, inputs):
        out, _ = learner_lib.act_body(
            acting, {k: v[0] for k, v in inputs.items()}, (),
            sample_action=False)
        return {"action": out.action[None].to(torch.int32),
                "policy_logits": out.policy_logits[None],
                "baseline": out.baseline[None]}

    def act_fn(params, inputs):
        if loaded[0] is not params:
            torch._foreach_copy_(server_params, nest.flatten(params))
            loaded[0] = params
        return forward(server_model, to_device(
            {k: inputs[k] for k in learner_lib.MODEL_INPUT_KEYS}, dev))

    local = PolicySnapshotStore(1, registry=MetricsRegistry())
    local.note_update(0)
    local.publish(0, list(published.parameters()))
    with torch.no_grad():
        torch._foreach_copy_(list(local_model.parameters()),
                             nest.flatten(local.latest()[1]))
    rng = np.random.default_rng(6)
    request = {"frame": rng.integers(0, 256, (1, B, 84, 84, 4), np.uint8),
               "reward": rng.standard_normal((1, B)).astype(np.float32),
               "done": rng.random((1, B)) < 0.1,
               "last_action": rng.integers(0, NUM_ACTIONS, (1, B)).astype(
                   np.int32)}
    with torch.no_grad():
        want = {k: v.cpu().numpy() for k, v in forward(
            local_model, to_device(request, dev)).items()}

    def same(out, lag, where):
        out = {k: np.array(v) for k, v in out.items()}
        check(np.array_equal(out["action"], want["action"]),
              f"(d) {where}: actions differ from the local forward")
        for key in ("policy_logits", "baseline"):
            check(out[key].dtype == want[key].dtype
                  and out[key].tobytes() == want[key].tobytes(),
                  f"(d) {where}: {key} not bitwise the local forward's")
        stamp = out["policy_lag"]
        check(stamp.dtype == np.int32 and (stamp == lag).all(),
              f"(d) {where}: policy_lag {stamp.reshape(-1)[:4]}, want {lag}")

    core = native_build.load()
    rtt = {}
    for transport in ("unix", "shm"):
        address = (f"{transport}:"
                   f"{os.path.join(tempfile.mkdtemp(), 'replica')}")
        server = rs.ReplicaServer(act_fn, address, max_policy_lag=20,
                                  batch_dim=1, max_batch_size=B,
                                  timeout_ms=1, registry=MetricsRegistry(),
                                  device=dev)
        server.start()
        publisher = rs.RemoteSnapshotPublisher(address, timeout_s=60)
        remote = rs.RemoteReplicaBatcher(address, timeout_s=60)
        central = DynamicBatcher(batch_dim=1, timeout_ms=1)
        native_central = core.DynamicBatcher(batch_dim=1)
        native_replica = core.DynamicBatcher(batch_dim=1)
        proxy = threading.Thread(target=rs.proxy_loop,
                                 args=(native_replica, remote), daemon=True)
        try:
            publisher.publish(0, list(published.parameters()))
            for v in (1, 2, 3):
                publisher.note_update(v)
            same(remote.compute(request), 3, f"{transport} direct")
            publisher.publish(3, list(published.parameters()))
            store = PolicySnapshotStore(1, registry=MetricsRegistry())
            store.note_update(3)
            store.publish(3, list(published.parameters()))
            hooks = ReplicaServingHooks(store, max_policy_lag=20,
                                        batch_dim=1,
                                        registry=MetricsRegistry())
            router = ReplicaRouter(central, remote, hooks,
                                   registry=MetricsRegistry())
            same(router.compute(request), 0, f"{transport} ReplicaRouter")
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                remote.compute(request)
                times.append(1000 * (time.perf_counter() - t0))
            rtt[transport] = statistics.median(times)
            proxy.start()
            native_router = core.ReplicaRouter(central=native_central,
                                               replica=native_replica)
            native_router.set_serving(True)
            same(native_router.compute(request), 0,
                 f"{transport} proxy_loop from the core's batcher")
            tm = native_router.telemetry()
            check(tm["replica_requests"] == 1 and tm["central_requests"] == 0,
                  f"(d) {transport}: the core's router {tm}")
        finally:
            native_central.close()
            native_replica.close()
            if proxy.is_alive():
                proxy.join(10)
            central.close()
            remote.close()
            publisher.close()
            server.stop()
        check(not proxy.is_alive(), f"(d) {transport}: proxy_loop hung")
    print(f"phase 11 (d): ReplicaServer on {dev} (deep, no LSTM, B={B}) "
          f"over unix: and shm:, fed by RemoteSnapshotPublisher: replies "
          "through RemoteReplicaBatcher, serving.ReplicaRouter and "
          "proxy_loop from the core's batcher equal a local forward of the "
          "same published snapshot (actions exact, logits and baseline "
          f"bitwise), lag stamps 3 then 0; round trip median "
          f"{rtt['unix']:.2f} ms unix, {rtt['shm']:.2f} ms shm (20 requests "
          f"of {B} rows)")


def run_split_phases(ops, dev, savedir, tf32):
    """Phase 11 (--split-only alone after the builds): (a) on the visible
    card; then, with the drivers' device list (parallel.visible_devices)
    replaced by [cuda:0] * 3 and restored after (the split's slices and
    learner all share the one card; nothing in the package has a knob for
    this), (b) monobeast and (c), (c2) polybeast; then (d) the replica
    server. TF32 off and cuDNN deterministic for (b) and (d), whose
    comparisons are bitwise. Returns the paths' launch counts."""
    from torchbeast_tpu_torch import parallel

    t0 = time.time()
    print(f"phase 11: {card_line()}")
    shared_python, by_path = split_visible(ops, savedir)
    visible = parallel.visible_devices
    parallel.visible_devices = lambda platform=None: [dev] * 3
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        by_path.update(split_monobeast(ops, savedir))
        torch.backends.cudnn.deterministic = False
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        by_path.update(split_polybeast(ops, savedir, shared_python))
        torch.cuda.empty_cache()
        measure_slice_stream(dev)
    finally:
        parallel.visible_devices = visible
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    check_replica_server(dev)
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
    torch.cuda.empty_cache()
    print(f"phase 11 (device split, replica server): {time.time() - t0:.1f} s")
    return by_path


# ----------------------------------------------------------------- phase 12

# (data, model) layouts of the TP paths: polybeast --tensor_parallel 2,
# alone and with --num_learner_devices 2.
TP_LAYOUTS = ((1, 2), (2, 2))
# A TP data shard's kernels an update: V-trace (the sharded learner
# refuses the fused tail, as the reference does; polybeast's transformer
# attends densely, reaching no attention kernel).
TP_KERNELS = {"vtrace_targets": 1}
# The MoE transformer at data 1 x model 2 x expert 2 ((data, expert,
# model), as _ep_path takes it): the attention kernels once a head group
# a layer.
TP_EP_LAYOUT = (1, 2, 2)
TP_EP_KERNELS = {"vtrace_targets": 1, "transformer_attention": 4,
                 "transformer_attention_bwd": 4}
# The PP updates: (label, model, depth, microbatches). Monobeast's
# defaults at --pipeline_parallel 2: the MLP one stage a device, the
# transformer its 4 layers (two passes).
PP_PATHS = (
    ("pipelined_mlp+LSTM pipe 2 M=2", "pipelined_mlp", {"num_stages": 2},
     None),
    ("pipelined_mlp+LSTM pipe 2 M=4", "pipelined_mlp", {"num_stages": 2},
     4),
    ("pipelined_mlp+LSTM pipe 2 stages 4 (two passes)", "pipelined_mlp",
     {"num_stages": 4}, None),
    ("pipelined_transformer pipe 2 M=2 (two passes)",
     "pipelined_transformer", {}, None),
    ("pipelined_transformer pipe 2 M=4 (two passes)",
     "pipelined_transformer", {}, 4),
)
PP_KERNELS = {"vtrace_targets": 1, "rmsprop_tail": 1}  # an update
# The monobeast PP paths through the driver, and polybeast's.
PP_DRIVER_ARGS = (
    ("monobeast pipelined_mlp+LSTM pipeline_parallel 2 M=4",
     PP_MLP_ARGS + ["--pipeline_parallel", "2", "--pipeline_microbatches",
                    "4"]),
    ("monobeast pipelined_mlp+LSTM pipeline_parallel 2 pipeline_stages 4",
     PP_MLP_ARGS + ["--pipeline_parallel", "2", "--pipeline_stages", "4"]),
    ("monobeast pipelined_transformer pipeline_parallel 2",
     PP_TRANSFORMER_ARGS + ["--pipeline_parallel", "2"]),
)
TP_PP_UPDATES = 2  # a polybeast path's updates


def _pp_hp():
    """The PP paths' learner: monobeast's, V-trace's kernel and the fused
    tail, the LR decay and the entropy anneal moving, RMSprop eps 1.0 as
    phase 9's (the comparison sees the update, not eps 0.01's
    conditioning)."""
    from torchbeast_tpu_torch import learner as learner_lib

    return learner_lib.HParams(unroll_length=T, batch_size=B,
                               vtrace_impl="pallas", opt_impl="pallas",
                               total_steps=20 * T * B,
                               entropy_cost_final=1e-4, rmsprop_eps=DP_EPS)


def _compare_params(label, model, want):
    """model's params (its one-device tree: a sharded model's slices
    assembled) against `want`'s within phase 9's tolerance; the largest
    difference relative to a leaf's largest entry."""
    from torchbeast_tpu_torch import parallel

    worst = 0.0
    for (pname, p), q in zip(parallel.local_view(model).items(),
                             want.parameters()):
        p, q = p.detach().float(), q.detach().float()
        err, ok = close(p, q, DP_PARAMS_RTOL, DP_PARAMS_ATOL)
        check(ok, f"{label}: param {pname} max |diff| {err:.3g} beyond "
                  f"rtol {DP_PARAMS_RTOL} / atol {DP_PARAMS_ATOL}")
        worst = max(worst, float(((p - q).abs().max()
                                  / q.abs().max().clamp_min(1e-30))))
    return worst


def _tp_model(dev):
    """polybeast's transformer at full width (2 layers, d 128, 4 heads,
    memory 64, FFN 512; dense attention), seed 0's weights."""
    from torchbeast_tpu_torch.models import create_model

    torch.manual_seed(0)
    return create_model("transformer", NUM_ACTIONS).to(dev)


def check_tp_path(ops, dev, layout, inputs, want):
    """(a) The TP update over a (data, model) mesh of `dev` repeated
    against the one-device update `want` ((model, stats, ms)) on the same
    batches from the same weights: params within phase 9's tolerance,
    total_loss within DP_LOSS_RTOL, replicas bitwise equal, V-trace once
    a data shard an update, the tail never, the shards' steps CUDA
    graphs. Returns its launch counts."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import parallel
    from torchbeast_tpu_torch.models import sharded

    data, model_par = layout
    label = f"phase 12 (a) TP data {data} x model {model_par}"
    batches, state = inputs
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    model = _tp_model(dev)
    opt = learner_lib.make_optimizer(_dp_hp(), list(model.parameters()))
    mesh = parallel.create_mesh(devices=[dev] * (data * model_par),
                                model_parallelism=model_par)
    dispatch = parallel.make_parallel_update_step(model, opt, _dp_hp(), mesh)
    torch.cuda.synchronize()
    storage = check_slot_bytes(label, dispatch.learner,
                               torch.cuda.memory_allocated(dev) - base)
    check(dispatch.captures_graphs and all(
        all([t.device for t in sharded.slots(m, "rel_bias") or ()]
            == mesh.model_devices(i)
            for m in r.modules() if hasattr(m, "rel_bias"))
        for i, r in enumerate(dispatch.learner.replicas)),
        f"{label}: not split over the model devices in CUDA graphs")
    dispatch.capture(batches[0], state)
    ops.reset_launch_counts()
    got = _dp_run(dispatch, batches, state)
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    for w, n in TP_KERNELS.items():
        check(counts[w] == n * data * DP_UPDATES,
              f"{label}: {counts[w]} {w} launches in {DP_UPDATES} updates")
    check(counts["rmsprop_tail"] == 0, f"{label}: the tail launched")
    for params in dispatch.learner.params[1:]:
        check(all(torch.equal(p, q) for p, q in zip(
            params, dispatch.learner.params[0])),
            f"{label}: a replica differs from the lead")
    want_model, want_stats, one_ms = want
    worst = _compare_params(label, model, want_model)
    loss_err, ok = close(got["total_loss"], want_stats["total_loss"],
                         DP_LOSS_RTOL, 0.0)
    check(ok, f"{label}: total_loss {got['total_loss'].tolist()} vs "
              f"{want_stats['total_loss'].tolist()}")
    ms = time_ms(lambda: dispatch(batches[0], state), reps=10)
    calls, _ = profile_call(lambda: dispatch(batches[0], state))

    def build():
        twin = _tp_model(dev)
        return (twin, learner_lib.make_optimizer(
            _dp_hp(), list(twin.parameters())), _dp_hp(),
            parallel.create_mesh(devices=[dev] * (data * model_par),
                                 model_parallelism=model_par))

    plain = check_sharded_plain(ops, label, build, inputs)
    print(f"{label} T={T} B={B}: every device {dev}, {DP_UPDATES} updates "
          f"against one device, RMSprop eps {DP_EPS}: params within rtol "
          f"{DP_PARAMS_RTOL} / atol {DP_PARAMS_ATOL} (largest difference "
          f"{worst:.3g} of a leaf's largest entry), total_loss within rtol "
          f"{DP_LOSS_RTOL} (max |diff| {loss_err:.3g}); replicas bitwise "
          f"equal; launches an update "
          f"{ {w: counts[w] // DP_UPDATES for w in TP_KERNELS} }, the tail "
          f"0; update {ms:.3f} ms (CUDA graphs), one device {one_ms:.3f} "
          f"ms; host API calls a dispatch {sum(calls.values())} {calls}; "
          f"{storage}; {plain}")
    return counts, bf16


def run_poly_parallel(ops, savedir, label, model_args, extra, native,
                      shards, tail=False, line="Parallel learner",
                      resume=None):
    """polybeast through its parser at polybeast_argv's settings (16 Mock
    env servers, T=80, B=32, V-trace on) with `model_args` in place of
    deep + LSTM, --opt_impl xla (the sharded learner refuses the tail;
    with `tail`, a one-device learner, pallas) and `extra`, TP_PP_UPDATES
    updates on the Python pool or the core: V-trace once a data shard an
    update (`shards`), the tail once an update with `tail` and else
    never, finite losses, HEALTHY, the learner's log line that starts
    with `line`, and after every publish the acting copy's whole leaves
    bitwise the learner's assembled params (models/sharded.Publisher,
    checked where polybeast calls it). `resume` (an earlier label)
    continues that run's checkpoint for TP_PP_UPDATES more updates.
    Returns the launch counts."""
    from torchbeast_tpu_torch import parallel, polybeast
    from torchbeast_tpu_torch.models import sharded

    xpid = "chip_smoke_" + re.sub(r"\W+", "_", resume or label)
    if resume is None:
        shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
    argv = polybeast_argv(savedir, xpid)
    at = argv.index("--model")
    del argv[at:at + 2]
    argv.remove("--use_lstm")
    if not tail:
        argv[argv.index("--opt_impl") + 1] = "xla"
    if native:
        argv[argv.index("--no_native_runtime")] = "--native_runtime"
    lines = _Lines()
    logger = logging.getLogger("torchbeast_tpu_torch")
    logger.addHandler(lines)
    logger.setLevel(logging.INFO)
    publish = sharded.Publisher.__call__
    published = []

    def checked(self):
        publish(self)
        view = parallel.local_view(self.model)
        check(len(self.whole) == len(view) and all(
            torch.equal(d, v) for d, v in zip(self.whole, view.values())),
            f"{label}: the acting copy differs from the learner's "
            "assembled params after a publish")
        published.append(sharded.is_sharded(self.model))

    sharded.Publisher.__call__ = checked
    ops.reset_launch_counts()
    t0 = time.time()
    flags = polybeast.make_parser().parse_args(
        argv + list(model_args) + list(extra)
        + ["--total_steps", str((2 if resume else 1) * TP_PP_UPDATES * T
                                * B)])
    try:
        stats = polybeast.train(flags)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(lines)
        sharded.Publisher.__call__ = publish
    wall = time.time() - t0
    check(published, f"{label}: no publish")
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    updates = stats["updates"]
    check(updates >= TP_PP_UPDATES, f"{label}: {updates} updates")
    check(counts["vtrace_targets"] >= shards * updates
          and (counts["rmsprop_tail"] >= updates if tail
               else counts["rmsprop_tail"] == 0),
          f"{label}: launches {counts} in {updates} updates")
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "grad_norm"):
        check(np.isfinite(stats[key]), f"{label} loss stat {key}")
    check(stats["health"] == "HEALTHY"
          and stats["runtime"] == ("native" if native else "python"),
          f"{label}: health {stats['health']}, runtime {stats['runtime']}")
    learner_line = [text for text in lines.lines if text.startswith(line)]
    check(learner_line, f"{label}: no line '{line}...'")
    if "--coordinator_address" in extra or "--fleet" in extra:
        joined = [text for text in lines.lines
                  if text.startswith("Joined")]
        check(joined, f"{label}: no process group joined")
        learner_line[0] += f"; {joined[0]}"
    if resume:
        check(stats["step"] >= 2 * TP_PP_UPDATES * T * B,
              f"{label}: step {stats['step']} after the resume")
    print(f"{label} T={flags.unroll_length} B={B}: "
          f"{learner_line[0].splitlines()[0]}; "
          f"{updates} updates in "
          f"{wall:.1f} s; SPS {stats['sps']:.1f}; update interval median "
          f"{stats['update_interval_ms_median']:.2f} ms; launches {counts}; "
          f"{len(published)} publishes, the acting copy bitwise the "
          f"learner's assembled params after each"
          f"{' (sharded storage)' if any(published) else ''}")
    return {label: (counts, bf16)}


def _pp_update(ops, dev, name, depth, mesh, microbatches, inputs):
    """DP_UPDATES updates (one CUDA graph a dispatch) of the full-width
    `name` at `depth`, seed 0's weights, its tower a GPipe over `mesh`'s
    pipe devices in `microbatches` (mesh None: the sequential tower):
    (model, stats, launch counts, dispatch)."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import parallel

    batches, state = inputs
    model, _ = _param_tree(dev, name, **depth)
    if mesh is not None:
        parallel.set_pipeline(model, mesh, microbatches)
    opt = learner_lib.make_optimizer(_pp_hp(), list(model.parameters()))
    dispatch = learner_lib.make_update_dispatch(model, opt, _pp_hp())
    dispatch.capture(batches[0], state)
    ops.reset_launch_counts()
    stats = _dp_run(dispatch, batches, state)
    return model, stats, (ops.launch_counts(), ops.bf16_launch_counts()), \
        dispatch


def check_pp_path(ops, dev, mesh, label, name, depth, microbatches):
    """(c) A GPipe update over `mesh` (two pipe devices, both `dev`)
    against the sequential tower on the same batches from the same
    weights: params within phase 9's tolerance and total_loss within
    DP_LOSS_RTOL (the microbatches' products run over fewer rows than the
    whole batch's, which can take other cuBLAS kernels and sum in another
    order, as the DP shards' do), V-trace and the tail once an update,
    the forward pipelined; both updates' ms. Returns the launch counts."""
    batches = [random_batch(i, dev) for i in range(DP_UPDATES)]
    probe, _ = _param_tree(dev, name, **depth)
    state = _agent_state(probe, name, dev)
    del probe
    seq, want, _, seq_dispatch = _pp_update(ops, dev, name, depth, None,
                                            None, (batches, state))
    pipe, got, (counts, bf16), dispatch = _pp_update(
        ops, dev, name, depth, mesh, microbatches, (batches, state))
    check(pipe.last_pipelined and not seq.last_pipelined,
          f"{label}: the update's forward did not pipeline")
    for w, n in PP_KERNELS.items():
        check(counts[w] == n * DP_UPDATES,
              f"{label}: {counts[w]} {w} launches in {DP_UPDATES} updates")
    worst = _compare_params(label, pipe, seq)
    loss_err, ok = close(got["total_loss"], want["total_loss"],
                         DP_LOSS_RTOL, 0.0)
    check(ok, f"{label}: total_loss {got['total_loss'].tolist()} vs "
              f"{want['total_loss'].tolist()}")
    ms = time_ms(lambda: dispatch(batches[0], state), reps=10)
    seq_ms = time_ms(lambda: seq_dispatch(batches[0], state), reps=10)
    print(f"phase 12 (c) {label} T={T} B={B}: {DP_UPDATES} updates against "
          f"the sequential tower, RMSprop eps {DP_EPS}: params within rtol "
          f"{DP_PARAMS_RTOL} / atol {DP_PARAMS_ATOL} (largest difference "
          f"{worst:.3g} of a leaf's largest entry), total_loss within rtol "
          f"{DP_LOSS_RTOL} (max |diff| {loss_err:.3g}); launches an update "
          f"{ {w: counts[w] // DP_UPDATES for w in PP_KERNELS} }; update "
          f"{ms:.3f} ms (one CUDA graph), sequential {seq_ms:.3f} ms")
    return counts, bf16


def check_pp_acting(dev, mesh):
    """(c) Acting: a T=1 batch of 3 rows does not divide into the 2
    microbatches and takes the sequential tower (bitwise the sequential
    model's outputs); B rows pipeline (within rtol 1e-5, atol 1e-6)."""
    from torchbeast_tpu_torch import parallel

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, depth in (("pipelined_mlp", {"num_stages": 2}),
                            ("pipelined_transformer", {})):
            seq, _ = _param_tree(dev, name, **depth)
            pipe, _ = _param_tree(dev, name, **depth)
            parallel.set_pipeline(pipe, mesh, None)
            batch = random_batch(5, dev)
            for rows in (3, B):
                inputs = {k: batch[k][:1, :rows] for k in
                          ("frame", "reward", "done", "last_action")}
                state = seq.initial_state(rows, dev)
                with torch.no_grad():
                    want, _ = seq(inputs, state, sample_action=False)
                    got, _ = pipe(inputs, state, sample_action=False)
                torch.cuda.synchronize()
                if rows == 3:
                    check(not pipe.last_pipelined and torch.equal(
                        got.policy_logits, want.policy_logits),
                        f"{name} acting at 3 rows: not the sequential tower")
                else:
                    err, ok = close(got.policy_logits, want.policy_logits,
                                    1e-5, 1e-6)
                    check(pipe.last_pipelined and ok,
                          f"{name} acting at {rows} rows: pipelined "
                          f"{pipe.last_pipelined}, max |err| {err}")
            print(f"phase 12 (c) {name} acting (T=1, TF32 off): 3 rows take "
                  f"the sequential tower, bitwise its outputs; {B} rows "
                  f"pipeline, logits within rtol 1e-5 / atol 1e-6 (max "
                  f"|err| {err:.3g})")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _free_tcp_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_tp_pp_phases(ops, dev, savedir, tf32):
    """Phase 12 (--tp-pp-only alone after the builds): with the drivers'
    device list (parallel.visible_devices) replaced by [cuda:0] * 4 and
    restored after, (a) TP, (b) TP with EP, (c) PP, (d) polybeast's data
    x pipe on the core. Returns the paths' launch counts."""
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import parallel

    t0 = time.time()
    print(f"phase 12: {card_line()}")
    by_path = {}
    visible = parallel.visible_devices
    parallel.visible_devices = lambda platform=None: [dev] * 4
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        # (a) TP against one device.
        one = _tp_model(dev)
        batches = [random_batch(i, dev) for i in range(DP_UPDATES)]
        state = random_cache(one, 0, dev)
        one_dispatch = learner_lib.make_update_dispatch(
            one, learner_lib.make_optimizer(_dp_hp(), list(
                one.parameters())), _dp_hp())
        one_dispatch.capture(batches[0], state)
        want_stats = _dp_run(one_dispatch, batches, state)
        # The params after DP_UPDATES updates, before timing runs more.
        want = copy.deepcopy(one)
        one_ms = time_ms(lambda: one_dispatch(batches[0], state), reps=10)
        for layout in TP_LAYOUTS:
            by_path[f"TP data {layout[0]} x model {layout[1]} update"] = \
                check_tp_path(ops, dev, layout, (batches, state),
                              (want, want_stats, one_ms))
        del one, want, one_dispatch, batches, state
        torch.cuda.empty_cache()
        # (b) The MoE transformer at data 1 x model 2 x expert 2.
        model, _ = _param_tree(dev, "transformer", "f32",
                               num_experts=EP_EXPERTS)
        inputs = ([random_batch(i, dev) for i in range(DP_UPDATES)],
                  _agent_state(model, "transformer", dev))
        del model
        want = _ep_path(dev, "f32", None, inputs)
        counts, got, ms = check_ep_path(ops, dev, "f32", TP_EP_LAYOUT,
                                        want, inputs, TP_EP_KERNELS)
        by_path["MoE data 1 x model 2 x expert 2 update"] = counts
        del want, got, inputs
        torch.cuda.empty_cache()
        # (c) PP against the sequential tower, the kernels against their
        # plain versions, acting.
        mesh = parallel.create_mesh(devices=[dev] * 2, pipe_parallelism=2)
        for label, name, depth, microbatches in PP_PATHS:
            by_path[f"PP {label} update"] = check_pp_path(
                ops, dev, mesh, label, name, depth, microbatches)
            torch.cuda.empty_cache()
        for name, depth in (("pipelined_mlp", {"num_stages": 2}),
                            ("pipelined_transformer", {})):
            model, _ = _param_tree(dev, name, **depth)
            parallel.set_pipeline(model, mesh, None)
            check_update_parity(ops, dev, f"{name} pipe 2", model,
                                _agent_state(model, name, dev))
            del model
        check_pp_acting(dev, mesh)
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        # The drivers: monobeast PP, polybeast TP on both runtimes and
        # data x pipe on the core, at the training settings.
        for label, args in PP_DRIVER_ARGS:
            by_path[label] = run_main_path(ops, savedir, (
                label, args, PIPELINED_KERNELS, "f32", TP_PP_UPDATES))
        for data, model_par in TP_LAYOUTS:
            for native in (False, True):
                by_path.update(run_poly_parallel(
                    ops, savedir,
                    f"polybeast transformer data {data} x model "
                    f"{model_par} {'core' if native else 'Python pool'}",
                    ["--model", "transformer"],
                    ["--tensor_parallel", str(model_par),
                     "--num_learner_devices", str(data)], native, data))
        # The sharded run's checkpoint, resumed on one device.
        by_path.update(run_poly_parallel(
            ops, savedir, "polybeast transformer one device Python pool, "
            "resuming data 1 x model 2 core", ["--model", "transformer"],
            [], False, 1, line="Resuming preempted job",
            resume="polybeast transformer data 1 x model 2 core"))
        by_path.update(run_poly_parallel(
            ops, savedir, "polybeast transformer data 1 x model 2 x expert "
            "2 core", ["--model", "transformer"],
            ["--tensor_parallel", "2", "--num_experts", "4",
             "--expert_parallel", "2"], True, 1))
        by_path.update(run_poly_parallel(
            ops, savedir, "polybeast transformer model 2 coordinator_address"
            " (NCCL group of one) core", ["--model", "transformer"],
            ["--tensor_parallel", "2", "--coordinator_address",
             f"127.0.0.1:{_free_tcp_port()}"], True, 1))
        by_path.update(run_poly_parallel(
            ops, savedir, "polybeast pipelined_transformer data 2 x pipe 2 "
            "core", PP_TRANSFORMER_ARGS,
            ["--num_learner_devices", "2", "--pipeline_parallel", "2"],
            True, 2))
    finally:
        parallel.visible_devices = visible
        torch.backends.cudnn.deterministic = False
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    print(f"phase 12 (tensor and pipeline parallel): "
          f"{time.time() - t0:.1f} s")
    return by_path


# ----------------------------------------------------------------- phase 13

# The sequence-parallel paths' unroll: T + 1 = 80 steps divide by the
# ring's P (2 and 4), the zigzag's 2P and, with the 4 heads, Ulysses'.
SP_T = 79
SP_OP_P = (2, 4)
# The ops against the dense path on the card (TF32 off): the online
# softmax adds and rescales in another order than one softmax.
SP_OP_RTOL, SP_OP_ATOL = 1e-4, 2e-5
SP_GRAD_RTOL, SP_GRAD_ATOL = 1e-3, 1e-4
# monobeast's SP updates: (label, schedule, strategy, experts).
SP_PATHS = (
    ("seq 2 ring", "contiguous", "ring", 0),
    ("seq 2 zigzag ring", "zigzag", "ring", 0),
    ("seq 2 Ulysses", "contiguous", "ulysses", 0),
    ("seq 2 x expert 2 ring", "contiguous", "ring", EP_EXPERTS),
)
SP_KERNELS = {"vtrace_targets": 1, "rmsprop_tail": 1}  # an update
# monobeast's SP paths through its parser: (label, flags beyond --model
# transformer --sequence_parallel 2, the blocks' path).
SP_DRIVER_ARGS = (
    ("ring", [], "ring"),
    ("zigzag ring", ["--ring_schedule", "zigzag"], "ring"),
    ("Ulysses", ["--sp_strategy", "ulysses"], "ulysses"),
    ("x expert_parallel 2 ring", ["--num_experts", str(EP_EXPERTS),
                                  "--expert_parallel", "2"], "ring"),
)
# The fleet's hosts: Mock frames, mlp + LSTM, 4 env servers a host.
FLEET_ARGS = ["--env", "Mock", "--model", "mlp", "--use_lstm",
              "--num_servers", "4", "--batch_size", "8", "--unroll_length",
              "20", "--vtrace_impl", "pallas", "--opt_impl", "xla",
              "--num_inference_threads", "1", "--max_inference_batch_size",
              "4", "--replica_refresh_updates", "1", "--max_policy_lag",
              "20", "--checkpoint_interval_s", "100000",
              "--no_native_runtime"]
FLEET_UPDATES = 8
FLEET_LONG_STEPS = 10 ** 7  # a run the smoke ends itself (SIGTERM)
# How long the lead of a gloo group whose remote is killed is watched.
FLEET_GROUP_LOSS_S = 60.0


def sp_op_inputs(dev, seed=0):
    """The transformer's attention inputs at the learner shape over
    T = SP_T + 1 steps (B=32, H=4, D=32, M=64): q, k, v, the cache, the
    relative bias, segments, the cache mask, the dense mask and offsets,
    a cotangent."""
    from torchbeast_tpu_torch.ops import attention

    t, M = SP_T + 1, MEMORY
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    x = {name: normal(B, t, HEADS, HEAD_DIM) for name in ("q", "k", "v",
                                                          "ct")}
    x["cache_k"], x["cache_v"] = (normal(B, M, HEADS, HEAD_DIM)
                                  for _ in range(2))
    x["rel_bias"] = normal(HEADS, M + 1)
    done = torch.from_numpy(rng.random((t, B)) < 0.05).to(dev)
    seg = attention.segment_ids_from_done(done).t().contiguous()
    valid = torch.from_numpy((rng.random((B, M)) < 0.7).astype(
        np.float32)).to(dev)
    no_done = seg == 0
    band, offsets = attention.band_relative_offsets(t, M, device=dev)
    cache_mask = (band[None, :, :M] & (valid != 0)[:, None, :]
                  & no_done[:, :, None])
    same = seg[:, :, None] == seg[:, None, :]
    x.update(seg=seg, cache_mask=cache_mask, offsets=offsets,
             mask=torch.cat([cache_mask, band[None, :, M:] & same], -1))
    return x


def check_sp_ops(dev):
    """(a) Ring (contiguous and zigzag) and Ulysses, plain and transformer
    variants, at P = 2 and 4 with every seq device `dev`: forward and the
    gradients of a fixed cotangent against the dense path, each one's
    forward ms beside the dense path's."""
    from torchbeast_tpu_torch.ops import attention as at

    x = sp_op_inputs(dev)
    plain_in, tf_in = ("q", "k", "v"), ("q", "k", "v", "cache_k",
                                        "cache_v", "rel_bias")

    def dense_plain(q, k, v):
        return at.causal_attention(q, k, v, x["seg"])

    def dense_tf(q, k, v, ck, cv, rb):
        return at.dense_transformer_attend(
            q, torch.cat([ck, k], 1), torch.cat([cv, v], 1), x["mask"],
            x["offsets"], rb)

    def grads(fn, names):
        xs = [x[n].detach().clone().requires_grad_(True) for n in names]
        out = fn(*xs)
        (out * x["ct"]).sum().backward()
        return out.detach(), [t.grad for t in xs]

    def ms(fn, names):
        with torch.no_grad():
            return time_ms(lambda: fn(*(x[n] for n in names)), reps=10)

    refs = {"plain": (grads(dense_plain, plain_in),
                      ms(dense_plain, plain_in)),
            "transformer": (grads(dense_tf, tf_in), ms(dense_tf, tf_in))}
    for P in SP_OP_P:
        devs = [dev] * P
        cases = (
            ("plain", "ring", plain_in,
             lambda q, k, v: at.ring_attention(q, k, v, devs, x["seg"])),
            ("plain", "zigzag ring", plain_in,
             lambda q, k, v: at.ring_attention(q, k, v, devs, x["seg"],
                                               schedule="zigzag")),
            ("plain", "Ulysses", plain_in,
             lambda q, k, v: at.ulysses_attention(q, k, v, devs, x["seg"])),
            ("transformer", "ring", tf_in,
             lambda q, k, v, ck, cv, rb: at.ring_transformer_attention(
                 q, k, v, ck, cv, x["cache_mask"], rb, MEMORY, x["seg"],
                 devs)),
            ("transformer", "zigzag ring", tf_in,
             lambda q, k, v, ck, cv, rb: at.ring_transformer_attention(
                 q, k, v, ck, cv, x["cache_mask"], rb, MEMORY, x["seg"],
                 devs, schedule="zigzag")),
            ("transformer", "Ulysses", tf_in,
             lambda q, k, v, ck, cv, rb: at.ulysses_transformer_attention(
                 q, k, v, ck, cv, x["mask"], x["offsets"], rb, devs)),
        )
        for kind, name, names, fn in cases:
            label = f"phase 13 (a) {kind} {name} P={P}"
            (want, want_g), dense_ms = refs[kind]
            out, got_g = grads(fn, names)
            err, ok = close(out, want, SP_OP_RTOL, SP_OP_ATOL)
            check(ok, f"{label}: forward max |diff| {err:.3g}")
            gerr = 0.0
            for n, g, w in zip(names, got_g, want_g):
                e, ok = close(g, w, SP_GRAD_RTOL, SP_GRAD_ATOL)
                check(ok, f"{label}: d{n} max |diff| {e:.3g}")
                gerr = max(gerr, e)
            print(f"{label} B={B} T={SP_T + 1} H={HEADS} D={HEAD_DIM} "
                  f"M={MEMORY}, every seq device {dev}: forward max |diff| "
                  f"{err:.3g} (rtol {SP_OP_RTOL}, atol {SP_OP_ATOL}), "
                  f"gradients {gerr:.3g} (rtol {SP_GRAD_RTOL}, atol "
                  f"{SP_GRAD_ATOL}) against the dense path; forward "
                  f"{ms(fn, names):.4f} ms, dense {dense_ms:.4f} ms")


def _sp_hp():
    """monobeast's SP learner: V-trace's kernel and the fused tail, the LR
    decay and the entropy anneal moving, RMSprop eps 1.0 (phase 9's)."""
    from torchbeast_tpu_torch import learner as learner_lib

    return learner_lib.HParams(unroll_length=SP_T, batch_size=B,
                               vtrace_impl="pallas", opt_impl="pallas",
                               total_steps=20 * SP_T * B,
                               entropy_cost_final=1e-4, rmsprop_eps=DP_EPS)


def _sp_model(dev, experts):
    """monobeast's transformer at full width (dense attention; with
    `experts` the MoE FFN), seed 0's weights."""
    from torchbeast_tpu_torch.models import create_model

    torch.manual_seed(0)
    return create_model("transformer", NUM_ACTIONS, **(
        {"num_experts": experts} if experts else {})).to(dev)


def _sp_inputs(dev, model):
    """DP_UPDATES random batches of SP_T + 1 steps and a random cache."""
    batches = [{k: v[:SP_T + 1].contiguous()
                for k, v in random_batch(i, dev).items()}
               for i in range(DP_UPDATES)]
    return batches, random_cache(model, 0, dev)


def _sp_one_device(dev, experts):
    """The one-device update (one CUDA graph) on the SP inputs: (params
    after DP_UPDATES updates, stats, update ms, inputs)."""
    from torchbeast_tpu_torch import learner as learner_lib

    one = _sp_model(dev, experts)
    inputs = _sp_inputs(dev, one)
    dispatch = learner_lib.make_update_dispatch(
        one, learner_lib.make_optimizer(_sp_hp(), list(one.parameters())),
        _sp_hp())
    dispatch.capture(inputs[0][0], inputs[1])
    stats = _dp_run(dispatch, *inputs)
    want = copy.deepcopy(one)
    ms = time_ms(lambda: dispatch(inputs[0][0], inputs[1]), reps=10)
    return want, stats, ms, inputs


def check_sp_update(ops, dev, label, schedule, strategy, experts, want):
    """(b) monobeast's SP update over seq devices [dev, dev] (with
    `experts`, expert devices [dev, dev] too) against the one-device
    update `want`: params within phase 9's tolerance, total_loss within
    DP_LOSS_RTOL, one CUDA graph an update, V-trace and the tail once an
    update and held against their plain versions on that update, the
    update ms beside one device's. Returns its launch counts."""
    from torchbeast_tpu_torch import graphs
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import parallel
    from torchbeast_tpu_torch.models.transformer import set_seq_devices

    name, label = label, f"phase 13 (b) monobeast {label}"
    want_model, want_stats, one_ms, (batches, state) = want
    model = _sp_model(dev, experts)
    set_seq_devices(model, [dev, dev], schedule, strategy)
    if experts:
        parallel.set_expert_devices(model, [dev, dev])
    check(model.block_0._sequence_parallel(SP_T + 1, HEADS) == strategy,
          f"{label}: the block does not take the {strategy} path")
    opt = learner_lib.make_optimizer(_sp_hp(), list(model.parameters()))
    dispatch = learner_lib.make_update_dispatch(model, opt, _sp_hp())
    check(isinstance(dispatch, graphs.CapturedUpdate),
          f"{label}: not a CUDA graph")
    dispatch.capture(batches[0], state)
    ops.reset_launch_counts()
    got = _dp_run(dispatch, batches, state)
    counts, bf16 = ops.launch_counts(), ops.bf16_launch_counts()
    for w, n in SP_KERNELS.items():
        check(counts[w] == n * DP_UPDATES,
              f"{label}: {counts[w]} {w} launches in {DP_UPDATES} updates")
    worst = _compare_params(label, model, want_model)
    loss_err, ok = close(got["total_loss"], want_stats["total_loss"],
                         DP_LOSS_RTOL, 0.0)
    check(ok, f"{label}: total_loss {got['total_loss'].tolist()} vs "
              f"{want_stats['total_loss'].tolist()}")
    ms = time_ms(lambda: dispatch(batches[0], state), reps=10)
    print(f"{label} T={SP_T} B={B}: seq devices {[dev, dev]}, "
          f"{DP_UPDATES} updates in one CUDA graph each against one device, "
          f"RMSprop eps {DP_EPS}: params within rtol {DP_PARAMS_RTOL} / "
          f"atol {DP_PARAMS_ATOL} (largest difference {worst:.3g} of a "
          f"leaf's largest entry), total_loss within rtol {DP_LOSS_RTOL} "
          f"(max |diff| {loss_err:.3g}); launches an update "
          f"{ {w: counts[w] // DP_UPDATES for w in SP_KERNELS} }; update "
          f"{ms:.3f} ms, one device {one_ms:.3f} ms")
    check_update_parity(ops, dev, f"monobeast {name}", model, state,
                        batch=batches[0])
    return counts, bf16


def run_sp_driver(ops, dev, savedir, label, extra, strategy):
    """(b) monobeast.train from its parser with --model transformer
    --sequence_parallel 2 and `extra` at --unroll_length SP_T, V-trace and
    the tail on (run_main_path, its counts reset just before the run):
    the driver's own seq mesh over [dev, dev] (its log line), every block
    taking `strategy` at SP_T + 1 steps, the update one CUDA graph that
    launches V-trace and the tail once a replay. Returns the counts."""
    from torchbeast_tpu_torch import graphs
    from torchbeast_tpu_torch import learner as learner_lib
    from torchbeast_tpu_torch import monobeast

    built, dispatches = [], []
    build_model = monobeast.build_model
    make_dispatch = learner_lib.make_update_dispatch

    def keep_model(*args, **kwargs):
        built.append(build_model(*args, **kwargs))
        return built[-1]

    def keep_dispatch(*args, **kwargs):
        dispatches.append(make_dispatch(*args, **kwargs))
        return dispatches[-1]

    lines = _Lines()
    logger = logging.getLogger("torchbeast_tpu_torch")
    logger.addHandler(lines)
    logger.setLevel(logging.INFO)
    monobeast.build_model = keep_model
    learner_lib.make_update_dispatch = keep_dispatch
    try:
        counts = run_main_path(ops, savedir, (
            label, ["--model", "transformer", "--sequence_parallel", "2",
                    *extra], tuple(SP_KERNELS), "f32", TP_PP_UPDATES),
            unroll=SP_T)
    finally:
        monobeast.build_model = build_model
        learner_lib.make_update_dispatch = make_dispatch
        logger.removeHandler(lines)
    sp_line = [text for text in lines.lines
               if text.startswith("Sequence parallel")]
    check(sp_line, f"{label}: no sequence-parallel line")
    blocks = [getattr(built[0], f"block_{i}")
              for i in range(built[0].num_layers)]
    check(all(b.seq_devices == [dev, dev]
              and b._sequence_parallel(SP_T + 1, HEADS) == strategy
              for b in blocks),
          f"{label}: the blocks do not take the {strategy} path over "
          f"{[dev, dev]}")
    update = dispatches[0]
    check(isinstance(update, graphs.CapturedUpdate)
          and update._graph is not None
          and all(update.launches_per_replay.get(w) == n
                  for w, n in SP_KERNELS.items()),
          f"{label}: the update is not one CUDA graph launching "
          f"{SP_KERNELS} ({getattr(update, 'launches_per_replay', None)})")
    print(f"{label}: {sp_line[0]}; every block {strategy} at T+1 = "
          f"{SP_T + 1}; the update one CUDA graph, launches a replay "
          f"{ {w: update.launches_per_replay[w] for w in SP_KERNELS} }")
    return counts


def _fleet_argv(savedir, xpid, rank, hosts, port, total_steps,
                min_live_hosts=1):
    return FLEET_ARGS + [
        "--batch_size", str(4 * hosts),  # 4 rows a host
        "--savedir", savedir, "--xpid", xpid, "--total_steps",
        str(total_steps), "--min_live_hosts", str(min_live_hosts),
        "--pipes_basename", f"unix:{savedir}/{xpid}-pipes",
        "--fleet", f"host={rank}/{hosts},coord=127.0.0.1:{port}"]


@contextlib.contextmanager
def _gloo_group(flags):
    """The process group of `flags.fleet` (its rendezvous address, the
    host count as world size, the host rank) in gloo, for the block:
    polybeast takes a joined group of the fleet's size as it finds it.
    Two hosts on one card need it: NCCL refuses two ranks on one GPU."""
    from torchbeast_tpu_torch import parallel
    from torchbeast_tpu_torch.fleet import parse_fleet_spec

    spec = parse_fleet_spec(flags.fleet)
    parallel.initialize_distributed(spec.coord_address, spec.num_hosts,
                                    spec.host_rank, backend="gloo")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def fleet_host_worker(config) -> int:
    """One fleet host of phase 13 (d) (`chip_smoke.py --fleet-host
    <json>`): polybeast.train with the config's argv under its strategy
    ("gloo": the process-group strategy in a gloo group joined first;
    "nccl": the driver's own NCCL group; "wire": the wire strategy, by
    this worker's choice, on the card), SIGTERM a checkpoint-and-exit.
    Its last line is one JSON object: step, health, reasons, a digest of
    the learner's params, the fleet counters, or the error."""
    import hashlib

    cfg = json.loads(config)
    from torchbeast_tpu_torch import monobeast, parallel, polybeast
    from torchbeast_tpu_torch import telemetry
    from torchbeast_tpu_torch.utils import install_preemption_handler

    built = []
    build_model = monobeast.build_model

    def capture(*args, **kwargs):
        model = build_model(*args, **kwargs)
        built.append(model)
        return model

    monobeast.build_model = capture
    if cfg["strategy"] == "wire":
        parallel.fleet_strategy = lambda device: "wire"
    polybeast._configure_logging()
    install_preemption_handler()
    flags = polybeast.make_parser().parse_args(cfg["argv"])
    out = {"rank": cfg["rank"]}
    try:
        if cfg["strategy"] == "gloo":
            with _gloo_group(flags):
                stats = polybeast.train(flags)
        else:
            stats = polybeast.train(flags)
    except Exception as e:  # noqa: BLE001  reported, the smoke decides
        out["error"] = f"{type(e).__name__}: {e}"
        if e.__cause__ is not None:
            out["error"] += (f" (from {type(e.__cause__).__name__}: "
                             f"{str(e.__cause__)[:300]})")
        print(json.dumps(out))
        return 1
    digest = hashlib.sha256()
    for p in built[0].parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    reg = telemetry.get_registry()
    out.update(step=int(stats["step"]), health=stats["health"],
               reasons=[r for _, r in stats.get("health_reasons") or []],
               params=digest.hexdigest(), updates=int(stats["updates"]),
               sps=float(stats["sps"]), counters={
                   name: reg.counter(name).value() for name in (
                       "fleet.param_syncs", "fleet.snapshots_received",
                       "fleet.snapshots_stale_dropped",
                       "fleet.heartbeats_received")})
    print(json.dumps(out))
    return 0


def fleet_chaos_worker(savedir, out) -> int:
    """Phase 13 (d)'s chaos lane (`chip_smoke.py --fleet-chaos <savedir>
    <out>`): chaos_run --selftest --hosts 2, its remote a `--fleet-host`
    process and its lead in a gloo group both hosts join first."""
    from torchbeast_tpu_torch import chaos_run

    def remote(argv):
        return [sys.executable, os.path.abspath(__file__), "--fleet-host",
                json.dumps({"rank": 1, "strategy": "gloo", "argv": argv})]

    return chaos_run.main(["--selftest", "--hosts", "2", "--savedir",
                           savedir, "--out", out], remote_command=remote,
                          lead_context=_gloo_group)


class _FleetRun:
    """The hosts of one fleet run of phase 13 (d), each a `chip_smoke.py
    --fleet-host` process of its own session, the remotes started first;
    their output under savedir."""

    def __init__(self, savedir, xpid, hosts, strategy, total_steps,
                 min_live_hosts=1):
        from torchbeast_tpu_torch import chaos_run

        shutil.rmtree(os.path.join(savedir, xpid), ignore_errors=True)
        port = chaos_run._free_coord_port()
        self.logs, self.procs = {}, {}
        for rank in reversed(range(hosts)):
            cfg = {"rank": rank, "strategy": strategy, "argv": _fleet_argv(
                savedir, xpid, rank, hosts, port, total_steps,
                min_live_hosts)}
            self.logs[rank] = os.path.join(savedir, f"{xpid}-{rank}.log")
            with open(self.logs[rank], "w") as f:
                self.procs[rank] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--fleet-host", json.dumps(cfg)], stdout=f,
                    stderr=subprocess.STDOUT, cwd=ROOT,
                    start_new_session=True)

    def text(self, rank):
        with open(self.logs[rank]) as f:
            return f.read()

    def wait_for(self, rank, marker, timeout_s):
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if marker in self.text(rank):
                return True
            if self.procs[rank].poll() is not None:
                return marker in self.text(rank)
            time.sleep(0.2)
        return False

    def signal(self, rank, sig):
        try:
            os.killpg(self.procs[rank].pid, sig)
        except ProcessLookupError:
            pass

    def finish(self, timeout_s):
        """{rank: the host's JSON line, or None}; every process ended."""
        import signal as signals

        deadline = time.time() + timeout_s
        results = {}
        for rank, p in self.procs.items():
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                self.signal(rank, signals.SIGKILL)
                p.wait()
            self.signal(rank, signals.SIGKILL)  # its env servers
            lines = [line for line in self.text(rank).splitlines()
                     if line.startswith('{"rank"')]
            results[rank] = json.loads(lines[-1]) if lines else None
        return results


def check_snapshot_wire_on_card(dev):
    """The lead's snapshot of CUDA params through the wire into a remote
    store on the card: latest_on serves the bits of a local publish."""
    from torchbeast_tpu_torch.fleet import apply_snapshot, build_snapshot
    from torchbeast_tpu_torch.runtime import wire
    from torchbeast_tpu_torch.serving import PolicySnapshotStore

    model = _sp_model(dev, 0)
    local = PolicySnapshotStore(1)
    local.publish(3, list(model.parameters()))
    remote = PolicySnapshotStore(1)
    snap = wire.decode(wire.encode(build_snapshot(3, model))[4:])
    check(apply_snapshot(remote, snap, template=model),
          "phase 13 (d) snapshot not applied")
    a, b = local.latest_on(dev)[1], remote.latest_on(dev)[1]
    check(all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
              for x, y in zip(a, b)),
          "phase 13 (d) the wire snapshot differs from a local publish")
    print(f"phase 13 (d) snapshot wire on the card: {len(snap.params)} "
          f"leaves, the remote store's tensors on {dev} bitwise a local "
          f"publish's")


def run_fleet_phases(ops, dev, savedir):
    """(d) The fleet: a one-host fleet over NCCL (in process), two hosts
    in a gloo group on the card (equal params, snapshots served), two in
    the driver's NCCL group (its error recorded), host loss above and
    below --min_live_hosts (wire strategy) and in the gloo group (the
    lead's outcome measured), and chaos_run --hosts 2. Returns the
    in-process path's launch counts."""
    import signal as signals

    by_path = run_poly_parallel(
        ops, savedir, "polybeast transformer fleet host=0/1 (NCCL group of "
        "one) core", ["--model", "transformer"],
        ["--fleet", f"host=0/1,coord=127.0.0.1:{_free_tcp_port()}"], True, 1)
    check_snapshot_wire_on_card(dev)
    steps = FLEET_UPDATES * 20 * 8
    # Two hosts in a gloo group, and beside them two in the driver's
    # NCCL group (one card, two ranks).
    t0 = time.time()
    gloo = _FleetRun(savedir, "fleet_gloo", 2, "gloo", steps)
    nccl = _FleetRun(savedir, "fleet_nccl", 2, "nccl", steps)
    res = gloo.finish(240)
    label = "phase 13 (d) two-host fleet, gloo group, learners on cuda:0"
    check(all(r and "error" not in r for r in res.values()),
          f"{label}: {res}")
    lead, remote = res[0], res[1]
    check(lead["params"] == remote["params"],
          f"{label}: the hosts' params differ")
    check(lead["health"] == remote["health"] == "HEALTHY",
          f"{label}: health {lead['health']} / {remote['health']}")
    check(remote["counters"]["fleet.snapshots_received"] > 0
          and remote["counters"]["fleet.snapshots_stale_dropped"] == 0,
          f"{label}: snapshots {remote['counters']}")
    check(os.path.exists(os.path.join(savedir, "fleet_gloo", "model.ckpt")),
          f"{label}: no checkpoint")
    print(f"{label}: {lead['updates']} updates each, params equal "
          f"(sha256 {lead['params'][:16]}), the remote applied "
          f"{remote['counters']['fleet.snapshots_received']:.0f} snapshots, "
          f"heartbeats {lead['counters']['fleet.heartbeats_received']:.0f};"
          f" SPS {lead['sps']:.1f} / {remote['sps']:.1f}; "
          f"{time.time() - t0:.1f} s")
    res = nccl.finish(120)
    outcome = {r: (v or {}).get("error", (v or {}).get("health"))
               for r, v in res.items()}
    print(f"phase 13 (d) two-host fleet, the driver's NCCL group on one "
          f"card, beside the gloo one: {outcome}; {time.time() - t0:.1f} s")
    # Host loss, the wire strategy (chosen by the worker): above the
    # floor the lead degrades; three hosts below it halt. Beside them the
    # process-group strategy in the gloo group, its remote killed: what
    # the lead does, and when, is measured and not held to a verdict.
    t0 = time.time()
    above = "phase 13 (d) remote killed, --min_live_hosts 1"
    below = "phase 13 (d) remote killed, --min_live_hosts 3"
    in_group = "phase 13 (d) remote killed in the gloo group"
    grouped = _FleetRun(savedir, "fleet_gloo_loss", 2, "gloo",
                        FLEET_LONG_STEPS)
    loss = _FleetRun(savedir, "fleet_loss", 2, "wire", FLEET_LONG_STEPS)
    halt = _FleetRun(savedir, "fleet_halt", 3, "wire", FLEET_LONG_STEPS,
                     min_live_hosts=3)
    check(grouped.wait_for(1, "Step ", 120),
          f"{in_group}: the remote never ran")
    grouped.signal(1, signals.SIGKILL)
    killed_at = time.time()
    lead_exit = []
    threading.Thread(target=lambda: lead_exit.append(
        (grouped.procs[0].wait(), time.time())), daemon=True).start()
    check(loss.wait_for(1, "Step ", 120), f"{above}: the remote never ran")
    loss.signal(1, signals.SIGKILL)
    check(halt.wait_for(2, "Step ", 120), f"{below}: host 2 never ran")
    halt.signal(2, signals.SIGKILL)
    check(loss.wait_for(0, "LOST", 60), f"{above}: the lead saw no loss")
    time.sleep(1.0)
    loss.signal(0, signals.SIGTERM)
    lead = loss.finish(120)[0]
    check(lead and "error" not in lead and lead["health"] == "DEGRADED"
          and any(r.startswith("fleet.host1_lost")
                  for r in lead["reasons"]), f"{above}: {lead}")
    check(os.path.exists(os.path.join(savedir, "fleet_loss", "model.ckpt")),
          f"{above}: no checkpoint")
    print(f"{above}: the lead DEGRADED, sticky {lead['reasons']}, "
          f"{lead['updates']} updates, checkpointed")
    res = halt.finish(120)
    check(all(res[r] and res[r].get("health") == "HALTED" for r in (0, 1)),
          f"{below}: {res}")
    check(os.path.exists(os.path.join(savedir, "fleet_halt", "model.ckpt")),
          f"{below}: no checkpoint")
    print(f"{below}: the lead and host 1 HALTED ({res[0]['reasons'][-1]}), "
          f"the lead checkpointed; both legs {time.time() - t0:.1f} s")
    deadline = killed_at + FLEET_GROUP_LOSS_S
    while not lead_exit and time.time() < deadline:
        time.sleep(0.1)
    lead = grouped.finish(5)[0] or {}
    log_tail = [text for text in grouped.text(0).splitlines()
                if "LOST" in text or "health ->" in text][-2:]
    if lead_exit:
        outcome = lead.get("error") or (
            f"{lead.get('health')} {lead.get('reasons')}")
        print(f"{in_group}: the lead exited rc {lead_exit[0][0]} "
              f"{lead_exit[0][1] - killed_at:.1f} s after the kill: "
              f"{outcome}; its fleet log lines {log_tail}")
    else:
        print(f"{in_group}: the lead had not exited "
              f"{FLEET_GROUP_LOSS_S:.0f} s after the kill (SIGKILLed); "
              f"its fleet log lines {log_tail}")
    # The chaos lane across two hosts, in a gloo group on the card.
    t0 = time.time()
    out = os.path.join(savedir, "chaos_fleet.json")
    chaos_dir = os.path.join(savedir, "chaos_fleet")
    shutil.rmtree(chaos_dir, ignore_errors=True)
    os.makedirs(chaos_dir)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--fleet-chaos",
         chaos_dir, out], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    check(proc.returncode == 0 and os.path.exists(out),
          f"chaos_run --hosts 2: rc {proc.returncode}\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    with open(out) as f:
        verdict = json.load(f)
    lead = verdict["results"]["lead"]
    counters = {k: v for k, v in
                verdict["results"]["remote"]["counters"].items()
                if v and not k.startswith("fleet.")}
    print(f"phase 13 (d) chaos_run --selftest --hosts 2, both hosts in a "
          f"gloo group: ok {verdict['ok']}, fleet {verdict['fleet']}, the "
          f"lead {lead['health']} "
          f"({[r for _, r in lead['health_reasons']]}), the remote's "
          f"counters {counters}; {time.time() - t0:.1f} s")
    return by_path


def run_sp_fleet_phases(ops, dev, savedir, tf32):
    """Phase 13 (--sp-fleet-only alone after the builds): with the
    drivers' device list replaced by [cuda:0] * 4 and restored after,
    (a) the sequence-parallel ops, (b) monobeast's SP updates and the
    driver's SP runs, (c) polybeast's seq mesh alone and data 2 x seq 2
    on both runtimes; then, on the machine's
    own devices, (d) the fleet. Returns the paths' launch counts."""
    from torchbeast_tpu_torch import parallel

    t0 = time.time()
    print(f"phase 13: {card_line()}")
    by_path = {}
    visible = parallel.visible_devices
    parallel.visible_devices = lambda platform=None: [dev] * 4
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        check_sp_ops(dev)
        torch.cuda.empty_cache()
        wants = {}
        for label, schedule, strategy, experts in SP_PATHS:
            if experts not in wants:
                wants[experts] = _sp_one_device(dev, experts)
            by_path[f"SP monobeast {label} update"] = check_sp_update(
                ops, dev, label, schedule, strategy, experts, wants[experts])
            torch.cuda.empty_cache()
        del wants
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = False
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        # The drivers at the training settings: monobeast's 1-D seq mesh
        # (and seq x expert) from its parser, polybeast's seq mesh alone
        # on the core and data 2 x seq 2 on both runtimes.
        for label, extra, strategy in SP_DRIVER_ARGS:
            label = f"monobeast transformer sequence_parallel 2 {label}"
            by_path[label] = run_sp_driver(ops, dev, savedir, label, extra,
                                           strategy)
        by_path.update(run_poly_parallel(
            ops, savedir, "polybeast transformer sequence_parallel 2 core",
            ["--model", "transformer"],
            ["--sequence_parallel", "2", "--unroll_length", str(SP_T)],
            True, 1, tail=True, line="Sequence parallel"))
        for native in (False, True):
            by_path.update(run_poly_parallel(
                ops, savedir, f"polybeast transformer data 2 x seq 2 "
                f"{'core' if native else 'Python pool'}",
                ["--model", "transformer"],
                ["--sequence_parallel", "2", "--num_learner_devices", "2",
                 "--unroll_length", str(SP_T)], native, 2))
    finally:
        parallel.visible_devices = visible
        torch.backends.cudnn.deterministic = False
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    # The fleet's hosts see the machine's devices: one card here.
    by_path.update(run_fleet_phases(ops, dev, savedir))
    torch.cuda.empty_cache()
    print(f"phase 13 (sequence parallel and the fleet): "
          f"{time.time() - t0:.1f} s")
    return by_path


def tally_launches(kernels, by_path):
    """Each kernel row's launches on the main paths, by path and in all
    (a bf16 row counts its variant's launches; an f32 row the rest)."""
    for k in kernels:
        wrapper = k.get("wrapper", k["name"])
        k["launches_by_path"] = {
            p: (bf16.get(wrapper, 0) if k.get("bf16")
                else counts[wrapper] - bf16.get(wrapper, 0))
            for p, (counts, bf16) in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())


def main(argv):
    kernels_only = argv == ["--kernels-only"]
    vtrace_only = argv == ["--vtrace-only"]
    serving_only = argv == ["--serving-only"]
    impact_only = argv == ["--impact-only"]
    remat_only = argv == ["--remat-only"]
    anakin_only = argv == ["--anakin-only"]
    pipelined_only = argv == ["--pipelined-only"]
    dp_only = argv == ["--dp-only"]
    ep_only = argv == ["--ep-only"]
    split_only = argv == ["--split-only"]
    tp_pp_only = argv == ["--tp-pp-only"]
    sp_fleet_only = argv == ["--sp-fleet-only"]
    v2lite_tail_only = argv == ["--v2lite-tail-only"]
    if len(argv) == 2 and argv[0] == "--fleet-host":
        return fleet_host_worker(argv[1])
    if len(argv) == 3 and argv[0] == "--fleet-chaos":
        return fleet_chaos_worker(argv[1], argv[2])
    if argv and not (kernels_only or vtrace_only or serving_only
                     or impact_only or remat_only or anakin_only
                     or pipelined_only or dp_only or ep_only or split_only
                     or tp_pp_only or sp_fleet_only or v2lite_tail_only):
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
    if v2lite_tail_only:
        print(json.dumps({"kernels": [
            check_opt(ops, dev, "deepseek_v2_lite")]}))
        return 0
    if impact_only:
        run_impact_phases(ops, dev, savedir, tf32)
        return 0
    if remat_only:
        run_remat_phases(ops, dev, savedir, tf32)
        return 0
    if anakin_only:
        row, by_path = run_anakin_phases(ops, dev, savedir, tf32)
        tally_launches([row], by_path)
        print(json.dumps({"kernels": [row]}))
        return 0
    if pipelined_only:
        rows, by_path = run_pipelined_phases(ops, dev, savedir, tf32)
        tally_launches(rows, by_path)
        print(json.dumps({"kernels": rows}))
        return 0
    if dp_only:
        by_path = run_dp_phases(ops, dev, savedir, tf32)
        print(json.dumps({"dp_launches": {
            path: counts for path, (counts, _) in by_path.items()}}))
        return 0
    if ep_only:
        by_path = run_ep_phases(ops, dev, savedir, tf32)
        print(json.dumps({"ep_launches": {
            path: counts for path, (counts, _) in by_path.items()}}))
        return 0
    if split_only:
        by_path = run_split_phases(ops, dev, savedir, tf32)
        print(json.dumps({"split_launches": {
            path: counts for path, (counts, _) in by_path.items()}}))
        return 0
    if tp_pp_only:
        by_path = run_tp_pp_phases(ops, dev, savedir, tf32)
        print(json.dumps({"tp_pp_launches": {
            path: counts for path, (counts, _) in by_path.items()}}))
        return 0
    if sp_fleet_only:
        by_path = run_sp_fleet_phases(ops, dev, savedir, tf32)
        print(json.dumps({"sp_fleet_launches": {
            path: counts for path, (counts, _) in by_path.items()}}))
        return 0
    kernels = [check_vtrace(ops, dev), check_opt(ops, dev, "deep"),
               check_opt(ops, dev, "transformer"), check_pool(ops, dev),
               *check_attention(ops, dev),
               check_opt(ops, dev, "deep", "bf16_train"),
               check_opt(ops, dev, "transformer", "bf16_train"),
               check_pool(ops, dev, BF16), *check_attention(ops, dev, BF16),
               check_lstm(ops, dev), check_opt(ops, dev, "deepseek_v2_lite")]
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
        check_graph_update(dev, "deep+LSTM", "deep", "f32", k, impact=True)
        torch.cuda.empty_cache()
    check_graph_target(dev)
    check_graph_acting(dev)
    check_graph_replica(dev)
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32

    by_path = run_remat_phases(ops, dev, savedir, tf32)
    by_path.update({path[0]: run_main_path(ops, savedir, path)
                    for path in PATHS})
    time_impact_update(dev)
    by_path.update(run_polybeast(ops, savedir))
    by_path.update(run_polybeast(ops, savedir, native=True))
    by_path.update(run_polybeast(ops, savedir, k=2))
    for native in (False, True):
        by_path.update(run_polybeast_impact(ops, savedir, native))
    for native in (False, True):
        by_path.update(run_polybeast_chaos(ops, savedir, native))
    check_checkpoint_round_trip(dev)
    row, anakin_paths = run_anakin_phases(ops, dev, savedir, tf32)
    kernels.append(row)
    by_path.update(anakin_paths)
    rows, pipelined_paths = run_pipelined_phases(ops, dev, savedir, tf32)
    kernels.extend(rows)
    by_path.update(pipelined_paths)
    by_path.update(run_dp_phases(ops, dev, savedir, tf32))
    by_path.update(run_ep_phases(ops, dev, savedir, tf32))
    by_path.update(run_split_phases(ops, dev, savedir, tf32))
    by_path.update(run_tp_pp_phases(ops, dev, savedir, tf32))
    by_path.update(run_sp_fleet_phases(ops, dev, savedir, tf32))
    tally_launches(kernels, by_path)

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
    for policy in ("f32", "bf16_train"):
        model, _ = _param_tree(dev, "deep", policy)
        check_update_parity(ops, dev, "deep+LSTM", model,
                            model.initial_state(B, dev), policy, impact=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
