"""The port's data-parallel learner (torchbeast_tpu_torch/parallel/)
against the JAX package's (torchbeast_tpu/parallel/), on the CPU's 8
virtual devices (tests/conftest.py sets XLA_FLAGS for both packages).

- create_mesh: the reference's shapes and errors; each inner axis
  (model, seq, pipe, expert) lays out as the reference's grid.
- The DP update over 2, 4 and 8 shards against the reference's
  make_parallel_update_step on the 8 devices, shallow + LSTM (the
  reference's own fixture), from the same weights (weights.py) and numpy
  batch; and against the port's one-device update on the whole batch for
  the deep model (V-trace and pool_bwd through their wrappers) and the
  transformer (the attention kernels' wrappers).
- Replicas bitwise equal after every update, the entropy anneal ticking
  once per update, K=2 in one dispatch bitwise equal to two K=1
  dispatches, bf16_train summing its gradients in f32.
- Two processes in one gloo group (tests/torch_dp_worker.py): their DP
  update over 2 x 2 shards against the one-device update.

RMSprop's eps is 1.0 in the parity tests, as in tests/test_torch_learner.py
(at eps 0.01 the first steps divide by about 0.1 |g| + eps, which turns a
summation-order difference of the gradient into a percent-sized one of
its step). Tolerances: loss stats rtol 1e-4 (a sum over shards against a
sum over the batch); params rtol 1e-5, atol 2e-6 against the one-device
update, rtol 1e-4, atol 1e-6 against the reference (two frameworks'
conv and matmul summation orders as well).
"""

import copy
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.parallel import create_mesh as jax_create_mesh
from torchbeast_tpu.parallel import (
    make_parallel_update_step as jax_parallel_update,
)
from torchbeast_tpu.parallel import replicate as jax_replicate
from torchbeast_tpu.parallel import shard_batch as jax_shard_batch
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import parallel, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 4, 8, 4  # B divisible by the 8-device data axis
FRAME = (48, 48, 1)  # the reference fixture's frames
STAT_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "episode_returns_sum", "episode_count", "grad_norm")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_batch(seed=0, frame=FRAME, b=B):
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 256, (T + 1, b) + frame, dtype=np.uint8),
        "reward": rng.standard_normal((T + 1, b)).astype(np.float32),
        "done": rng.random((T + 1, b)) < 0.2,
        "episode_return": rng.standard_normal((T + 1, b)).astype(
            np.float32),
        "episode_step": rng.integers(0, 99, (T + 1, b)).astype(np.int32),
        "last_action": rng.integers(0, A, (T + 1, b)).astype(np.int32),
        "action": rng.integers(0, A, (T + 1, b)).astype(np.int32),
        "policy_logits": rng.standard_normal((T + 1, b, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((T + 1, b)).astype(np.float32),
    }


def _torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    return tuple(torch.from_numpy(np.asarray(v)) for v in tree)


def _hp(**kw):
    base = dict(batch_size=B, unroll_length=T, rmsprop_eps=1.0,
                entropy_cost=0.01, total_steps=10 * T * B)
    base.update(kw)
    return base


# ------------------------------------------------------------------ mesh


def test_mesh_shapes_match_the_reference():
    ours, theirs = parallel.create_mesh(8), jax_create_mesh(8)
    assert ours.devices.shape == theirs.devices.shape == (8, 1)
    assert ours.axis_names == theirs.axis_names == ("data", "model")
    assert ours.shape == dict(theirs.shape) == {"data": 8, "model": 1}
    two = parallel.create_mesh(2)
    assert two.shape == dict(jax_create_mesh(2).shape)
    assert two.local_devices == [torch.device("cpu")] * 2


@pytest.mark.parametrize("kwargs,match", [
    ({"n_devices": 8, "model_parallelism": 3}, "not divisible"),
    ({"n_devices": 64}, "visible"),
    ({"n_devices": 8, "pipe_parallelism": 2, "expert_parallelism": 2},
     "pipe_parallelism does not combine"),
])
def test_mesh_errors_match_the_reference(kwargs, match):
    with pytest.raises(ValueError, match=match):
        jax_create_mesh(**kwargs)
    with pytest.raises(ValueError, match=match):
        parallel.create_mesh(**kwargs)


@pytest.mark.parametrize("axis,item", [
    ("model_parallelism", "tensor parallel"),
    ("expert_parallelism", "expert parallel"),
    ("seq_parallelism", "sequence parallel"),
    ("pipe_parallelism", "pipeline parallel"),
])
def test_inner_axes_are_roadmap_items(axis, item):
    """The reference builds these meshes (each once a ROADMAP.md Queue 1
    item of the port: `item`); the port builds every one as the
    reference lays it out (the inner axis innermost, reported only above
    1 for seq, pipe and expert)."""
    theirs = jax_create_mesh(8, **{axis: 2})
    assert theirs.devices.size == 8
    ours = parallel.create_mesh(8, **{axis: 2})
    assert ours.shape == dict(theirs.shape)
    assert ours.axis_names == theirs.axis_names
    assert ours.devices.shape == theirs.devices.shape
    assert len(ours.local_devices) == 4
    row = {"model_parallelism": ours.model_devices,
           "expert_parallelism": ours.expert_devices,
           "seq_parallelism": ours.seq_devices,
           "pipe_parallelism": ours.pipe_devices}[axis](1)
    assert row == [torch.device("cpu")] * 2


def test_cpu_device_count_follows_xla_flags(monkeypatch):
    assert parallel.cpu_device_count() == len(jax.devices()) == 8
    monkeypatch.setenv("XLA_FLAGS", "")
    assert parallel.cpu_device_count() == 1
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=3")
    assert len(parallel.visible_devices("cpu")) == 3


def test_explicit_devices_may_repeat():
    mesh = parallel.create_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.lead == torch.device("cpu")


def test_shard_batch_splits_in_order_and_checks_rows():
    mesh = parallel.create_mesh(4)
    batch = make_batch()
    state = (np.arange(B * 3, dtype=np.float32).reshape(1, B, 3),)
    sharded = parallel.shard_batch(mesh, batch, state)
    assert len(sharded.shards) == 4
    for i, (b, s) in enumerate(sharded.shards):
        np.testing.assert_array_equal(
            b["reward"].numpy(), batch["reward"][:, 2 * i:2 * i + 2])
        np.testing.assert_array_equal(s[0].numpy(),
                                      state[0][:, 2 * i:2 * i + 2])
        assert b["frame"].is_contiguous()
    stacks = {k: np.stack([v, v]) for k, v in batch.items()}
    sharded = parallel.shard_batch(mesh, stacks, None, leading_axes=1)
    assert sharded.shards[0][0]["frame"].shape == (2, T + 1, 2) + FRAME
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_batch(parallel.create_mesh(3), batch, state)
    copies = parallel.replicate(mesh, {"w": torch.ones(2)})
    assert len(copies) == 4 and copies[0]["w"] is not copies[1]["w"]


# ------------------------------------------------- the reference's update


@functools.lru_cache(maxsize=None)
def _reference(n=8):
    """The reference's fixture and its DP update over n devices: (start
    params, state, params after one update, stats)."""
    model = jax_create_model("shallow", num_actions=A, use_lstm=True)
    batch = make_batch()
    rng = np.random.default_rng(7)
    state = tuple((0.5 * rng.standard_normal(np.shape(s))).astype(np.float32)
                  for s in model.initial_state(B))
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        batch, state)
    hp = jax_learner.HParams(**_hp())
    optimizer = jax_learner.make_optimizer(hp)
    start = jax.device_get(params)
    mesh = jax_create_mesh(n)
    step = jax_parallel_update(model, optimizer, hp, mesh, donate=False)
    p = jax_replicate(mesh, jax.tree_util.tree_map(jnp.copy, params))
    o = jax_replicate(mesh, optimizer.init(params))
    b, s = jax_shard_batch(mesh, batch, state)
    p, _, stats = step(p, o, b, s)
    return start, state, jax.device_get(p), jax.device_get(stats)


def _port_shallow(start):
    model = port_create_model("shallow", A, use_lstm=True, frame_shape=FRAME)
    weights.load_jax_params(model, start)
    return model


def _close_trees(got, want, rtol, atol):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), rtol=rtol, atol=atol), got, want)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dp_update_matches_the_reference(n):
    """The port's update over n shards against the reference's over all 8
    virtual devices (one compile): each is the whole batch's update."""
    start, state, want_params, want_stats = _reference()
    model = _port_shallow(start)
    hp = port_learner.HParams(**_hp())
    optimizer = port_learner.make_optimizer(hp, list(model.parameters()))
    update = parallel.make_parallel_update_step(
        model, optimizer, hp, parallel.create_mesh(n))
    stats = update(_torch(make_batch()), _torch(state))
    for key in STAT_KEYS:
        np.testing.assert_allclose(float(stats[key]), float(want_stats[key]),
                                   rtol=1e-4, err_msg=key)
    _close_trees(weights.torch_to_jax(model.state_dict()), want_params,
                 rtol=1e-4, atol=1e-6)
    assert optimizer.state.count == 1 and int(optimizer.device_count) == 1


# ------------------------------------------- against the one-device update


def _state(model, name):
    """A random LSTM state (numpy, seed 5), or the transformer's empty
    cache."""
    state = model.initial_state(B)
    if name == "transformer":
        return state
    rng = np.random.default_rng(5)
    return tuple(torch.from_numpy(
        (0.5 * rng.standard_normal(s.shape)).astype(np.float32))
        for s in state)


def _one_and_dp(name, n, frame, steps=2, hp_kw=None, dp_kw=None,
                model_kw=None):
    """(one-device model, its stats, DP model, DP stats, the DP dispatch)
    after `steps` updates from the same weights and batches."""
    torch.manual_seed(3)
    model = port_create_model(name, A, frame_shape=frame, **(model_kw or {}))
    from torchbeast_tpu_torch import precision

    policy = precision.get((hp_kw or {}).get("policy", "f32"))
    model = precision.cast_params(model, policy)
    kw = dict(_hp(), param_dtype=policy.param_dtype,
              opt_state_dtype=policy.opt_state_dtype)
    kw.update({k: v for k, v in (hp_kw or {}).items() if k != "policy"})
    hp = port_learner.HParams(**kw)
    twin = copy.deepcopy(model)
    state = _state(model, name)
    batches = [_torch(make_batch(seed=i, frame=frame)) for i in range(steps)]
    opt1 = port_learner.make_optimizer(hp, list(model.parameters()))
    one = port_learner.update_body(model, opt1, hp)
    want = [one(b, state) for b in batches]
    opt2 = port_learner.make_optimizer(hp, list(twin.parameters()))
    update = parallel.make_parallel_update_step(
        twin, opt2, hp, parallel.create_mesh(n), **(dp_kw or {}))
    got = [update(b, state) for b in batches]
    return model, want, twin, got, update


def _same_update(model, want, twin, got, rtol=1e-5, atol=2e-6,
                 stat_rtol=1e-4):
    for w, g in zip(want, got):
        for key in STAT_KEYS:
            np.testing.assert_allclose(float(g[key]), float(w[key]),
                                       rtol=stat_rtol, err_msg=key)
    for p, q in zip(model.parameters(), twin.parameters()):
        np.testing.assert_allclose(q.detach().float().numpy(),
                                   p.detach().float().numpy(),
                                   rtol=rtol, atol=atol)


def test_deep_dp_matches_one_device_through_the_kernel_wrappers(
        monkeypatch):
    """deep + LSTM, 2 shards, --vtrace_impl pallas and TBT_POOL_PALLAS=1:
    V-trace and pool_bwd go through their wrappers (their plain versions
    on CPU tensors), once and three times a shard an update."""
    from torchbeast_tpu_torch import ops

    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    ops.reset_launch_counts()
    out = _one_and_dp("deep", 2, (84, 84, 4), steps=2,
                      hp_kw={"vtrace_impl": "pallas"},
                      model_kw={"use_lstm": True})
    _same_update(*out[:4])


def test_transformer_dp_matches_one_device():
    """The transformer (KV-cache state sharded along its batch axis) with
    --attention_impl pallas's wrappers, 2 shards."""
    out = _one_and_dp("transformer", 2, (84, 84, 4), steps=2,
                      hp_kw={"vtrace_impl": "pallas"},
                      model_kw={"attention_impl": "pallas"})
    _same_update(*out[:4])


def test_replicas_stay_bitwise_equal():
    _, _, twin, _, update = _one_and_dp("shallow", 4, FRAME, steps=2,
                                        model_kw={"use_lstm": True})
    learner = update.learner
    assert learner.replicas[0] is twin
    for params in learner.params[1:]:
        assert all(torch.equal(p, q)
                   for p, q in zip(params, learner.params[0]))
    for count in learner.counts:
        assert int(count) == 2


def test_superstep_k2_bitwise_equal_to_two_k1_dispatches():
    model, _, twin, got, _ = _one_and_dp("shallow", 4, FRAME, steps=2,
                                         model_kw={"use_lstm": True})
    # The same start as _one_and_dp's, then one K=2 dispatch.
    torch.manual_seed(3)
    k2 = port_create_model("shallow", A, use_lstm=True, frame_shape=FRAME)
    hp = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(hp, list(k2.parameters()))
    update = parallel.make_parallel_update_step(
        k2, opt, hp, parallel.create_mesh(4), superstep_k=2)
    state = _state(k2, "shallow")
    batches = [_torch(make_batch(seed=i)) for i in range(2)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    stats = update(stacked, tuple(torch.stack([s, s]) for s in state))
    assert opt.state.count == 2
    assert all(torch.equal(p, q)
               for p, q in zip(k2.parameters(), twin.parameters()))
    for key in STAT_KEYS:
        assert torch.equal(stats[key],
                           torch.stack([g[key] for g in got])), key


def test_entropy_anneal_ticks_once_per_update():
    """The reference's test: with the anneal armed, entropy_loss at the
    half-horizon count is half the count-0 value on the same params and
    batch (count 5 of a 10-update horizon), over 8 shards."""
    torch.manual_seed(3)
    model = port_create_model("shallow", A, use_lstm=True, frame_shape=FRAME)
    hp = port_learner.HParams(**_hp(entropy_cost=1.0, entropy_cost_final=0.0,
                                    learning_rate=0.0))
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    update = parallel.make_parallel_update_step(
        model, opt, hp, parallel.create_mesh(8))
    batch, state = _torch(make_batch()), model.initial_state(B)
    e0 = float(update(batch, state)["entropy_loss"])
    opt.set_count(5)
    update.learner.sync()
    e5 = float(update(batch, state)["entropy_loss"])
    assert e0 != 0.0
    np.testing.assert_allclose(e5, 0.5 * e0, rtol=1e-5)
    assert opt.state.count == 6


def test_bf16_train_sums_f32_gradients():
    """--precision bf16_train: bf16-resident replicas, the gradient summed
    in f32 and applied to the lead's f32 master; the DP update within a
    bf16 ulp of the one-device one, the replicas bitwise equal."""
    model, want, twin, got, update = _one_and_dp(
        "shallow", 2, FRAME, steps=1, hp_kw={"policy": "bf16_train"},
        model_kw={"use_lstm": True})
    assert all(p.dtype == torch.bfloat16 for p in twin.parameters())
    master = update.learner.optimizer.state.master
    assert master is not None and master[0].dtype == torch.float32
    _same_update(model, want, twin, got, rtol=2 ** -7, atol=1e-3,
                 stat_rtol=2e-2)
    for p, q in zip(update.learner.params[1], update.learner.params[0]):
        assert torch.equal(p, q)


def test_refusals():
    torch.manual_seed(0)
    model = port_create_model("shallow", A, frame_shape=FRAME)
    hp = port_learner.HParams(**_hp(opt_impl="pallas"))
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    with pytest.raises(ValueError, match="--opt_impl pallas does not"):
        parallel.make_parallel_update_step(model, opt, hp,
                                           parallel.create_mesh(2))
    # A mixture of experts is no longer refused: its step routes over the
    # whole batch and runs eagerly, so only a capture is refused
    # (tests/test_torch_ep.py holds its numbers against the reference).
    moe = port_create_model("transformer", A, frame_shape=FRAME,
                            num_experts=4)
    hp = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(hp, list(moe.parameters()))
    update = parallel.make_parallel_update_step(
        moe, opt, hp, parallel.create_mesh(2), capture=True)
    assert update.learner.exchange is not None
    with pytest.raises(ValueError, match="cannot be captured"):
        update(_torch(make_batch(frame=FRAME)),
               moe.initial_state(B))


def test_initialize_distributed_reads_the_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.delenv("TORCHBEAST_COORDINATOR", raising=False)
    assert parallel.initialize_distributed() is False and not calls
    monkeypatch.setenv("TORCHBEAST_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.setenv("TORCHBEAST_NUM_PROCESSES", "2")
    monkeypatch.setenv("TORCHBEAST_PROCESS_ID", "0")
    assert parallel.initialize_distributed(backend="gloo") is True
    assert calls == [("gloo", {"init_method": "tcp://127.0.0.1:1234",
                               "world_size": 2, "rank": 0})]
    assert parallel.initialize_distributed(
        "tcp://h:1", num_processes=4, process_id=3, backend="gloo")
    assert calls[-1][1] == {"init_method": "tcp://h:1", "world_size": 4,
                            "rank": 3}


# ------------------------------------------------------ two processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_update_matches_one_device(tmp_path):
    """Two processes, 2 CPU devices each, one gloo group: each passes its
    4 rows of the 8-row batch; the DP update over the 4 shards must
    match the one-device update on all 8 rows (params rtol 1e-5, atol
    2e-6; stats rtol 1e-4), every process ending with the same params."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "update", str(rank), "2", str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank}:\n{out}"
        assert "two-process update matches one device OK" in out, out
    digests = {np.load(tmp_path / f"params{r}.npy").tobytes()
               for r in range(2)}
    assert len(digests) == 1
