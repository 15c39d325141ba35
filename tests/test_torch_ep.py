"""Expert parallelism and whole-batch MoE routing in the port
(torchbeast_tpu_torch/models/moe.py `routing`, parallel/{mesh,ep,dp}.py)
against the JAX package, on the CPU's 8 virtual devices (tests/
conftest.py's XLA_FLAGS), at small widths (1 layer, d 16, 4 experts).

- The routing scope over 2, 4 and 8 shards in lockstep against the
  reference's MoEFFN on the whole token set, at capacity factor 0.5 so
  that assignments drop in several shards: output rtol 1e-5, atol 1e-6
  (tests/test_torch_moe.py's); the kept mask exactly; the load-balance
  loss, a sum of per-shard pieces, rtol 1e-6; the router gradient of
  the pieces, summed over the shards, rtol 1e-5, atol 1e-6. One shard's
  scope is the one-device layer bit for bit; the remat recompute reuses
  the forward's routing table.
- The DP update of the MoE transformer over 2, 4 and 8 shards against
  the reference's make_parallel_update_step on the 8 devices, and the
  data x expert update (1x2, 2x2, 4x2) against the reference's composite
  setting (tests/test_composite_mesh.py:50): stats rtol 1e-4, params
  rtol 1e-4, atol 1e-6 at RMSprop eps 1.0 (tests/test_torch_parallel.py's
  tolerances and reason). The router is skewed toward expert 0 (a
  LayerNorm bias it reads) so that assignments drop, and the drops equal
  the one-device port's.
- Anakin's acting forward of two shards in lockstep, and the IMPACT
  target forwards of two shards (K=1 and K=2), equal the one device's on
  the whole batch.
- The leaf rule picks the reference's leaves: on the transformer's
  params and optimizer state, none on the pipelined families.
- The reference's error texts; one end-to-end run of each driver (both
  polybeast runtimes); two gloo processes (tests/torch_dp_worker.py):
  the data x expert update against one device, and polybeast's
  composite mesh across them; an EP checkpoint resumed on one device and
  by the reference's EP run.
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
from torchbeast_tpu import monobeast as jax_monobeast
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.parallel import create_mesh as jax_create_mesh
from torchbeast_tpu.parallel import (
    expert_param_shardings as jax_expert_param_shardings,
)
from torchbeast_tpu.parallel import (
    make_parallel_update_step as jax_parallel_update,
)
from torchbeast_tpu.parallel import replicate as jax_replicate
from torchbeast_tpu.parallel import shard_batch as jax_shard_batch
from torchbeast_tpu_torch import anakin
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import monobeast, parallel, polybeast, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.models import moe, sharded
from torchbeast_tpu_torch.utils import checkpoint
from tests.test_torch_moe import _jax_layer, _port_layer
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 4, 8, 5
FRAME = (6, 6, 1)
KW = dict(num_layers=1, d_model=16, num_heads=2, memory_len=4,
          num_experts=4)
STAT_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "aux_loss", "episode_returns_sum", "episode_count",
             "grad_norm")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 256, (T + 1, B) + FRAME, dtype=np.uint8),
        "reward": rng.standard_normal((T + 1, B)).astype(np.float32),
        "done": rng.random((T + 1, B)) < 0.15,
        "episode_return": rng.standard_normal((T + 1, B)).astype(
            np.float32),
        "episode_step": rng.integers(0, 9, (T + 1, B)).astype(np.int32),
        "last_action": rng.integers(0, A, (T + 1, B)).astype(np.int32),
        "action": rng.integers(0, A, (T + 1, B)).astype(np.int32),
        "policy_logits": rng.standard_normal((T + 1, B, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((T + 1, B)).astype(np.float32),
    }


def _torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
    return tuple(_torch(v) if isinstance(v, tuple)
                 else torch.from_numpy(np.asarray(v)) for v in tree)


def _hp(**kw):
    return dict(batch_size=B, unroll_length=T, rmsprop_eps=1.0,
                entropy_cost=0.01, total_steps=10 * T * B, **kw)


# ------------------------------------------------------ the routing scope


def _reference_kept(params, x, top_k, capacity_factor):
    """The reference's kept mask [t, K, E] (models/moe.py:59-83's lines)."""
    kernel = params["params"]["router"]["kernel"]
    probs = jax.nn.softmax(jnp.asarray(x) @ kernel, axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    t, E = x.shape[0], kernel.shape[1]
    cap = max(1, int(np.ceil(top_k * t / E * capacity_factor)))
    sel = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    flat = sel.transpose(1, 0, 2).reshape(top_k * t, E)
    pos = (jnp.cumsum(flat, axis=0) - flat).reshape(
        top_k, t, E).transpose(1, 0, 2)
    return np.asarray(sel * (pos < cap))


def _lockstep(layers, xs, weights_=None):
    """Each shard's layer on its tokens in its routing scope, in
    lockstep: [(y, recorded loss)] in shard order."""
    mesh = parallel.create_mesh(devices=["cpu"] * len(layers))
    exchange = parallel.RoutingExchange(mesh)

    def shard(i):
        def run():
            with moe.routing(exchange.shard(i)), \
                    moe.recording_losses() as recorded:
                y = layers[i](xs[i])
            return y, recorded[layers[i]]
        return run

    return exchange.run([shard(i) for i in range(len(layers))])


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_routing_over_shards_is_the_whole_batch_layer(shards):
    tokens, case = 32, dict(top_k=2, capacity_factor=0.5)
    layer, params, x = _jax_layer(tokens, **case)
    w = np.random.default_rng(1).standard_normal((tokens, 8)).astype(
        np.float32)

    def loss(p):
        y, sown = layer.apply(p, x, mutable=["losses"])
        aux = sown["losses"]["moe_load_balance"]
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (want, want_aux)), grads = jax.value_and_grad(
        loss, has_aux=True)(params)
    layers = [_port_layer(params, **case) for _ in range(shards)]
    for m in layers:
        m.track_routing = True
    outs = _lockstep(layers, torch.from_numpy(x).chunk(shards))
    got = torch.cat([y for y, _ in outs])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    kept = torch.cat([m.last_kept for m in layers]).numpy()
    np.testing.assert_array_equal(kept, _reference_kept(params, x, **case))
    aux = sum(a for _, a in outs)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               rtol=1e-6)
    # Drops fall in several shards, and a shard alone would have taken
    # another capacity.
    dropped = [float(m.last_dropped) for m in layers]
    assert sum(d > 0 for d in dropped) >= 2, dropped
    assert layers[0].capacity(tokens // shards) != layers[0].capacity(tokens)
    # The pieces' gradients, summed over the shards, are the reference's.
    total = torch.sum(got * torch.from_numpy(w)) + aux
    total.backward()
    router = sum(m.router.weight.grad for m in layers)
    np.testing.assert_allclose(router.numpy().T,
                               np.asarray(grads["params"]["router"]["kernel"]),
                               rtol=1e-5, atol=1e-6)
    w_in = sum(m.w_in.grad for m in layers)
    np.testing.assert_allclose(w_in.numpy(),
                               np.asarray(grads["params"]["w_in"]),
                               rtol=1e-5, atol=1e-6)


def test_one_shard_scope_is_the_one_device_layer():
    layer, params, x = _jax_layer(32, top_k=2, capacity_factor=0.5)
    port = _port_layer(params, top_k=2, capacity_factor=0.5)
    port.track_routing = True
    xt = torch.from_numpy(x)
    want = port(xt)
    want_kept = port.last_kept
    with moe.routing(lambda counts: (counts[None], 0)):
        got = port(xt)
    assert torch.equal(got, want)
    assert torch.equal(port.last_kept, want_kept)


def test_remat_recompute_reuses_the_forward_table():
    """Two shards of the transformer with blocks=all remat: the same
    gradients as without remat, and one exchange a layer a forward (the
    recompute in the backward exchanges nothing)."""
    calls = []
    grads = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = port_create_model("transformer", A, frame_shape=FRAME,
                                  remat=remat, **KW)
        mesh = parallel.create_mesh(2)
        hp = port_learner.HParams(**_hp())
        opt = port_learner.make_optimizer(hp, list(model.parameters()))
        learner = parallel.ParallelLearner(model, opt, hp, mesh)
        exchange = learner.exchange
        inner = exchange._exchange

        def counted(i, counts, inner=inner):
            calls.append(i)
            return inner(i, counts)

        exchange._exchange = counted
        calls.clear()
        sharded = parallel.shard_batch(mesh, make_batch(),
                                       model.initial_state(B))
        outs = exchange.run([
            functools.partial(learner.grads, i, b, s)
            for i, (b, s) in enumerate(sharded.shards)])
        assert sorted(calls) == [0, 1], calls
        grads[remat] = [g for g, _ in outs]
    for a, b in zip(grads[False], grads[True]):
        for g, h in zip(a, b):
            np.testing.assert_allclose(h.numpy(), g.numpy(), rtol=1e-6,
                                       atol=1e-7)


# ------------------------------------------------ updates, the reference's


def _skewed_params(seed=0):
    """The reference's fresh params with the router skewed toward expert
    0: the block's second LayerNorm gets a bias b and the router kernel's
    column 0 gains 2 b, so most tokens pick expert 0 first and overflow
    its capacity."""
    model = jax_create_model("transformer", num_actions=A, **KW)
    params = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(seed),
         "action": jax.random.PRNGKey(seed + 1)},
        make_batch(), model.initial_state(B)))
    params = jax.tree_util.tree_map(np.array, params)
    block = params["params"]["block_0"]
    b = 0.5 * np.random.default_rng(seed).standard_normal(
        KW["d_model"]).astype(np.float32)
    block["LayerNorm_1"]["bias"] = b
    block["moe"]["router"]["kernel"][:, 0] += 2.0 * b
    return params


@functools.lru_cache(maxsize=None)
def _reference(expert=1):
    """The reference's update on 8 devices (data 8, or data 8/expert x
    expert with the expert kernels sharded) from the skewed params:
    (start params, params after one update, stats)."""
    start = _skewed_params()
    mesh = jax_create_mesh(8, expert_parallelism=expert)
    model = jax_create_model("transformer", num_actions=A,
                             moe_mesh=mesh if expert > 1 else None, **KW)
    hp = jax_learner.HParams(**_hp())
    optimizer = jax_learner.make_optimizer(hp)
    batch, state = make_batch(), model.initial_state(B)
    if expert > 1:
        shardings = jax_expert_param_shardings(mesh, start)
        params = jax.tree_util.tree_map(jax.device_put, start, shardings)
        step = jax_parallel_update(model, optimizer, hp, mesh, donate=False,
                                   param_shardings=shardings)
    else:
        params = jax_replicate(mesh, start)
        step = jax_parallel_update(model, optimizer, hp, mesh, donate=False)
    opt_state = optimizer.init(params)
    if expert == 1:
        opt_state = jax_replicate(mesh, opt_state)
    b, s = jax_shard_batch(mesh, batch, state)
    p, _, stats = step(params, opt_state, b, s)
    return start, jax.device_get(p), jax.device_get(stats)


def _port_update(start, mesh):
    """The port's update of the skewed params over `mesh` (or on one
    device, mesh None): (model, stats, dropped assignments)."""
    model = port_create_model("transformer", A, frame_shape=FRAME, **KW)
    weights.load_jax_params(model, start)
    hp = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    if mesh is None:
        layers = [m for m in model.modules() if isinstance(m, moe.MoEFFN)]
        step = port_learner.update_body(model, opt, hp)
    else:
        step = parallel.make_parallel_update_step(model, opt, hp, mesh)
        layers = [m for r in step.learner.replicas for m in r.modules()
                  if isinstance(m, moe.MoEFFN)]
    for m in layers:
        m.track_routing = True
    stats = step(_torch(make_batch()), model.initial_state(B))
    dropped = sum(int(m.last_dropped) for m in layers)
    return model, stats, dropped


def _same(model, stats, want_params, want_stats):
    for key in STAT_KEYS:
        np.testing.assert_allclose(float(stats[key]), float(want_stats[key]),
                                   rtol=1e-4, err_msg=key)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                                atol=1e-6),
        weights.torch_to_jax(parallel.local_view(model)), want_params)


@functools.lru_cache(maxsize=None)
def _one_device_drops():
    return _port_update(_reference()[0], None)[2]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_moe_dp_update_matches_the_reference(n):
    start, want_params, want_stats = _reference()
    mesh = parallel.create_mesh(n)
    model, stats, dropped = _port_update(start, mesh)
    _same(model, stats, want_params, want_stats)
    assert dropped == _one_device_drops() > 0


@pytest.mark.parametrize("data", [1, 2, 4])
def test_data_x_expert_update_matches_the_reference(data):
    start, want_params, want_stats = _reference(expert=2)
    mesh = parallel.create_mesh(2 * data, expert_parallelism=2)
    assert mesh.shape == {"data": data, "model": 1, "expert": 2}
    assert dict(jax_create_mesh(2 * data, expert_parallelism=2).shape) \
        == mesh.shape
    model, stats, dropped = _port_update(start, mesh)
    _same(model, stats, want_params, want_stats)
    assert dropped == _one_device_drops() > 0


def test_moe_dp_step_runs_eagerly():
    """The routing exchange sits mid-forward: the step does not capture,
    and asking it to raises."""
    model = port_create_model("transformer", A, frame_shape=FRAME, **KW)
    hp = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    update = parallel.make_parallel_update_step(model, opt, hp,
                                                parallel.create_mesh(2))
    assert update.learner.exchange is not None
    assert not update.captures_graphs
    twin = copy.deepcopy(model)
    captured = parallel.make_parallel_update_step(
        twin, port_learner.make_optimizer(hp, list(twin.parameters())), hp,
        parallel.create_mesh(2), capture=True)
    with pytest.raises(ValueError, match="cannot be captured"):
        captured(_torch(make_batch()), model.initial_state(B))


def test_a_failing_shard_raises_its_error():
    """A shard's error breaks the barrier for the other shard, which
    would wait forever, and is raised; the exchange runs again after."""
    exchange = parallel.RoutingExchange(parallel.create_mesh(2))

    def bad():
        raise RuntimeError("shard 1 failed")

    def waits():
        return exchange.shard(0)(torch.ones(2, 4))

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        exchange.run([waits, bad])
    table, s = exchange.run(
        [waits, lambda: exchange.shard(1)(torch.zeros(2, 4))])[0]
    assert s == 0 and table.shape == (2, 2, 4)


def test_exchange_under_thread_stress():
    """16 shards (more than the host's cores), 200 exchanges each, the
    interpreter switching threads every microsecond: every shard gets,
    every round, exactly the table of that round's counts and its own
    index (a table read after the next round's posts, or a lost post,
    would differ)."""
    import sys

    n, rounds = 16, 200
    exchange = parallel.RoutingExchange(
        parallel.create_mesh(devices=["cpu"] * n), timeout_s=60)
    seen = [[] for _ in range(n)]

    def shard(i):
        def run():
            for r in range(rounds):
                counts = torch.full((2, 3), float(1000 * r + i))
                table, s = exchange.shard(i)(counts)
                seen[i].append((s, table.clone()))
        return run

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        exchange.run([shard(i) for i in range(n)])
    finally:
        sys.setswitchinterval(interval)
    for i in range(n):
        assert len(seen[i]) == rounds
        for r, (s, table) in enumerate(seen[i]):
            assert s == i
            want = (1000 * r + torch.arange(n, dtype=torch.float32))
            assert torch.equal(table[:, 0, 0], want), (i, r)


def test_anakin_acting_routes_over_the_whole_batch():
    """Two shards' T=1 acting forwards in lockstep (each in its routing
    scope, as anakin's collect runs them) give the one device's logits
    and baselines on the whole batch."""
    model = port_create_model("transformer", A, frame_shape=FRAME, **KW)
    weights.load_jax_params(model, _reference()[0])  # skewed: drops
    hp = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    learner = parallel.ParallelLearner(model, opt, hp,
                                       parallel.create_mesh(2))
    batch = {k: v[:1] for k, v in _torch(make_batch()).items()}
    state = model.initial_state(B)
    with torch.no_grad():
        want, _ = model(batch, state, sample_action=False)
    halves = parallel.shard_batch(learner.mesh, batch, state).shards

    def act(i):
        def run():
            with learner.routing(i), torch.no_grad():
                return learner.replicas[i](halves[i][0], halves[i][1],
                                           sample_action=False)[0]
        return run

    outs = learner.exchange.run([act(0), act(1)])
    for field in ("policy_logits", "baseline"):
        got = torch.cat([getattr(o, field) for o in outs], dim=1)
        np.testing.assert_allclose(got.numpy(),
                                   getattr(want, field).numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_impact_target_forwards_route_over_the_whole_batch(k):
    """--loss impact under DP: each shard's target forward (each of a
    superstep's K) runs in lockstep in a routing scope of its own, so the
    merged target outputs are the one device's on the whole batch."""
    from torchbeast_tpu_torch.learner import (
        TARGET_BASELINE_KEY, TARGET_LOGITS_KEY, target_forward_body)

    model = port_create_model("transformer", A, frame_shape=FRAME, **KW)
    weights.load_jax_params(model, _reference()[0])  # skewed: drops
    hp = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    update = parallel.make_parallel_update_step(
        model, opt, hp, parallel.create_mesh(2), superstep_k=k)
    target = parallel.ShardedTarget(update, refresh_updates=1,
                                    superstep_k=k)
    batches = [_torch(make_batch(seed)) for seed in range(k)]
    state = model.initial_state(B)
    if k == 1:
        batch, stack_state = batches[0], state
    else:
        batch = {key: torch.stack([b[key] for b in batches])
                 for key in batches[0]}
        stack_state = tuple(tuple(torch.stack([t] * k) for t in layer)
                            for layer in state)
    want = target_forward_body(model, k)(batch, stack_state)
    merged = target.merge(batch, stack_state)
    for key, w in zip((TARGET_LOGITS_KEY, TARGET_BASELINE_KEY), want):
        got = torch.cat([b[key] for b, _ in merged.shards], dim=k)
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------- the leaf rule


def _picked(specs, spec):
    from torchbeast_tpu_torch.parallel.ep import _flat

    return {tuple(str(p) for p in path) for path, s in _flat(specs)
            if s == spec}


def _jax_picked(shardings):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: hasattr(x, "spec"))
    out = set()
    for path, s in flat:
        if not s.is_fully_replicated:
            out.add(tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                          for p in path))
    return out


def test_leaf_rule_picks_the_references_leaves():
    from torchbeast_tpu_torch.parallel import ep

    mesh = jax_create_mesh(8, expert_parallelism=2)
    model = port_create_model("transformer", A, frame_shape=FRAME,
                              **{**KW, "num_layers": 2})
    tree = weights.torch_to_jax(model.state_dict())
    tree = jax.tree_util.tree_map(np.asarray, tree)
    want = _jax_picked(jax_expert_param_shardings(mesh, tree))
    assert len(want) == 4
    assert _picked(parallel.expert_param_shardings(2, tree),
                   ep.EXPERT) == want
    # The torch state dict: the same leaves under their dotted names.
    flat = _picked(parallel.expert_param_shardings(2, model.state_dict()),
                   ep.EXPERT)
    assert flat == {(f"block_{i}", "moe", k) for i in (0, 1)
                    for k in ("w_in", "w_out")}
    # 4 experts over 3 do not divide: nothing shards.
    assert not _picked(parallel.expert_param_shardings(3, tree), ep.EXPERT)
    # The optimizer state, params-shaped, as the reference's.
    hp = port_learner.HParams(**_hp(rmsprop_momentum=0.9))
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    port_state = checkpoint.opt_state_tree(model, opt)
    jax_hp = jax_learner.HParams(**_hp(rmsprop_momentum=0.9))
    jax_state = jax_learner.make_optimizer(jax_hp).init(tree)
    want = _jax_picked(jax_expert_param_shardings(mesh, jax_state))
    got = _picked(parallel.expert_param_shardings(2, port_state), ep.EXPERT)
    assert len(got) == len(want) == 8  # nu and the trace, 2 layers x 2
    assert {p[-4:] for p in got} == {p[-4:] for p in want}
    # The placement (shard_expert_params over models/sharded.shard):
    # halves on the row's expert devices, half the kernels' bytes each.
    placed = copy.deepcopy(model)
    devices = parallel.create_mesh(
        2, expert_parallelism=2).expert_devices(0)
    assert parallel.shard_expert_params(placed, devices) == 4
    halves = sharded.slots(placed.block_0.moe, "w_in")
    assert [t.device for t in halves] == devices
    assert halves[0].shape[0] == 2
    assert torch.equal(torch.cat(halves), model.block_0.moe.w_in)
    assert sharded.slots(placed.block_0.moe.router, "weight") is None
    kernels = sum(getattr(model, f"block_{i}").moe.get_parameter(k)
                  .numel() * 4 for i in (0, 1) for k in ("w_in", "w_out"))
    assert sharded.slot_bytes(placed)[("expert", 0)] == kernels // 2
    assert sharded.slot_bytes(placed)[("expert", 1)] == kernels // 2


@pytest.mark.parametrize("name,kw", [
    ("pipelined_mlp", {}),
    ("pipelined_transformer", {"num_layers": 2, "d_model": 16,
                               "num_heads": 2, "memory_len": 4})])
def test_leaf_rule_picks_nothing_on_the_pipelined_trees(name, kw):
    mesh = jax_create_mesh(8, expert_parallelism=2)
    model = port_create_model(name, A, frame_shape=FRAME, **kw)
    tree = jax.tree_util.tree_map(
        np.asarray, weights.torch_to_jax(model.state_dict()))
    if name == "pipelined_mlp":
        # Stage-stacked [S=4, d, ff] kernels under the expert names, whose
        # leading dim divides by 2: only the router signature tells.
        assert tree["params"]["w_in"].shape[0] % 2 == 0
    assert not _jax_picked(jax_expert_param_shardings(mesh, tree))
    assert not _picked(parallel.expert_param_shardings(2, tree), "expert")
    assert parallel.set_expert_devices(model, ["cpu", "cpu"]) == 0


# ------------------------------------------------------------ the drivers


def _mono(tmp_path, xpid, *extra, total_steps=48):
    return monobeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "transformer",
        "--num_experts", "8", "--num_actors", "4", "--batch_size", "4",
        "--unroll_length", "4", "--total_steps", str(total_steps),
        "--serial_envs", "--savedir", str(tmp_path), "--xpid", xpid,
        "--attention_impl", "pallas", "--vtrace_impl", "pallas", *extra])


@pytest.mark.parametrize("extra,error,match", [
    (["--num_experts", "0", "--expert_parallel", "2"], ValueError,
     "--expert_parallel needs --num_experts"),
    (["--expert_parallel", "3"], ValueError,
     "--num_experts 8 not divisible by --expert_parallel 3"),
    (["--num_experts", "16", "--expert_parallel", "16"], ValueError,
     "--expert_parallel 16 but only 8 devices are visible"),
    (["--expert_parallel", "2", "--num_learner_devices", "2"], ValueError,
     "--num_learner_devices in the sync trainer is plain DP"),
    (["--expert_parallel", "2", "--sequence_parallel", "2"],
     ValueError, "--attention_impl pallas and --sequence_parallel are "
     "mutually exclusive"),
], ids=["needs_experts", "divisible", "visible", "dp_x_ep", "sp_x_ep"])
def test_monobeast_reference_errors(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        monobeast.train(_mono(tmp_path, "bad", *extra))
    assert not (tmp_path / "bad").exists()


@pytest.mark.parametrize("extra", [
    ["--expert_parallel", "2", "--opt_impl", "pallas", "--remat", "all"],
    ["--num_learner_devices", "2"]], ids=["ep2", "dp2"])
def test_monobeast_trains_moe_across_devices(tmp_path, extra):
    stats = monobeast.train(_mono(tmp_path, "x", *extra))
    assert stats["step"] == 48 and np.isfinite(stats["total_loss"])
    assert float(stats["aux_loss"]) > 0


def _poly(tmp_path, xpid, *extra, total_steps=40):
    return polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "transformer",
        "--num_experts", "4", "--num_servers", "2", "--batch_size", "4",
        "--unroll_length", "5", "--total_steps", str(total_steps),
        "--savedir", str(tmp_path), "--xpid", xpid, "--pipes_basename",
        f"unix:{tmp_path}/pipes", "--max_inference_batch_size", "4",
        "--expert_parallel", "2", *extra])


@pytest.mark.parametrize("runtime", [
    ["--no_native_runtime"], ["--native_runtime", "--native_server"]],
    ids=["python", "native"])
def test_polybeast_composite_mesh_trains(tmp_path, runtime):
    stats = polybeast.train(_poly(tmp_path, "poly-ep", *runtime,
                                  "--num_learner_devices", "2"))
    assert stats["step"] >= 40 and np.isfinite(stats["total_loss"])
    assert stats["health"] == "HEALTHY"
    import json

    last = [json.loads(line) for line in
            open(tmp_path / "poly-ep" / "telemetry.jsonl")][-1]
    assert last["learner.mesh_shape"] == {"data": 2, "model": 1,
                                          "expert": 2}


@pytest.mark.parametrize("extra,error,match", [
    (["--num_learner_devices", "2", "--precision", "bf16_train"],
     RuntimeError, "do not compose with --expert_parallel"),
    (["--num_learner_devices", "2", "--factored_opt_state"],
     RuntimeError, "do not compose with --expert_parallel"),
    (["--num_learner_devices", "8"], ValueError,
     "Requested a 16-device mesh but only 8 devices are visible"),
    (["--num_learner_devices", "1", "--num_experts", "16",
      "--expert_parallel", "16"], ValueError,
     "--expert_parallel 16 but only 8 devices are visible"),
], ids=["bf16_train", "factored", "mesh_visible", "ep_visible"])
def test_polybeast_reference_errors(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        polybeast.train(_poly(tmp_path, "bad", *extra))


def test_polybeast_one_learner_device_takes_the_expert_mesh(tmp_path):
    """--num_learner_devices 1 --expert_parallel 2: the reference's 1-D
    expert mesh under the one-device update, bf16_train allowed."""
    stats = polybeast.train(_poly(tmp_path, "poly-ep1",
                                  "--no_native_runtime", "--precision",
                                  "bf16_train", total_steps=20))
    assert stats["step"] >= 20 and np.isfinite(stats["total_loss"])


def test_anakin_moe_over_two_devices_trains(tmp_path):
    stats = anakin.train(anakin.make_parser().parse_args([
        "--disable_cuda", "--env", "Catch", "--batch_size", "4",
        "--unroll_length", "4", "--savedir", str(tmp_path), "--xpid", "a",
        "--model", "transformer", "--num_experts", "4", "--num_devices",
        "2", "--total_steps", "64", "--checkpoint_interval_s", "100000"]))
    assert stats["step"] == 64 and np.isfinite(stats["total_loss"])
    assert float(stats["aux_loss"]) > 0


def test_ep_checkpoint_resumes_on_one_device_and_in_the_reference(
        tmp_path):
    """monobeast --expert_parallel 2 writes model.ckpt; the one-device
    port resumes it, and so does the reference's --expert_parallel 2 run
    (whole leaves in the reference's layout)."""
    monobeast.train(_mono(tmp_path, "ckpt", "--expert_parallel", "2",
                          total_steps=16))
    stats = monobeast.train(_mono(tmp_path, "ckpt", total_steps=32))
    assert stats["step"] == 32
    stats = jax_monobeast.train(jax_monobeast.make_parser().parse_args([
        "--env", "Mock", "--model", "transformer", "--num_experts", "8",
        "--expert_parallel", "2", "--num_actors", "4", "--batch_size",
        "4", "--unroll_length", "4", "--total_steps", "48",
        "--serial_envs", "--savedir", str(tmp_path), "--xpid", "ckpt"]))
    assert stats["step"] == 48


# ------------------------------------------------------- two processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _workers(mode, tmp_path, *args, timeout=300):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, mode, str(rank), "2", str(port),
         str(tmp_path), *map(str, args)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank}:\n{out[-4000:]}"
    return outs


def test_two_process_data_x_expert_update_matches_one_device(tmp_path):
    """Two gloo processes, 2 CPU devices each, one (data 2 x expert 2)
    mesh: the routing counts all_gathered across them mid-forward; the
    update equals the one-device update on all 8 rows in both."""
    outs = _workers("update_ep", tmp_path)
    for out in outs:
        assert "two-process data x expert update matches one device OK" \
            in out, out
    digests = {np.load(tmp_path / f"params{r}.npy").tobytes()
               for r in range(2)}
    assert len(digests) == 1


def test_two_process_polybeast_dp_ep(tmp_path):
    """The reference's dp_ep mode (tests/poly_distributed_worker.py):
    polybeast over a (data 2 x expert 2) mesh across two processes."""
    outs = _workers("poly_ep", tmp_path, 40)
    updates = {out.split(f"worker {r}: final step")[1].split()[2]
               for r, out in enumerate(outs)}
    assert len(updates) == 1, updates
    assert (tmp_path / "poly-dist" / "model.ckpt").exists()
