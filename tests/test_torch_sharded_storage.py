"""Sharded storage in the port (torchbeast_tpu_torch/models/sharded.py,
parallel/{ep,tp,dp}.py, learner.RMSpropChain, weights.py,
utils/checkpoint.py, polybeast.py) against the JAX package's polybeast
placement on the CPU's 8 virtual devices (tests/conftest.py's XLA_FLAGS),
at small widths (1 layer, d 16, 4 heads, memory 4; 4 experts under EP).

The reference's polybeast, on a learner mesh with --tensor_parallel or
--expert_parallel, merges the TP and EP rules, device_puts its params
and optimizer state on them and keeps 1/K of each split leaf (and of its
RMSprop state) a device. The layouts: data 1 x model 2, data 2 x model
2, data 1 x model 2 x expert 2 and data 2 x expert 2.

- (a) Bytes per device: the reference's params and opt_state placed with
  jax.device_put, their addressable shards' bytes summed per device and
  per kind of leaf (split over `model`, over `expert`, replicated). The
  port's learner holds, in each (data row, slot), the bytes of the same
  kind of leaf that the reference's device at that place holds; its row
  device holds what the reference's does in all, every other slot at
  most that (the port keeps replicated leaves only on the row's device).
  Its RMSprop state (nu and the momentum trace; the scalar counts
  aside) lies on row 0 only, equal there slot by slot and in all. No
  split leaf is left whole in any replica's params, gradients or state.
- (b) Three sharded updates against the reference's sharded update
  (momentum 0.9, RMSprop eps 1.0 as tests/test_torch_parallel.py
  explains): params rtol 1e-4 / atol 1e-6 through the assembly,
  total_loss and aux_loss rtol 2e-4, the global norm (summed from the
  slots' partial sums) rtol 1e-4.
- (c) polybeast --tensor_parallel 2 (Python pool) and --num_learner_
  devices 2 --expert_parallel 2 (the C++ core) write a checkpoint with
  the one-device tree (keys, shapes and dtypes of an unsharded run's);
  the reference restores it into its own templates, bit for bit the
  writer's assembled params and nu, and updates from it;
  the port resumes it on one device (model 2 -> model 1) and on data 1 x
  model 2 x expert 2.
- (d) In those runs every publish leaves the acting copy's params equal,
  bit for bit, to the learner's assembled params, and the acting copy
  holds whole leaves.
"""

import collections
import copy
import functools
import json

import numpy as np
import pytest
import torch

import jax

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu import monobeast as jax_monobeast
from torchbeast_tpu import polybeast as jax_polybeast
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.parallel import create_mesh as jax_create_mesh
from torchbeast_tpu.parallel import (
    expert_param_shardings as jax_expert_param_shardings,
    make_parallel_update_step as jax_parallel_update,
    merge_param_shardings as jax_merge_param_shardings,
    shard_batch as jax_shard_batch,
    transformer_tp_shardings as jax_transformer_tp_shardings,
)
from torchbeast_tpu.utils.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import monobeast, parallel, polybeast, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.models import sharded
from torchbeast_tpu_torch.utils import checkpoint, serialization
from tests.test_torch_ep import A, B, FRAME, _hp, _torch, make_batch
from tests.test_torch_tp import KW, _start_params
from tests.test_torch_tp_pp_drivers import RUNTIMES
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

# (data, model, expert)
LAYOUTS = {"model2": (1, 2, 1), "data2_model2": (2, 2, 1),
           "model2_expert2": (1, 2, 2), "data2_expert2": (2, 1, 2)}
UPDATES = 3


def _hparams(package):
    return package.HParams(**_hp(rmsprop_momentum=0.9))


def _ref_bytes(tree) -> collections.Counter:
    """{(device id, kind): bytes} of a placed tree's addressable shards;
    kind "model", "expert" or None (replicated). Scalars (the optimizer's
    counts) are left out."""
    out = collections.Counter()
    for leaf in jax.tree_util.tree_leaves(tree):
        if leaf.ndim == 0:
            continue
        spec = tuple(leaf.sharding.spec)
        kind = ("model" if "model" in spec
                else "expert" if "expert" in spec else None)
        for sh in leaf.addressable_shards:
            out[(sh.device.id, kind)] += sh.data.nbytes
    return out


@functools.lru_cache(maxsize=None)
def _reference(layout):
    """The reference polybeast's placement and its sharded update, three
    times from the same start: (start params, device ids [data, model,
    expert], params bytes, opt_state bytes, [(params, stats)] after each
    update)."""
    data, model_par, expert = LAYOUTS[layout]
    moe = {"num_experts": 4} if expert > 1 else {}
    start = _start_params(**moe)
    mesh = jax_create_mesh(data * model_par * expert,
                           model_parallelism=model_par,
                           expert_parallelism=expert)
    model = jax_create_model("transformer", num_actions=A,
                             moe_mesh=mesh if expert > 1 else None, **KW,
                             **moe)
    hp = _hparams(jax_learner)
    optimizer = jax_learner.make_optimizer(hp)
    rules = ([jax_expert_param_shardings] if expert > 1 else []) + (
        [jax_transformer_tp_shardings] if model_par > 1 else [])
    opt_state = optimizer.init(start)
    p_sh = jax_merge_param_shardings(*(r(mesh, start) for r in rules))
    o_sh = jax_merge_param_shardings(*(r(mesh, opt_state) for r in rules))
    params = jax.tree_util.tree_map(jax.device_put, start, p_sh)
    opt_state = jax.tree_util.tree_map(jax.device_put, opt_state, o_sh)
    ids = np.vectorize(lambda d: d.id)(np.asarray(mesh.devices)).reshape(
        data, model_par, expert)
    p_bytes, o_bytes = _ref_bytes(params), _ref_bytes(opt_state)
    step = jax_parallel_update(model, optimizer, hp, mesh, donate=False,
                               param_shardings=p_sh, opt_shardings=o_sh)
    after = []
    for seed in range(UPDATES):
        b, s = jax_shard_batch(mesh, make_batch(seed),
                               model.initial_state(B))
        params, opt_state, stats = step(params, opt_state, b, s)
        after.append((jax.device_get(params), jax.device_get(stats)))
    return start, ids, p_bytes, o_bytes, after


def _port_learner(layout, start):
    data, model_par, expert = LAYOUTS[layout]
    moe = {"num_experts": 4} if expert > 1 else {}
    model = port_create_model("transformer", A, frame_shape=FRAME, **KW,
                              **moe)
    weights.load_jax_params(model, start)
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mesh = parallel.create_mesh(data * model_par * expert,
                                model_parallelism=model_par,
                                expert_parallelism=expert)
    hp = _hparams(port_learner)
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    return (model, opt, hp, mesh, whole,
            parallel.make_parallel_update_step(model, opt, hp, mesh))


def _place(ids, row, pos):
    """The reference's device id and leaf kind at the port's (row, slot
    position): the row's device for whole leaves, model slot j at
    (row, j, 0), expert slot j at (row, 0, j)."""
    if pos is None:
        return ids[row, 0, 0], None
    axis, j = pos
    return (ids[row, j, 0] if axis == "model" else ids[row, 0, j]), axis


def _totals(counter):
    out = collections.Counter()
    for (dev, _), n in counter.items():
        out[dev] += n
    return out


def _no_whole_split_leaf(replica, tensors, whole):
    """Every slice in `tensors` (aligned with replica.parameters()) is
    smaller than its whole leaf, and the whole leaves' names are gone."""
    names = [n for n, _ in replica.named_parameters()]
    positions = sharded.positions(replica)
    for name, pos, t in zip(names, positions, tensors):
        if pos is not None:
            leaf = name.rsplit("_slot", 1)[0]
            assert leaf not in names
            assert t.numel() < int(np.prod(whole[leaf])), name
            assert tuple(t.shape) != whole[leaf], name
    assert sum(t.numel() for t in tensors) == sum(
        int(np.prod(s)) for s in whole.values())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bytes_per_device_are_the_references(layout):
    start, ids, p_bytes, o_bytes, _ = _reference(layout)
    model, opt, hp, mesh, whole, update = _port_learner(layout, start)
    learner = update.learner
    assert sharded.is_sharded(model)
    # Params: each (row, slot) holds the reference's bytes of that kind
    # of leaf on the device at its place.
    port_total = collections.Counter()
    for i, replica in enumerate(learner.replicas):
        for pos, n in sharded.slot_bytes(replica).items():
            place = _place(ids, i, pos)
            assert n == p_bytes[place], (i, pos, n, p_bytes[place])
            port_total[place[0]] += n
        _no_whole_split_leaf(replica, list(replica.parameters()), whole)
    ref_total = _totals(p_bytes)
    for dev, n in ref_total.items():
        assert port_total[dev] <= n
    for i in range(LAYOUTS[layout][0]):
        assert port_total[ids[i, 0, 0]] == ref_total[ids[i, 0, 0]]
    # The optimizer: nu and the trace on row 0's slots, the reference's
    # bytes there; nothing on the other rows.
    st = opt.state
    state_total = collections.Counter()
    for tensors in (st.nu, st.mom):
        assert all(t.device == p.device and t.shape == p.shape
                   for t, p in zip(tensors, opt.params))
        _no_whole_split_leaf(model, tensors, whole)
        for pos, n in sharded.slot_bytes(model, tensors).items():
            state_total[_place(ids, 0, pos)] += n
    for place, n in state_total.items():
        assert n == o_bytes[place], (place, n, o_bytes[place])
    port_state, ref_state = _totals(state_total), _totals(o_bytes)
    assert port_state[ids[0, 0, 0]] == ref_state[ids[0, 0, 0]]
    for dev, n in ref_state.items():
        assert port_state[dev] <= n
    # The gradients land on their slots, a slice each.
    shards = parallel.shard_batch(mesh, _torch(make_batch()),
                                  model.initial_state(B)).shards
    fns = [functools.partial(learner.grads, i, b, s)
           for i, (b, s) in enumerate(shards)]
    outs = (learner.exchange.run(fns) if learner.exchange is not None
            else [fn() for fn in fns])
    for (grads, _), replica in zip(outs, learner.replicas):
        assert all(g.shape == p.shape and g.device == p.device
                   for g, p in zip(grads, replica.parameters()))
        _no_whole_split_leaf(replica, grads, whole)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_three_sharded_updates_match_the_reference(layout):
    start, _, _, _, after = _reference(layout)
    model, _, _, _, _, update = _port_learner(layout, start)
    for seed, (want_params, want_stats) in enumerate(after):
        stats = update(_torch(make_batch(seed)), model.initial_state(B))
        for key, rtol in (("total_loss", 2e-4), ("aux_loss", 2e-4),
                          ("grad_norm", 1e-4)):
            if key in want_stats:
                np.testing.assert_allclose(
                    float(stats[key]), float(want_stats[key]), rtol=rtol,
                    err_msg=f"{key} after update {seed + 1}")
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(
                g, np.asarray(w), rtol=1e-4, atol=1e-6),
            weights.torch_to_jax(parallel.local_view(model)), want_params)
    for replica in update.learner.params[1:]:
        assert all(torch.equal(p, q)
                   for p, q in zip(replica, update.learner.params[0]))


def test_assembly_round_trips_and_refuses_a_partial_leaf():
    model = port_create_model("transformer", A, frame_shape=FRAME, **KW,
                              num_experts=4)
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert parallel.set_model_devices(model, ["cpu"] * 2) == 8
    assert parallel.shard_expert_params(model, ["cpu"] * 2) == 2
    view = parallel.local_view(model)
    assert list(view) == list(whole)
    assert all(torch.equal(view[n], t) for n, t in whole.items())
    # split is assembly's inverse; load writes through it.
    parts = sharded.split(model, view)
    assert all(torch.equal(a, p) for a, p in zip(parts, model.parameters()))
    sharded.load(model, {n: t + 1 for n, t in whole.items()})
    assert all(torch.equal(parallel.local_view(model)[n], t + 1)
               for n, t in whole.items())
    # A leaf missing a slice is refused as the reference's local_view
    # refuses a leaf sharded across processes.
    broken = copy.deepcopy(model)
    del broken.block_0.q._parameters["weight_slot1"]
    with pytest.raises(ValueError, match="sharded ACROSS processes"):
        parallel.local_view(broken)
    # Unsharding restores the one-device module.
    sharded.unshard(model)
    assert not sharded.is_sharded(model)
    assert [n for n, _ in model.named_parameters()] == list(whole)


# --------------------------------------------- polybeast, end to end


# (the sharded run's flags, the resume's, the resume's mesh shape),
# each on one runtime.
POLY = [
    pytest.param(["--tensor_parallel", "2"], [], {"data": 1, "model": 1},
                 *RUNTIMES[0].values, id="model2_python",
                 marks=RUNTIMES[0].marks),
    pytest.param(["--num_experts", "4", "--expert_parallel", "2",
                  "--num_learner_devices", "2"],
                 ["--num_experts", "4", "--expert_parallel", "2",
                  "--tensor_parallel", "2"],
                 {"data": 1, "model": 2, "expert": 2},
                 *RUNTIMES[1].values, id="data2_expert2_native",
                 marks=RUNTIMES[1].marks),
]


def _poly_argv(tmp_path, xpid, total_steps, *extra):
    return ["--env", "Mock", "--model", "transformer", "--num_servers",
            "2", "--batch_size", "4", "--unroll_length", "4",
            "--total_steps", str(total_steps),
            "--max_inference_batch_size", "4", "--pipes_basename",
            f"unix:{tmp_path}/pipes", "--savedir", str(tmp_path), "--xpid",
            xpid, "--vtrace_impl", "pallas", "--checkpoint_interval_s",
            "100000", "--momentum", "0.9", *extra]


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(np.shape(v)),
                                      np.asarray(v).dtype)
            for p, v in flat}


def _arrays(tree):
    """path -> (shape, dtype, bytes) of each leaf, for exact equality."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))
    return {jax.tree_util.keystr(p): (np.shape(v), np.asarray(v).dtype,
                                      np.asarray(v).tobytes())
            for p, v in flat}


def _rms_nu(opt_state):
    """The params-shaped nu of the optax chain's RMSprop state."""
    found = []

    def visit(x):
        if hasattr(x, "nu"):
            found.append(x.nu)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif isinstance(x, dict):
            for y in x.values():
                visit(y)

    visit(opt_state)
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize("layout,resume,resume_shape,runtime", POLY)
def test_polybeast_checkpoint_and_publish(tmp_path, monkeypatch, layout,
                                          resume, resume_shape, runtime):
    # (d): every publish, checked where it happens.
    publishes = []
    publish = sharded.Publisher.__call__

    def checked(self):
        publish(self)
        assert sharded.is_sharded(self.model)
        view = parallel.local_view(self.model)
        assert len(self.whole) == len(view)
        assert all(torch.equal(d, v)
                   for d, v in zip(self.whole, view.values()))
        publishes.append(len(self.whole))

    # (c): what the learner held when the run wrote its checkpoint.
    saved = {}
    save = polybeast.save_train_state

    def recorded(path, model, optimizer, **kw):
        save(path, model, optimizer, **kw)
        saved["params"] = weights.param_list_to_jax(
            model, list(model.parameters()))
        saved["nu"] = weights.optimizer_state_to_jax(
            model, optimizer.state)["nu"]

    monkeypatch.setattr(sharded.Publisher, "__call__", checked)
    monkeypatch.setattr(polybeast, "save_train_state", recorded)
    argv = _poly_argv(tmp_path, "x", 24, *layout)
    stats = polybeast.main(polybeast.make_parser().parse_args(
        ["--disable_cuda", *argv, *runtime]))
    assert stats["step"] >= 24 and publishes and saved
    monkeypatch.setattr(sharded.Publisher, "__call__", publish)
    monkeypatch.setattr(polybeast, "save_train_state", save)

    # (c): the file's tree is the one-device tree.
    path = tmp_path / "x" / "model.ckpt"
    flags = polybeast.make_parser().parse_args(["--disable_cuda", *argv])
    one = monobeast.build_model(flags, 6, (84, 84, 4), torch.device("cpu"))
    opt = port_learner.make_optimizer(
        monobeast.hparams_from_flags(flags), list(one.parameters()))
    payload = checkpoint.read_payload(str(path))
    for key, template in (("params", checkpoint.params_tree(one)),
                          ("opt_state",
                           checkpoint.opt_state_tree(one, opt))):
        got = serialization.to_numpy(serialization.msgpack_restore(
            payload[key]))
        assert _leaves(got) == _leaves(serialization.to_numpy(template))
    # The reference restores it into its own templates and updates.
    ref_flags = jax_polybeast.make_parser().parse_args(argv)
    model, params = jax_monobeast._init_model_and_params(
        ref_flags, 6, 4, (84, 84, 4))
    hp = jax_monobeast.hparams_from_flags(ref_flags)
    optimizer = jax_learner.make_optimizer(hp)
    restored = jax_load_checkpoint(
        str(path), params_template=jax.device_get(params),
        opt_state_template=jax.device_get(optimizer.init(params)))
    rng = np.random.default_rng(0)
    batch = {
        "frame": rng.integers(0, 256, (5, 4, 84, 84, 4), dtype=np.uint8),
        "reward": np.zeros((5, 4), np.float32),
        "done": np.zeros((5, 4), bool),
        "episode_return": np.zeros((5, 4), np.float32),
        "episode_step": np.zeros((5, 4), np.int32),
        "last_action": rng.integers(0, 6, (5, 4)).astype(np.int32),
        "action": rng.integers(0, 6, (5, 4)).astype(np.int32),
        "policy_logits": np.zeros((5, 4, 6), np.float32),
        "baseline": np.zeros((5, 4), np.float32),
    }
    # It holds the writer's assembled params and nu, bit for bit.
    assert _arrays(restored["params"]) == _arrays(saved["params"])
    assert _arrays(_rms_nu(restored["opt_state"])) == _arrays(saved["nu"])
    _, _, ref_stats = jax_learner.make_update_step(
        model, optimizer, hp, donate=False)(
            restored["params"], restored["opt_state"], batch,
            model.initial_state(4))
    assert np.isfinite(float(ref_stats["total_loss"]))
    # The port resumes it in another layout.
    stats = polybeast.main(polybeast.make_parser().parse_args(
        ["--disable_cuda", *_poly_argv(tmp_path, "x", 40, *resume),
         *runtime]))
    assert stats["step"] >= 40
    last = [json.loads(line) for line in
            open(tmp_path / "x" / "telemetry.jsonl")][-1]
    assert last["learner.mesh_shape"] == resume_shape
