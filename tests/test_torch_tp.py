"""Tensor parallelism in the port (torchbeast_tpu_torch/parallel/tp.py,
models/transformer._Block `model_devices`, parallel/{mesh,dp}.py) against
the JAX package, on the CPU's 8 virtual devices (tests/conftest.py's
XLA_FLAGS), at small widths (1 or 2 layers, d 16, 4 heads, memory 4,
FFN 64).

- The leaf rules: the port's transformer_tp_shardings, dense_kernel_
  shardings and merge_param_shardings give the reference's PartitionSpec
  of every leaf, as a tuple, at model 2 and model 4, on the params tree
  and on the optimizer's state; the torch state dict's leaves split the
  same axes in torch's layout; the reference's ValueErrors for a head
  count that does not divide and for a merge conflict.
- The Megatron block: one forward and backward of the transformer with
  its blocks split over 2 and 4 model devices against the one-device
  model: outputs rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6
  (the head and FFN groups' partial sums add in another order).
- The update: the port's sharded update at model 2, data 2 x model 2 and
  (the MoE transformer) data 1 x model 2 x expert 2 against the
  reference's make_parallel_update_step with its TP (and EP) shardings
  on the same devices: stats rtol 1e-4, params rtol 1e-4 / atol 1e-6 at
  RMSprop eps 1.0 (tests/test_torch_parallel.py's tolerances and
  reason).
- Two gloo processes (tests/torch_dp_worker.py `update_tp`), each one
  data row of 2 model devices: the update equals the one-device update
  on all 8 rows in both processes.
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
from jax.sharding import NamedSharding, PartitionSpec as P

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.parallel import create_mesh as jax_create_mesh
from torchbeast_tpu.parallel import (
    dense_kernel_shardings as jax_dense_kernel_shardings,
    expert_param_shardings as jax_expert_param_shardings,
    make_parallel_update_step as jax_parallel_update,
    merge_param_shardings as jax_merge_param_shardings,
    shard_batch as jax_shard_batch,
    transformer_tp_shardings as jax_transformer_tp_shardings,
)
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import parallel, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.models import sharded
from torchbeast_tpu_torch.parallel import ep, tp
from torchbeast_tpu_torch.utils import checkpoint
from tests.test_torch_ep import A, B, FRAME, STAT_KEYS, T, _hp, _torch
from tests.test_torch_ep import make_batch
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

KW = dict(num_layers=1, d_model=16, num_heads=4, memory_len=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(model):
    return jax.tree_util.tree_map(
        np.asarray, weights.torch_to_jax(model.state_dict()))


def _jax_specs(shardings):
    """{path tuple: the spec as a tuple} of a tree of NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: hasattr(x, "spec"))
    return {tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                  for p in path): tuple(s.spec) for path, s in flat}


def _port_specs(specs):
    return {tuple(str(p) for p in path): spec
            for path, spec in ep._flat(specs, specs=True)}


def _state_key(path):
    """An optimizer state leaf's path as (its moment, the params path):
    the two packages nest the chain's states otherwise."""
    toks = [t.lstrip(".") for t in path]
    i = toks.index("params")
    return (toks[i - 1],) + tuple(toks[i:])


def _same_specs(ours, theirs):
    got, want = _port_specs(ours), _jax_specs(theirs)
    assert got.keys() == want.keys()
    for path, spec in want.items():
        assert tuple(got[path]) == spec, (path, got[path], spec)
    return sum(spec != () for spec in want.values())


# ------------------------------------------------------------ leaf rules


@pytest.mark.parametrize("size", [2, 4])
def test_tp_specs_are_the_references(size):
    mesh = jax_create_mesh(8, model_parallelism=size)
    model = port_create_model("transformer", A, frame_shape=FRAME,
                              **{**KW, "num_layers": 2})
    tree = _tree(model)
    n = _same_specs(parallel.transformer_tp_shardings(size, tree),
                    jax_transformer_tp_shardings(mesh, tree))
    assert n == 2 * 11  # 11 leaves a block (tests/test_parallel.py)
    # The optimizer's state, params-shaped, as the reference's (momentum
    # on: nu and the trace).
    hp = port_learner.HParams(**_hp(rmsprop_momentum=0.9))
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    port_state = checkpoint.opt_state_tree(model, opt)
    jax_state = jax_learner.make_optimizer(
        jax_learner.HParams(**_hp(rmsprop_momentum=0.9))).init(tree)
    got = {_state_key(p): s for p, s in _port_specs(
        parallel.transformer_tp_shardings(size, port_state)).items()
        if s != ()}
    want = {_state_key(p): s for p, s in _jax_specs(
        jax_transformer_tp_shardings(mesh, jax_state)).items() if s != ()}
    assert got == want and len(got) == 2 * 2 * 11
    # The torch state dict: the same leaves, split on torch's axes.
    flat = {".".join(p): s for p, s in _port_specs(
        parallel.transformer_tp_shardings(size, model.state_dict())).items()
        if s != ()}
    block = {"q.weight": ("model", None), "q.bias": ("model",),
             "k.weight": ("model", None), "k.bias": ("model",),
             "v.weight": ("model", None), "v.bias": ("model",),
             "out.weight": (None, "model"), "rel_bias": ("model", None),
             "Dense_0.weight": ("model", None), "Dense_0.bias": ("model",),
             "Dense_1.weight": (None, "model")}
    assert flat == {f"block_{i}.{k}": v for i in (0, 1)
                    for k, v in block.items()}
    # The placement (set_model_devices over models/sharded.shard):
    # slices on the row's model devices that cat back to the whole leaf,
    # 1/size of the split leaves' bytes each.
    placed = copy.deepcopy(model)
    devices = parallel.create_mesh(
        size, model_parallelism=size).model_devices(0)
    assert parallel.set_model_devices(placed, devices) == len(flat)
    out_w = sharded.slots(placed.block_0.out, "weight")
    assert [t.device for t in out_w] == devices
    assert torch.equal(torch.cat(out_w, dim=1), model.block_0.out.weight)
    assert sharded.slots(placed.block_0.LayerNorm_0, "weight") is None
    whole = model.state_dict()
    split_bytes = sum(whole[k].numel() * 4 for k in flat)
    assert sharded.slot_bytes(placed) == {
        None: sum(t.numel() * 4 for t in whole.values()) - split_bytes,
        **{("model", j): split_bytes // size for j in range(size)}}


@pytest.mark.parametrize("name", ["shallow", "deep"])
def test_dense_kernel_specs_are_the_references(name):
    mesh = jax_create_mesh(8, model_parallelism=2)
    model = port_create_model(name, A, use_lstm=True, frame_shape=FRAME)
    tree = _tree(model)
    n = _same_specs(parallel.dense_kernel_shardings(2, tree),
                    jax_dense_kernel_shardings(mesh, tree))
    assert n > 0


def test_merge_is_the_references_and_conflicts_raise():
    mesh = jax_create_mesh(8, model_parallelism=2, expert_parallelism=2)
    model = port_create_model("transformer", A, frame_shape=FRAME,
                              num_experts=4, **KW)
    tree = _tree(model)
    n = _same_specs(
        parallel.merge_param_shardings(
            parallel.expert_param_shardings(2, tree),
            parallel.transformer_tp_shardings(2, tree)),
        jax_merge_param_shardings(jax_expert_param_shardings(mesh, tree),
                                  jax_transformer_tp_shardings(mesh, tree)))
    # 2 expert kernels + 8 attention leaves (tests/test_composite_mesh.py).
    assert n == 10
    a = {"w": NamedSharding(mesh, P("expert"))}
    b = {"w": NamedSharding(mesh, P("model"))}
    with pytest.raises(ValueError) as theirs:
        jax_merge_param_shardings(a, b)
    with pytest.raises(ValueError) as ours:
        parallel.merge_param_shardings({"w": ep.EXPERT}, {"w": ("model",)})
    assert str(ours.value) == str(theirs.value)


def test_indivisible_heads_raise_the_references_error():
    mesh = jax_create_mesh(8, model_parallelism=4)
    model = port_create_model("transformer", A, frame_shape=FRAME,
                              **{**KW, "num_heads": 2})
    tree = _tree(model)
    with pytest.raises(ValueError) as theirs:
        jax_transformer_tp_shardings(mesh, tree)
    with pytest.raises(ValueError) as ours:
        parallel.transformer_tp_shardings(4, tree)
    assert str(ours.value) == str(theirs.value)
    assert "num_heads (2)" in str(ours.value)
    with pytest.raises(ValueError, match="num_heads"):
        parallel.set_model_devices(model, ["cpu"] * 4)


# ------------------------------------------------------- the split block


@pytest.mark.parametrize("size,impl", [(2, "dense"), (4, "dense"),
                                       (2, "pallas")])
def test_split_block_is_the_one_device_block(size, impl):
    torch.manual_seed(0)
    model = port_create_model("transformer", A, frame_shape=FRAME,
                              attention_impl=impl,
                              **{**KW, "num_layers": 2})
    split = copy.deepcopy(model)
    assert parallel.set_model_devices(split, ["cpu"] * size) == 22
    batch = _torch(make_batch())
    rng = np.random.default_rng(4)
    state = tuple(tuple(torch.from_numpy(
        rng.standard_normal(t.shape).astype(np.float32)) for t in layer[:2])
        + (layer[2] + 1,) for layer in model.initial_state(B))
    w = torch.from_numpy(rng.standard_normal((T + 1, B, A)).astype(
        np.float32))
    outs = []
    for m in (model, split):
        out, new_state = m(batch, state, sample_action=False)
        loss = torch.sum(out.policy_logits * w) + out.baseline.sum()
        loss.backward()
        outs.append((out, new_state, list(parallel.local_view(
            m, [p.grad for p in m.parameters()]).values())))
    (o1, s1, g1), (o2, s2, g2) = outs
    np.testing.assert_allclose(o2.policy_logits.detach().numpy(),
                               o1.policy_logits.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(s2),
                    jax.tree_util.tree_leaves(s1)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
    # One device again: the plain block, its leaves whole.
    parallel.set_model_devices(split, None)
    assert not sharded.is_sharded(split)
    assert [n for n, _ in split.named_parameters()] == [
        n for n, _ in model.named_parameters()]


# ------------------------------------------------ updates, the reference's


def _start_params(seed=0, **kw):
    model = jax_create_model("transformer", num_actions=A, **KW, **kw)
    params = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(seed),
         "action": jax.random.PRNGKey(seed + 1)},
        make_batch(), model.initial_state(B)))
    return jax.tree_util.tree_map(np.array, params)


@functools.lru_cache(maxsize=None)
def _reference(data, expert):
    """The reference's update over a (data x model 2 [x expert]) mesh with
    the TP (and EP) shardings merged: (start params, params after one
    update, stats)."""
    moe = {"num_experts": 4} if expert > 1 else {}
    start = _start_params(**moe)
    mesh = jax_create_mesh(data * 2 * expert, model_parallelism=2,
                           expert_parallelism=expert)
    model = jax_create_model("transformer", num_actions=A,
                             moe_mesh=mesh if expert > 1 else None, **KW,
                             **moe)
    hp = jax_learner.HParams(**_hp())
    optimizer = jax_learner.make_optimizer(hp)
    rules = [jax_transformer_tp_shardings(mesh, start)]
    if expert > 1:
        rules.append(jax_expert_param_shardings(mesh, start))
    shardings = jax_merge_param_shardings(*rules)
    params = jax.tree_util.tree_map(jax.device_put, start, shardings)
    step = jax_parallel_update(model, optimizer, hp, mesh, donate=False,
                               param_shardings=shardings)
    b, s = jax_shard_batch(mesh, make_batch(), model.initial_state(B))
    p, _, stats = step(params, optimizer.init(params), b, s)
    return start, jax.device_get(p), jax.device_get(stats)


@pytest.mark.parametrize("data,expert", [(1, 1), (2, 1), (1, 2)],
                         ids=["model2", "data2_model2",
                              "data1_model2_expert2"])
def test_tp_update_matches_the_reference(data, expert):
    start, want_params, want_stats = _reference(data, expert)
    moe = {"num_experts": 4} if expert > 1 else {}
    model = port_create_model("transformer", A, frame_shape=FRAME, **KW,
                              **moe)
    weights.load_jax_params(model, start)
    mesh = parallel.create_mesh(data * 2 * expert, model_parallelism=2,
                                expert_parallelism=expert)
    assert mesh.shape == dict(jax_create_mesh(
        data * 2 * expert, model_parallelism=2,
        expert_parallelism=expert).shape)
    hp = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    update = parallel.make_parallel_update_step(model, opt, hp, mesh)
    for i, replica in enumerate(update.learner.replicas):
        blocks = [m for m in replica.modules() if hasattr(m, "rel_bias")]
        assert blocks
        # The split leaves are resident slices on the row's model
        # devices; no whole copy stays.
        for b in blocks:
            split = [(b.q, "weight"), (b.out, "weight"), (b, "rel_bias")]
            if not hasattr(b, "moe"):
                split.append((b.Dense_0, "bias"))
            for module, leaf in split:
                assert getattr(module, leaf) is None
                assert [t.device for t in sharded.slots(module, leaf)] \
                    == mesh.model_devices(i)
    assert not update.learner.spans_cards
    stats = update(_torch(make_batch()), model.initial_state(B))
    for key in STAT_KEYS:
        if key in want_stats:
            np.testing.assert_allclose(float(stats[key]),
                                       float(want_stats[key]), rtol=1e-4,
                                       err_msg=key)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                                atol=1e-6),
        weights.torch_to_jax(parallel.local_view(model)), want_params)
    for replica in update.learner.params[1:]:
        assert all(torch.equal(p, q)
                   for p, q in zip(replica, update.learner.params[0]))


def test_rows_on_other_devices_run_eagerly():
    """The graph-or-eager choice: a row whose devices are one device
    captures; a row over two devices does not (on the CPU nothing
    captures, so the choice is read from the learner)."""
    model = port_create_model("transformer", A, frame_shape=FRAME, **KW)
    hp = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    one = parallel.create_mesh(devices=["cpu", "cpu"], model_parallelism=2)
    assert not one.spans_cards()
    two = parallel.Mesh(np.array(
        [torch.device("cpu"), torch.device("meta")],
        dtype=object).reshape(1, 2, 1, 1, 1))
    assert two.spans_cards()
    learner = parallel.ParallelLearner(model, opt, hp, one)
    assert not learner.spans_cards and not learner.captures()


# ------------------------------------------------------- two processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_data_x_model_update_matches_one_device(tmp_path):
    """Two gloo processes, 2 CPU devices each, one (data 2 x model 2)
    mesh: each process one data row of 2 model devices; the update
    equals the one-device update on all 8 rows in both."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])}
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "update_tp", str(rank), "2", str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for rank in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank}:\n{out[-4000:]}"
        assert "two-process data x model update matches one device OK" \
            in out, out
    digests = {np.load(tmp_path / f"params{r}.npy").tobytes()
               for r in range(2)}
    assert len(digests) == 1
