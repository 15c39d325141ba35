"""Pipeline parallelism in the port (torchbeast_tpu_torch/parallel/pp.py,
the `mesh` branches of models/pipelined.py and models/transformer_pp.py)
against the JAX package's GPipe (torchbeast_tpu/parallel/pp.py) on the
CPU's 8 virtual devices (tests/conftest.py's XLA_FLAGS).

- pipeline_apply and pipeline_apply_multi against the reference's own
  functions on the same numpy inputs (tests/test_pp.py's residual tanh
  stage of width 16, B=8): the outputs, the stage carry and the shared
  inputs, with M = S and M = 8, 4 stages over 4 devices and 8 over 4
  (two passes), and a (data 2 x pipe 2) mesh with `batch_axis`; rtol
  1e-5 / atol 1e-5 (the schedules compute the same products on the same
  rows; XLA's and torch's tanh and products differ in the last bits,
  which 8 stages compound to 2.4e-6 on values near 2). Gradients through both
  schedules rtol 1e-5 / atol 1e-6. The reference's ValueErrors, text for
  text: a batch the microbatches do not divide, microbatch rows the data
  axis does not divide, a leading dim other than the pipe axis, a stage
  count the devices do not divide; and the can_pipeline gate on a table
  of meshes and batches.
- Both pipelined families with a `pipe` mesh against the reference's
  with its pipe mesh (tests/test_torch_pipelined.py's sizes and
  tolerances: forward rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol
  1e-5): the MLP without and with its LSTM head, the transformer with
  its cache as the stage carry over two unrolls; M = 4 and 4 stages
  over 2 devices (two passes); one learner update each with the kernels'
  plain versions (params rtol 1e-5 / atol 2e-6, stats rtol 1e-4, eps
  1.0); the acting fallback (a batch the microbatches do not divide runs
  the sequential tower, as the reference's does); remat's gradients bit
  for bit; the reference's ValueError for a depth the pipe axis does not
  divide.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.parallel import create_mesh as jax_create_mesh
from torchbeast_tpu.parallel import pp as jax_pp
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import parallel, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.parallel import pp
from tests.test_torch_pipelined import (
    A,
    B,
    CONFIGS,
    FRAME,
    FWD,
    GRAD,
    T,
    _inputs,
    _jax_loss,
    _port_unrolls,
    _tensors,
)
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

D = 16
SCHED = dict(rtol=1e-5, atol=1e-5)


def _pipe_mesh(n, pipe=None):
    """The reference's 1-D pipe mesh over n devices and the port's."""
    return (Mesh(np.asarray(jax.devices()[:n]), ("pipe",)),
            parallel.create_mesh(devices=["cpu"] * n, pipe_parallelism=n))


def _stage_params(seed, n_stages):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_stages, D, D))
                  / np.sqrt(D)).astype(np.float32),
            "b": (0.1 * rng.standard_normal((n_stages, D))).astype(
                np.float32)}


def _jax_stage(params, x, carry, shared):
    """tests/test_pp.py's stage: carry and shared both read."""
    h = jnp.tanh(x @ params["w"] + params["b"])
    if shared is not None:
        h = h * shared["scale"]
    if carry is None:
        return x + h, None
    return (x + h + carry["acc"][:, None] * 0.01,
            {"acc": carry["acc"] + h.sum(axis=-1)})


def _port_stage(params, x, carry, shared):
    h = torch.tanh(x @ params["w"] + params["b"])
    if shared is not None:
        h = h * shared["scale"]
    if carry is None:
        return x + h, None
    return (x + h + carry["acc"][:, None] * 0.01,
            {"acc": carry["acc"] + h.sum(dim=-1)})


def _case(seed, n_stages, carry=True):
    rng = np.random.default_rng(seed)
    params = _stage_params(seed, n_stages)
    x = rng.standard_normal((B, D)).astype(np.float32)
    c = ({"acc": rng.standard_normal((n_stages, B)).astype(np.float32)}
         if carry else None)
    shared = ({"scale": (1 + 0.1 * rng.standard_normal((B, 1))).astype(
        np.float32)} if carry else None)
    return params, x, c, shared


def _t(tree):
    return None if tree is None else {
        k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# (stages, devices, microbatches, carry and shared)
CASES = {
    "s4_m4": (4, 4, None, False),
    "s4_m8": (4, 4, 8, False),
    "s4_carry_shared": (4, 4, None, True),
    "s8_over_4_carry_shared": (8, 4, 2, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_the_reference(case):
    n_stages, n_dev, M, carry = CASES[case]
    params, x, c, shared = _case(1, n_stages, carry)
    jmesh, mesh = _pipe_mesh(n_dev)
    want_y, want_c = jax_pp.pipeline_apply_multi(
        _jax_stage, params, x, mesh=jmesh, n_microbatches=M,
        stage_carry=c, shared=shared)
    got_y, got_c = pp.pipeline_apply_multi(
        _port_stage, _t(params), torch.from_numpy(x), mesh=mesh,
        n_microbatches=M, stage_carry=_t(c), shared=_t(shared))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SCHED)
    if carry:
        np.testing.assert_allclose(got_c["acc"].numpy(),
                                   np.asarray(want_c["acc"]), **SCHED)
    else:
        assert got_c is None and want_c is None


def test_batch_axis_runs_one_gpipe_a_data_row():
    """A (data 2 x pipe 2) mesh: each microbatch's rows split over the
    data rows, each row its own GPipe; the reference's on its composite
    mesh."""
    params, x, c, shared = _case(2, 2)
    jmesh = jax_create_mesh(4, pipe_parallelism=2)
    mesh = parallel.create_mesh(4, pipe_parallelism=2)
    assert mesh.shape == dict(jmesh.shape)
    want_y, want_c = jax_pp.pipeline_apply(
        _jax_stage, params, x, mesh=jmesh, n_microbatches=2,
        stage_carry=c, shared=shared, batch_axis="data")
    got_y, got_c = pp.pipeline_apply(
        _port_stage, _t(params), torch.from_numpy(x), mesh=mesh,
        n_microbatches=2, stage_carry=_t(c), shared=_t(shared),
        batch_axis="data")
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SCHED)
    np.testing.assert_allclose(got_c["acc"].numpy(),
                               np.asarray(want_c["acc"]), **SCHED)


@pytest.mark.parametrize("n_stages", [4, 8], ids=["one_pass", "two_passes"])
def test_gradients_match_the_reference(n_stages):
    params, x, _, _ = _case(3, n_stages, carry=False)
    target = np.random.default_rng(4).standard_normal((B, D)).astype(
        np.float32)
    jmesh, mesh = _pipe_mesh(4)

    def jax_loss(p):
        y, _ = jax_pp.pipeline_apply_multi(_jax_stage, p, x, mesh=jmesh)
        return jnp.mean((y - target) ** 2)

    want = jax.grad(jax_loss)(params)
    got = {k: v.requires_grad_() for k, v in _t(params).items()}
    y, _ = pp.pipeline_apply_multi(_port_stage, got, torch.from_numpy(x),
                                   mesh=mesh)
    torch.mean((y - torch.from_numpy(target)) ** 2).backward()
    for k in got:
        np.testing.assert_allclose(got[k].grad.numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", [
    "batch_microbatches", "rows_data_axis", "leading_dim", "passes"])
def test_schedule_errors_are_the_references(case):
    jmesh, mesh = _pipe_mesh(4)
    jcomp = jax_create_mesh(8, pipe_parallelism=4)
    comp = parallel.create_mesh(8, pipe_parallelism=4)
    params, _, _, _ = _case(5, 6 if case == "passes" else 4, carry=False)
    rows = {"batch_microbatches": 6, "rows_data_axis": 4}.get(case, 8)
    x = np.zeros((rows, D), np.float32)
    kwargs = {"batch_microbatches": dict(n_microbatches=4),
              "rows_data_axis": dict(batch_axis="data")}.get(case, {})
    if case == "leading_dim":
        params = _stage_params(5, 8)
    fn = (jax_pp.pipeline_apply_multi, pp.pipeline_apply_multi)
    if case in ("leading_dim", "batch_microbatches"):
        fn = (jax_pp.pipeline_apply, pp.pipeline_apply)
    on = (jcomp, comp) if case == "rows_data_axis" else (jmesh, mesh)
    theirs = _raised(lambda: fn[0](
        lambda p, xb, c, s: (xb, None), params, x, mesh=on[0], **kwargs))
    ours = _raised(lambda: fn[1](
        lambda p, xb, c, s: (xb, None), _t(params), torch.from_numpy(x),
        mesh=on[1], **kwargs))
    assert ours == theirs


def test_can_pipeline_gate_is_the_references():
    meshes = [(jax_create_mesh(4, pipe_parallelism=4),
               parallel.create_mesh(4, pipe_parallelism=4)),
              (jax_create_mesh(8, pipe_parallelism=4),
               parallel.create_mesh(8, pipe_parallelism=4))]
    for jmesh, mesh in meshes:
        for rows in (2, 4, 6, 8, 12, 16):
            for M in (None, 2, 3):
                for axis in (None, "data"):
                    assert pp.can_pipeline(mesh, rows, "pipe", M, axis) == \
                        jax_pp.can_pipeline(jmesh, rows, "pipe", M, axis)
                    assert pp.default_n_microbatches(mesh, "pipe", M) == \
                        jax_pp.default_n_microbatches(jmesh, "pipe", M)
    trees = [_t(_stage_params(s, 1)) for s in range(3)]
    stacked = pp.stack_stages([{k: v[0] for k, v in t.items()}
                               for t in trees])
    want = jax_pp.stack_stages([{k: np.asarray(v[0]) for k, v in t.items()}
                                for t in trees])
    for k in stacked:
        np.testing.assert_array_equal(stacked[k].numpy(), np.asarray(want[k]))
    jmesh, mesh = _pipe_mesh(4)
    specs = pp.stage_param_shardings(mesh, stacked)
    want = jax_pp.stage_param_shardings(jmesh, want)
    assert {k: tuple(v.spec) for k, v in want.items()} == specs


# ------------------------------------------------- the pipelined families


def _sized(config, kw):
    """CONFIGS[config] with its size overridden by `kw`'s depth."""
    family, use_lstm, size = CONFIGS[config]
    return (family, use_lstm, {**size, **kw})


def _pipe_models(config, n_dev=2, M=None, **kw):
    """The reference's model with a pipe mesh over n_dev devices, and a
    port model factory with the same pipe (`kw`: a depth of its own)."""
    jmesh, mesh = _pipe_mesh(n_dev)
    family, use_lstm, size = _sized(config, kw)
    jmodel = jax_create_model(family, num_actions=A, use_lstm=use_lstm,
                              mesh=jmesh, n_microbatches=M, **size)

    def port(params, **pkw):
        model = port_create_model(family, A, use_lstm=use_lstm,
                                  frame_shape=FRAME, **size, **pkw)
        weights.load_jax_params(model, params)
        parallel.set_pipeline(model, mesh, M)
        return model

    return jmodel, port


def _acting_inputs(seed, b):
    """One acting step's [1, b] inputs."""
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 256, (1, b) + FRAME, dtype=np.uint8),
        "reward": rng.standard_normal((1, b)).astype(np.float32),
        "done": rng.random((1, b)) < 0.5,
        "last_action": rng.integers(0, A, (1, b)).astype(np.int32),
    }


@functools.lru_cache(maxsize=None)
def _reference(config, n_dev=2, M=None, stages=None):
    """The reference's pipelined run (tests/test_torch_pipelined.py's
    _jax_run on a pipe mesh): params, state1, value, outputs, state2,
    gradients."""
    kw = {} if stages is None else {"num_stages": stages}
    jmodel, _ = _pipe_models(config, n_dev, M, **kw)
    state0 = jmodel.initial_state(B)
    params = jmodel.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        _inputs(10), state0)
    forward = jax.jit(lambda p, i, s: jmodel.apply(
        p, i, s, sample_action=False))
    _, state1 = forward(params, _inputs(11), state0)
    value_and_grad = jax.jit(jax.value_and_grad(
        _jax_loss(jmodel, _inputs(12), state1), has_aux=True))
    (value, (out, state2)), grads = value_and_grad(params)
    return jax.device_get((params, state1, value, out, state2, grads))


MODEL_CASES = {
    "mlp": ("mlp", 2, None, None),
    "mlp_lstm": ("mlp_lstm", 2, None, None),
    "mlp_lstm_m4_two_passes": ("mlp_lstm", 2, 4, 4),
    "transformer": ("transformer", 2, None, None),
    "transformer_m4": ("transformer", 2, 4, None),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_pipelined_model_matches_the_reference(case):
    config, n_dev, M, stages = MODEL_CASES[case]
    params, _, value, want, want_state, grads = _reference(config, n_dev,
                                                           M, stages)
    _, port = _pipe_models(config, n_dev, M, **(
        {} if stages is None else {"num_stages": stages}))
    model = port(params)
    out, loss, _, state = _port_unrolls(model, grad=True)
    assert model.last_pipelined
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(value),
                               rtol=1e-5)
    np.testing.assert_array_equal(out.action.numpy(),
                                  np.asarray(want.action))
    np.testing.assert_allclose(out.policy_logits.detach().numpy(),
                               np.asarray(want.policy_logits), **FWD)
    np.testing.assert_allclose(out.baseline.detach().numpy(),
                               np.asarray(want.baseline), **FWD)
    for g, w in zip(jax.tree_util.tree_leaves(state,
                                              is_leaf=torch.is_tensor),
                    jax.tree_util.tree_leaves(want_state)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FWD)
    got_grads = weights.torch_to_jax(
        {n: p.grad for n, p in model.named_parameters()})
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **GRAD),
        got_grads, grads)


def _learner_batch(seed=0):
    rng = np.random.default_rng(seed)
    batch = dict(_inputs(seed, t=T + 1))
    batch.update({
        "episode_return": rng.standard_normal((T + 1, B)).astype(
            np.float32),
        "episode_step": rng.integers(0, 9, (T + 1, B)).astype(np.int32),
        "action": rng.integers(0, A, (T + 1, B)).astype(np.int32),
        "policy_logits": rng.standard_normal((T + 1, B, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((T + 1, B)).astype(np.float32),
    })
    return batch


@pytest.mark.parametrize("config", ["mlp_lstm", "transformer"])
def test_pipelined_update_matches_the_reference(config):
    """One learner update (V-trace and the RMSprop tail, their plain
    versions here) through both GPipes, from the same weights on the same
    batch."""
    params = _reference(config)[0]
    jmodel, port = _pipe_models(config)
    kw = dict(batch_size=B, unroll_length=T, rmsprop_eps=1.0,
              vtrace_impl="pallas", opt_impl="pallas")
    jhp = jax_learner.HParams(**kw)
    optimizer = jax_learner.make_optimizer(jhp)
    state = jmodel.initial_state(B)
    batch = _learner_batch()
    p, _, want = jax_learner.make_update_step(
        jmodel, optimizer, jhp, donate=False)(
            params, optimizer.init(params), batch, state)
    want_params = jax.device_get(p)
    model = port(params)
    hp = port_learner.HParams(**kw)
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    got = port_learner.update_body(model, opt, hp)(
        _tensors(batch), _tensors(state) if state else ())
    assert model.last_pipelined
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, err_msg=key)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6),
        weights.torch_to_jax(model.state_dict()), want_params)


@pytest.mark.parametrize("config", ["mlp_lstm", "transformer"])
def test_acting_batch_takes_the_sequential_tower(config):
    """B=3 acting rows do not divide into 2 microbatches: both packages
    fall back to the sequential loop; the outputs agree."""
    params = _reference(config)[0]
    jmodel, port = _pipe_models(config)
    inputs = _acting_inputs(13, 3)
    assert not jax_pp.can_pipeline(jmodel.mesh, 3, "pipe")
    state = jmodel.initial_state(3)
    want, want_state = jmodel.apply(params, inputs, state,
                                    sample_action=False)
    model = port(params)
    with torch.no_grad():
        got, got_state = model(_tensors(inputs), _tensors(state) if state
                               else (), sample_action=False)
    assert not model.last_pipelined
    np.testing.assert_allclose(got.policy_logits.numpy(),
                               np.asarray(want.policy_logits), **FWD)
    for g, w in zip(jax.tree_util.tree_leaves(got_state,
                                              is_leaf=torch.is_tensor),
                    jax.tree_util.tree_leaves(want_state)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)
    # A divisible acting batch pipelines.
    with torch.no_grad():
        model(_tensors(_acting_inputs(13, 4)), model.initial_state(4)
              if config == "transformer" else _tensors(
                  jmodel.initial_state(4)), sample_action=False)
    assert model.last_pipelined


def test_remat_gradients_are_bitwise_the_plain_ones():
    params = _reference("transformer")[0]
    _, port = _pipe_models("transformer")
    grads = []
    for remat in (False, True):
        model = port(params, remat=remat)
        _, loss, _, _ = _port_unrolls(model, grad=True)
        loss.backward()
        assert model.last_pipelined
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("config", ["mlp", "transformer"])
def test_depth_the_pipe_axis_does_not_divide_raises(config):
    depth = {"num_stages": 3} if config == "mlp" else {"num_layers": 3}
    jmodel, port = _pipe_models(config, **depth)
    with pytest.raises(ValueError) as theirs:
        jmodel.init({"params": jax.random.PRNGKey(0),
                     "action": jax.random.PRNGKey(1)}, _inputs(10),
                    jmodel.initial_state(B))
    family, use_lstm, size = _sized(config, depth)
    _, mesh = _pipe_mesh(2)
    with pytest.raises(ValueError) as ours:
        port_create_model(family, A, use_lstm=use_lstm, frame_shape=FRAME,
                          mesh=mesh, **size)
    assert str(ours.value) == str(theirs.value)
