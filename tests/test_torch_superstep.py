"""The port's K-update superstep (torchbeast_tpu_torch/learner.py) and its
device-side schedules, on the CPU:

- the port's superstep at K=2 and K=4 against the JAX
  make_update_superstep from the same weights (weights.py) and numpy
  batches, on deep+LSTM and the transformer, --opt_impl xla and pallas,
  with and without the entropy anneal. Tolerances as
  tests/test_torch_learner.py states them for three sequential updates
  (and RMSprop eps 1.0 for the reason it gives): stats rtol 1e-4, params
  rtol 1e-5 / atol 2e-6, nu per leaf within 2e-2 of its largest entry
  plus 1e-12 (the transformer's key bias has a gradient that is zero in
  exact arithmetic, so its nu after four updates is squared rounding
  noise, about 1e-17 here, in both packages); the update count exact;
- the port's superstep against K sequential port updates: bit for bit;
- the schedule ticks once per update, not once per dispatch, on the
  host count and on the device count;
- the device count's learning rate and entropy cost: the same f32 bits as
  the host schedules (and the reference's) at counts 0, 1, horizon - 1,
  horizon and horizon + 5;
- stack_superstep_columns equal to the reference's, and the errors.

The JAX side runs its Pallas kernels interpreted; the port's kernels run
their plain versions on CPU tensors. Small shapes: the deep model on
12x12x4 frames, the transformer of tests/test_torch_transformer.py with
dense attention (its kernel is held elsewhere; interpreted, it would
take most of this file's time).
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import nest, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.ops import opt as port_opt
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 4, 2, 4
MODELS = {
    "deep": dict(frame=(12, 12, 4), kw=dict(use_lstm=True)),
    "transformer": dict(frame=(8, 8, 1), kw=dict(
        d_model=32, num_heads=4, memory_len=4, attention_impl="dense")),
}
STAT_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "episode_returns_sum", "episode_count", "grad_norm")


def _batch(seed, frame):
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 256, (T + 1, B) + frame, dtype=np.uint8),
        "reward": rng.standard_normal((T + 1, B)).astype(np.float32),
        "done": rng.random((T + 1, B)) < 0.2,
        "episode_return": rng.standard_normal((T + 1, B)).astype(np.float32),
        "episode_step": rng.integers(0, 100, (T + 1, B)).astype(np.int32),
        "last_action": rng.integers(0, A, (T + 1, B)).astype(np.int32),
        "action": rng.integers(0, A, (T + 1, B)).astype(np.int32),
        "policy_logits": rng.standard_normal((T + 1, B, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((T + 1, B)).astype(np.float32),
    }


def _hp(opt_impl, anneal, **kw):
    # A short horizon moves the schedules visibly between updates.
    return dict(unroll_length=T, batch_size=B, total_steps=10 * T * B,
                vtrace_impl="pallas" if opt_impl == "pallas"
                else "associative", opt_impl=opt_impl,
                entropy_cost=0.01, entropy_cost_final=1e-4 if anneal
                else None, rmsprop_eps=1.0, **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(model_name):
    spec = MODELS[model_name]
    model = jax_create_model(model_name, num_actions=A, **spec["kw"])
    state = jax.device_get(model.initial_state(B))
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        {k: v[:1] for k, v in _batch(0, spec["frame"]).items()}, state)
    return model, jax.device_get(params), state


def _port(model_name, params=None):
    spec = MODELS[model_name]
    model = port_create_model(model_name, A, frame_shape=spec["frame"],
                              **spec["kw"])
    if params is not None:
        weights.load_jax_params(model, params)
    return model


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _torch(tree):
    return nest.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("model_name,opt_impl,anneal,k", [
    ("deep", "pallas", True, 4),
    ("deep", "xla", False, 2),
    ("transformer", "pallas", False, 4),
    ("transformer", "xla", True, 2),
])
def test_superstep_matches_jax(model_name, opt_impl, anneal, k):
    jmodel, params, state = _jax_params(model_name)
    frame = MODELS[model_name]["frame"]
    batches = [_batch(10 + i, frame) for i in range(k)]
    stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
    states = _stack([state] * k)

    jhp = jax_learner.HParams(**_hp(opt_impl, anneal))
    optimizer = jax_learner.make_optimizer(jhp)
    superstep = jax_learner.make_update_superstep(jmodel, optimizer, jhp, k,
                                                  donate=False)
    want_params, opt_state, want_stats = jax.device_get(superstep(
        params, optimizer.init(params), stacked, states))
    want_nu = optax.tree_utils.tree_get(opt_state, "nu")

    model = _port(model_name, params)
    hp = port_learner.HParams(**_hp(opt_impl, anneal))
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    stats = port_learner.make_update_superstep(model, opt, hp, k)(
        _torch(stacked), _torch(states))
    assert opt.state.count == k and int(opt.device_count) == k
    for key in STAT_KEYS:
        assert stats[key].shape == (k,)
        np.testing.assert_allclose(stats[key].float().numpy(),
                                   np.asarray(want_stats[key], np.float32),
                                   rtol=1e-4, err_msg=key)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6),
        weights.torch_to_jax(model.state_dict()), want_params)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_less(
            np.abs(g - np.asarray(w)).max(), 2e-2 * np.abs(w).max() + 1e-12),
        weights.param_list_to_jax(model, opt.state.nu), want_nu)


@pytest.mark.parametrize("model_name", ["deep", "transformer"])
@pytest.mark.parametrize("opt_impl", ["pallas", "xla"])
def test_superstep_bit_identical_to_sequential_updates(model_name,
                                                       opt_impl):
    """K=4 in one superstep == four update_body calls on the same
    batches, bit for bit: params, nu, the counts and every stat."""
    k = 4
    frame = MODELS[model_name]["frame"]
    hp = port_learner.HParams(**_hp(opt_impl, True))
    batches = [_torch(_batch(20 + i, frame)) for i in range(k)]
    runs = []
    for stacked in (False, True):
        torch.manual_seed(3)
        model = _port(model_name)
        opt = port_learner.make_optimizer(hp, list(model.parameters()))
        state = model.initial_state(B)
        if stacked:
            stats = port_learner.make_update_superstep(model, opt, hp, k)(
                {key: torch.stack([b[key] for b in batches])
                 for key in batches[0]},
                nest.map(lambda s: torch.stack([s] * k), state))
        else:
            step = port_learner.update_body(model, opt, hp)
            per = [step(b, state) for b in batches]
            stats = {key: torch.stack([s[key] for s in per])
                     for key in per[0]}
        runs.append((list(model.parameters()), nest.flatten(opt.state.nu),
                     opt.state.count, int(opt.device_count), stats))
    (p1, n1, c1, d1, s1), (p2, n2, c2, d2, s2) = runs
    assert c1 == c2 == d1 == d2 == k
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert all(torch.equal(a, b) for a, b in zip(n1, n2))
    assert list(s1) == list(s2)
    assert all(torch.equal(s1[key], s2[key]) for key in s1)


def test_superstep_schedule_ticks_per_update_not_per_dispatch():
    """After one K=4 dispatch both counts read 4, and the anneal moved
    within the dispatch: the four updates' entropy losses took four
    different costs."""
    frame = MODELS["deep"]["frame"]
    hp = port_learner.HParams(**_hp("pallas", True))
    model = _port("deep")
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    batch = _torch(_batch(30, frame))
    stacked = {key: torch.stack([v] * 4) for key, v in batch.items()}
    superstep = port_learner.make_update_superstep(model, opt, hp, 4)
    superstep(stacked, nest.map(lambda s: torch.stack([s] * 4),
                                model.initial_state(B)))
    assert opt.state.count == 4
    assert int(opt.device_count) == 4
    anneal = port_learner.entropy_schedule(hp)
    costs = {anneal(port_opt.FusedTailState(count=c, nu=[], mom=None))
             for c in range(4)}
    assert len(costs) == 4


@pytest.mark.parametrize("opt_impl", ["pallas", "xla"])
def test_device_schedules_equal_the_host_bits(opt_impl):
    hp = port_learner.HParams(**_hp(opt_impl, True))
    jhp = jax_learner.HParams(**_hp(opt_impl, True))
    horizon = port_learner.updates_horizon(hp)
    opt = port_learner.make_optimizer(hp, [torch.nn.Parameter(
        torch.zeros(3))])
    anneal = port_learner.entropy_schedule(hp)
    theirs_lr = optax.linear_schedule(hp.learning_rate, 0.0, horizon)
    theirs_ent = jax_learner.entropy_schedule(jhp)
    bits = lambda x: np.asarray(x, np.float32).view(np.int32)  # noqa: E731
    for count in (0, 1, horizon - 1, horizon, horizon + 5):
        c = torch.tensor(count)
        lr = opt.schedule.on_device(c)
        ent = anneal.on_device(c)
        assert lr.dtype == ent.dtype == torch.float32
        host_lr = opt.schedule(count)
        host_ent = anneal(port_opt.FusedTailState(count=count, nu=[],
                                                  mom=None))
        assert bits(lr.numpy()) == bits(host_lr), count
        assert bits(ent.numpy()) == bits(host_ent), count
        assert bits(host_lr) == bits(theirs_lr(np.int32(count))), count
        assert bits(host_ent) == bits(theirs_ent(
            optax.ScaleByScheduleState(count=np.int32(count)))), count


def test_a_step_reads_and_advances_the_device_count():
    """The update reads its rate from the device count, so a count set
    on the device (as a checkpoint's resume sets it) is the one applied:
    one step from count c moves a parameter by exactly lr(c) * update."""
    hp = port_learner.HParams(**_hp("pallas", False))
    p = torch.nn.Parameter(torch.zeros(2))
    opt = port_learner.make_optimizer(hp, [p])
    opt.set_count(7)
    assert opt.state.count == 7 and int(opt.device_count) == 7
    lr = torch.tensor(opt.schedule(7), dtype=torch.float32)
    g = torch.tensor([1.0, -2.0])
    opt.step([g])
    nu = (1 - hp.rmsprop_alpha) * g * g
    want = -(lr * (g / (torch.sqrt(nu) + hp.rmsprop_eps)))
    assert torch.equal(p.detach(), want)
    assert opt.state.count == 8 and int(opt.device_count) == 8
    opt.advance_host_count(3)
    assert opt.state.count == 11 and int(opt.device_count) == 8


def test_stack_superstep_columns_matches_the_reference():
    rng = np.random.default_rng(3)
    wide = _batch(4, (2, 2, 1))
    wide = {k: np.concatenate([v] * 4, axis=1) for k, v in wide.items()}
    state = (rng.standard_normal((1, 8, 6)).astype(np.float32),)
    ours = port_learner.stack_superstep_columns(wide, state, k=2,
                                                columns=2, offset=4)
    theirs = jax_learner.stack_superstep_columns(wide, state, k=2,
                                                 columns=2, offset=4)
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(theirs)):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for key, v in wide.items():
        assert not np.shares_memory(ours[0][key], v)
    # Tensor leaves (the driver's device-resident agent state) stack the
    # same columns into a fresh tensor.
    tensors = port_learner.stack_superstep_columns(
        {}, (torch.from_numpy(state[0]),), k=2, columns=2, offset=4)[1]
    np.testing.assert_array_equal(tensors[0].numpy(), theirs[1][0])


def test_superstep_rejects_bad_k_and_a_wrong_stack():
    hp = port_learner.HParams(**_hp("pallas", False))
    model = _port("deep")
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    with pytest.raises(ValueError, match="superstep k"):
        port_learner.make_update_superstep(model, opt, hp, 0)
    superstep = port_learner.make_update_superstep(model, opt, hp, 3)
    batch = _torch(_batch(5, MODELS["deep"]["frame"]))
    with pytest.raises(ValueError, match="K=3"):
        superstep({key: torch.stack([v] * 2) for key, v in batch.items()},
                  nest.map(lambda s: torch.stack([s] * 2),
                           model.initial_state(B)))
    assert opt.state.count == 0


def test_update_dispatch_on_the_cpu_is_the_eager_step():
    hp = port_learner.HParams(**_hp("pallas", False))
    model = _port("deep")
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    for k in (1, 2):
        dispatch = port_learner.make_update_dispatch(model, opt, hp, k)
        batch = _torch(_batch(6, MODELS["deep"]["frame"]))
        state = model.initial_state(B)
        if k > 1:
            batch = {key: torch.stack([v] * k) for key, v in batch.items()}
            state = nest.map(lambda s: torch.stack([s] * k), state)
        stats = dispatch(batch, state)
        assert stats["total_loss"].shape == (() if k == 1 else (k,))
    assert opt.state.count == 3
