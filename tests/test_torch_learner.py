"""The whole learner update of the port (torchbeast_tpu_torch/learner.py)
against the JAX package's, on the CPU, with the slice's kernel switches:
--vtrace_impl pallas --opt_impl pallas, on the deep ResNet + LSTM.

The JAX update runs its Pallas kernels interpreted (its own CPU path);
the port runs the kernels' plain versions on CPU tensors. Both start from
the same weights (carried across by weights.py) and take the same numpy
batches, for one update and for three in a row.

RMSprop's eps is 1.0 here instead of 0.01: with nu starting at zero, the
first updates divide each gradient by about 0.1 |g| + eps, so at eps 0.01
an element whose gradient is small and cancels in a long sum (a conv bias
summed over 70k positions) turns a 1e-7-relative gradient difference into
a percent-sized difference of its step. eps 1.0 keeps the step close to
linear in the gradient, so the comparison sees the update, not that
conditioning; the kernels run the same code paths at any eps (the tail is
held at eps 0.01 in test_torch_opt.py).

Tolerances: loss stats rtol 1e-4; params rtol 1e-5 with atol 2e-6
(gradients differ by the two frameworks' conv and matmul summation
orders); RMSprop nu per leaf, max |difference| <= 2e-2 * max |nu|. nu
holds squared gradients, and the first-stage conv weights and biases sum
theirs over 70k nearly cancelling positions: in f32 both packages land
about 1e-3 (max-relative) from the f64 gradient of such a leaf, and
after three updates their nu leaves differ by up to 1.0e-2 of the leaf's
largest entry (measured).
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
from torchbeast_tpu_torch import weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.ops.opt import FusedTailState
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 4, 2, 6
FRAME = (84, 84, 4)
STAT_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "episode_returns_sum", "episode_count", "grad_norm")


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 256, (T + 1, B) + FRAME, dtype=np.uint8),
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


def _hp(**kw):
    return dict(unroll_length=T, batch_size=B, total_steps=T * B * 10,
                vtrace_impl="pallas", opt_impl="pallas",
                entropy_cost=0.01, rmsprop_eps=1.0, **kw)


@functools.lru_cache(maxsize=1)
def _jax_updates():
    """JAX params/nu/stats after each of 3 updates, and the start."""
    model = jax_create_model("deep", num_actions=A, use_lstm=True)
    rng = np.random.default_rng(9)
    state = tuple(
        (0.5 * rng.standard_normal(np.shape(s))).astype(np.float32)
        for s in model.initial_state(B)
    )
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        {k: v[:1] for k, v in _batch(0).items()}, state,
    )
    hp = jax_learner.HParams(**_hp())
    optimizer = jax_learner.make_optimizer(hp)
    opt_state = optimizer.init(params)
    step = jax_learner.make_update_step(model, optimizer, hp, donate=False)
    start = jax.device_get(params)
    history = []
    for i in range(3):
        params, opt_state, stats = step(params, opt_state, _batch(i), state)
        history.append(jax.device_get(
            (params, optax.tree_utils.tree_get(opt_state, "nu"), stats)))
    return start, state, history


def _close_trees(got, want, rtol, atol):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=rtol,
                                                atol=atol),
        got, want,
    )


@pytest.mark.parametrize("num_updates", [1, 3])
def test_update_matches_jax(num_updates):
    start, state, history = _jax_updates()
    model = port_create_model("deep", A, use_lstm=True, frame_shape=FRAME)
    weights.load_jax_params(model, start)
    hp = port_learner.HParams(**_hp())
    optimizer = port_learner.make_optimizer(hp, list(model.parameters()))
    step = port_learner.update_body(model, optimizer, hp)
    agent_state = tuple(torch.from_numpy(s) for s in state)
    for i in range(num_updates):
        batch = {k: torch.from_numpy(v) for k, v in _batch(i).items()}
        stats = step(batch, agent_state)
        want_params, want_nu, want_stats = history[i]
        for key in STAT_KEYS:
            np.testing.assert_allclose(
                float(stats[key]), float(want_stats[key]), rtol=1e-4,
                err_msg=f"update {i}: {key}")
    assert optimizer.state.count == num_updates
    _close_trees(weights.torch_to_jax(model.state_dict()), want_params,
                 rtol=1e-5, atol=2e-6)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_less(
            np.abs(g - np.asarray(w)).max(), 2e-2 * np.abs(w).max() + 1e-30),
        weights.param_list_to_jax(model, optimizer.state.nu), want_nu,
    )


def test_update_leaves_no_grad_state_and_moves_every_param():
    model = port_create_model("deep", A, use_lstm=True, frame_shape=FRAME)
    before = [p.detach().clone() for p in model.parameters()]
    hp = port_learner.HParams(**_hp())
    optimizer = port_learner.make_optimizer(hp, list(model.parameters()))
    stats = port_learner.update_body(model, optimizer, hp)(
        {k: torch.from_numpy(v) for k, v in _batch(5).items()},
        model.initial_state(B),
    )
    assert all(not v.requires_grad for v in stats.values())
    assert all(p.grad is None for p in model.parameters())
    moved = [not torch.equal(b, p) for b, p in
             zip(before, model.parameters())]
    assert all(moved)
    out = port_learner.episode_stat_postprocess(
        {k: np.atleast_1d(v.numpy()) for k, v in stats.items()})
    assert np.isfinite(out["total_loss"])


def test_entropy_anneal_follows_the_update_count():
    hp = port_learner.HParams(**_hp(entropy_cost_final=0.0))
    jhp = jax_learner.HParams(**_hp(entropy_cost_final=0.0))
    ours = port_learner.entropy_schedule(hp)
    theirs = jax_learner.entropy_schedule(jhp)
    for count in (0, 3, 10, 20):
        state = FusedTailState(count=count, nu=[], mom=None)
        jstate = optax.ScaleByScheduleState(count=np.int32(count))
        assert np.float32(ours(state)) == np.asarray(theirs(jstate))
    assert port_learner.updates_horizon(hp) == jax_learner.updates_horizon(
        jhp)


def test_not_ported_options_raise():
    # The precision options build their optimizer state.
    params = [torch.nn.Parameter(torch.zeros(2))]
    opt = port_learner.make_optimizer(
        port_learner.HParams(opt_state_dtype="bf16"), params)
    assert opt.state.nu[0].dtype == torch.bfloat16
    assert opt.state.master is None
    resident = [torch.nn.Parameter(torch.zeros(2, dtype=torch.bfloat16))]
    opt = port_learner.make_optimizer(
        port_learner.HParams(param_dtype="bf16"), resident)
    assert opt.state.master[0].dtype == torch.float32
    assert opt.state.nu[0].dtype == torch.float32
    # The factored state needs each parameter's JAX leaves.
    with pytest.raises(ValueError, match="jax_layouts"):
        port_learner.make_optimizer(
            port_learner.HParams(opt_factored=True), params)
    opt = port_learner.make_optimizer(
        port_learner.HParams(opt_factored=True), params,
        layouts=[(lambda t: [t], lambda vs: vs[0])])
    assert opt.step([torch.ones(2)]).shape == ()
