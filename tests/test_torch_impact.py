"""The port's IMPACT loss, target network and replay reuse
(torchbeast_tpu_torch/ops/impact.py, learner.py) against the JAX
package's on the CPU, mirroring tests/test_impact.py.

Inputs are made with numpy from fixed seeds and handed to both packages;
weights cross by weights.py. The JAX side runs its Pallas V-trace in
interpret mode (its own CPU path); the port's "pallas" impl runs the
kernel's plain version on CPU tensors.

Tolerances: the loss function's values and gradients rtol 1e-5, atol
1e-6; compute_loss through a model, its stats rtol 1e-5 and its
parameter gradients rtol 1e-4, atol 1e-6 (the two frameworks sum the
convolutions in other orders); a whole update params rtol 1e-5 (atol
1e-7) and nu rtol 1e-5 with an atol of 1e-6 of each leaf's largest
entry (nu holds squared gradients: entries near 0 carry the summation
orders' differences), with RMSprop eps 1.0 as
tests/test_torch_learner.py explains.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.ops import impact_policy_losses as jax_impact
from torchbeast_tpu.serving.snapshot import (
    PolicySnapshotStore as JaxSnapshotStore,
)
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.ops import impact_policy_losses as port_impact
from torchbeast_tpu_torch.ops import vtrace_policy_losses
from torchbeast_tpu_torch.ops.vtrace import SCAN_IMPLS
from torchbeast_tpu_torch.telemetry.metrics import MetricsRegistry
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 5, 3, 4
FRAME = (48, 48, 1)
RTOL, ATOL = 1e-5, 1e-6
STAT_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "episode_returns_sum", "episode_count")


def _inputs(seed=0, t=T, b=B):
    rng = np.random.default_rng(seed)
    return {
        "behavior_logits": rng.standard_normal((t, b, A)).astype(np.float32),
        "target_logits": rng.standard_normal((t, b, A)).astype(np.float32),
        "learner_logits": rng.standard_normal((t, b, A)).astype(np.float32),
        "actions": rng.integers(0, A, (t, b)).astype(np.int32),
        "discounts": (rng.random((t, b)) < 0.9).astype(np.float32) * 0.99,
        "rewards": rng.standard_normal((t, b)).astype(np.float32),
        "target_values": rng.standard_normal((t, b)).astype(np.float32),
        "values": rng.standard_normal((t, b)).astype(np.float32),
        "bootstrap": rng.standard_normal((b,)).astype(np.float32),
    }


def _kwargs(x, to):
    return dict(
        behavior_policy_logits=to(x["behavior_logits"]),
        target_net_policy_logits=to(x["target_logits"]),
        actions=to(x["actions"]),
        discounts=to(x["discounts"]),
        rewards=to(x["rewards"]),
        target_net_values=to(x["target_values"]),
        target_net_bootstrap_value=to(x["bootstrap"]),
    )


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("clip", [0.2, None])
@pytest.mark.parametrize("impl", SCAN_IMPLS)
def test_losses_and_grads_match_jax(impl, clip):
    """pg and baseline losses, and their gradients with respect to the
    learner's logits and values, against the reference, with a lagged
    target (the ratio away from 1, so the clip binds somewhere)."""
    x = _inputs(1)

    def jax_total(logits, values):
        pg, bl = jax_impact(learner_policy_logits=logits, values=values,
                            clip_epsilon=clip, scan_impl=impl,
                            **_kwargs(x, jnp.asarray))
        return pg + bl, (pg, bl)

    (_, (pg_w, bl_w)), grads_w = jax.value_and_grad(
        jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x["learner_logits"]), jnp.asarray(x["values"]))
    logits = torch.tensor(x["learner_logits"], requires_grad=True)
    values = torch.tensor(x["values"], requires_grad=True)
    pg, bl = port_impact(learner_policy_logits=logits, values=values,
                         clip_epsilon=clip, scan_impl=impl,
                         **_kwargs(x, torch.from_numpy))
    (pg + bl).backward()
    np.testing.assert_allclose(pg.item(), float(pg_w), RTOL, ATOL)
    np.testing.assert_allclose(bl.item(), float(bl_w), RTOL, ATOL)
    for got, want in zip((logits.grad, values.grad), grads_w):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL,
                                   ATOL)


@pytest.mark.parametrize("impl", SCAN_IMPLS)
def test_grads_match_vtrace_at_zero_lag(impl):
    """Target network == learner, clip wide open: the gradients of the
    IMPACT losses equal V-trace's."""
    x = _inputs(2)
    grads = []
    for loss in ("vtrace", "impact"):
        logits = torch.tensor(x["learner_logits"], requires_grad=True)
        values = torch.tensor(x["values"], requires_grad=True)
        common = dict(behavior_policy_logits=torch.from_numpy(
            x["behavior_logits"]), actions=torch.from_numpy(x["actions"]),
            discounts=torch.from_numpy(x["discounts"]),
            rewards=torch.from_numpy(x["rewards"]), scan_impl=impl)
        if loss == "vtrace":
            pg, bl = vtrace_policy_losses(
                target_policy_logits=logits, values=values,
                bootstrap_value=torch.from_numpy(x["bootstrap"]), **common)
        else:
            pg, bl = port_impact(
                target_net_policy_logits=logits.detach(),
                learner_policy_logits=logits,
                target_net_values=values.detach(), values=values,
                target_net_bootstrap_value=torch.from_numpy(x["bootstrap"]),
                clip_epsilon=None, **common)
        (pg + bl).backward()
        grads.append((logits.grad, values.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), RTOL, ATOL)


def test_clip_engages_only_off_policy():
    """At ratio 1 any epsilon is inert; with a lagged target the clip
    binds and can only raise the loss."""
    x = _inputs(3)
    common = dict(
        behavior_policy_logits=torch.from_numpy(x["behavior_logits"]),
        actions=torch.from_numpy(x["actions"]),
        discounts=torch.from_numpy(x["discounts"]),
        rewards=torch.from_numpy(x["rewards"]),
        values=torch.from_numpy(x["values"]),
        target_net_values=torch.from_numpy(x["values"]),
        target_net_bootstrap_value=torch.from_numpy(x["bootstrap"]),
    )
    learner = torch.from_numpy(x["learner_logits"])
    at_zero_lag = [
        float(port_impact(target_net_policy_logits=learner,
                          learner_policy_logits=learner, clip_epsilon=eps,
                          **common)[0])
        for eps in (0.05, 0.2, None)]
    np.testing.assert_allclose(at_zero_lag, at_zero_lag[0], rtol=1e-6)
    lagged = learner + 2.0
    lagged[..., 0] -= 4.0
    pg_open, pg_clipped = (
        float(port_impact(target_net_policy_logits=lagged,
                          learner_policy_logits=learner, clip_epsilon=eps,
                          **common)[0])
        for eps in (None, 0.2))
    assert not np.isclose(pg_open, pg_clipped, rtol=1e-6)
    assert pg_clipped >= pg_open - 1e-5


@pytest.mark.parametrize("impl", SCAN_IMPLS)
def test_targets_carry_no_gradient(impl):
    """Nothing flows into the target network's logits and values or the
    behavior logits."""
    x = _inputs(4)
    t_logits = torch.tensor(x["target_logits"], requires_grad=True)
    t_values = torch.tensor(x["target_values"], requires_grad=True)
    b_logits = torch.tensor(x["behavior_logits"], requires_grad=True)
    logits = torch.tensor(x["learner_logits"], requires_grad=True)
    pg, bl = port_impact(
        behavior_policy_logits=b_logits, target_net_policy_logits=t_logits,
        learner_policy_logits=logits, actions=torch.from_numpy(
            x["actions"]), discounts=torch.from_numpy(x["discounts"]),
        rewards=torch.from_numpy(x["rewards"]), target_net_values=t_values,
        values=torch.from_numpy(x["values"]),
        target_net_bootstrap_value=torch.from_numpy(x["bootstrap"]),
        scan_impl=impl)
    (pg + bl).backward()
    for t in (t_logits, t_values, b_logits):
        assert t.grad is None
    assert logits.grad is not None and float(logits.grad.abs().sum()) > 0


# ------------------------------------------- compute_loss and the target

def _batch(seed=0, t=T, b=B):
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 256, (t + 1, b) + FRAME, dtype=np.uint8),
        "reward": rng.standard_normal((t + 1, b)).astype(np.float32),
        "done": rng.random((t + 1, b)) < 0.2,
        "episode_return": rng.standard_normal((t + 1, b)).astype(np.float32),
        "episode_step": rng.integers(0, 100, (t + 1, b)).astype(np.int32),
        "last_action": rng.integers(0, A, (t + 1, b)).astype(np.int32),
        "action": rng.integers(0, A, (t + 1, b)).astype(np.int32),
        "policy_logits": rng.standard_normal((t + 1, b, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((t + 1, b)).astype(np.float32),
    }


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=1)
def _jax_model():
    """The shallow model and its params, and a lagged copy of them (the
    params plus 0.05 of a standard normal)."""
    model = jax_create_model("shallow", num_actions=A)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        _batch(), ())
    rng = np.random.default_rng(5)
    lagged = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32), jax.device_get(params))
    return model, jax.device_get(params), lagged


def _port_model(params):
    model = port_create_model("shallow", A, frame_shape=FRAME)
    weights.load_jax_params(model, params)
    return model


def _jax_merge(model, target_params, batch, superstep_k=1):
    fwd = jax_learner.make_target_forward(model, superstep_k=superstep_k)
    logits, base = fwd(target_params, batch, ())
    return {**batch, jax_learner.TARGET_LOGITS_KEY: np.asarray(logits),
            jax_learner.TARGET_BASELINE_KEY: np.asarray(base)}


def _port_merge(target_model, batch, superstep_k=1):
    fwd = port_learner.make_target_forward(target_model, superstep_k)
    logits, base = fwd(batch, ())
    return {**batch, port_learner.TARGET_LOGITS_KEY: logits,
            port_learner.TARGET_BASELINE_KEY: base}


def test_target_keys_are_the_reference_names():
    assert port_learner.TARGET_LOGITS_KEY == jax_learner.TARGET_LOGITS_KEY
    assert (port_learner.TARGET_BASELINE_KEY
            == jax_learner.TARGET_BASELINE_KEY)


@pytest.mark.parametrize("k", [1, 2])
def test_target_forward_matches_jax(k):
    """make_target_forward at K=1 and over a [K] stack, against the
    reference's forward on the same (converted) weights."""
    model, params, _ = _jax_model()
    cols = [_batch(10 + i) for i in range(k)]
    batch = (cols[0] if k == 1 else
             {key: np.stack([c[key] for c in cols]) for key in cols[0]})
    want = jax_learner.make_target_forward(model, superstep_k=k)(
        params, batch, ())
    got = port_learner.make_target_forward(_port_model(params), k)(
        _tensors(batch), ())
    for g, w in zip(got, want):
        assert not g.requires_grad and g.dtype == torch.float32
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), RTOL, 1e-5)


@pytest.mark.parametrize("lag", ["zero", "lagged"])
def test_compute_loss_with_target_keys_matches_jax(lag):
    """compute_loss --loss impact, the target outputs on the batch, at
    zero lag and with a lagged target: stats and parameter gradients
    against the reference's."""
    model, params, lagged = _jax_model()
    target_params = params if lag == "zero" else lagged
    batch = _batch(1)
    hp_j = jax_learner.HParams(loss="impact", entropy_cost=0.01)
    (_, stats_w), grads_w = jax.value_and_grad(
        lambda p: jax_learner.compute_loss(
            model, p, _jax_merge(model, target_params, batch), (), hp_j),
        has_aux=True)(params)
    port = _port_model(params)
    merged = _port_merge(_port_model(target_params), _tensors(batch))
    hp_p = port_learner.HParams(loss="impact", entropy_cost=0.01)
    total, stats = port_learner.compute_loss(port, merged, (), hp_p)
    total.backward()
    assert port_learner.TARGET_LOGITS_KEY in merged  # a copy was popped
    for key in STAT_KEYS:
        np.testing.assert_allclose(stats[key].item(),
                                   np.asarray(stats_w[key]), RTOL, 1e-5)
    got = weights.param_list_to_jax(port, [p.grad for p in
                                           port.parameters()])
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), 1e-4,
                                                1e-6), got, grads_w)


def test_param_grads_match_vtrace_at_zero_lag():
    """Through compute_loss and the batch keys: with the target forward
    run on the current params, the impact gradient equals the vtrace
    one (entropy included, a shared term)."""
    _, params, _ = _jax_model()
    batch = _tensors(_batch(2))
    grads = []
    for loss in ("vtrace", "impact"):
        model = _port_model(params)
        inputs = (_port_merge(_port_model(params), batch)
                  if loss == "impact" else batch)
        total, _ = port_learner.compute_loss(
            model, inputs, (), port_learner.HParams(loss=loss,
                                                    impact_clip=None))
        total.backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), 1e-4, 1e-6)


def test_impact_without_target_keys_raises():
    _, params, _ = _jax_model()
    with pytest.raises(ValueError, match="target network"):
        port_learner.compute_loss(_port_model(params), _tensors(_batch(2)),
                                  (), port_learner.HParams(loss="impact"))


def test_vtrace_ignores_target_keys():
    """Stray target keys must not change the vtrace loss."""
    _, params, _ = _jax_model()
    model = _port_model(params)
    batch = _tensors(_batch(3))
    hp = port_learner.HParams()
    with torch.no_grad():
        plain, _ = port_learner.compute_loss(model, batch, (), hp)
        merged, _ = port_learner.compute_loss(
            model, _port_merge(model, batch), (), hp)
    assert float(plain) == float(merged)


def test_version_skew_changes_objective():
    """A stale target moves the impact loss (the ratio departs from 1)."""
    _, params, lagged = _jax_model()
    model = _port_model(lagged)  # the learner has moved past the stamp
    batch = _tensors(_batch(4))
    hp = port_learner.HParams(loss="impact")
    with torch.no_grad():
        at_lag0, _ = port_learner.compute_loss(
            model, _port_merge(model, batch), (), hp)
        skewed, _ = port_learner.compute_loss(
            model, _port_merge(_port_model(params), batch), (), hp)
    assert not np.isclose(float(at_lag0), float(skewed), rtol=1e-6)


# ------------------------------------------------------ target versioning

def _target(model, refresh=8):
    return port_learner.TargetNetwork(model, refresh,
                                      registry=MetricsRegistry())


def test_target_refresh_cadence_matches_the_reference():
    """TargetNetwork.maybe_refresh publishes when the reference's store
    would: version 0 at construction, then every refresh_updates."""
    _, params, _ = _jax_model()
    model = _port_model(params)
    target = _target(model, 8)
    ref = JaxSnapshotStore(8, namespace="learner.target", cast_bf16=False)
    ref.publish(0, {"w": np.zeros(2, np.float32)})
    params_list = list(model.parameters())
    got = [v for v in range(1, 20) if target.maybe_refresh(v, params_list)]
    want = [v for v in range(1, 20) if ref.note_update(v)
            and ref.publish(v, {"w": np.zeros(2, np.float32)})]
    assert got == want == [8, 16]
    assert target.store.version == 16


def test_target_is_full_precision_and_a_copy():
    """The stamped target equals the learner's params bit for bit (no
    bf16 rounding), and is a copy: the learner changing its params in
    place after the stamp does not move the target's outputs."""
    _, params, _ = _jax_model()
    model = _port_model(params)
    batch = _tensors(_batch(5))
    target = _target(model)
    _, stamped = target.store.latest()
    for s, p in zip(stamped, model.parameters()):
        assert torch.equal(s, p.detach()) and s.data_ptr() != p.data_ptr()
    before = target.outputs(batch, ())
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    after = target.outputs(batch, ())
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    # A refresh loads the new params into the target's buffer.
    assert target.maybe_refresh(8, model.parameters())
    moved = target.outputs(batch, ())
    assert not torch.equal(moved[0], before[0])
    want = port_learner.make_target_forward(model)(batch, ())
    for a, b in zip(moved, want):
        assert torch.equal(a, b)


def test_target_series_are_the_reference_names():
    """The store's series under learner.target.*: the reference's own."""
    _, params, _ = _jax_model()
    reg = MetricsRegistry()
    port_learner.TargetNetwork(_port_model(params), 8, registry=reg)
    names = set(reg.instruments())
    assert {"learner.target.snapshots_published",
            "learner.target.snapshot_bytes_published",
            "learner.target.snapshot_refresh_failures",
            "learner.target.snapshot_version",
            "learner.target.snapshot_lag"} <= names


def test_updates_horizon_scales_with_reuse():
    for reuse in (1, 3):
        kw = dict(total_steps=1000, unroll_length=10, batch_size=10,
                  replay_reuse=reuse)
        assert port_learner.updates_horizon(port_learner.HParams(**kw)) \
            == jax_learner.updates_horizon(jax_learner.HParams(**kw)) \
            == 10 * reuse


# -------------------------------------------------------- a whole update

def _hp(**kw):
    return dict(unroll_length=T, batch_size=B, total_steps=T * B * 10,
                vtrace_impl="pallas", entropy_cost=0.01, rmsprop_eps=1.0,
                loss="impact", replay_reuse=2, **kw)


@pytest.mark.parametrize("opt_impl", ["xla", "pallas"])
def test_impact_update_matches_jax(opt_impl):
    """Two updates on one batch (--replay_reuse 2) against a lagged
    target, from the same weights: params and nu after each, and the
    stats, against the reference's update step."""
    model, params, lagged = _jax_model()
    batch = _batch(6)
    hp_j = jax_learner.HParams(**_hp(opt_impl=opt_impl))
    optimizer = jax_learner.make_optimizer(hp_j)
    opt_state = optimizer.init(params)
    step_j = jax_learner.make_update_step(model, optimizer, hp_j,
                                          donate=False)
    merged_j = _jax_merge(model, lagged, batch)
    port = _port_model(params)
    hp_p = port_learner.HParams(**_hp(opt_impl=opt_impl))
    opt = port_learner.make_optimizer(hp_p, list(port.parameters()))
    step_p = port_learner.update_body(port, opt, hp_p)
    merged_p = _port_merge(_port_model(lagged), _tensors(batch))
    p_j = params
    for _ in range(2):
        p_j, opt_state, stats_w = step_j(p_j, opt_state, merged_j, ())
        stats = step_p(merged_p, ())
        for key in STAT_KEYS + ("grad_norm",):
            np.testing.assert_allclose(float(stats[key]),
                                       np.asarray(stats_w[key]), RTOL, 1e-5)
        want = jax.device_get(p_j)
        got = weights.torch_to_jax(port.state_dict())
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(g, w, RTOL, 1e-7),
            got, want)
        nu_w = jax.device_get(optax.tree_utils.tree_get(opt_state, "nu"))
        nu = weights.param_list_to_jax(port, opt.state.nu)
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_allclose(
                g, w, RTOL, 1e-6 * np.abs(w).max()), nu, nu_w)
