"""The port's pipelined families (torchbeast_tpu_torch/models/pipelined.py,
models/transformer_pp.py) against the JAX package's on the CPU.

Sizes: T=4, B=8, 5 actions, 6x6x2 frames; PipelinedMLPNet with 4 stages
of d_model 32, with and without its LSTM head; PipelinedTransformerNet
with 2 layers, d_model 32, 4 heads and memory_len 5, so the band (5)
hides the oldest cache entries from the last queries and the roll keeps
one old entry beside the unroll's four. Inputs are numpy draws from fixed
seeds with dones planted, so segments and the no-done gate act; the
weights are the reference's init, carried across by weights.py.

- Forward: a first unroll from the initial state, then a second from
  the state it left; on the second, logits and baseline within rtol 1e-5
  / atol 1e-5 and the argmax actions (sample_action=False) equal; the
  state after each unroll (the LSTM's (h, c), or each layer's k, v and
  validity) within the same tolerance, validity exactly.
- Parameter gradients of a fixed weighted sum of the second unroll's
  logits and baseline: rtol 1e-4, atol 1e-5, as tests/test_torch_
  transformer.py holds them.
- One learner update (--vtrace_impl pallas --opt_impl pallas, the port's
  kernels' plain versions on the CPU, eps 1.0 as tests/test_torch_
  learner.py explains): params within rtol 1e-5 (atol 2e-6), the loss
  stats within rtol 1e-4, nu within 2e-2 of each leaf's largest entry.
- The remat levers (`blocks`: remat=True on the transformer; `core`:
  core_remat=True on the LSTM head) give the un-rematted outputs and
  gradients bit for bit.
- bf16_train: the forward's logits, baseline and state within 3e-2 of
  their largest entry, and one update's change of the f32 master within
  3e-2 in norm, leaf by leaf and over all leaves, of the reference's;
  the loss stats within 3e-2 of themselves or of |total_loss|. Two
  figures are sums of terms of both signs to a small total, and differ
  by more than 3e-2 of themselves, on the transformer: pg_loss (the
  port -0.4385, the reference -0.4904, f32 -0.4874; 6e-3 of
  |total_loss|) and the change of the baseline head's bias, whose
  gradient sums baseline - vs over the batch (the port's change 0.10 of
  the reference's away in norm; every other leaf within 1.3e-2), which
  is held within 0.25. Both packages' bf16 forwards are within one bf16
  ulp of their f32 ones there.
- Fresh weights: every stacked kernel of both packages' draws has the std
  of flax's rule (the MLP's w_in [S, d, 4d] fan_in S*d: flax counts the
  stage axis in the receptive field; the transformer's variance_scaling
  with batch_axis=0: d, 4d for w2, H*hd for wo) within four standard
  errors, and is cut at two of the untruncated std.
- weights.py round trip, exact; the full-width parameter counts equal the
  reference's.
- The reference's GPipe path on a 2-device `pipe` mesh (tests/conftest.py
  forces 8 CPU devices): the port's sequential forward and gradients
  against it, at the forward's and gradients' tolerances.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu import precision as jax_precision
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.parallel.pp import can_pipeline
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import precision, weights
from torchbeast_tpu_torch.models import NOT_PORTED
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.models import init
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 4, 8, 5
FRAME = (6, 6, 2)
MLP_SIZE = dict(num_stages=4, d_model=32)
TF_SIZE = dict(num_layers=2, d_model=32, num_heads=4, memory_len=5)
# name -> (family, use_lstm, size)
CONFIGS = {
    "mlp": ("pipelined_mlp", False, MLP_SIZE),
    "mlp_lstm": ("pipelined_mlp", True, MLP_SIZE),
    "transformer": ("pipelined_transformer", False, TF_SIZE),
}
RECURRENT = ["mlp_lstm", "transformer"]
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 3e-2
# The baseline head's bias, whose gradient sums the baseline's errors over
# the batch to a small total (see the docstring), as tests/test_torch_
# precision_models.py holds any single leaf (its LEAF_TOL).
BASELINE_BIAS_TOL = 0.25


def _inputs(seed, t=T, b=B):
    rng = np.random.default_rng(seed)
    done = rng.random((t, b)) < 0.2
    done[1, 0] = True
    return {
        "frame": rng.integers(0, 256, (t, b) + FRAME, dtype=np.uint8),
        "reward": (3 * rng.standard_normal((t, b))).astype(np.float32),
        "done": done,
        "last_action": rng.integers(0, A, (t, b)).astype(np.int32),
    }


def _tensors(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _jax_model(config, policy="f32", **kw):
    family, use_lstm, size = CONFIGS[config]
    pol = jax_precision.get(policy)
    return jax_create_model(family, num_actions=A, use_lstm=use_lstm,
                            dtype=pol.compute_dtype,
                            head_dtype=pol.head_dtype, **size, **kw)


def _port_model(config, params, policy="f32", **kw):
    family, use_lstm, size = CONFIGS[config]
    pol = precision.get(policy)
    model = port_create_model(family, A, use_lstm=use_lstm,
                              frame_shape=FRAME, dtype=pol.compute_dtype,
                              head_dtype=pol.head_dtype, **size, **kw)
    weights.load_jax_params(model, params)
    return precision.cast_params(model, pol)


def _weights(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, B, A)).astype(np.float32),
            rng.standard_normal((T, B)).astype(np.float32))


def _jax_loss(model, inputs, state):
    w_logits, w_base = _weights()

    def loss(p):
        out, new_state = model.apply(p, inputs, state, sample_action=False)
        value = (jnp.sum(out.policy_logits * w_logits)
                 + jnp.sum(out.baseline * w_base))
        return value, (out, new_state)

    return loss


@functools.lru_cache(maxsize=None)
def _jax_run(config):
    """Params; the state after a first unroll; the second unroll's
    outputs, state and the gradients of the weighted loss."""
    model = _jax_model(config)
    state0 = model.initial_state(B)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        _inputs(10), state0)
    _, state1 = model.apply(params, _inputs(11), state0, sample_action=False)
    (value, (out, state2)), grads = jax.value_and_grad(
        _jax_loss(model, _inputs(12), state1), has_aux=True)(params)
    return jax.device_get((params, state1, value, out, state2, grads))


def _port_unrolls(model, grad=False):
    """The port's two unrolls; the second's outputs, its loss and each
    state."""
    with torch.no_grad():
        _, state1 = model(_tensors(_inputs(11)), model.initial_state(B),
                          sample_action=False)
    with torch.set_grad_enabled(grad):
        out, state2 = model(_tensors(_inputs(12)), state1,
                            sample_action=False)
    w_logits, w_base = (torch.from_numpy(w) for w in _weights())
    loss = (torch.sum(out.policy_logits * w_logits)
            + torch.sum(out.baseline * w_base))
    return out, loss, state1, state2


def _assert_state(got, want):
    got = jax.tree_util.tree_leaves(got, is_leaf=torch.is_tensor)
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **FWD)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_matches_jax(config):
    params, _, _, want, _, _ = _jax_run(config)
    model = _port_model(config, params)
    got, _, _, _ = _port_unrolls(model)
    np.testing.assert_array_equal(got.action.numpy(),
                                  np.asarray(want.action))
    np.testing.assert_allclose(got.policy_logits.numpy(),
                               np.asarray(want.policy_logits), **FWD)
    np.testing.assert_allclose(got.baseline.numpy(),
                               np.asarray(want.baseline), **FWD)


@pytest.mark.parametrize("config", RECURRENT)
def test_state_carried_over_two_unrolls(config):
    params, want1, _, _, want2, _ = _jax_run(config)
    _, _, got1, got2 = _port_unrolls(_port_model(config, params))
    _assert_state(got1, want1)
    _assert_state(got2, want2)
    if config == "transformer":
        assert len(got2) == TF_SIZE["num_layers"]
        k, v, valid = got2[0]
        assert k.shape == v.shape == (5, B, 4, 8) and valid.shape == (5, B)
        # The roll keeps one entry of the first unroll where no done hid it.
        assert valid[0].any() and not valid[0].all()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_parameter_gradients_match_jax(config):
    params, _, value, _, _, grads = _jax_run(config)
    model = _port_model(config, params)
    _, loss, _, _ = _port_unrolls(model, grad=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(value),
                               rtol=1e-5)
    got = weights.torch_to_jax(
        {n: p.grad for n, p in model.named_parameters()})
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(grads))
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **GRAD),
        got, grads)


@pytest.mark.parametrize("config,lever", [("transformer", "remat"),
                                          ("mlp_lstm", "core_remat")])
def test_remat_lever_gives_the_same_outputs_and_gradients(config, lever):
    params = _jax_run(config)[0]
    runs = []
    for on in (False, True):
        model = _port_model(config, params, **{lever: on})
        out, loss, _, state2 = _port_unrolls(model, grad=True)
        loss.backward()
        runs.append((out, state2, [p.grad for p in model.parameters()]))
    (out0, st0, g0), (out1, st1, g1) = runs
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(out1.policy_logits, out0.policy_logits,
                               **exact)
    torch.testing.assert_close(out1.baseline, out0.baseline, **exact)
    for a, b in zip(jax.tree_util.tree_leaves(st1, is_leaf=torch.is_tensor),
                    jax.tree_util.tree_leaves(st0, is_leaf=torch.is_tensor)):
        torch.testing.assert_close(a, b, **exact)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, **exact)


# ------------------------------------------------------------- learner

LT = 4  # learner unroll


def _batch(seed):
    rng = np.random.default_rng(seed)
    batch = _inputs(seed, t=LT + 1)
    batch.update({
        "episode_return": rng.standard_normal((LT + 1, B)).astype(
            np.float32),
        "episode_step": rng.integers(0, 100, (LT + 1, B)).astype(np.int32),
        "action": rng.integers(0, A, (LT + 1, B)).astype(np.int32),
        "policy_logits": rng.standard_normal((LT + 1, B, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((LT + 1, B)).astype(np.float32),
    })
    return batch


def _hp(**kw):
    # eps 1.0 for the reason tests/test_torch_learner.py gives.
    return dict(unroll_length=LT, batch_size=B, total_steps=LT * B * 10,
                vtrace_impl="pallas", opt_impl="pallas", entropy_cost=0.01,
                rmsprop_eps=1.0, **kw)


STAT_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "grad_norm")


def _jax_update(config, policy, params, state):
    pol = jax_precision.get(policy)
    extra = ({} if policy == "f32"
             else dict(opt_state_dtype="bf16", param_dtype="bf16"))
    hp = jax_learner.HParams(**_hp(**extra))
    optimizer = jax_learner.make_optimizer(hp)
    params = jax_precision.cast_params(params, pol)
    opt_state = optimizer.init(params)
    step = jax_learner.make_update_step(_jax_model(config, policy),
                                        optimizer, hp, donate=False)
    return jax.device_get((opt_state,) + tuple(step(
        params, opt_state, jax_precision.cast_batch(_batch(0),
                                                    pol.batch_dtype),
        jax_precision.cast_batch(state, pol.batch_dtype))))


def _port_update(config, policy, params, state):
    pol = precision.get(policy)
    extra = ({} if policy == "f32"
             else dict(opt_state_dtype="bf16", param_dtype="bf16"))
    port = _port_model(config, params, policy)
    hp = port_learner.HParams(**_hp(**extra))
    opt = port_learner.make_optimizer(hp, list(port.parameters()))
    stats = port_learner.update_body(port, opt, hp)(
        precision.cast_batch(_tensors(_batch(0)), pol.batch_dtype),
        precision.cast_batch(_tensors(state), pol.batch_dtype))
    return port, opt, stats


@pytest.mark.parametrize("config", RECURRENT)
def test_learner_update_matches_jax(config):
    params, state = _jax_run(config)[:2]
    _, want_params, opt_state, want_stats = _jax_update(
        config, "f32", params, state)
    port, opt, stats = _port_update(config, "f32", params, state)
    for key in STAT_KEYS + ("episode_returns_sum", "episode_count"):
        np.testing.assert_allclose(float(stats[key]),
                                   float(want_stats[key]), rtol=1e-4,
                                   err_msg=key)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6),
        weights.torch_to_jax(port.state_dict()), want_params)
    want_nu = optax.tree_utils.tree_get(opt_state, "nu")
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_less(
            np.abs(g - np.asarray(w)).max(), 2e-2 * np.abs(w).max() + 1e-30),
        weights.param_list_to_jax(port, opt.state.nu), want_nu)


def _within(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("config", RECURRENT)
def test_bf16_train_matches_jax(config):
    params, state = _jax_run(config)[:2]
    pol_j = jax_precision.get("bf16_train")
    want, want_state = _jax_model(config, "bf16_train").apply(
        jax_precision.cast_params(params, pol_j), _inputs(12), state,
        sample_action=False)
    port = _port_model(config, params, "bf16_train")
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())
    with torch.no_grad():
        got, got_state = port(_tensors(_inputs(12)), _tensors(state),
                              sample_action=False)
    assert got.policy_logits.dtype == torch.float32
    _within(got.policy_logits.numpy(), want.policy_logits, BF16_TOL,
            "logits")
    _within(got.baseline.numpy(), want.baseline, BF16_TOL, "baseline")
    for g, w in zip(jax.tree_util.tree_leaves(got_state,
                                              is_leaf=torch.is_tensor),
                    jax.tree_util.tree_leaves(want_state)):
        _within(g.float().numpy(), w, BF16_TOL, "state")

    opt_state0, _, opt_state, want_stats = _jax_update(
        config, "bf16_train", params, state)
    port, opt, stats = _port_update(config, "bf16_train", params, state)
    # pg_loss sums terms of both signs, so it is held to the size of the
    # objective, as every stat is, as well as to its own.
    scale = abs(float(want_stats["total_loss"]))
    for key in STAT_KEYS:
        np.testing.assert_allclose(float(stats[key]), float(want_stats[key]),
                                   rtol=BF16_TOL, atol=BF16_TOL * scale,
                                   err_msg=key)
    got = jax.tree_util.tree_leaves(
        weights.param_list_to_jax(port, opt.state.master))
    want = jax.tree_util.tree_leaves(opt_state.master)
    start = jax.tree_util.tree_leaves(opt_state0.master)
    paths = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(opt_state.master)[0]]
    assert len(got) == len(want) == len(start) == len(paths)
    diff = total = 0.0
    for path, g, w, s in zip(paths, got, want, start):
        s = np.asarray(s, np.float64)
        dg, dw = np.asarray(g, np.float64) - s, np.asarray(w, np.float64) - s
        tol = (BASELINE_BIAS_TOL if "['baseline']['bias']" in path
               else BF16_TOL)
        assert (np.linalg.norm(dg - dw)
                <= tol * np.linalg.norm(dw) + 1e-12), path
        diff += np.sum((dg - dw) ** 2)
        total += np.sum(dw ** 2)
    assert diff <= BF16_TOL ** 2 * total


# ----------------------------------------------------------------- init

INIT_SIZES = {
    "pipelined_mlp": dict(num_stages=4, d_model=32),
    "pipelined_transformer": dict(num_layers=3, d_model=32, num_heads=4,
                                  memory_len=5),
}


def _fan_in(family, name, shape):
    """flax's fan_in of a stacked kernel under the reference's
    initializer: lecun_normal() on the MLP's rank-3 leaves (every axis
    but the last two is receptive field); the transformer's
    variance_scaling with batch_axis=0 and its in_axis."""
    if family == "pipelined_mlp":
        return math.prod(shape[:-1])
    return {"wq": shape[1], "wk": shape[1], "wv": shape[1],
            "wo": shape[1] * shape[2], "w1": shape[1],
            "w2": shape[1]}[name]


@pytest.mark.parametrize("family", sorted(INIT_SIZES))
def test_init_statistics_are_flax_draws(family):
    size = INIT_SIZES[family]
    jmodel = jax_create_model(family, num_actions=A, **size)
    ref = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        _inputs(0), jmodel.initial_state(B))["params"])
    torch.manual_seed(0)
    port = weights.torch_to_jax(port_create_model(
        family, A, frame_shape=FRAME, **size).state_dict(), wrap=False)
    stacked = {"pipelined_mlp": ("w_in", "w_out"),
               "pipelined_transformer": ("wq", "wk", "wv", "wo", "w1",
                                         "w2")}[family]
    if family == "pipelined_mlp":
        # The stage axis counts: fan_in S*d, not d.
        assert _fan_in(family, "w_in", ref["w_in"].shape) == 4 * 32
    for tree in (port, ref):
        for name in stacked:
            leaf = np.asarray(tree[name], np.float64)
            assert leaf.shape == np.shape(ref[name])
            sigma = math.sqrt(1.0 / _fan_in(family, name, leaf.shape))
            std = math.sqrt(np.mean(leaf ** 2))
            assert abs(std / sigma - 1) <= 4 / math.sqrt(2 * leaf.size), (
                name, std, sigma)
            cut = 2 * sigma / init.TRUNCATED_STD * (1 + 2.0 ** -23)
            assert np.abs(leaf).max() <= cut, name
        for name, leaf in tree.items():
            if name in stacked or isinstance(leaf, dict):
                continue
            want = 1.0 if name.endswith("_scale") else 0.0
            assert (np.asarray(leaf) == want).all(), name


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_weights_round_trip(config):
    params = _jax_run(config)[0]
    model = _port_model(config, params)
    family = CONFIGS[config][0]
    names = type(model).STAGE_PARAM_NAMES
    state = model.state_dict()
    assert set(names) <= set(state)
    assert not any(k.endswith("weight") and k in names for k in state)
    back = weights.torch_to_jax(state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        back, params)
    restored = weights.jax_to_torch(back)
    for k, v in state.items():
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0)
    lead = (MLP_SIZE["num_stages"] if family == "pipelined_mlp"
            else TF_SIZE["num_layers"])
    for name in names:
        assert state[name].shape[0] == lead, name


@pytest.mark.parametrize("family,use_lstm", [("pipelined_mlp", True),
                                             ("pipelined_transformer",
                                              False)])
def test_full_width_parameter_count_matches_jax(family, use_lstm):
    """The reference's defaults on 84x84x4 frames and 6 actions."""
    jmodel = jax_create_model(family, num_actions=6, use_lstm=use_lstm)
    inputs = {
        "frame": jnp.zeros((1, 2, 84, 84, 4), jnp.uint8),
        "reward": jnp.zeros((1, 2)), "done": jnp.zeros((1, 2), bool),
        "last_action": jnp.zeros((1, 2), jnp.int32)}
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                             "action": jax.random.PRNGKey(1)}, inputs,
                            jmodel.initial_state(2)))
    want = sum(math.prod(x.shape)
               for x in jax.tree_util.tree_leaves(shapes))
    port = port_create_model(family, 6, use_lstm=use_lstm)
    assert sum(p.numel() for p in port.parameters()) == want


def test_registry_rules():
    assert NOT_PORTED == {}
    with pytest.raises(ValueError, match="use_lstm"):
        port_create_model("pipelined_transformer", A, use_lstm=True)
    for family in ("pipelined_mlp", "pipelined_transformer"):
        with pytest.raises(ValueError, match="transformer only"):
            port_create_model(family, A, num_experts=4)


# ------------------------------------------------------------------ GPipe


@pytest.mark.parametrize("config", ["mlp_lstm", "transformer"])
def test_sequential_port_matches_the_references_gpipe_path(config):
    """The reference's model on a 2-device `pipe` mesh (2 microbatches,
    one per device) runs its GPipe schedule; the port's sequential stage
    loop on the same params computes the same outputs, state and
    gradients."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pipe",))
    pipe = _jax_model(config, mesh=mesh)
    params, state1 = _jax_run(config)[:2]
    value_and_grad = jax.jit(jax.value_and_grad(
        _jax_loss(pipe, _inputs(12), state1), has_aux=True))
    (value, (out, state2)), grads = value_and_grad(params)
    out, state2, grads = jax.device_get((out, state2, grads))
    # The batch divides into the microbatches, so the GPipe path runs.
    rows = T * B if config == "mlp_lstm" else B
    assert can_pipeline(mesh, rows, "pipe", None)
    model = _port_model(config, params)
    got, loss, _, got_state = _port_unrolls(model, grad=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=1e-5)
    np.testing.assert_array_equal(got.action.numpy(), np.asarray(out.action))
    np.testing.assert_allclose(got.policy_logits.detach().numpy(),
                               np.asarray(out.policy_logits), **FWD)
    np.testing.assert_allclose(got.baseline.detach().numpy(),
                               np.asarray(out.baseline), **FWD)
    _assert_state(got_state, state2)
    got_grads = weights.torch_to_jax(
        {n: p.grad for n, p in model.named_parameters()})
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **GRAD),
        got_grads, grads)
