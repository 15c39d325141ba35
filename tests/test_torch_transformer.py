"""The port's transformer policy (torchbeast_tpu_torch/models/transformer.py)
against the JAX package's on the CPU: forward and parameter gradients from
converted weights, the batch-vs-stepwise cache invariant, the weight
converter, and one learner update.

Model: 2 layers, d_model 32, 4 heads, memory_len 4 on 8x8x1 frames with 4
actions, B=2, T=6, so the band (4) is shorter than the unroll and the
cache evicts. The cache is warmed by a first unroll, and the compared
unroll plants a done, so segments and the no-done gate act. Forward:
argmax actions equal; logits, baseline and the new cache within atol
1e-4; cache validity equal. Parameter gradients: rtol 1e-4, atol 1e-5,
as for the conv models (LayerNorm needs no more). The learner update is
held at the tolerances of tests/test_torch_learner.py.
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
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.models import transformer as port_transformer
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 6, 2, 4
FRAME = (8, 8, 1)
SIZE = dict(d_model=32, num_heads=4, memory_len=4)
IMPLS = ["dense", "pallas"]


def _inputs(seed, t=T, done_at=None):
    rng = np.random.default_rng(seed)
    done = np.zeros((t, B), bool)
    if done_at is not None:
        done[done_at, 0] = True
    return {
        "frame": rng.integers(0, 256, (t, B) + FRAME, dtype=np.uint8),
        "reward": (3 * rng.standard_normal((t, B))).astype(np.float32),
        "done": done,
        "last_action": rng.integers(0, A, (t, B)).astype(np.int32),
    }


def _jax_model(impl="dense"):
    return jax_create_model("transformer", num_actions=A,
                            attention_impl=impl, **SIZE)


def _port_model(params, impl="dense"):
    model = port_create_model("transformer", A, frame_shape=FRAME,
                              attention_impl=impl, **SIZE)
    weights.load_jax_params(model, params)
    return model


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


@functools.lru_cache(maxsize=None)
def _jax_run(impl):
    """Params, a warm cache, and the outputs, new cache and parameter
    gradients of a fixed scalar loss on an unroll with a done at t=2."""
    model = _jax_model(impl)
    state0 = model.initial_state(B)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        _inputs(10), state0,
    )
    _, cache = _jax_model().apply(params, _inputs(11), state0,
                                  sample_action=False)
    rng = np.random.default_rng(1)
    w_logits = rng.standard_normal((T, B, A)).astype(np.float32)
    w_base = rng.standard_normal((T, B)).astype(np.float32)
    inputs = _inputs(12, done_at=2)

    def loss(p):
        out, new_state = model.apply(p, inputs, cache, sample_action=False)
        value = (jnp.sum(out.policy_logits * w_logits)
                 + jnp.sum(out.baseline * w_base))
        return value, (out, new_state)

    (value, (out, new_state)), grads = jax.value_and_grad(
        loss, has_aux=True)(params)
    return jax.device_get((params, cache, w_logits, w_base, value, out,
                           new_state, grads))


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_jax(impl):
    params, cache, _, _, _, want, want_state, _ = _jax_run(impl)
    model = _port_model(params, impl)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(12, done_at=2)
              .items()}
    with torch.no_grad():
        got, got_state = model(inputs, _to_torch(cache),
                               sample_action=False)
    np.testing.assert_array_equal(got.action.numpy(),
                                  np.asarray(want.action))
    np.testing.assert_allclose(got.policy_logits.numpy(),
                               np.asarray(want.policy_logits), atol=1e-4)
    np.testing.assert_allclose(got.baseline.numpy(),
                               np.asarray(want.baseline), atol=1e-4)
    assert len(got_state) == len(want_state) == 2
    for (gk, gv, gval), (wk, wv, wval) in zip(got_state, want_state):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-4)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-4)
        np.testing.assert_array_equal(gval.numpy(), np.asarray(wval))


@pytest.mark.parametrize("impl", IMPLS)
def test_parameter_gradients_match_jax(impl):
    params, cache, w_logits, w_base, value, _, _, grads = _jax_run(impl)
    model = _port_model(params, impl)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(12, done_at=2)
              .items()}
    out, _ = model(inputs, _to_torch(cache), sample_action=False)
    loss = (torch.sum(out.policy_logits * torch.from_numpy(w_logits))
            + torch.sum(out.baseline * torch.from_numpy(w_base)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(value),
                               rtol=1e-4)
    got = weights.torch_to_jax(
        {n: p.grad for n, p in model.named_parameters()})
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                                atol=1e-5),
        got, grads,
    )


@pytest.mark.parametrize("impl", IMPLS)
def test_batch_forward_matches_stepwise(impl):
    """The batch (learner) forward equals T stepwise (acting) forwards that
    carry the cache, logits and the cache written back alike."""
    params = _jax_run("dense")[0]
    model = _port_model(params, impl)
    warm = {k: torch.from_numpy(v) for k, v in _inputs(11).items()}
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(13, done_at=3)
              .items()}
    with torch.no_grad():
        _, state = model(warm, model.initial_state(B), sample_action=False)
        full, full_state = model(inputs, state, sample_action=False)
        logits = []
        for t in range(T):
            out, state = model({k: v[t:t + 1] for k, v in inputs.items()},
                               state, sample_action=False)
            logits.append(out.policy_logits[0])
    torch.testing.assert_close(torch.stack(logits), full.policy_logits,
                               rtol=2e-4, atol=2e-5)
    for (bk, bv, bval), (sk, sv, sval) in zip(full_state, state):
        torch.testing.assert_close(sk, bk, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(sv, bv, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(sval, bval, rtol=0, atol=0)


def test_pallas_path_goes_through_the_kernel_wrapper(monkeypatch):
    """Both the batch forward and the T=1 acting forward call the fused
    attention wrapper, once per layer."""
    calls = []
    wrapped = port_transformer.transformer_attention

    def counting(*args):
        calls.append(args[1].shape[1])
        return wrapped(*args)

    monkeypatch.setattr(port_transformer, "transformer_attention", counting)
    model = _port_model(_jax_run("dense")[0], "pallas")
    with torch.no_grad():
        for t in (T, 1):
            inputs = {k: torch.from_numpy(v) for k, v in _inputs(14, t=t)
                      .items()}
            model(inputs, model.initial_state(B), sample_action=True)
    assert calls == [T, T, 1, 1]


def test_converter_round_trip():
    params = _jax_run("dense")[0]
    model = _port_model(params)
    back = weights.torch_to_jax(model.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        back, params,
    )
    state = weights.jax_to_torch(back)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)


def test_full_width_model():
    """The reference's defaults: 2 layers, d_model 128, 4 heads of 32,
    memory_len 64, FFN 512, 6 actions on 84x84x4 frames: 4,012,047
    parameters, as many as the JAX tree holds."""
    model = port_create_model("transformer", 6)
    assert sum(p.numel() for p in model.parameters()) == 4_012_047
    assert model.block_1.Dense_0.out_features == 512
    assert model.block_0.rel_bias.shape == (4, 65)
    k, v, valid = model.initial_state(5)[1]
    assert k.shape == v.shape == (64, 5, 4, 32)
    assert valid.shape == (64, 5)


def test_registry_rules():
    with pytest.raises(ValueError, match="use_lstm"):
        port_create_model("transformer", A, use_lstm=True)
    with pytest.raises(ValueError, match="attention_impl"):
        port_create_model("transformer", A, attention_impl="ring")


# ------------------------------------------------------------- learner

LT = 4  # learner unroll


def _batch(seed):
    rng = np.random.default_rng(seed)
    done = rng.random((LT + 1, B)) < 0.2
    done[2, 1] = True
    return {
        "frame": rng.integers(0, 256, (LT + 1, B) + FRAME, dtype=np.uint8),
        "reward": rng.standard_normal((LT + 1, B)).astype(np.float32),
        "done": done,
        "episode_return": rng.standard_normal((LT + 1, B)).astype(
            np.float32),
        "episode_step": rng.integers(0, 100, (LT + 1, B)).astype(np.int32),
        "last_action": rng.integers(0, A, (LT + 1, B)).astype(np.int32),
        "action": rng.integers(0, A, (LT + 1, B)).astype(np.int32),
        "policy_logits": rng.standard_normal((LT + 1, B, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((LT + 1, B)).astype(np.float32),
    }


def _hp():
    # eps 1.0 for the reason tests/test_torch_learner.py gives.
    return dict(unroll_length=LT, batch_size=B, total_steps=LT * B * 10,
                vtrace_impl="pallas", opt_impl="pallas", entropy_cost=0.01,
                rmsprop_eps=1.0)


def test_learner_update_matches_jax():
    """One update of --model transformer --attention_impl pallas
    --vtrace_impl pallas --opt_impl pallas from the same weights, warm
    cache and batch: stats rtol 1e-4, params rtol 1e-5 / atol 2e-6, nu
    within 2e-2 of each leaf's largest entry."""
    model = _jax_model("pallas")
    params, cache = _jax_run("dense")[:2]
    hp = jax_learner.HParams(**_hp())
    optimizer = jax_learner.make_optimizer(hp)
    step = jax_learner.make_update_step(model, optimizer, hp, donate=False)
    want_params, opt_state, want_stats = jax.device_get(step(
        params, optimizer.init(params), _batch(0), cache))
    want_nu = optax.tree_utils.tree_get(opt_state, "nu")

    port = _port_model(params, "pallas")
    phat = port_learner.HParams(**_hp())
    port_opt = port_learner.make_optimizer(phat, list(port.parameters()))
    stats = port_learner.update_body(port, port_opt, phat)(
        {k: torch.from_numpy(v) for k, v in _batch(0).items()},
        _to_torch(cache),
    )
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
                "episode_returns_sum", "episode_count", "grad_norm"):
        np.testing.assert_allclose(float(stats[key]),
                                   float(want_stats[key]), rtol=1e-4,
                                   err_msg=key)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6),
        weights.torch_to_jax(port.state_dict()), want_params,
    )
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_less(
            np.abs(g - np.asarray(w)).max(), 2e-2 * np.abs(w).max() + 1e-30),
        weights.param_list_to_jax(port, port_opt.state.nu), want_nu,
    )
