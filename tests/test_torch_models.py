"""The port's models (torchbeast_tpu_torch/models/) and weight converter
(weights.py) against the JAX package on the CPU.

Weights come from the JAX model's init and are carried across by
weights.py; the same numpy batch (84x84x4 uint8 frames, T=3, B=2) goes
through both. Forward: argmax actions equal, logits and baseline within
atol 1e-4. Parameter gradients of a scalar loss of the outputs: rtol 1e-4
(atol 1e-5 for entries near zero); the convolutions and matrix products
sum in another order in each framework.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu_torch import weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 3, 2, 6
CONFIGS = [("shallow", False), ("shallow", True), ("deep", False),
           ("deep", True), ("mlp", False), ("mlp", True)]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 256, (T, B, 84, 84, 4), dtype=np.uint8),
        "reward": (3 * rng.standard_normal((T, B))).astype(np.float32),
        "done": rng.random((T, B)) < 0.3,
        "last_action": rng.integers(0, A, (T, B)).astype(np.int32),
    }


def _state(rng, state):
    """A random (h, c) agent state of the reference's shapes."""
    return tuple(rng.standard_normal(np.shape(s)).astype(np.float32)
                 for s in state)


@functools.lru_cache(maxsize=None)
def _jax_run(name, use_lstm):
    """JAX params, outputs and parameter gradients of a fixed scalar loss."""
    model = jax_create_model(name, num_actions=A, use_lstm=use_lstm)
    inputs = _inputs()
    rng = np.random.default_rng(1)
    state = _state(rng, model.initial_state(B))
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        inputs, state,
    )
    w_logits = rng.standard_normal((T, B, A)).astype(np.float32)
    w_base = rng.standard_normal((T, B)).astype(np.float32)

    def loss(p):
        out, new_state = model.apply(p, inputs, state, sample_action=False)
        value = (jnp.sum(out.policy_logits * w_logits)
                 + jnp.sum(out.baseline * w_base))
        return value, (out, new_state)

    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (value, (out, new_state)), grads = value_and_grad(params)
    return jax.device_get((params, state, w_logits, w_base, value, out,
                           new_state, grads))


def _port_model(name, use_lstm, params):
    model = port_create_model(name, A, use_lstm)
    weights.load_jax_params(model, params)
    return model


@pytest.mark.parametrize("name,use_lstm", CONFIGS)
def test_forward_matches_jax(name, use_lstm):
    params, state, _, _, _, want, want_state, _ = _jax_run(name, use_lstm)
    model = _port_model(name, use_lstm, params)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with torch.no_grad():
        got, got_state = model(
            inputs, tuple(torch.from_numpy(s) for s in state),
            sample_action=False,
        )
    np.testing.assert_array_equal(got.action.numpy(),
                                  np.asarray(want.action))
    np.testing.assert_allclose(got.policy_logits.numpy(),
                               np.asarray(want.policy_logits), atol=1e-4)
    np.testing.assert_allclose(got.baseline.numpy(),
                               np.asarray(want.baseline), atol=1e-4)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("name,use_lstm", CONFIGS)
def test_parameter_gradients_match_jax(name, use_lstm):
    params, state, w_logits, w_base, value, _, _, grads = _jax_run(
        name, use_lstm)
    model = _port_model(name, use_lstm, params)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    out, _ = model(inputs, tuple(torch.from_numpy(s) for s in state),
                   sample_action=False)
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


@pytest.mark.parametrize("name,use_lstm", [("shallow", True),
                                           ("deep", True), ("mlp", True)])
def test_converter_round_trip(name, use_lstm):
    params = _jax_run(name, use_lstm)[0]
    model = _port_model(name, use_lstm, params)
    back = weights.torch_to_jax(model.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        back, params,
    )
    # And the port's own state dict survives torch -> JAX -> torch.
    state = weights.jax_to_torch(back)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)


def test_deep_model_at_full_width():
    """84x84x4 frames, trunk 16/32/32, fc 256, LSTM 256: the reference's
    1,617,367 parameters in 39 tensors (48 flax leaves)."""
    model = port_create_model("deep", A, use_lstm=True)
    assert sum(p.numel() for p in model.parameters()) == 1_617_367
    assert len(list(model.parameters())) == 39
    assert model.trunk.fc.in_features == 11 * 11 * 32
    assert model.head.core.hidden_size == 256
    h, c = model.initial_state(5)
    assert h.shape == c.shape == (1, 5, 256)


def test_sampled_actions_follow_the_generator():
    model = port_create_model("deep", A, use_lstm=False)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            out, _ = model(inputs, (), sample_action=True, generator=gen)
        draws.append(out.action)
    torch.testing.assert_close(draws[0], draws[1])
    assert draws[0].shape == (T, B)
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < A


def test_not_ported_families_raise():
    """Every family of the reference is in the port: nothing is left to
    raise, and the last two build."""
    from torchbeast_tpu_torch.models import NOT_PORTED

    assert NOT_PORTED == {}
    for name in ("pipelined_transformer", "pipelined_mlp"):
        model = port_create_model(name, A)
        assert type(model).__name__ == {
            "pipelined_transformer": "PipelinedTransformerNet",
            "pipelined_mlp": "PipelinedMLPNet"}[name]
