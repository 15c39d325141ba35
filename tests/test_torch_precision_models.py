"""The port's models and learner under the bf16 precision policies against
the JAX package on the CPU, and the driver's --precision flags.

- Forward: the shallow, deep + LSTM and transformer (dense and pallas
  attention) models at bf16_compute and bf16_train, from the same weights
  (the JAX init, carried across by weights.py, then cast by each
  package's cast_params) and the same numpy inputs. Logits, baseline and
  the new state come out f32 in both, and the argmax actions are equal.
  Tolerance: max |difference| <= FWD_TOL times the largest |logit| (or
  |baseline|, or |state|); measured at most 1.1e-2 (the shallow model's
  LSTM state at bf16_train). bf16 rounds at other places in the two
  frameworks (XLA on the CPU may keep f32 between fused ops, and the
  convolutions and products sum in other orders), so each layer differs
  by a few bf16 ulps.
- One learner update at bf16_train (--vtrace_impl pallas --opt_impl
  pallas, the deep model with TBT_POOL_PALLAS=1 semantics on the CPU and
  the transformer with --attention_impl pallas), eps 1.0 as in
  tests/test_torch_learner.py: the loss stats within STATS_RTOL
  (measured: at most 1.6e-2, the deep model's pg_loss), and the change of
  the f32 master: the norm of its difference within UPDATE_TOL of the norm
  of the JAX change over all leaves (measured 3.2e-2 deep, 6.9e-3
  transformer) and within LEAF_TOL leaf by leaf (measured at most 0.13,
  a 16-element conv bias of the deep trunk: its bf16 gradient sums bf16
  products over every position of the batch, which the two frameworks'
  bf16 convolutions round at other places).
- The driver: --precision bf16_train trains on the CPU for deep and
  transformer with every kernel switch on; --model_dtype bfloat16 is
  bf16_compute.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu import precision as jax_precision
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import monobeast, precision, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

A = 6
FWD_TOL = 3e-2
STATS_RTOL = 3e-2
UPDATE_TOL, LEAF_TOL = 6e-2, 0.25

CONFIGS = {
    "shallow": dict(name="shallow", use_lstm=True, frame=(84, 84, 4),
                    size={}),
    "deep": dict(name="deep", use_lstm=True, frame=(84, 84, 4), size={}),
    "transformer_dense": dict(
        name="transformer", use_lstm=False, frame=(8, 8, 1),
        size=dict(d_model=32, num_heads=4, memory_len=4,
                  attention_impl="dense")),
    "transformer_pallas": dict(
        name="transformer", use_lstm=False, frame=(8, 8, 1),
        size=dict(d_model=32, num_heads=4, memory_len=4,
                  attention_impl="pallas")),
}


def _inputs(frame, t, b, seed, done_at=None):
    rng = np.random.default_rng(seed)
    done = rng.random((t, b)) < 0.2
    if done_at is not None:
        done[done_at, 0] = True
    return {
        "frame": rng.integers(0, 256, (t, b) + frame, dtype=np.uint8),
        "reward": (3 * rng.standard_normal((t, b))).astype(np.float32),
        "done": done,
        "last_action": rng.integers(0, A, (t, b)).astype(np.int32),
    }


def _state(model, b, seed):
    """A random f32 agent state of the model's shapes (a 70%-valid cache
    for the transformer)."""
    rng = np.random.default_rng(seed)
    state = model.initial_state(b)
    if not state:
        return state
    if isinstance(state[0], tuple):  # transformer: (k, v, valid) a layer
        return tuple(
            (rng.standard_normal(k.shape).astype(np.float32),
             rng.standard_normal(v.shape).astype(np.float32),
             (rng.random(valid.shape) < 0.7).astype(np.float32))
            for k, v, valid in state)
    return tuple((0.5 * rng.standard_normal(np.shape(s))).astype(np.float32)
                 for s in state)


def _jax_model(config, policy):
    c = CONFIGS[config]
    pol = jax_precision.get(policy)
    return jax_create_model(c["name"], num_actions=A, use_lstm=c["use_lstm"],
                            dtype=pol.compute_dtype,
                            head_dtype=pol.head_dtype, **c["size"])


def _port_model(config, policy, params):
    c = CONFIGS[config]
    pol = precision.get(policy)
    model = port_create_model(c["name"], A, use_lstm=c["use_lstm"],
                              frame_shape=c["frame"],
                              dtype=pol.compute_dtype,
                              head_dtype=pol.head_dtype, **c["size"])
    weights.load_jax_params(model, jax.device_get(params))
    return precision.cast_params(model, pol)


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


@functools.lru_cache(maxsize=None)
def _init(config):
    """f32 flax params of `config` (from the f32 model), its inputs and
    state."""
    c = CONFIGS[config]
    model = _jax_model(config, "f32")
    T, B = 3, 2
    inputs = _inputs(c["frame"], T, B, seed=1, done_at=1)
    state = _state(model, B, seed=2)
    params = model.init({"params": jax.random.PRNGKey(0),
                         "action": jax.random.PRNGKey(1)}, inputs, state)
    return params, inputs, state


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("policy", ["bf16_compute", "bf16_train"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_matches_jax(config, policy):
    params, inputs, state = _init(config)
    jparams = jax_precision.cast_params(params, jax_precision.get(policy))
    want, want_state = _jax_model(config, policy).apply(
        jparams, inputs, state, sample_action=False)
    port = _port_model(config, policy, params)
    with torch.no_grad():
        got, got_state = port({k: torch.from_numpy(v)
                               for k, v in inputs.items()},
                              _to_torch(state), sample_action=False)
    assert got.policy_logits.dtype == torch.float32
    assert got.baseline.dtype == torch.float32
    assert want.policy_logits.dtype == jnp.float32
    np.testing.assert_array_equal(got.action.numpy(),
                                  np.asarray(want.action))
    _close(got.policy_logits.numpy(), want.policy_logits, FWD_TOL, "logits")
    _close(got.baseline.numpy(), want.baseline, FWD_TOL, "baseline")
    for g, w in zip(jax.tree_util.tree_leaves(
            got_state, is_leaf=torch.is_tensor),
            jax.tree_util.tree_leaves(want_state)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _close(g.numpy(), w, FWD_TOL, "state")


# ------------------------------------------------------------- learner

LT, LB = 4, 2


def _batch(frame, seed):
    rng = np.random.default_rng(seed)
    batch = _inputs(frame, LT + 1, LB, seed)
    batch.update({
        "episode_return": rng.standard_normal((LT + 1, LB)).astype(
            np.float32),
        "episode_step": rng.integers(0, 100, (LT + 1, LB)).astype(np.int32),
        "action": rng.integers(0, A, (LT + 1, LB)).astype(np.int32),
        "policy_logits": rng.standard_normal((LT + 1, LB, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((LT + 1, LB)).astype(np.float32),
    })
    return batch


def _hp():
    # eps 1.0 for the reason tests/test_torch_learner.py gives.
    return dict(unroll_length=LT, batch_size=LB, total_steps=LT * LB * 10,
                vtrace_impl="pallas", opt_impl="pallas", entropy_cost=0.01,
                rmsprop_eps=1.0, opt_state_dtype="bf16", param_dtype="bf16")


STAT_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
             "grad_norm")


@pytest.mark.parametrize("config", ["deep", "transformer_pallas"])
def test_bf16_train_update_matches_jax(config, monkeypatch):
    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    c = CONFIGS[config]
    pol_j = jax_precision.get("bf16_train")
    model = _jax_model(config, "bf16_train")
    params = _init(config)[0]
    params = jax_precision.cast_params(params, pol_j)
    state = _state(model, LB, seed=4)
    batch = _batch(c["frame"], seed=5)
    hp = jax_learner.HParams(**_hp())
    optimizer = jax_learner.make_optimizer(hp)
    opt_state = optimizer.init(params)
    start = jax.device_get(opt_state.master)
    step = jax_learner.make_update_step(model, optimizer, hp, donate=False)
    _, opt_state, want_stats = jax.device_get(step(
        params, opt_state, jax_precision.cast_batch(batch, pol_j.batch_dtype),
        jax_precision.cast_batch(state, pol_j.batch_dtype)))

    port = _port_model(config, "bf16_train", _init(config)[0])
    phat = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(phat, list(port.parameters()))
    pol = precision.get("bf16_train")
    got_stats = port_learner.update_body(port, opt, phat)(
        precision.cast_batch({k: torch.from_numpy(v)
                              for k, v in batch.items()}, pol.batch_dtype),
        precision.cast_batch(_to_torch(state), pol.batch_dtype))
    for key in STAT_KEYS:
        np.testing.assert_allclose(float(got_stats[key]),
                                   float(want_stats[key]), rtol=STATS_RTOL,
                                   err_msg=key)
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())
    got = jax.tree_util.tree_leaves(
        weights.param_list_to_jax(port, opt.state.master))
    want = jax.tree_util.tree_leaves(jax.device_get(opt_state.master))
    start = jax.tree_util.tree_leaves(start)
    diff = total = 0.0
    for g, w, s in zip(got, want, start):
        s = np.asarray(s, np.float64)
        dg, dw = np.asarray(g, np.float64) - s, np.asarray(w, np.float64) - s
        leaf_diff, leaf_norm = np.sum((dg - dw) ** 2), np.sum(dw ** 2)
        assert leaf_diff <= LEAF_TOL ** 2 * leaf_norm, g.shape
        diff, total = diff + leaf_diff, total + leaf_norm
    assert diff <= UPDATE_TOL ** 2 * total, np.sqrt(diff / total)


def test_optimizer_state_crosses_between_the_packages():
    """weights.py carries the bf16_train optimizer state both ways: the
    JAX fused tail's f32 master and bf16 nu into the port's
    FusedTailState and back, bit for bit; so a port update can start from
    the reference's state."""
    config = "transformer_pallas"
    params = jax_precision.cast_params(_init(config)[0],
                                       jax_precision.get("bf16_train"))
    hp = jax_learner.HParams(**_hp())
    state = jax_learner.make_optimizer(hp).init(params)
    rng = np.random.default_rng(8)
    master = jax.tree_util.tree_map(
        lambda m: np.asarray(m) + rng.standard_normal(m.shape).astype(
            np.float32), jax.device_get(state.master))
    nu = jax.tree_util.tree_map(
        lambda n: jnp.asarray(rng.random(n.shape), jnp.bfloat16), state.nu)
    port = _port_model(config, "bf16_train", _init(config)[0])
    opt = port_learner.make_optimizer(port_learner.HParams(**_hp()),
                                      list(port.parameters()))
    weights.load_optimizer_state(port, opt, nu=jax.device_get(nu),
                                 master=master)
    assert {n.dtype for n in opt.state.nu} == {torch.bfloat16}
    back = weights.optimizer_state_to_jax(port, opt.state)
    assert back["mom"] is None
    for got, want in ((back["master"], master), (back["nu"], nu)):
        jax.tree_util.tree_map(
            lambda g, w: np.testing.assert_array_equal(g, np.asarray(
                w, np.float32)), got, jax.device_get(want))


# -------------------------------------------------------------- driver


def _flags(tmp_path, *extra):
    return monobeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--num_actors", "4",
        "--batch_size", "2", "--unroll_length", "4", "--total_steps", "48",
        "--serial_envs", "--vtrace_impl", "pallas", "--opt_impl", "pallas",
        "--savedir", str(tmp_path), "--xpid", "tiny", *extra,
    ])


@pytest.mark.parametrize("model", [
    ("--model", "deep", "--use_lstm"),
    ("--model", "transformer", "--attention_impl", "pallas"),
])
def test_driver_trains_at_bf16_train_on_cpu(tmp_path, monkeypatch, model):
    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    stats = monobeast.train(_flags(tmp_path, "--precision", "bf16_train",
                                   *model))
    for key in STAT_KEYS + ("sps",):
        assert np.isfinite(stats[key]), key
    assert stats["step"] == 48


def test_model_dtype_alias_is_bf16_compute(tmp_path):
    flags = _flags(tmp_path, "--model_dtype", "bfloat16", "--model", "deep")
    assert precision.resolve_flags(flags).name == "bf16_compute"
    hp = monobeast.hparams_from_flags(flags)
    assert (hp.param_dtype, hp.opt_state_dtype) == ("f32", "f32")
    model = monobeast.build_model(flags, A, (84, 84, 4),
                                  torch.device("cpu"))
    assert model.trunk.dtype == torch.bfloat16
    assert model.head.dtype == torch.float32
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    flags = _flags(tmp_path, "--model_dtype", "bfloat16", "--precision",
                   "bf16_train")
    with pytest.raises(ValueError, match="conflicts"):
        monobeast.train(flags)


def test_factored_opt_state_trains_with_xla_and_refuses_pallas(tmp_path):
    flags = _flags(tmp_path, "--factored_opt_state", "--opt_impl", "xla",
                   "--model", "deep", "--precision", "bf16_train")
    assert np.isfinite(monobeast.train(flags)["total_loss"])
    flags = _flags(tmp_path, "--factored_opt_state", "--model", "deep")
    with pytest.raises(ValueError, match="factored"):
        monobeast.train(flags)


def test_bf16_train_builds_the_optimizer_from_resident_params(tmp_path):
    flags = _flags(tmp_path, "--precision", "bf16_train", "--model",
                   "transformer")
    model = monobeast.build_model(flags, A, (84, 84, 4),
                                  torch.device("cpu"))
    hp = monobeast.hparams_from_flags(flags)
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert {m.dtype for m in opt.state.master} == {torch.float32}
    assert {n.dtype for n in opt.state.nu} == {torch.bfloat16}
