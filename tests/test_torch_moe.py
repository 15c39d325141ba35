"""The port's mixture of experts (torchbeast_tpu_torch/models/moe.py) and
the MoE transformer against the JAX package's on the CPU.

- MoEFFN from the same weights and tokens: output rtol 1e-5, atol 1e-6;
  the routing (top-k indices) equal, including a token whose router
  logits all tie (an all-zero token: lower index first, as
  jax.lax.top_k); capacity overflow; the load-balance loss rtol 1e-6;
  the parameter gradients rtol 1e-5, atol 1e-6.
- The reference's tests/test_moe.py cases that need no mesh, on the port.
- The transformer with --num_experts at T=81 (learning) and T=1
  (acting): logits, baseline and KV cache within atol 1e-4 and parameter
  gradients rtol 1e-4, atol 1e-5 (tests/test_torch_transformer.py's);
  one whole --num_experts 4 update at eps 1.0 (the reason is in
  tests/test_torch_learner.py): loss stats and aux_loss rtol 1e-4,
  params rtol 1e-5, atol 2e-6; with the factored RMSprop state (its
  row/col EMAs of the rank-3 expert leaves) and at bf16 (the tolerances
  of tests/test_torch_precision_models.py).
- The acting path records no loss; blocks=all remat gives the same aux
  loss and gradients as no remat; flax's init statistics of w_in and
  w_out; the weights round trip; the drivers' MoE flags.
"""

import functools
import math
import threading

import flax
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu import precision as jax_precision
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.models.moe import MoEFFN as JaxMoEFFN
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import monobeast, polybeast, precision, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.models import moe
from torchbeast_tpu_torch.utils import checkpoint
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

D, FF, E = 8, 16, 4


def _jax_layer(tokens, seed=0, **kw):
    layer = JaxMoEFFN(d_model=D, d_ff=FF, **{"num_experts": E, **kw})
    x = np.random.default_rng(seed).standard_normal((tokens, D)).astype(
        np.float32)
    x[3] = 0.0  # every router logit 0: a tied row
    x[5] = x[4]  # two identical tokens: token order decides capacity
    params = layer.init(jax.random.PRNGKey(seed), x)
    return layer, jax.device_get(params), x


def _port_layer(params, **kw):
    layer = moe.MoEFFN(D, FF, kw.pop("num_experts", E), **kw)
    p = params["params"]
    with torch.no_grad():
        layer.router.weight.copy_(torch.from_numpy(
            np.array(p["router"]["kernel"]).T))
        for name in ("w_in", "b_in", "w_out", "b_out"):
            getattr(layer, name).copy_(torch.from_numpy(np.array(p[name])))
    return layer


LAYER_CASES = [
    dict(tokens=16, top_k=2, capacity_factor=1.25),
    dict(tokens=32, top_k=2, capacity_factor=0.5),  # overflow
    dict(tokens=12, top_k=1, capacity_factor=1.0),
    dict(tokens=24, top_k=3, capacity_factor=2.0, num_experts=6),
]


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_layer_matches_jax(case):
    case = dict(case)
    tokens = case.pop("tokens")
    layer, params, x = _jax_layer(tokens, **case)
    w = np.random.default_rng(1).standard_normal((tokens, D)).astype(
        np.float32)

    def loss(p):
        y, sown = layer.apply(p, x, mutable=["losses"])
        aux = sown["losses"]["moe_load_balance"]
        return jnp.sum(y * w) + aux, (y, aux)

    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (_, (want, want_aux)), grads = value_and_grad(params)
    port = _port_layer(params, **case)
    xt = torch.from_numpy(x)
    with moe.recording_losses() as recorded:
        got = port(xt)
    assert list(recorded) == [port]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(recorded[port].detach()),
                               float(want_aux),
                               rtol=1e-6)
    # The routing: the reference's top-k of its router probabilities.
    probs = jax.nn.softmax(x @ params["params"]["router"]["kernel"], -1)
    want_gate, want_idx = jax.lax.top_k(probs, port.top_k)
    _, gate, idx = port.route(xt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(idx[3].numpy(), np.arange(port.top_k))
    np.testing.assert_allclose(
        gate.detach().numpy(),
        np.asarray(want_gate / (want_gate.sum(-1, keepdims=True) + 1e-9)),
        rtol=1e-6)
    # The parameter gradients, the aux loss's included.
    total = torch.sum(got * torch.from_numpy(w)) + recorded[port]
    total.backward()
    g = grads["params"]
    np.testing.assert_allclose(port.router.weight.grad.numpy().T,
                               np.asarray(g["router"]["kernel"]),
                               rtol=1e-5, atol=1e-6)
    for name in ("w_in", "b_in", "w_out", "b_out"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(),
                                   np.asarray(g[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_capacity_follows_the_reference_formula():
    layer = moe.MoEFFN(D, FF, 4, top_k=2, capacity_factor=1.25)
    for tokens in (1, 2, 7, 16, 81, 2592):
        assert layer.capacity(tokens) == max(
            1, int(math.ceil(2 * tokens / 4 * 1.25)))
    with pytest.raises(ValueError, match="top_k=3 exceeds num_experts=2"):
        moe.MoEFFN(D, FF, 2, top_k=3)


# The reference's tests/test_moe.py cases without a mesh, on the port.


def test_identical_experts_equal_dense_ffn():
    _, params, x = _jax_layer(16)
    layer = _port_layer(params, top_k=2, capacity_factor=16.0)
    with torch.no_grad():
        for name in ("w_in", "b_in", "w_out", "b_out"):
            p = getattr(layer, name)
            p.copy_(p[:1].expand_as(p))
        y = layer(torch.from_numpy(x))
        dense = torch.nn.functional.gelu(
            torch.from_numpy(x) @ layer.w_in[0] + layer.b_in[0],
            approximate="tanh") @ layer.w_out[0] + layer.b_out[0]
    torch.testing.assert_close(y, dense, rtol=1e-5, atol=1e-5)


def test_capacity_overflow_drops_tokens():
    """Router forced onto one expert with capacity 2: exactly 2 tokens
    get expert output, the rest fall back to zero."""
    layer = moe.MoEFFN(D, FF, E, top_k=1, capacity_factor=1.0)
    with torch.no_grad():
        layer.router.weight.zero_()  # uniform logits: ties -> expert 0
        layer.b_out.fill_(1.0)
        x = torch.randn(8, D, generator=torch.Generator().manual_seed(1))
        y = layer(x)
    nonzero = torch.nonzero(y.abs().sum(dim=1) > 1e-9).flatten()
    assert nonzero.tolist() == [0, 1]  # token order wins


def test_aux_loss_recorded_and_balanced_floor():
    layer = moe.MoEFFN(D, FF, E, top_k=2, aux_loss_weight=1.0)
    x = torch.randn(64, D, generator=torch.Generator().manual_seed(3))
    with moe.recording_losses() as recorded:
        layer(x)
    # E * sum(f_e * p_e) >= 1, with equality iff perfectly uniform.
    assert float(recorded[layer].detach()) >= 0.99
    assert not any("loss" in k for k in layer.state_dict())


# --------------------------------------------------------- transformer

A = 5
FRAME = (8, 8, 1)
SIZE = dict(d_model=32, num_heads=4, memory_len=8, num_experts=4)


def _inputs(seed, t, b, done_at=None):
    rng = np.random.default_rng(seed)
    done = rng.random((t, b)) < 0.05
    if done_at is not None:
        done[done_at, 0] = True
    return {
        "frame": rng.integers(0, 256, (t, b) + FRAME, dtype=np.uint8),
        "reward": (3 * rng.standard_normal((t, b))).astype(np.float32),
        "done": done,
        "last_action": rng.integers(0, A, (t, b)).astype(np.int32),
    }


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _port_model(params, **kw):
    model = port_create_model("transformer", A, frame_shape=FRAME,
                              **{**SIZE, **kw})
    weights.load_jax_params(model, params)
    return model


@functools.lru_cache(maxsize=None)
def _jax_run(t, b=2):
    """Params, a warm cache, and on an unroll of t steps: the outputs,
    new cache, parameter gradients of a fixed loss (with the sown aux
    loss) and the aux loss."""
    model = jax_create_model("transformer", num_actions=A, **SIZE)
    state0 = model.initial_state(b)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        _inputs(10, 3, b), state0)
    _, cache = model.apply(params, _inputs(11, 5, b), state0,
                           sample_action=False)
    rng = np.random.default_rng(1)
    w_logits = rng.standard_normal((t, b, A)).astype(np.float32)
    inputs = _inputs(12, t, b, done_at=min(2, t - 1))

    def loss(p):
        (out, new_state), sown = model.apply(
            p, inputs, cache, sample_action=False, mutable=["losses"])
        aux = sum(jnp.sum(v) for v in jax.tree_util.tree_leaves(sown))
        value = (jnp.sum(out.policy_logits * w_logits)
                 + jnp.sum(out.baseline) + aux)
        return value, (out, new_state, aux)

    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (value, (out, new_state, aux)), grads = value_and_grad(params)
    return jax.device_get((params, cache, inputs, w_logits, value, out,
                           new_state, grads, aux))


@pytest.mark.parametrize("t", [81, 1])
def test_transformer_forward_and_gradients_match_jax(t):
    (params, cache, inputs, w_logits, value, want, want_state, grads,
     aux) = _jax_run(t)
    model = _port_model(params)
    with moe.recording_losses() as recorded:
        got, got_state = model({k: torch.from_numpy(v)
                                for k, v in inputs.items()},
                               _to_torch(cache), sample_action=False)
    assert len(recorded) == 2  # one per block
    got_aux = sum(recorded.values())
    np.testing.assert_allclose(float(got_aux.detach()), float(aux),
                               rtol=1e-5)
    np.testing.assert_allclose(got.policy_logits.detach().numpy(),
                               np.asarray(want.policy_logits), atol=1e-4)
    np.testing.assert_allclose(got.baseline.detach().numpy(),
                               np.asarray(want.baseline), atol=1e-4)
    for (gk, gv, gval), (wk, wv, wval) in zip(got_state, want_state):
        np.testing.assert_allclose(gk.detach().numpy(), np.asarray(wk),
                                   atol=1e-4)
        np.testing.assert_allclose(gv.detach().numpy(), np.asarray(wv),
                                   atol=1e-4)
        np.testing.assert_array_equal(gval.numpy(), np.asarray(wval))
    loss = (torch.sum(got.policy_logits * torch.from_numpy(w_logits))
            + torch.sum(got.baseline) + got_aux)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(value),
                               rtol=1e-4)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                                atol=1e-5),
        weights.torch_to_jax({n: p.grad for n, p in
                              model.named_parameters()}), grads)


def test_acting_path_records_no_loss():
    """An acting forward outside any recording computes no loss; one on
    another thread never writes into this thread's recording; the
    learner's forward records one loss per block."""
    params = _jax_run(1)[0]
    model = _port_model(params)
    inputs = {k: torch.from_numpy(v[0])
              for k, v in _inputs(7, 1, 2).items()}
    state = model.initial_state(2)
    with torch.no_grad():
        out, _ = port_learner.act_body(model, inputs, state)
    assert out.action.shape == (2,)
    with moe.recording_losses() as recorded:
        worker = threading.Thread(target=lambda: port_learner.act_body(
            model, inputs, state))
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive()
        assert recorded == {}
        model({k: v[None] for k, v in inputs.items()}, state,
              sample_action=False)
        assert len(recorded) == 2


def _batch(seed, t=4, b=2):
    rng = np.random.default_rng(seed)
    batch = _inputs(seed, t + 1, b, done_at=2)
    batch.update({
        "episode_return": rng.standard_normal((t + 1, b)).astype(
            np.float32),
        "episode_step": rng.integers(0, 100, (t + 1, b)).astype(np.int32),
        "action": rng.integers(0, A, (t + 1, b)).astype(np.int32),
        "policy_logits": rng.standard_normal((t + 1, b, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((t + 1, b)).astype(np.float32),
    })
    return batch


def test_remat_blocks_all_gives_the_same_aux_loss_and_gradients():
    params, cache = _jax_run(1)[:2]
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    hp = port_learner.HParams(unroll_length=4, batch_size=2)
    got = {}
    for remat in (False, True):
        model = _port_model(params, remat=remat)
        loss, stats = port_learner.compute_loss(model, batch,
                                                _to_torch(cache), hp)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        got[remat] = (stats, grads)
    assert float(got[False][0]["aux_loss"].detach()) > 0
    for key in ("total_loss", "aux_loss"):
        torch.testing.assert_close(got[True][0][key], got[False][0][key],
                                   rtol=0, atol=0)
    for a, b in zip(got[True][1], got[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


UPDATE_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss",
               "aux_loss", "grad_norm")


def _hp(**kw):
    # eps 1.0 for the reason tests/test_torch_learner.py gives.
    return dict(unroll_length=4, batch_size=2, total_steps=4 * 2 * 10,
                entropy_cost=0.01, rmsprop_eps=1.0, **kw)


def _jax_updates(jhp, batches, model=None, cache=None):
    params, cache0 = _jax_run(1)[:2]
    model = model or jax_create_model("transformer", num_actions=A,
                                      **SIZE)
    optimizer = jax_learner.make_optimizer(jhp)
    step = jax_learner.make_update_step(model, optimizer, jhp, donate=False)
    opt_state = optimizer.init(params)
    for batch in batches:
        params, opt_state, stats = step(params, opt_state, batch,
                                        cache0 if cache is None else cache)
    return jax.device_get((params, opt_state, stats))


@pytest.mark.parametrize("impls", [
    dict(vtrace_impl="pallas", opt_impl="pallas"),
    dict(vtrace_impl="associative", opt_impl="xla", opt_factored=True),
], ids=["pallas", "xla-factored"])
def test_moe_update_matches_jax(impls):
    """Two updates of --model transformer --num_experts 4 from the same
    weights, warm cache and batches."""
    batches = [_batch(4), _batch(5)]
    want_params, want_opt, want_stats = _jax_updates(
        jax_learner.HParams(**_hp(**impls)), batches)
    params, cache = _jax_run(1)[:2]
    port = _port_model(params)
    router = port.block_0.moe.router.weight.detach().clone()
    hp = port_learner.HParams(**_hp(**impls))
    opt = port_learner.make_optimizer(
        hp, list(port.parameters()),
        layouts=weights.jax_layouts(port) if hp.opt_factored else None)
    step = port_learner.update_body(port, opt, hp)
    for batch in batches:
        stats = step({k: torch.from_numpy(v) for k, v in batch.items()},
                     _to_torch(cache))
    for key in UPDATE_KEYS:
        np.testing.assert_allclose(float(stats[key]),
                                   float(want_stats[key]), rtol=1e-4,
                                   err_msg=key)
    assert float(stats["aux_loss"]) > 0
    # The aux loss reaches the router: its weight moves.
    assert not torch.equal(port.block_0.moe.router.weight, router)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6),
        weights.torch_to_jax(port.state_dict()), want_params)
    if not hp.opt_factored:
        return
    # The factored EMAs, the expert leaves' [E, d] / [E, ff] rows and
    # columns among them, in the reference's own tree.
    got_tree = checkpoint.opt_state_tree(port, opt)
    want_tree = flax.serialization.to_state_dict(want_opt)
    leaves = got_tree["1"]["0"]["leaves"]
    shapes = {tuple(np.shape(v["row"])) for v in leaves.values()}
    assert (4, 32) in shapes and (4, 128) in shapes
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(
            np.asarray(g, np.float32), np.asarray(w, np.float32),
            rtol=1e-4, atol=1e-9), got_tree, want_tree)


@pytest.mark.parametrize("policy", ["bf16_compute", "bf16_train"])
def test_bf16_forward_matches_jax(policy):
    """The experts in bf16, the routing in f32: logits, baseline and cache
    within 3e-2 of the largest entry, as the precision tests hold the
    dense transformer."""
    params, cache, inputs = _jax_run(81)[:3]
    pol_j = jax_precision.get(policy)
    model = jax_create_model("transformer", num_actions=A,
                             dtype=pol_j.compute_dtype,
                             head_dtype=pol_j.head_dtype, **SIZE)
    want, want_state = model.apply(
        jax_precision.cast_params(params, pol_j), inputs, cache,
        sample_action=False)
    pol = precision.get(policy)
    port = precision.cast_params(_port_model(
        params, dtype=pol.compute_dtype, head_dtype=pol.head_dtype), pol)
    assert port.block_0.moe.w_in.dtype == (
        torch.bfloat16 if policy == "bf16_train" else torch.float32)
    with torch.no_grad():
        got, got_state = port({k: torch.from_numpy(v)
                               for k, v in inputs.items()},
                              _to_torch(cache), sample_action=False)
    assert got.policy_logits.dtype == torch.float32
    pairs = [(got.policy_logits, want.policy_logits),
             (got.baseline, want.baseline)]
    pairs += [(g, w) for gs, ws in zip(got_state, want_state)
              for g, w in zip(gs[:2], ws[:2])]
    for g, w in pairs:
        w = np.asarray(w, np.float64)
        err = np.abs(g.numpy().astype(np.float64) - w).max()
        assert err <= 3e-2 * np.abs(w).max()


def test_bf16_train_master_covers_the_expert_weights():
    params = _jax_run(1)[0]
    pol = precision.get("bf16_train")
    port = precision.cast_params(_port_model(
        params, dtype=pol.compute_dtype, head_dtype=pol.head_dtype), pol)
    hp = port_learner.HParams(param_dtype="bf16", opt_state_dtype="bf16")
    opt = port_learner.make_optimizer(hp, list(port.parameters()))
    names = [n for n, _ in port.named_parameters()]
    masters = dict(zip(names, opt.state.master))
    for name in ("w_in", "b_in", "w_out", "b_out"):
        m = masters[f"block_1.moe.{name}"]
        assert m.dtype == torch.float32
        torch.testing.assert_close(
            m.to(torch.bfloat16), getattr(port.block_1.moe, name),
            rtol=0, atol=0)
    assert masters["block_0.moe.router.weight"].dtype == torch.float32


def test_init_statistics_are_flax_draws():
    """Fresh w_in [E, d, ff] and w_out [E, ff, d]: lecun_normal with the
    leading expert axis in flax's receptive field, fan_in d*E and ff*E
    (flax's own _compute_fans), std within four standard errors of
    sqrt(1/fan_in), cut at two of the untruncated normal's std; the
    router fan_in d; zero biases. The reference's own draw has the same
    std."""
    from jax._src.nn.initializers import _compute_fans

    d, ff, e = 64, 256, 8
    torch.manual_seed(0)
    layer = moe.MoEFFN(d, ff, e)
    ref = jax.device_get(JaxMoEFFN(d_model=d, d_ff=ff, num_experts=e).init(
        jax.random.PRNGKey(0), np.zeros((4, d), np.float32)))["params"]
    cases = (("w_in", layer.w_in, (e, d, ff), d * e),
             ("w_out", layer.w_out, (e, ff, d), ff * e),
             ("router", layer.router.weight.t(), (d, e), d))
    for name, leaf, shape, fan_in in cases:
        assert tuple(leaf.shape) == shape
        assert _compute_fans(shape)[0] == fan_in, name
        std = math.sqrt(1.0 / fan_in)
        want = ref[name] if name != "router" else ref["router"]["kernel"]
        for values in (leaf.detach().numpy(), np.asarray(want)):
            # The relative standard error of a sample std: 1/sqrt(2n).
            tol = 4.0 / math.sqrt(2 * values.size)
            assert abs(values.std() / std - 1.0) < tol, name
            assert np.abs(values).max() <= 2.0 * std / 0.87962566103423978
    assert not layer.b_in.any() and not layer.b_out.any()


def test_weights_round_trip_and_names():
    params = _jax_run(1)[0]
    model = _port_model(params)
    keys = set(model.state_dict())
    assert {"block_0.moe.router.weight", "block_0.moe.w_in",
            "block_0.moe.b_in", "block_0.moe.w_out",
            "block_0.moe.b_out"} <= keys
    assert not any(k.startswith("block_0.Dense_") for k in keys)
    assert model.block_0.moe.router.weight.shape == (4, 32)
    back = weights.torch_to_jax(model.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        back, params)
    # Without experts the block keeps its keys.
    dense = port_create_model("transformer", A, frame_shape=FRAME,
                              d_model=32, num_heads=4, memory_len=8)
    assert "block_0.Dense_0.weight" in dense.state_dict()
    assert not any("moe" in k for k in dense.state_dict())


# -------------------------------------------------------------- drivers


def _mono_argv(tmp_path, *extra):
    return ["--disable_cuda", "--env", "Mock", "--model", "transformer",
            "--num_actors", "4", "--batch_size", "2", "--unroll_length",
            "4", "--total_steps", "32", "--serial_envs", "--savedir",
            str(tmp_path), "--xpid", "moe", *extra]


@pytest.mark.parametrize("driver", ["monobeast", "polybeast"])
@pytest.mark.parametrize("extra,error,match", [
    (["--num_experts", "4", "--expert_parallel", "2"], NotImplementedError,
     "Queue 1 item 'expert parallel'"),
    (["--expert_parallel", "1"], ValueError,
     "--expert_parallel needs --num_experts"),
])
def test_driver_moe_flag_checks(tmp_path, driver, extra, error, match):
    mod = {"monobeast": monobeast, "polybeast": polybeast}[driver]
    flags = mod.make_parser().parse_args(
        ["--disable_cuda", "--env", "Mock", "--model", "transformer",
         "--savedir", str(tmp_path), *extra])
    with pytest.raises(error, match=match):
        mod.main(flags)


def test_num_experts_off_the_transformer_raises(tmp_path):
    flags = monobeast.make_parser().parse_args(
        _mono_argv(tmp_path, "--model", "deep", "--num_experts", "4"))
    with pytest.raises(ValueError, match="transformer only"):
        monobeast.main(flags)


def test_monobeast_trains_the_moe_transformer_on_cpu(tmp_path):
    stats = monobeast.main(monobeast.make_parser().parse_args(_mono_argv(
        tmp_path, "--num_experts", "4", "--attention_impl", "pallas",
        "--vtrace_impl", "pallas", "--opt_impl", "pallas",
        "--expert_parallel", "1")))
    assert stats["aux_loss"] > 0 and np.isfinite(stats["total_loss"])
    assert (tmp_path / "moe" / "model.ckpt").is_file()


def test_polybeast_trains_the_moe_transformer_on_cpu(tmp_path):
    """The serving tier's bf16 snapshots and a replica carry the MoE
    leaves (--replica_refresh_updates 1)."""
    stats = polybeast.main(polybeast.make_parser().parse_args([
        "--disable_cuda", "--env", "Mock", "--model", "transformer",
        "--num_experts", "4", "--num_servers", "2", "--batch_size", "2",
        "--unroll_length", "5", "--total_steps", "30",
        "--max_inference_batch_size", "4", "--replica_refresh_updates", "1",
        "--no_native_runtime", "--pipes_basename",
        f"unix:{tmp_path}/moe", "--savedir", str(tmp_path), "--xpid",
        "moe"]))
    assert stats["aux_loss"] > 0 and np.isfinite(stats["total_loss"])
