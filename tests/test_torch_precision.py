"""The port's precision policies (torchbeast_tpu_torch/precision.py) and its
optimizer under them (ops/opt.py, learner.py) against the JAX package on
the CPU.

- Policy table, `resolve_flags` (the --model_dtype alias, its one-time
  warning, the conflict error), `cast_batch` and `cast_params`: equal to
  torchbeast_tpu.precision's (bf16 values compared exactly, widened to
  f32: numpy has no bf16, so the JAX side's ml_dtypes arrays are widened
  before they reach the port, which is exact).
- The fused tail in bf16 (--opt_impl pallas, bf16_train): the port's
  plain version against `fused_rmsprop_tail(param_dtype="bf16",
  state_dtype=bfloat16)` with its Pallas kernel interpreted, on an
  LSTM-sized and an MLP-sized tree, clip active and inactive, and with
  momentum, 3 updates at a decaying LR. The f32 master within rtol 1e-6
  and MASTER_ATOL; the resident params and nu within 1 bf16 ulp; the
  port's resident params bf16(master) bit for bit.
- The xla chain (--opt_impl xla) at bf16_train against the JAX
  make_optimizer's (_bf16_resident_params over _clip_by_global_norm_f32
  and _scale_by_rms_torch), at the same tolerances.
- The LR/momentum order of each branch of the reference's _rmsprop_torch:
  momentum 0.9 and a decaying LR, f32 and bf16 state, rtol 1e-6.
- --factored_opt_state against _scale_by_factored_rms_torch, on a tree
  of JAX leaves (identity layouts) and on the deep and transformer
  models through weights.jax_layouts (required: without it the port
  raises); --opt_impl pallas with it raises ValueError in both packages.

MASTER_ATOL: both versions compute the same f32 operations, but where
the two f32 values of nu straddle a bf16 rounding boundary the stored nu
differs by one bf16 ulp, the next step's update by up to 2**-8 of itself,
and the master by about lr * 2**-8 (1.9e-6 at lr 4.8e-4). F32_ATOL: f32
params whose three steps nearly cancel, a few f32 ulps of a step (about
4e-3 here; XLA may contract p + u into one multiply-add).
"""

import functools
import logging

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu import precision as jax_precision
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.ops.pallas_opt import fused_rmsprop_tail
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import precision, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.ops import opt as port_opt
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

LR, DECAY, EPS, HORIZON = 4.8e-4, 0.99, 0.01, 10
BF16_ULP = 2.0 ** -7
MASTER_RTOL, MASTER_ATOL = 1e-6, 4e-6
F32_ATOL = 1e-8


def _f32(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------- policy


@pytest.mark.parametrize("name", precision.CHOICES)
def test_policy_table_matches_jax(name):
    ours, theirs = precision.get(name), jax_precision.get(name)
    assert ours.name == theirs.name
    for a, b in ((ours.compute_dtype, theirs.compute_dtype),
                 (ours.head_dtype, theirs.head_dtype)):
        assert str(a).replace("torch.", "") == jnp.dtype(b).name
    assert ours.param_dtype == theirs.param_dtype
    assert ours.opt_state_dtype == theirs.opt_state_dtype
    assert (ours.batch_dtype is None) == (theirs.batch_dtype is None)
    if ours.batch_dtype is not None:
        assert str(ours.batch_dtype) == "torch." + np.dtype(
            theirs.batch_dtype).name
    with pytest.raises(ValueError, match="Unknown precision"):
        precision.get("fp8")


class _Flags:
    def __init__(self, precision=None, model_dtype=None):
        self.precision, self.model_dtype = precision, model_dtype


@pytest.mark.parametrize("prec,legacy", [
    ("f32", None), ("bf16_compute", None), ("bf16_train", None),
    (None, None), ("f32", "float32"), ("f32", "bfloat16"),
    ("bf16_compute", "bfloat16"), ("bf16_train", "bfloat16"),
    ("bf16_train", "float32"),
])
def test_resolve_flags_matches_jax(prec, legacy, caplog):
    flags = _Flags(prec, legacy)
    try:
        want = jax_precision.resolve_flags(flags).name
    except ValueError as e:
        with pytest.raises(ValueError, match="conflicts"):
            precision.resolve_flags(flags)
        assert "conflicts" in str(e)
        return
    precision.resolve_flags.__dict__.pop("_warned_model_dtype", None)
    with caplog.at_level(logging.WARNING):
        assert precision.resolve_flags(flags).name == want
        precision.resolve_flags(flags)  # warned once per process
    warned = [r for r in caplog.records if r.name == precision.log.name
              and "deprecated" in r.getMessage()]
    assert len(warned) == (1 if legacy == "bfloat16" else 0)


def _batch_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 256, (3, 2, 4, 4, 1), dtype=np.uint8),
        "reward": (3 * rng.standard_normal((3, 2))).astype(np.float32),
        "done": rng.random((3, 2)) < 0.5,
        "episode_step": rng.integers(0, 9, (3, 2)).astype(np.int32),
        "policy_logits": rng.standard_normal((3, 2, 5)).astype(np.float32),
        "state": ((rng.standard_normal((1, 2, 8)) * 1e3).astype(np.float32),
                  rng.standard_normal((1, 2, 8)).astype(np.float64)),
    }


@pytest.mark.parametrize("name", precision.CHOICES)
def test_cast_batch_matches_jax(name):
    tree = _batch_tree()
    want = jax_precision.cast_batch(tree, jax_precision.get(name).batch_dtype)
    got = precision.cast_batch(jax.tree_util.tree_map(torch.from_numpy, tree),
                               precision.get(name).batch_dtype)
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: torch.is_tensor(x))
    assert len(flat_w) == len(flat_g)
    for g, w in zip(flat_g, flat_w):
        assert str(g.dtype) == "torch." + np.dtype(w.dtype).name
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        np.testing.assert_array_equal(g, _f32(w)
                                      if w.dtype.name == "bfloat16" else w)


@pytest.mark.parametrize("name", precision.CHOICES)
def test_cast_params_matches_jax(name):
    model = jax_create_model("deep", num_actions=6, use_lstm=True)
    rng = np.random.default_rng(0)
    state = tuple(rng.standard_normal(np.shape(s)).astype(np.float32)
                  for s in model.initial_state(1))
    frame = {"frame": np.zeros((1, 1, 84, 84, 4), np.uint8),
             "reward": np.zeros((1, 1), np.float32),
             "done": np.zeros((1, 1), bool),
             "last_action": np.zeros((1, 1), np.int32)}
    params = model.init({"params": jax.random.PRNGKey(0),
                         "action": jax.random.PRNGKey(1)}, frame, state)
    want = jax_precision.cast_params(params, jax_precision.get(name))
    port = port_create_model("deep", 6, use_lstm=True)
    weights.load_jax_params(port, params)
    precision.cast_params(port, precision.get(name))
    resident = (torch.bfloat16 if name == "bf16_train" else torch.float32)
    assert {p.dtype for p in port.parameters()} == {resident}
    # channels_last kept for the conv weights (the pool kernel's layout).
    assert port.trunk.feat_conv_0.weight.is_contiguous(
        memory_format=torch.channels_last)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_array_equal(g, _f32(w)),
        weights.torch_to_jax(port.state_dict()), jax.device_get(want))


# ------------------------------------------------------- the fused tail

# Synthetic trees: the deep model's LSTM and heads, and a small MLP.
TREES = {
    "lstm": {"ih": (257, 1024), "hh": (256, 1024), "bias": (1024,),
             "policy": (256, 6), "policy_bias": (6,), "baseline": (256, 1)},
    "mlp": {"w1": (64, 128), "b1": (128,), "w2": (128, 6), "b2": (6,),
            "scale": (7, 9, 5)},
}
# (gradient scale, max_norm, momentum)
CASES = {"clip_active": (1.0, 40.0, 0.0), "clip_inactive": (1e-3, 40.0, 0.0),
         "momentum": (1.0, 40.0, 0.9)}


@functools.lru_cache(maxsize=None)
def _tree_data(tree, scale):
    """(bf16 params, 3 steps of bf16 grads) as JAX trees."""
    rng = np.random.default_rng(len(tree))
    shapes = TREES[tree]
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    params = {k: bf(0.1 * rng.standard_normal(s)) for k, s in shapes.items()}
    grads = [{k: bf(scale * rng.standard_normal(s))
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def _f32_tree_data(tree):
    """_tree_data's values as f32 params and f32 grads (the f32 policy:
    the stock optax clip sums the gradients in their own dtype)."""
    params, grads = _tree_data(tree, 1.0)
    f32 = lambda t: {k: v.astype(jnp.float32)  # noqa: E731
                     for k, v in t.items()}
    return f32(params), [f32(g) for g in grads]


def _port_list(tree):
    """A JAX tree of bf16 (or f32) arrays -> port tensors (copies), same
    dtype."""
    return [torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for _, v in sorted(tree.items())]


def _jax_run(opt, params, grads):
    update = jax.jit(opt.update)
    state = opt.init(params)
    for g in grads:
        updates, state = update(g, state, params)
        params = jax_learner.apply_updates(params, updates, state)
    return jax.device_get((params, state))


def _leaves(tree):
    return [_f32(v) for _, v in sorted(tree.items())]


def _assert_bf16_close(got, want):
    """Within 1 bf16 ulp (rtol 2**-7 of the value)."""
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-30)


def _check_resident_run(port_params, port_state, jax_params, jax_master,
                        jax_nu):
    for p, m, jp, jm in zip(port_params, port_state.master,
                            _leaves(jax_params), _leaves(jax_master)):
        np.testing.assert_allclose(m.numpy(), jm, rtol=MASTER_RTOL,
                                   atol=MASTER_ATOL)
        # bf16(master) of masters that agree to MASTER_ATOL.
        np.testing.assert_allclose(p.float().numpy(), jp, rtol=BF16_ULP,
                                   atol=MASTER_ATOL)
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, m.to(torch.bfloat16))
    for n, jn in zip(port_state.nu, _leaves(jax_nu)):
        assert n.dtype == torch.bfloat16
        _assert_bf16_close(n.float().numpy(), jn)


def _port_run(cls, params, grads, **kw):
    p = _port_list(params)
    opt = cls(p, port_opt.linear_schedule(LR, 0.0, HORIZON), decay=DECAY,
              eps=EPS, **kw)
    for g in grads:
        opt.step(_port_list(g))
    return opt


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_bf16_tail_matches_jax_fused_tail(tree, case):
    scale, max_norm, momentum = CASES[case]
    params, grads = _tree_data(tree, scale)
    schedule = optax.linear_schedule(LR, 0.0, HORIZON)
    want_params, state = _jax_run(
        fused_rmsprop_tail(schedule, DECAY, EPS, momentum=momentum,
                           max_norm=max_norm, param_dtype="bf16",
                           state_dtype=jnp.bfloat16, interpret=True),
        params, grads)
    opt = _port_run(port_opt.FusedRMSpropTail, params, grads,
                    momentum=momentum, max_norm=max_norm, param_dtype="bf16",
                    state_dtype="bf16")
    _check_resident_run(opt.params, opt.state, want_params, state.master,
                        state.nu)
    if momentum:
        # mom sums unscaled updates, each of which a one-ulp difference of
        # bf16 nu moves by up to 2**-8 of itself: within one bf16 ulp of
        # the leaf's largest entry.
        for m, jm in zip(opt.state.mom, _leaves(state.mom)):
            assert np.abs(m.numpy() - jm).max() <= BF16_ULP * np.abs(
                jm).max()


def _jax_hp(**kw):
    return jax_learner.HParams(learning_rate=LR, total_steps=HORIZON,
                               unroll_length=1, batch_size=1,
                               rmsprop_alpha=DECAY, rmsprop_eps=EPS, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_xla_chain_matches_jax_chain(case):
    scale, max_norm, momentum = CASES[case]
    params, grads = _tree_data("lstm", scale)
    hp = _jax_hp(grad_norm_clipping=max_norm, rmsprop_momentum=momentum,
                 param_dtype="bf16", opt_state_dtype="bf16")
    want_params, state = _jax_run(jax_learner.make_optimizer(hp), params,
                                  grads)
    assert isinstance(state, jax_learner.MasterParamsState)
    opt = _port_run(port_learner.RMSpropChain, params, grads,
                    momentum=momentum, max_norm=max_norm, param_dtype="bf16",
                    state_dtype="bf16")
    _check_resident_run(opt.params, opt.state, want_params, state.master,
                        optax.tree_utils.tree_get(state, "nu"))


@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_xla_chain_orders_lr_and_momentum_as_the_reference(state_dtype):
    """Momentum 0.9 with the LR decaying to 0 over 10 updates: f32 state
    is optax.rmsprop (LR, then the trace), bf16 state the composed chain
    (the trace, then the LR). Applying one order where the other belongs
    moves the params by about 0.5% of a step after 3 updates. Params:
    rtol 1e-6, atol F32_ATOL (f32 state), MASTER_ATOL (bf16 state)."""
    params, grads = _f32_tree_data("mlp")
    hp = _jax_hp(grad_norm_clipping=40.0, rmsprop_momentum=0.9,
                 opt_state_dtype=state_dtype)
    want_params, state = _jax_run(jax_learner.make_optimizer(hp), params,
                                  grads)
    opt = _port_run(port_learner.RMSpropChain, params, grads, momentum=0.9,
                    max_norm=40.0, state_dtype=state_dtype)
    atol = F32_ATOL if state_dtype == "f32" else MASTER_ATOL
    for p, w in zip(opt.params, _leaves(want_params)):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-6, atol=atol)
    nu = _leaves(optax.tree_utils.tree_get(state, "nu"))
    for n, w in zip(opt.state.nu, nu):
        if state_dtype == "bf16":
            _assert_bf16_close(n.float().numpy(), w)
        else:
            # nu = c^2 g^2 with c the clip scale, max_norm over an f32 norm
            # of 9,400 squares summed in another order in each package.
            np.testing.assert_allclose(n.numpy(), w, rtol=5e-6)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_factored_state_matches_jax_on_a_plain_tree(momentum):
    """A tree whose tensors are the JAX leaves themselves (identity views):
    vectors keep the full nu, matrices and the 3-D leaf row/col EMAs."""
    params, grads = _f32_tree_data("mlp")
    hp = _jax_hp(grad_norm_clipping=40.0, rmsprop_momentum=momentum,
                 opt_factored=True)
    want_params, _ = _jax_run(jax_learner.make_optimizer(hp), params, grads)
    identity = [(lambda t: [t], lambda vs: vs[0])] * len(params)
    opt = _port_run(port_learner.RMSpropChain, params, grads,
                    momentum=momentum, max_norm=40.0, factored=True,
                    layouts=identity)
    for p, w in zip(opt.params, _leaves(want_params)):
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-6, atol=F32_ATOL)


MODEL_CASES = {
    "deep": dict(name="deep", use_lstm=True, frame=(84, 84, 4), size={}),
    "transformer": dict(name="transformer", use_lstm=False, frame=(8, 8, 1),
                        size=dict(d_model=32, num_heads=4, memory_len=4)),
}


@pytest.mark.parametrize("model_name", sorted(MODEL_CASES))
def test_factored_state_follows_the_jax_leaves_of_a_model(model_name):
    """The deep model (HWIO convs, the LSTM's per-gate kernels) and the
    transformer (3-D DenseGeneral kernels, [H, hd] biases): the port
    factors each JAX leaf over its own last two axes, through
    weights.jax_layouts. Two updates, bf16_train storage."""
    case = MODEL_CASES[model_name]
    A = 6
    jmodel = jax_create_model(case["name"], num_actions=A,
                              use_lstm=case["use_lstm"], **case["size"])
    inputs = {"frame": np.zeros((1, 1) + case["frame"], np.uint8),
              "reward": np.zeros((1, 1), np.float32),
              "done": np.zeros((1, 1), bool),
              "last_action": np.zeros((1, 1), np.int32)}
    params = jmodel.init({"params": jax.random.PRNGKey(0),
                          "action": jax.random.PRNGKey(1)}, inputs,
                         jmodel.initial_state(1))
    params = jax_precision.cast_params(params, jax_precision.get(
        "bf16_train"))
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.bfloat16),
        params) for _ in range(2)]
    hp = _jax_hp(grad_norm_clipping=40.0, param_dtype="bf16",
                 opt_state_dtype="bf16", opt_factored=True)
    want_params, state = _jax_run(jax_learner.make_optimizer(hp), params,
                                  grads)
    port = port_create_model(case["name"], A, use_lstm=case["use_lstm"],
                             frame_shape=case["frame"], **case["size"])
    weights.load_jax_params(port, jax.device_get(params))
    precision.cast_params(port, precision.get("bf16_train"))
    opt = port_learner.make_optimizer(
        port_learner.HParams(**{k: getattr(hp, k) for k in (
            "learning_rate", "total_steps", "unroll_length", "batch_size",
            "rmsprop_alpha", "rmsprop_eps", "grad_norm_clipping",
            "param_dtype", "opt_state_dtype", "opt_factored")}),
        list(port.parameters()), layouts=weights.jax_layouts(port))
    for g in grads:
        g = weights.param_list_from_jax(port, jax.device_get(g))
        opt.step(g)
    got_master = weights.param_list_to_jax(port, opt.state.master)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, _f32(w), rtol=1e-6,
                                                atol=MASTER_ATOL),
        got_master, jax.device_get(state.master))


def test_pallas_with_factored_state_raises_in_both_packages():
    with pytest.raises(ValueError, match="factored"):
        jax_learner.make_optimizer(_jax_hp(opt_impl="pallas",
                                           opt_factored=True))
    with pytest.raises(ValueError, match="factored"):
        port_learner.make_optimizer(
            port_learner.HParams(opt_impl="pallas", opt_factored=True),
            [torch.zeros(2, requires_grad=True)])
