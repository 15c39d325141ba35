"""The port's optimizer tail (torchbeast_tpu_torch/ops/opt.py, learner.py)
against the JAX package on the CPU, over the deep ResNet + LSTM parameter
tree (48 flax leaves, 1.62 M parameters).

The same numpy gradients go through 3 updates of the JAX fused tail
(ops/pallas_opt.fused_rmsprop_tail, its Pallas kernel interpreted), of the
JAX optax chain (--opt_impl xla), of the port's fused tail (on CPU tensors
its plain version) and of the port's torch form of the optax chain, with
gradient clipping active, inactive and off. Momentum is held against the
optax chain and torch.optim.RMSprop. Tolerance: rtol 1e-6 on params and
RMSprop state (one f32 rounding per op; the clip scale may differ by one
ulp between the two norm summation orders), and atol 1e-8 for entries
that cancel to near zero: a few f32 ulps of one step lr * update (about
4e-3 here, where XLA may contract p - lr * update into one multiply-add).
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu.ops.pallas_opt import fused_rmsprop_tail
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import weights
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.ops import opt as port_opt
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

RTOL, ATOL = 1e-6, 1e-8
LR, DECAY, EPS, HORIZON = 4.8e-4, 0.99, 0.01, 10


@functools.lru_cache(maxsize=1)
def _tree():
    """(names, params as a JAX tree, 3 steps of JAX-tree gradients)."""
    torch.manual_seed(0)
    model = create_model("deep", 6, use_lstm=True)
    state = {k: v for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    grads = []
    for _ in range(3):
        g = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                 .astype(np.float32))
             for k, v in state.items()}
        grads.append(weights.torch_to_jax(g))
    return list(state), weights.torch_to_jax(state), grads


def _to_port(names, tree):
    d = weights.jax_to_torch(tree)
    return [d[n] for n in names]


def _to_jax(names, tensors):
    return weights.torch_to_jax(dict(zip(names, tensors)))


def _scaled(tree, s):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(s),
                                  tree)


def _run_jax(opt, params, grads):
    update = jax.jit(opt.update)
    state = opt.init(params)
    for g in grads:
        updates, state = update(g, state, params)
        params = jax_learner.apply_updates(params, updates, state)
    nu = optax.tree_utils.tree_get(state, "nu")
    return jax.device_get(params), jax.device_get(nu)


def _run_port(cls, names, params, grads, **kw):
    p = _to_port(names, params)
    opt = cls(p, port_opt.linear_schedule(LR, 0.0, HORIZON), decay=DECAY,
              eps=EPS, **kw)
    for g in grads:
        opt.step(_to_port(names, g))
    assert opt.state.count == len(grads)
    return _to_jax(names, opt.params), _to_jax(names, opt.state.nu)


def _assert_trees_close(got, want):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), RTOL, ATOL),
        got, want,
    )


# (gradient scale, max_norm): |g| ~ 1.27e3 for unit gradients.
CLIP_CASES = {
    "clip_active": (1.0, 40.0),
    "clip_inactive": (1e-3, 40.0),
    "clip_off": (1.0, None),
}


@functools.lru_cache(maxsize=None)
def _jax_results(case):
    """(scaled grads, JAX fused tail result, JAX optax chain result or
    None) for one clip case, shared by both port impls."""
    scale, max_norm = CLIP_CASES[case]
    _, params, grads = _tree()
    grads = [_scaled(g, scale) for g in grads]
    schedule = optax.linear_schedule(LR, 0.0, HORIZON)
    fused = _run_jax(
        fused_rmsprop_tail(schedule, DECAY, EPS, max_norm=max_norm,
                           interpret=True),
        params, grads,
    )
    chain = None
    if max_norm is not None:
        hp = jax_learner.HParams(
            learning_rate=LR, total_steps=HORIZON, unroll_length=1,
            batch_size=1, grad_norm_clipping=max_norm,
        )
        chain = _run_jax(jax_learner.make_optimizer(hp), params, grads)
    return grads, fused, chain


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
@pytest.mark.parametrize("port_impl", ["pallas", "xla"])
def test_tail_matches_jax_fused_tail_and_optax_chain(port_impl, case):
    names, params, _ = _tree()
    grads, want_fused, want_chain = _jax_results(case)
    cls = (port_opt.FusedRMSpropTail if port_impl == "pallas"
           else port_learner.RMSpropChain)
    got = _run_port(cls, names, params, grads,
                    max_norm=CLIP_CASES[case][1])
    _assert_trees_close(got, want_fused)
    if want_chain is not None:
        _assert_trees_close(got, want_chain)


@pytest.mark.parametrize("port_impl", ["pallas", "xla"])
def test_momentum_matches_optax_chain(port_impl):
    """The port keeps torch's order, momentum trace then LR (as the JAX
    Pallas tail does). optax.rmsprop, which the reference's xla chain
    uses on optax >= 0.2.4, applies the LR before the trace, so the two
    agree only while the LR holds still: the horizon here is 1e9 updates,
    which keeps the LR constant to 1e-8 over the 3 steps."""
    names, params, grads = _tree()
    horizon = 10 ** 9
    hp = jax_learner.HParams(
        learning_rate=LR, total_steps=horizon, unroll_length=1,
        batch_size=1, rmsprop_momentum=0.9,
    )
    want = _run_jax(jax_learner.make_optimizer(hp), params, grads)
    cls = (port_opt.FusedRMSpropTail if port_impl == "pallas"
           else port_learner.RMSpropChain)
    opt = cls(_to_port(names, params), port_opt.linear_schedule(
        LR, 0.0, horizon), decay=DECAY, eps=EPS, momentum=0.9, max_norm=40.0)
    for g in grads:
        opt.step(_to_port(names, g))
    _assert_trees_close(
        (_to_jax(names, opt.params), _to_jax(names, opt.state.nu)), want)


def test_momentum_matches_torch_rmsprop():
    """No clip and a constant LR: the fused tail IS torch.optim.RMSprop."""
    names, params, grads = _tree()
    ours = _to_port(names, params)
    theirs = [p.clone().requires_grad_(True) for p in ours]
    tail = port_opt.FusedRMSpropTail(ours, lambda count: LR, decay=DECAY,
                                     eps=EPS, momentum=0.9)
    rms = torch.optim.RMSprop(theirs, lr=LR, alpha=DECAY, eps=EPS,
                              momentum=0.9)
    for g in grads:
        gs = _to_port(names, g)
        tail.step(gs)
        for p, gi in zip(theirs, gs):
            p.grad = gi.clone()
        rms.step()
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), RTOL,
                                   ATOL)


@pytest.mark.parametrize("port_impl", ["pallas", "xla"])
def test_step_returns_squared_global_norm(port_impl):
    """The learner's grad_norm stat is the root of what step returns: the
    squared global norm of the gradients before clipping."""
    names, params, grads = _tree()
    cls = (port_opt.FusedRMSpropTail if port_impl == "pallas"
           else port_learner.RMSpropChain)
    opt = cls(_to_port(names, params), lambda count: LR, decay=DECAY,
              eps=EPS, max_norm=40.0)
    g = _to_port(names, grads[0])
    want = sum(float(np.square(t.numpy().astype(np.float64)).sum())
               for t in g)
    got = opt.step(g)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


@pytest.mark.parametrize("count", [0, 1, 3, 9, 10, 25])
def test_linear_schedule_matches_optax(count):
    ours = port_opt.linear_schedule(LR, 0.0, HORIZON)(count)
    theirs = optax.linear_schedule(LR, 0.0, HORIZON)(jnp.int32(count))
    assert np.float32(ours) == np.asarray(theirs)


def test_cpu_tail_launches_no_kernel_and_checks_inputs():
    p = [torch.zeros(3, 2), torch.zeros(4)]
    g = [torch.ones(3, 2), torch.ones(4)]
    nu = [torch.zeros(3, 2), torch.zeros(4)]
    before = port_opt.rmsprop_tail.launches
    sumsq = port_opt.rmsprop_tail(p, g, nu, None, lr=0.1, alpha=0.9,
                                  eps=0.01)
    assert port_opt.rmsprop_tail.launches == before
    assert sumsq.dtype == torch.float32 and float(sumsq) == 10.0
    assert float(p[0][0, 0]) < 0
    with pytest.raises(ValueError, match="shape"):
        port_opt.rmsprop_tail(p, [torch.ones(2, 3), g[1]], nu, None, lr=0.1,
                              alpha=0.9, eps=0.01)
    with pytest.raises(ValueError, match="dtype"):
        port_opt.rmsprop_tail(p, [g[0].double(), g[1]], nu, None, lr=0.1,
                              alpha=0.9, eps=0.01)
    with pytest.raises(ValueError, match="mom"):
        port_opt.rmsprop_tail(p, g, nu, None, lr=0.1, alpha=0.9, eps=0.01,
                              momentum=0.5)
    # bf16-resident params build with an f32 master beside them, and the
    # tail refuses bf16 params without one.
    pb = [t.to(torch.bfloat16) for t in p]
    tail = port_opt.FusedRMSpropTail(pb, lambda c: 0.1, 0.9, 0.01,
                                     param_dtype="bf16", state_dtype="bf16")
    assert [m.dtype for m in tail.state.master] == [torch.float32] * 2
    assert all(torch.equal(m, q.float())
               for m, q in zip(tail.state.master, pb))
    assert [n.dtype for n in tail.state.nu] == [torch.bfloat16] * 2
    with pytest.raises(ValueError, match="master"):
        port_opt.rmsprop_tail(pb, [t.to(torch.bfloat16) for t in g], nu,
                              None, lr=0.1, alpha=0.9, eps=0.01)
    # bf16 params with f32 nu: no policy pairs them, and the kernel has no
    # instance for them.
    with pytest.raises(ValueError, match="bf16 nu"):
        port_opt.rmsprop_tail(pb, [t.to(torch.bfloat16) for t in g], nu,
                              None, lr=0.1, alpha=0.9, eps=0.01,
                              masters=[t.float() for t in pb])
