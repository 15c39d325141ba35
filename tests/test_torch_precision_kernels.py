"""The bf16 plain versions of the port's pool backward and attention
(torchbeast_tpu_torch/ops/pool.py, ops/attention.py) against the JAX
package's Pallas kernels in bf16, run in interpret mode, on the CPU.

- Pool backward: `pool_bwd_plain` in bf16 against
  `pallas_pool.pool_bwd(..., interpret=True)` in bf16, ties planted:
  exact. Both add the taps in (kh, kw) order into zeros and round to bf16
  after every add; a sum of two bf16 values rounded once is the same
  wherever it is computed.
- Attention forward: `transformer_attention_plain` in bf16 against the
  JAX Pallas forward in bf16 (both widen q, k, v and rel_bias, compute
  in f32, narrow the output): within 1 bf16 ulp.
- Attention gradients: autograd of the plain version (f32 inside,
  gradients narrowed once) against the JAX VJP, which recomputes through
  `_reference` in bf16 (its q.k einsum, its softmax weights and its
  P.V product rounded to bf16): max |difference| <= GRAD_TOL * max
  |gradient| per input (measured: at most 7.9e-3), inside the
  reference's own bf16-vs-f32 tolerance (tests/test_precision.py, rtol
  3e-2 to 5e-2). The forwards agree bit for bit at these shapes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu.ops.pallas_attention import (
    transformer_attention as jax_transformer_attention,
)
from torchbeast_tpu.ops.pallas_pool import pool_bwd as jax_pallas_pool_bwd
from torchbeast_tpu_torch.ops import attention
from torchbeast_tpu_torch.ops import pool as port_pool
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

BF16_ULP = 2.0 ** -7
GRAD_TOL = 2e-2  # measured: at most 7.9e-3 of the largest gradient


def _bf16_jax(a):
    return jnp.asarray(a, jnp.bfloat16)


def _bf16_torch(a):
    """A bf16 JAX array (or f32 numpy) -> a bf16 tensor, via an exact f32
    widening (numpy has no bf16)."""
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _f32(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


# ------------------------------------------------------------------ pool

SHAPES = [(2, 84, 84, 16), (2, 42, 42, 32), (3, 21, 21, 32), (2, 11, 13, 8)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_pool_backward_matches_jax_pallas(shape, ties):
    rng = np.random.default_rng(sum(shape))
    N, H, W, C = shape
    if ties:  # a coarse grid: most windows hold several copies of the max
        x = rng.integers(0, 4, shape).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    Ho, Wo = port_pool.pooled_size(H), port_pool.pooled_size(W)
    g = rng.standard_normal((N, Ho, Wo, C)).astype(np.float32)
    xj, gj = _bf16_jax(x), _bf16_jax(g)
    yj = jax.lax.reduce_window(xj, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                               (1, 2, 2, 1), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = jax_pallas_pool_bwd(xj, yj, gj, interpret=True)
    assert want.dtype == jnp.bfloat16

    nchw = lambda a: _bf16_torch(a).permute(0, 3, 1, 2)  # noqa: E731
    xt, yt, gt = nchw(xj), nchw(yj), nchw(gj)
    torch.testing.assert_close(
        yt, torch.nn.functional.max_pool2d(xt, 3, 2, 1), rtol=0, atol=0)
    got = port_pool.pool_bwd(xt, yt, gt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got.permute(0, 2, 3, 1)), _f32(want))


def test_bf16_pool_backward_goes_through_autograd():
    """The trunk's bf16 max_pool2d takes the wrapper on its backward."""
    rng = np.random.default_rng(3)
    x = _bf16_torch(rng.integers(0, 4, (2, 9, 9, 8)).astype(np.float32))
    x = x.permute(0, 3, 1, 2).requires_grad_()
    y = port_pool.max_pool2d(x)
    g = _bf16_torch(rng.standard_normal(tuple(y.shape)).astype(np.float32))
    (gx,) = torch.autograd.grad(y, x, g)
    assert gx.dtype == torch.bfloat16
    torch.testing.assert_close(gx, port_pool.pool_bwd_plain(x.detach(), y, g),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="dtype"):
        port_pool.pool_bwd(x.detach(), y.float(), g)


# ------------------------------------------------------------- attention

B, H, D = 2, 4, 16
ATT_SHAPES = [(12, 8), (1, 8), (6, 3)]  # (T, M)


def _att_inputs(t, m, seed):
    rng = np.random.default_rng(seed)
    done = rng.random((t, B)) < 0.15
    done[min(2, t - 1), 0] = True
    seg = np.ascontiguousarray(np.cumsum(done, axis=0).T, dtype=np.int32)
    return (
        rng.standard_normal((B, t, H, D)).astype(np.float32),
        rng.standard_normal((B, m + t, H, D)).astype(np.float32),
        rng.standard_normal((B, m + t, H, D)).astype(np.float32),
        seg,
        (rng.random((B, m)) < 0.7).astype(np.float32),
        seg == 0,
        (0.1 * rng.standard_normal((H, m + 1))).astype(np.float32),
    )


def _jax_inputs(xs, bias_bf16):
    q, k, v, seg, valid, nodone, bias = xs
    return (_bf16_jax(q), _bf16_jax(k), _bf16_jax(v), jnp.asarray(seg),
            jnp.asarray(valid), jnp.asarray(nodone),
            _bf16_jax(bias) if bias_bf16 else jnp.asarray(bias))


def _port_inputs(jxs):
    q, k, v, seg, valid, nodone, bias = jxs
    return (_bf16_torch(q), _bf16_torch(k), _bf16_torch(v),
            torch.from_numpy(np.array(seg)),
            torch.from_numpy(np.array(valid)),
            torch.from_numpy(np.array(nodone)),
            _bf16_torch(bias) if bias.dtype == jnp.bfloat16
            else torch.from_numpy(np.array(bias)))


@functools.lru_cache(maxsize=None)
def _jax_run(t, m, bias_bf16):
    jxs = _jax_inputs(_att_inputs(t, m, seed=t + 7 * m), bias_bf16)
    cot = _bf16_jax(np.random.default_rng(t).standard_normal(
        (B, t, H, D)).astype(np.float32))
    out, vjp = jax.vjp(
        lambda q, k, v, b: jax_transformer_attention(
            m, True, q, k, v, jxs[3], jxs[4], jxs[5], b),
        jxs[0], jxs[1], jxs[2], jxs[6])
    return jxs, cot, out, vjp(cot)


@pytest.mark.parametrize("bias_bf16", [True, False])
@pytest.mark.parametrize("t,m", ATT_SHAPES)
def test_bf16_attention_forward_matches_jax_pallas(t, m, bias_bf16):
    jxs, _, want, _ = _jax_run(t, m, bias_bf16)
    assert want.dtype == jnp.bfloat16
    got = attention.transformer_attention(m, *_port_inputs(jxs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_ULP,
                               atol=1e-6)


@pytest.mark.parametrize("bias_bf16", [True, False])
@pytest.mark.parametrize("t,m", ATT_SHAPES)
def test_bf16_attention_gradients_match_jax_vjp(t, m, bias_bf16):
    jxs, cot, _, want = _jax_run(t, m, bias_bf16)
    xs = _port_inputs(jxs)
    leaves = [x.clone().requires_grad_() for x in (xs[0], xs[1], xs[2],
                                                   xs[6])]
    out = attention.transformer_attention(m, leaves[0], leaves[1], leaves[2],
                                          xs[3], xs[4], xs[5], leaves[3])
    got = torch.autograd.grad(out, leaves, _bf16_torch(cot))
    for label, g, w, leaf in zip(("dq", "dk", "dv", "drel_bias"), got, want,
                                 leaves):
        assert g.dtype == leaf.dtype, label
        w = _f32(w)
        err = np.abs(_f32(g) - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (label, err)


def test_wrapper_takes_bf16_and_refuses_mixed_dtypes():
    xs = _port_inputs(_jax_inputs(_att_inputs(6, 3, seed=1), True))
    q, k, v, seg, valid, nodone, bias = xs
    with pytest.raises(ValueError, match="k_all dtype"):
        attention.transformer_attention(3, q, k.float(), v, seg, valid,
                                        nodone, bias)
    with pytest.raises(ValueError, match="rel_bias dtype"):
        attention.transformer_attention(3, q.float(), k.float(), v.float(),
                                        seg, valid, nodone, bias)
    with pytest.raises(ValueError, match="q dtype"):
        attention.transformer_attention(3, q.half(), k.half(), v.half(),
                                        seg, valid, nodone, bias.half())
