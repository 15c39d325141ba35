"""The port's attention ops (torchbeast_tpu_torch/ops/attention.py) against
the JAX package on the CPU.

The same numpy inputs (B=2, H=4, D=16, planted dones, a partly valid
cache) go through the JAX Pallas kernel in interpret mode, its jnp oracle
`_reference`, and the port's plain version and kernel wrapper (which
takes the plain version on CPU tensors). Forward: rtol 1e-4, atol 1e-5.
Gradients of q, k_all, v_all and rel_bias: rtol 2e-3, atol 2e-4, the
reference's own tolerance between its kernel and its oracle. The dense
helpers agree exactly on their integer and bool outputs and within
atol 1e-6 on floats.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu.ops import attention as jax_attention
from torchbeast_tpu.ops.pallas_attention import (
    _reference,
    transformer_attention as jax_transformer_attention,
)
from torchbeast_tpu_torch.ops import attention
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

B, H, D = 2, 4, 16
SHAPES = [(12, 8), (1, 8), (6, 3)]  # (T, M)


def op_inputs(t, m, seed):
    """numpy (q, k_all, v_all, seg, cache_valid, no_done, rel_bias)."""
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


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@functools.lru_cache(maxsize=None)
def _jax_forward(t, m):
    xs = [jnp.asarray(a) for a in op_inputs(t, m, seed=t + m)]
    kernel = jax_transformer_attention(m, True, *xs)
    return np.asarray(kernel), np.asarray(_reference(*xs, m))


@pytest.mark.parametrize("fn", ["plain", "wrapper"])
@pytest.mark.parametrize("t,m", SHAPES)
def test_forward_matches_jax(t, m, fn):
    kernel, ref = _jax_forward(t, m)
    q, k, v, seg, valid, nodone, bias = _torch(op_inputs(t, m, seed=t + m))
    f = (attention.transformer_attention_plain if fn == "plain"
         else attention.transformer_attention)
    got = f(m, q, k, v, seg, valid, nodone, bias).numpy()
    for want in (kernel, ref):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t,m", SHAPES)
def test_gradients_match_jax(t, m):
    arrays = op_inputs(t, m, seed=100 + t)
    q, k, v, seg, valid, nodone, bias = [jnp.asarray(a) for a in arrays]

    def loss(q, k, v, bias):
        out = jax_transformer_attention(m, True, q, k, v, seg, valid,
                                        nodone, bias)
        return jnp.sum(out ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, bias)
    tq, tk, tv, tseg, tvalid, tnodone, tbias = _torch(arrays)
    leaves = [x.requires_grad_() for x in (tq, tk, tv, tbias)]
    out = attention.transformer_attention(m, tq, tk, tv, tseg, tvalid,
                                          tnodone, tbias)
    got = torch.autograd.grad(torch.sum(out ** 2), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-4)


def test_shape_guard_rejects_long_context():
    xs = _torch(op_inputs(4096, 8, seed=3))
    with pytest.raises(ValueError, match="score tile"):
        attention.transformer_attention(8, *xs)


def test_wrapper_checks_its_inputs():
    q, k, v, seg, valid, nodone, bias = _torch(op_inputs(6, 3, seed=4))
    with pytest.raises(ValueError, match="seg dtype"):
        attention.transformer_attention(3, q, k, v, seg.long(), valid,
                                        nodone, bias)
    with pytest.raises(ValueError, match="rel_bias"):
        attention.transformer_attention(3, q, k, v, seg, valid, nodone,
                                        bias[:, :-1])
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        attention.transformer_attention(
            3, *(x.to("meta") for x in (q, k, v, seg, valid, nodone, bias)))


def test_cpu_tensors_take_the_plain_version_uncounted():
    xs = _torch(op_inputs(6, 3, seed=5))
    before = (attention.transformer_attention.launches,
              attention.transformer_attention_bwd.launches)
    leaves = [x.requires_grad_() for x in (xs[0], xs[1], xs[2], xs[6])]
    out = attention.transformer_attention(3, *xs)
    torch.autograd.grad(out.sum(), leaves)
    assert (attention.transformer_attention.launches,
            attention.transformer_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.transformer_attention_bwd(3, *xs, out, out, out)


def test_backward_tickets_are_zeroed_once_and_grow_with_heads():
    """The backward kernel's per-head ticket counters: zeros, one tensor
    per device reused while it holds H counters, a larger one after."""
    cpu = torch.device("cpu")
    attention._tickets.pop(cpu, None)
    first = attention._bwd_tickets(cpu, 4)
    assert first.dtype == torch.int32 and first.tolist() == [0] * 4
    assert attention._bwd_tickets(cpu, 2) is first
    grown = attention._bwd_tickets(cpu, 6)
    assert grown.numel() == 6 and not grown.any()
    assert attention._bwd_tickets(cpu, 4) is grown
    attention._tickets.pop(cpu)


@pytest.mark.parametrize("t", [1, 7])
def test_segment_ids_from_done(t):
    done = np.random.default_rng(t).random((t, 3)) < 0.4
    want = np.asarray(jax_attention.segment_ids_from_done(jnp.asarray(done)))
    got = attention.segment_ids_from_done(torch.from_numpy(done))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t,m", SHAPES)
def test_band_relative_offsets(t, m):
    want_band, want_off = jax_attention.band_relative_offsets(t, m)
    band, off = attention.band_relative_offsets(t, m)
    np.testing.assert_array_equal(band.numpy(), np.asarray(want_band))
    np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))


def test_roll_kv_cache():
    rng = np.random.default_rng(6)
    t, m = 5, 3
    k_cache, v_cache = (rng.standard_normal((B, m, H, D)).astype(np.float32)
                        for _ in range(2))
    valid = (rng.random((B, m)) < 0.6).astype(np.float32)
    k_new, v_new = (rng.standard_normal((B, t, H, D)).astype(np.float32)
                    for _ in range(2))
    done = np.zeros((t, B), bool)
    done[3, 1] = True
    seg = np.ascontiguousarray(np.cumsum(done, 0).T, dtype=np.int32)
    arrays = (k_cache, v_cache, valid, k_new, v_new, seg, seg == 0)
    want = jax_attention.roll_kv_cache(*(jnp.asarray(a) for a in arrays))
    got = attention.roll_kv_cache(*_torch(arrays))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dense_transformer_attend():
    t, m = 6, 3
    q, k, v, seg, valid, nodone, bias = op_inputs(t, m, seed=7)
    rng = np.random.default_rng(8)
    mask = rng.random((B, t, m + t)) < 0.6
    mask[:, np.arange(t), m + np.arange(t)] = True  # every row sees itself
    _, offsets = jax_attention.band_relative_offsets(t, m)
    offsets = np.asarray(offsets)
    want = jax_attention.dense_transformer_attend(
        *(jnp.asarray(a) for a in (q, k, v, mask, offsets, bias)))
    got = attention.dense_transformer_attend(
        *_torch((q, k, v, mask, offsets.astype(np.int64), bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
