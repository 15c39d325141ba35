"""The port's max-pool and its all-ties backward (torchbeast_tpu_torch/
ops/pool.py) against the JAX package on the CPU.

The same numpy inputs go through the JAX forward (reduce_window), its CPU
tap-sum VJP, the Pallas backward kernel in interpret mode
(ops/pallas_pool.pool_bwd(interpret=True)), and the port's forward and
backward (on a CPU tensor: the kernel's plain version, the tap-sum). The
inputs include planted ties. Tolerance: exact for the forward; atol 1e-6
for the backward (every tie is credited by all three, and the taps are
added in the same order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu.ops import pool as jax_pool
from torchbeast_tpu.ops.pallas_pool import pool_bwd as jax_pallas_pool_bwd
from torchbeast_tpu_torch.ops import pool as port_pool
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

# Trunk stage shapes (H, W, C) at small N, plus odd and non-square grids.
SHAPES = [(2, 84, 84, 16), (2, 42, 42, 32), (3, 21, 21, 32), (2, 11, 13, 8)]


def _inputs(shape, ties, seed=0):
    rng = np.random.default_rng(seed)
    if ties:  # a coarse grid: most windows hold several copies of the max
        x = rng.integers(0, 4, shape).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    N, H, W, C = shape
    Ho, Wo = port_pool.pooled_size(H), port_pool.pooled_size(W)
    g = rng.standard_normal((N, Ho, Wo, C)).astype(np.float32)
    return x, g


def _nchw(a):
    """NHWC numpy -> NCHW tensor in channels_last memory (same bytes)."""
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_all_ties_backward_match_jax(shape, ties):
    x, g = _inputs(shape, ties)
    y_jax, vjp = jax.vjp(jax_pool.max_pool2d, jnp.asarray(x))
    (gx_tapsum,) = vjp(jnp.asarray(g))
    gx_pallas = jax_pallas_pool_bwd(jnp.asarray(x), y_jax, jnp.asarray(g),
                                    interpret=True)

    xt = _nchw(x).requires_grad_(True)
    y = port_pool.max_pool2d(xt)
    y.backward(_nchw(g))
    np.testing.assert_array_equal(_nhwc(y), np.asarray(y_jax))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_tapsum),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_pallas),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("layout", ["channels_last", "nchw", "offset"])
def test_backward_matches_jax_in_any_layout(layout):
    """The pool's autograd function hands x, y and g to the backward in
    the layout they come in (the kernel reads strides; no copy), so NCHW
    memory and a view into its storage give the channels_last result."""
    x, g = _inputs((2, 21, 19, 3), ties=True, seed=5)
    _, vjp = jax.vjp(jax_pool.max_pool2d, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt, gt = _nchw(x), _nchw(g)
    if layout == "nchw":
        xt, gt = xt.contiguous(), gt.contiguous()
    elif layout == "offset":
        buf = torch.zeros(1 + xt.numel())
        buf[1:] = xt.contiguous().flatten()
        xt = buf[1:].view(xt.shape)
    xt.requires_grad_(True)
    port_pool.max_pool2d(xt).backward(gt)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_ties_are_all_credited():
    # One 3x3 window of equal values: every one of its positions that no
    # other window reaches gets the full cotangent.
    x = torch.zeros(1, 1, 3, 3).requires_grad_(True)
    y = port_pool.max_pool2d(x)
    assert y.shape == (1, 1, 2, 2)
    y.backward(torch.ones_like(y))
    # (h, w) is covered by 1, 2 or 4 windows, all tied at 0.
    want = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]])
    torch.testing.assert_close(x.grad[0, 0], want)


def test_plain_backward_equals_wrapper_on_cpu():
    x, g = _inputs((2, 21, 21, 4), ties=True, seed=3)
    xt, gt = _nchw(x), _nchw(g)
    y = torch.nn.functional.max_pool2d(xt, 3, 2, 1)
    before = port_pool.pool_bwd.launches
    torch.testing.assert_close(port_pool.pool_bwd(xt, y, gt),
                               port_pool.pool_bwd_plain(xt, y, gt))
    assert port_pool.pool_bwd.launches == before  # no kernel on the CPU


def test_wrapper_checks_inputs():
    x = torch.zeros(2, 4, 10, 10)
    y = torch.zeros(2, 4, 5, 5)
    with pytest.raises(ValueError, match="must be"):
        port_pool.pool_bwd(x, torch.zeros(2, 4, 4, 4), y)
    with pytest.raises(ValueError, match="dtype"):
        port_pool.pool_bwd(x.double(), y, y)
    with pytest.raises(ValueError, match="4-D"):
        port_pool.pool_bwd(torch.zeros(4, 10, 10), y, y)
