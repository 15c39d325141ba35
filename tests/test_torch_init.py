"""Fresh weights of the port's models (torchbeast_tpu_torch/models/init.py)
against flax's default initialisers, which the JAX package's models keep.

Each family is built at a small width in both packages from fixed seeds:
the shallow AtariNet with its 2-layer LSTM (36x36x4 frames, so the fc
sees a 1x1x64 map; the LSTM's width, 512 + A + 1, is fixed), the deep
ResNet with its LSTM (trunk 4/8/8, LSTM 16, 16x16x4 frames) and the
transformer (2 layers, d_model 32, 4 heads, memory 4, 8x8x1 frames). The
port's state dict is carried to the JAX layout by weights.py, so every
leaf of either package is read the same way and held to the same
analytic init:

- a kernel's std within 4 standard errors (sqrt(1 / (2 n)) relative, for
  n entries) of sqrt(1 / fan_in), and every |w| at most
  2 sqrt(1 / fan_in) / 0.8796 (lecun_normal: truncated at 2 std), with
  fan_in over the JAX leaf's input axes (a DenseGeneral q/k/v kernel
  [d, H, hd] has fan_in d; `out` [H, hd, d] has H * hd);
- each LSTM recurrent gate block W orthogonal, W W^T = I within 1e-5;
- every bias exactly 0, LayerNorm scales exactly 1, rel_bias exactly 0;
- the two packages' stds within 4 standard errors of each other.

The two packages draw from different generators (torch's global one,
jax.random's keys), so their weights can never be equal bit for bit:
only their distributions are compared. Two port builds from one seed are
equal bit for bit.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax

from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu_torch import weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.models import init
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 2, 2, 4
# name -> (model kwargs shared by both packages, use_lstm, frame shape)
FAMILIES = {
    "shallow": ({}, True, (36, 36, 4)),
    "deep": (dict(trunk_channels=(4, 8, 8), hidden_size=16), True,
             (16, 16, 4)),
    "transformer": (dict(num_layers=2, d_model=32, num_heads=4,
                         memory_len=4), False, (8, 8, 1)),
}
_LSTM_SCOPE = "Scan_StackedLSTMStep_0"
# A DenseGeneral kernel whose last two axes are outputs (H, hd).
_MULTI_OUT = ("q", "k", "v")
# An f32 cut-off may round above the exact one by half an ulp.
_F32_SLACK = 1 + 2.0 ** -23


def _inputs(frame):
    rng = np.random.default_rng(0)
    return {
        "frame": rng.integers(0, 256, (T, B) + frame, dtype=np.uint8),
        "reward": rng.standard_normal((T, B)).astype(np.float32),
        "done": np.zeros((T, B), bool),
        "last_action": rng.integers(0, A, (T, B)).astype(np.int32),
    }


@functools.lru_cache(maxsize=None)
def _jax_tree(name):
    kwargs, use_lstm, frame = FAMILIES[name]
    model = jax_create_model(name, num_actions=A, use_lstm=use_lstm,
                             **kwargs)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        _inputs(frame), model.initial_state(B),
    )
    return jax.device_get(params["params"])


def _port_model(name, seed=0):
    kwargs, use_lstm, frame = FAMILIES[name]
    torch.manual_seed(seed)
    return port_create_model(name, A, use_lstm, frame_shape=frame, **kwargs)


@functools.lru_cache(maxsize=None)
def _port_tree(name):
    return weights.torch_to_jax(_port_model(name).state_dict(), wrap=False)


def _leaves(tree, path=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v, np.float64)


def _kind(path, leaf):
    """(kind, fan_in) of a JAX leaf: "zeros", "ones", "orthogonal" or
    "lecun" with the fan_in of flax's rule."""
    if path[-1] in ("bias", "rel_bias"):
        return "zeros", None
    if path[-1] == "scale":
        return "ones", None
    assert path[-1] == "kernel", path
    if _LSTM_SCOPE in path and path[-2].startswith("h"):
        return "orthogonal", None
    n_out = 2 if path[-2] in _MULTI_OUT else 1
    return "lecun", math.prod(leaf.shape[:-n_out])


def _rel_std_error(n):
    return math.sqrt(1.0 / (2 * n))


def _check_leaf(path, leaf):
    kind, fan_in = _kind(path, leaf)
    where = "/".join(path)
    if kind == "zeros":
        assert not leaf.any(), f"{where}: not all 0"
    elif kind == "ones":
        assert (leaf == 1).all(), f"{where}: not all 1"
    elif kind == "orthogonal":
        assert leaf.shape[0] == leaf.shape[1], where
        np.testing.assert_allclose(leaf @ leaf.T, np.eye(leaf.shape[0]),
                                   rtol=0, atol=1e-5, err_msg=where)
    else:
        sigma = math.sqrt(1.0 / fan_in)
        std = math.sqrt(np.mean(leaf ** 2))
        assert abs(std / sigma - 1) <= 4 * _rel_std_error(leaf.size), (
            f"{where}: std {std:.5g} against {sigma:.5g} (fan_in {fan_in}, "
            f"{leaf.size} entries)")
        cut = 2 * sigma / init.TRUNCATED_STD * _F32_SLACK
        assert np.abs(leaf).max() <= cut, (
            f"{where}: |w| {np.abs(leaf).max():.5g} beyond the cut {cut:.5g}")
    return kind


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_fresh_leaves_follow_flax_init(name, package):
    tree = _port_tree(name) if package == "port" else _jax_tree(name)
    kinds = [_check_leaf(path, leaf) for path, leaf in _leaves(tree)]
    assert "lecun" in kinds and "zeros" in kinds
    assert ("orthogonal" in kinds) == FAMILIES[name][1]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_port_and_jax_draw_the_same_distribution(name):
    port = dict(_leaves(_port_tree(name)))
    ref = dict(_leaves(_jax_tree(name)))
    assert sorted(port) == sorted(ref)
    for path, leaf in ref.items():
        assert port[path].shape == leaf.shape, path
        if _kind(path, leaf)[0] != "lecun":
            continue
        s_port = math.sqrt(np.mean(port[path] ** 2))
        s_ref = math.sqrt(np.mean(leaf ** 2))
        # The difference of two independent estimates: sqrt(2) SEs.
        assert abs(s_port / s_ref - 1) <= (
            4 * math.sqrt(2) * _rel_std_error(leaf.size)), (
            f"{'/'.join(path)}: port std {s_port:.5g}, jax {s_ref:.5g}")


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_same_seed_gives_the_same_weights(name):
    a = _port_model(name, seed=3).state_dict()
    b = _port_model(name, seed=3).state_dict()
    c = _port_model(name, seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_lecun_normal_is_truncated_and_scaled():
    torch.manual_seed(0)
    fan_in = 50
    w = init.lecun_normal_(torch.empty(400, fan_in), fan_in)
    sigma = math.sqrt(1.0 / fan_in)
    std = float(w.double().square().mean().sqrt())
    assert abs(std / sigma - 1) <= 4 * _rel_std_error(w.numel())
    cut = 2 * sigma / init.TRUNCATED_STD
    assert float(w.abs().max()) <= cut * _F32_SLACK
    # A plain normal of that std would put 4.6% of entries beyond the cut;
    # the truncated one puts some within a hundredth of it.
    assert float(w.abs().max()) >= 0.99 * cut


def test_orthogonal_gates_makes_each_block_orthogonal():
    torch.manual_seed(0)
    H = 24
    w = init.orthogonal_gates_(torch.empty(4 * H, H))
    blocks = w.double().chunk(4, 0)
    for block in blocks:
        torch.testing.assert_close(block @ block.t(),
                                   torch.eye(H, dtype=torch.float64),
                                   rtol=0, atol=1e-5)
    # Four draws, not one block repeated.
    assert not torch.equal(blocks[0], blocks[1])
