"""Layers computed in a given dtype, as flax computes them.

A flax `Dense(dtype=d)` or `Conv(dtype=d)` casts its input, kernel and
bias to `d` before it computes, whatever dtype its params are stored in;
with `dtype=None` (flax's LayerNorm, or a Dense without a dtype) it
promotes them all to their common type. The port writes those casts out
at each layer, so that every op runs in the reference's dtype, rather
than leaving the choice to torch.autocast's own op lists.

`Dense` and `Conv` are nn.Linear and nn.Conv2d whose fresh weights are
drawn as flax's Dense and Conv draw theirs (models/init.py).
"""

import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models import init


class Dense(nn.Linear):
    """nn.Linear drawn as flax's Dense (and DenseGeneral, stored as a
    Linear over the flattened axes): lecun_normal with fan_in = the input
    features, zero bias."""

    def reset_parameters(self):
        init.lecun_normal_(self.weight, self.in_features)
        nn.init.zeros_(self.bias)


class Conv(nn.Conv2d):
    """nn.Conv2d drawn as flax's Conv: lecun_normal with fan_in =
    kh * kw * C_in, zero bias."""

    def reset_parameters(self):
        init.lecun_normal_(self.weight, self.weight[0].numel())
        nn.init.zeros_(self.bias)


def _promoted(x, *params):
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return dtype


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def linear(layer: nn.Linear, x, dtype=None):
    """`layer` on x in `dtype` (None: the promoted type of x and the
    params)."""
    if dtype is None:
        dtype = _promoted(x, layer.weight, layer.bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    _cast(layer.bias, dtype))


def conv2d(layer: nn.Conv2d, x, dtype):
    """`layer` on x in `dtype`."""
    return F.conv2d(x.to(dtype), layer.weight.to(dtype),
                    _cast(layer.bias, dtype), layer.stride, layer.padding)


def layer_norm(layer: nn.LayerNorm, x):
    """`layer` on x in the promoted type of x and its params (flax's
    LayerNorm carries no dtype)."""
    dtype = _promoted(x, layer.weight, layer.bias)
    return F.layer_norm(x.to(dtype), layer.normalized_shape,
                        _cast(layer.weight, dtype), _cast(layer.bias, dtype),
                        layer.eps)
