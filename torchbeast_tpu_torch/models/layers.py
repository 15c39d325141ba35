"""Layers computed in a given dtype, as flax computes them.

A flax `Dense(dtype=d)` or `Conv(dtype=d)` casts its input, kernel and
bias to `d` before it computes, whatever dtype its params are stored in;
with `dtype=None` (flax's LayerNorm, or a Dense without a dtype) it
promotes them all to their common type. The port writes those casts out
at each layer, so that every op runs in the reference's dtype, rather
than leaving the choice to torch.autocast's own op lists.

`Dense` and `Conv` are nn.Linear and nn.Conv2d whose fresh weights are
drawn as flax's Dense and Conv draw theirs (models/init.py).

`promoted_einsum` and `layer_norm_of` serve the pipelined families
(models/pipelined.py, models/transformer_pp.py), whose stage functions
work on explicit slices of stacked parameters rather than on layers: a
product in the promoted type of its operands, as `jnp.einsum` and `@`
promote (torch's raise on mixed dtypes), and a LayerNorm from a scale and
a bias.

`checkpointed` is the port's flax `nn.remat`: the remat levers of the
models (the trunk stages, the LSTM step, the transformer blocks) call
through it.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def promoted_einsum(equation: str, x, w):
    """torch.einsum of x and w in their promoted type."""
    dtype = _promoted(x, w)
    return torch.einsum(equation, x.to(dtype), w.to(dtype))


def layer_norm_of(x, scale, bias, eps: float):
    """LayerNorm of x over its last axis with `scale` and `bias`, in the
    promoted type of the three."""
    dtype = _promoted(x, scale, bias)
    return F.layer_norm(x.to(dtype), scale.shape, scale.to(dtype),
                        bias.to(dtype), eps)


def checkpointed(fn, *args):
    """fn(*args) with its activations recomputed in the backward instead
    of kept (torch.utils.checkpoint, non-reentrant), when a gradient is
    being taken; the plain call under torch.no_grad() (acting, the target
    forward, replicas), whose graphs keep their launches and bits. No RNG
    state is saved: saving it reads the generator, which a CUDA graph
    capture forbids, and no remat region draws random numbers."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)
