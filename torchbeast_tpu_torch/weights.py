"""Convert weights between the JAX package's params and the port's
`state_dict`, in both directions.

The JAX side is a nested dict of numpy arrays (flax params, optionally
under a top-level "params" key); the port's side is a flat state dict
whose keys are the flax scope paths joined with "." (the port names its
submodules after the flax scopes). Per leaf:

- Dense kernel [in, out] -> Linear weight [out, in]; biases as they are.
- Conv kernel HWIO -> Conv2d weight OIHW.
- The fc after a conv trunk needs no permutation: both packages flatten
  the trunk output in NHWC order.
- flax OptimizedLSTMCell (scope head/core/Scan_StackedLSTMStep_0/layer_l):
  the input kernels ii/if/ig/io and the hidden kernels hi/hf/hg/ho stack
  in i, f, g, o order into weight_ih_l{l} / weight_hh_l{l}, and the
  hidden-side biases into bias_hh_l{l} (flax has no input-side bias).
- The transformer's attention projections are flax DenseGenerals over
  (H, hd), stored as Linear layers of H*hd: the q/k/v kernel [d, H, hd]
  becomes the weight [H*hd, d] and its bias [H, hd] the bias [H*hd]; the
  `out` kernel [H, hd, d] becomes the weight [d, H*hd]. Back to flax, H
  is the first dimension of the block's `rel_bias` [H, M+1].
- LayerNorm `scale` is the port's `weight` (the only 1-D weight);
  `rel_bias` crosses as it is, and so does every other leaf: the MoE
  experts' and the pipelined families' stacked `[L, ...]` leaves (`wq`,
  `w_in`, `ln1_scale`, ...), which keep the reference's names and layout
  (none is named `weight` or `kernel`), at any depth of the tree.

Optimizer trees shaped like the params (RMSprop's nu, the momentum trace,
the f32 master) convert with the same leaf map. flax's LSTM carry is
(c, h); the reference and the port keep agent state as (h, c), so state
needs no conversion.

Dtypes: JAX leaves of any float dtype (bf16 ones as ml_dtypes arrays)
come across as f32 tensors, which `load_state_dict` copies into the
module's params of the policy's dtype (bf16 values exactly); bf16 tensors
go back to JAX as f32 numpy arrays, also exactly (numpy has no bf16 of
its own).

`jax_layouts` gives, per port parameter, its views in the JAX leaves'
layout, which the factored RMSprop (--factored_opt_state) needs: it
factors each JAX leaf over its last two axes.

A model with sharded storage (models/sharded.py: polybeast's learner
mesh under --tensor_parallel or --expert_parallel) converts through its
one-device tree: the lists aligned with its parameters are assembled
into whole leaves on the way to JAX and cut into its slots on the way
back, so the flax tree is always the one-device tree.
"""

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from torchbeast_tpu_torch.models import sharded

_GATES = ("i", "f", "g", "o")
_LSTM_SCOPE = ("core", "Scan_StackedLSTMStep_0")
_HEAD_PROJECTIONS = ("q", "k", "v")  # DenseGeneral out to (H, hd)
_HEAD_MERGE = "out"  # DenseGeneral in from (H, hd)


def _unwrap(tree):
    if set(tree) == {"params"}:
        return tree["params"]
    return tree


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def jax_to_torch(tree) -> Dict[str, torch.Tensor]:
    """flax params (or a params-shaped optimizer tree) -> state-dict-like
    {key: tensor} for the port's module."""
    out = {}
    lstm = {}
    for path, leaf in _leaves(_unwrap(tree)):
        if len(path) >= 5 and path[-5:-3] == _LSTM_SCOPE:
            # .../core/Scan_StackedLSTMStep_0/layer_<l>/<side><gate>/<kind>
            prefix = ".".join(path[:-4])
            layer = int(path[-3].split("_")[1])
            side, gate = path[-2][0], path[-2][1]
            lstm.setdefault((prefix, layer), {})[(side, gate, path[-1])] = leaf
            continue
        key = ".".join(path[:-1])
        if path[-1] == "kernel":
            if leaf.ndim == 4:
                out[key + ".weight"] = leaf.transpose(3, 2, 0, 1)
            elif leaf.ndim == 3 and path[-2] == _HEAD_MERGE:
                out[key + ".weight"] = leaf.reshape(-1, leaf.shape[-1]).T
            elif leaf.ndim == 3:
                out[key + ".weight"] = leaf.reshape(leaf.shape[0], -1).T
            else:
                out[key + ".weight"] = leaf.T
        elif path[-1] == "scale":
            out[key + ".weight"] = leaf
        elif path[-1] == "bias":
            out[key + ".bias"] = leaf.reshape(-1)
        else:
            out[".".join(path)] = leaf
    for (prefix, layer), parts in lstm.items():
        out[f"{prefix}.weight_ih_l{layer}"] = np.concatenate(
            [parts[("i", g, "kernel")] for g in _GATES], axis=1
        ).T
        out[f"{prefix}.weight_hh_l{layer}"] = np.concatenate(
            [parts[("h", g, "kernel")] for g in _GATES], axis=1
        ).T
        out[f"{prefix}.bias_hh_l{layer}"] = np.concatenate(
            [parts[("h", g, "bias")] for g in _GATES]
        )
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
        for k, v in out.items()
    }


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _heads(state, parts):
    """H of an attention projection's block (its rel_bias [H, M+1]), or
    None for a key outside the attention projections."""
    if len(parts) < 2 or parts[-2] not in _HEAD_PROJECTIONS + (_HEAD_MERGE,):
        return None
    rel_bias = state.get(".".join(parts[:-2] + ["rel_bias"]))
    return None if rel_bias is None else rel_bias.shape[0]


def torch_to_jax(state: Dict[str, torch.Tensor], wrap: bool = True):
    """The port's state dict (or a params-aligned {key: tensor} optimizer
    tree) -> flax params as nested numpy dicts, under "params" when
    `wrap`."""
    tree = {}
    for key, t in state.items():
        t = t.detach()
        a = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        parts = key.split(".")
        name = parts[-1]
        heads = _heads(state, parts)
        if name.startswith(("weight_ih_l", "weight_hh_l", "bias_hh_l")):
            layer = int(name.rsplit("_l", 1)[1])
            scope = tuple(parts[:-1]) + (_LSTM_SCOPE[1], f"layer_{layer}")
            side = "i" if name.startswith("weight_ih") else "h"
            kind = "bias" if name.startswith("bias") else "kernel"
            for gate, chunk in zip(_GATES, np.split(a, 4, axis=0)):
                leaf = chunk if kind == "bias" else chunk.T
                _set(tree, scope + (side + gate, kind), np.array(leaf))
            continue
        if name == "weight" and a.ndim == 1:
            _set(tree, tuple(parts[:-1]) + ("scale",), np.array(a))
        elif name == "weight":
            if a.ndim == 4:
                leaf = a.transpose(2, 3, 1, 0)
            elif heads is not None and parts[-2] == _HEAD_MERGE:
                leaf = a.T.reshape(heads, -1, a.shape[0])
            elif heads is not None:
                leaf = a.T.reshape(a.shape[1], heads, -1)
            else:
                leaf = a.T
            _set(tree, tuple(parts[:-1]) + ("kernel",), np.array(leaf))
        elif name == "bias" and heads is not None and (
                parts[-2] in _HEAD_PROJECTIONS):
            _set(tree, tuple(parts), np.array(a.reshape(heads, -1)))
        else:
            _set(tree, tuple(parts), np.array(a))
    return {"params": tree} if wrap else tree


def load_jax_params(model: torch.nn.Module, tree) -> None:
    """Copy flax params into the module (strict: every key must match;
    a sharded model's slots take their slices)."""
    state = jax_to_torch(tree)
    if sharded.is_sharded(model):
        sharded.load(model, state)
    else:
        model.load_state_dict(state, strict=True)


def param_list_to_jax(model: torch.nn.Module, tensors, wrap: bool = True):
    """A list aligned with `model.parameters()` (e.g. RMSprop nu) as a
    params-shaped JAX tree (a sharded model's slices assembled)."""
    return torch_to_jax(sharded.local_view(model, tensors), wrap=wrap)


def param_list_from_jax(model: torch.nn.Module, tree, like=None):
    """A params-shaped JAX tree (e.g. RMSprop nu) -> a list aligned with
    `model.parameters()`, each tensor in its parameter's layout (a
    sharded model's slice of it), on its device, and in the dtype of
    `like`'s entry (default: its parameter's)."""
    parts = sharded.split(model, jax_to_torch(tree))
    out = []
    for i, (p, part) in enumerate(zip(model.parameters(), parts)):
        dtype = (p if like is None else like[i]).dtype
        out.append(torch.empty_like(p, dtype=dtype).copy_(part))
    return out


def optimizer_state_to_jax(model: torch.nn.Module, state, wrap: bool = True):
    """The optimizer's per-leaf state (FusedTailState: nu, mom, master) as
    params-shaped JAX trees: {"nu": ..., "mom": ... or None, "master": ...
    or None}, so one update can be compared state for state."""
    return {
        key: (None if getattr(state, key) is None
              else param_list_to_jax(model, getattr(state, key), wrap))
        for key in ("nu", "mom", "master")
    }


def load_optimizer_state(model: torch.nn.Module, optimizer, nu=None,
                         mom=None, master=None) -> None:
    """Copy params-shaped JAX trees into the optimizer's state lists (in
    their own dtypes): the reference's ScaleByRmsState/FusedTailState nu,
    its TraceState/momentum trace and its f32 master."""
    for key, tree in (("nu", nu), ("mom", mom), ("master", master)):
        if tree is None:
            continue
        dest = getattr(optimizer.state, key)
        with torch.no_grad():
            for d, src in zip(dest, param_list_from_jax(model, tree, dest)):
                d.copy_(src)


# A port tensor -> its JAX leaves' views (values in the JAX layout), and
# those leaves (same layout) -> one port tensor.
Layout = Tuple[Callable[[torch.Tensor], List[torch.Tensor]],
               Callable[[List[torch.Tensor]], torch.Tensor]]


def _layout(name: str, shape, heads) -> Layout:
    parts = name.split(".")
    last = parts[-1]
    if last.startswith(("weight_ih_l", "weight_hh_l")):
        # [4H, D] -> four gate kernels [D, H]
        return (lambda t: [c.t() for c in t.chunk(4, 0)],
                lambda vs: torch.cat([v.t() for v in vs], 0))
    if last.startswith("bias_hh_l"):
        return (lambda t: list(t.chunk(4, 0)), lambda vs: torch.cat(vs))
    if last == "weight" and len(shape) == 4:  # OIHW <-> HWIO
        return (lambda t: [t.permute(2, 3, 1, 0)],
                lambda vs: vs[0].permute(3, 2, 0, 1))
    if last == "weight" and len(shape) == 2 and heads is not None:
        if parts[-2] == _HEAD_MERGE:  # [d, H*hd] <-> [H, hd, d]
            return (lambda t: [t.t().reshape(heads, -1, t.shape[0])],
                    lambda vs: vs[0].reshape(-1, vs[0].shape[-1]).t())
        # [H*hd, d] <-> [d, H, hd]
        return (lambda t: [t.t().reshape(t.shape[1], heads, -1)],
                lambda vs: vs[0].reshape(vs[0].shape[0], -1).t())
    if last == "weight" and len(shape) == 2:  # Linear [out, in] <-> [in, out]
        return (lambda t: [t.t()], lambda vs: vs[0].t())
    if last == "bias" and heads is not None and parts[-2] in _HEAD_PROJECTIONS:
        return (lambda t: [t.reshape(heads, -1)],
                lambda vs: vs[0].reshape(-1))
    return (lambda t: [t], lambda vs: vs[0])


def jax_layouts(model: torch.nn.Module) -> List[Layout]:
    """Per parameter of `model` (in `model.parameters()` order): (views,
    join), where views(t) gives t's values as the reference's leaves (one,
    or an LSTM weight's four gates) in their JAX layout and join(leaves)
    puts such leaves back into one tensor of the port's layout."""
    if sharded.is_sharded(model):
        raise ValueError("jax_layouts reads whole leaves: the factored "
                         "second moment does not compose with sharded "
                         "storage")
    named = dict(model.named_parameters())
    return [_layout(n, tuple(p.shape), _heads(named, n.split(".")))
            for n, p in named.items()]
