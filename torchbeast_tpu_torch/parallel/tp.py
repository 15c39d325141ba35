"""Tensor parallelism over a `model` mesh axis (counterpart of
torchbeast_tpu/parallel/tp.py).

The reference shards the transformer's blocks Megatron-style and lets XLA
insert one all-reduce per attention and one per FFN: q/k/v and the FFN's
up-projection split by column (heads, d_ff), the attention's out
projection and the FFN's down-projection by row. The port picks the same
leaves by the same rule and splits the same axes in the forward instead:
with K model devices, each block of a data row runs head group j and FFN
column group j on the row's j-th model device (models/transformer._Block
`model_devices`), its weight slices copied there inside the forward, and
sums the K partial out and down projections on the row's device in the
order j = 0..K-1 before the replicated biases and the residual are added.
Autograd carries the gradients back through the copies to the whole
leaves.

The leaves stay whole on the data row's device, as parallel/ep.py keeps
the expert kernels: the optimizer, the checkpoints, weights.py and the
acting forward see the tree of one device. The reference's memory saving
(each chip holding 1/K of the block kernels and of their optimizer
state) is not the port's (ROADMAP.md).

The leaf rules return one spec per leaf, a tuple of mesh axis names and
None, one entry a dimension of the leaf (the reference's PartitionSpec as
a tuple; `()` is replicated). They apply to a tree of the reference's
layout (nested dicts: the flax params tree, the optimizer's params-shaped
state) and to a torch state dict (dotted names), whose Linear weights
are the flax kernels transposed and flattened over (H, hd): q/k/v
`weight` [H*hd, d] splits its rows, `out.weight` [d, H*hd] its columns,
`Dense_0.weight` [ff, d] its rows and `Dense_1.weight` [d, ff] its
columns. The head count of a torch block comes from its `rel_bias`
[H, M+1].
"""

from typing import Any, Optional, Sequence

import torch

from torchbeast_tpu_torch.parallel.ep import (
    EXPERT,
    REPLICATED,
    _flat,
    _map,
    _size,
)

# The replicated spec: the reference's P().
REPLICATED_SPEC = ()


def _is_replicated(spec) -> bool:
    return spec in (REPLICATED_SPEC, REPLICATED, None) or (
        isinstance(spec, tuple) and all(s is None for s in spec))


def _normalized(spec):
    """An ep.py spec as a tuple (EXPERT is the reference's P("expert"))."""
    if spec == EXPERT:
        return ("expert",)
    if spec == REPLICATED:
        return REPLICATED_SPEC
    return spec


def _path_str(path) -> str:
    return "".join(f"[{p!r}]" for p in path)


def dense_kernel_shardings(mesh_or_size, params: Any,
                           axis: str = "model") -> Any:
    """`params` with each leaf replaced by its spec: a 2-D leaf whose
    first dim divides by the axis size shards that dim over `axis`
    (("model", None), the reference's row-parallel P("model", None)),
    every other leaf is replicated. `mesh_or_size` is a Mesh or the
    axis size."""
    size = _size(mesh_or_size, axis)

    def rule(path, leaf):
        shape = getattr(leaf, "shape", None)
        if (size > 1 and shape is not None and len(shape) == 2
                and shape[0] % size == 0):
            return (axis, None)
        return REPLICATED_SPEC

    return _map(rule, params)


def transformer_tp_shardings(mesh_or_size, params: Any,
                             axis: str = "model") -> Any:
    """The Megatron pairing of the TransformerNet tree, one spec a leaf.

    Inside every `block_*` scope, in the reference's layout:
      q/k/v kernels [d, H, hd]  -> (None, axis, None)   (column: heads)
      q/k/v biases  [H, hd]     -> (axis, None)
      rel_bias      [H, M+1]    -> (axis, None)         (per head)
      out kernel    [H, hd, d]  -> (axis, None, None)   (row: heads)
      FFN Dense_0   [d, ff]     -> (None, axis), bias [ff] -> (axis,)
      FFN Dense_1   [ff, d]     -> (axis, None)         (row)
    and in a torch state dict the same split on its own axes (module
    docstring). Every other leaf (the LayerNorms, the out and Dense_1
    biases, the encoder, extras and head, the MoE leaves, which EP owns)
    is replicated. Raises the reference's ValueError when the head count
    or the FFN width does not divide by the axis size."""
    size = _size(mesh_or_size, axis)
    heads = {}
    for path, leaf in _flat(params):
        if path and path[-1] == "rel_bias" and hasattr(leaf, "shape"):
            heads[path[:-1]] = leaf.shape[0]

    def check(dim, what, path):
        if dim % size != 0:
            raise ValueError(
                f"transformer_tp_shardings: {what} ({dim}) at "
                f"{_path_str(path)} not divisible by the "
                f"`{axis}` axis size {size}"
            )

    def rule(path, leaf):
        toks = [str(t) for t in path]
        in_block = any(t.startswith("block_") for t in toks)
        shape = getattr(leaf, "shape", None)
        if size <= 1 or not in_block or shape is None:
            return REPLICATED_SPEC
        ndim = len(shape)
        name = toks[-1]
        parent = toks[-2] if len(toks) >= 2 else None
        if parent in ("q", "k", "v"):
            if name == "kernel" and ndim == 3:
                check(shape[1], "num_heads", path)
                return (None, axis, None)
            if name == "bias" and ndim == 2:
                check(shape[0], "num_heads", path)
                return (axis, None)
            if name in ("weight", "bias") and ndim in (1, 2):
                check(heads.get(tuple(path[:-2]), shape[0]), "num_heads",
                      path)
                return (axis,) + (None,) * (ndim - 1)
        if parent == "out":
            if name == "kernel" and ndim == 3:
                check(shape[0], "num_heads", path)
                return (axis, None, None)
            if name == "weight" and ndim == 2:
                check(heads.get(tuple(path[:-2]), shape[1]), "num_heads",
                      path)
                return (None, axis)
        if name == "rel_bias" and ndim == 2:
            check(shape[0], "num_heads", path)
            return (axis, None)
        if parent == "Dense_0":  # FFN up-projection (column)
            if name == "kernel" and ndim == 2:
                check(shape[1], "d_ff", path)
                return (None, axis)
            if name == "weight" and ndim == 2:
                check(shape[0], "d_ff", path)
                return (axis, None)
            if name == "bias" and ndim == 1:
                check(shape[0], "d_ff", path)
                return (axis,)
        if parent == "Dense_1":  # FFN down-projection (row)
            if name == "kernel" and ndim == 2:
                check(shape[0], "d_ff", path)
                return (axis, None)
            if name == "weight" and ndim == 2:
                check(shape[1], "d_ff", path)
                return (None, axis)
        return REPLICATED_SPEC

    return _map(rule, params)


def merge_param_shardings(*spec_trees: Any) -> Any:
    """Leaf-wise union of spec trees of one tree: for each leaf, at most
    one distinct non-replicated spec among the inputs (the TP pairing and
    the EP rule pick disjoint leaves); a conflict raises the reference's
    ValueError. ep.py's EXPERT reads as ("expert",)."""
    flats = [list(_flat(tree, specs=True)) for tree in spec_trees]
    merged = {}
    for leaves in zip(*flats):
        path = leaves[0][0]
        specs = [_normalized(spec) for _, spec in leaves]
        distinct = []
        for spec in specs:
            if not _is_replicated(spec) and spec not in distinct:
                distinct.append(spec)
        if len(distinct) > 1:
            shown = ", ".join(f"PartitionSpec{spec!r}" for spec in distinct)
            raise ValueError(
                "merge_param_shardings: conflicting non-replicated "
                f"shardings at {_path_str(path)}: [{shown}]"
            )
        merged[path] = distinct[0] if distinct else REPLICATED_SPEC
    return _map(lambda path, _: merged[path], spec_trees[0], specs=True)


def split_slices(leaf: torch.Tensor, spec, devices: Sequence) -> list:
    """The leaf split along the dim its spec shards into len(devices)
    equal slices, slice j copied to devices[j]."""
    dim = next(i for i, s in enumerate(spec) if s is not None)
    return [part.to(d) for part, d in
            zip(leaf.chunk(len(devices), dim=dim), devices)]


def place_params(mesh, params: Any, specs: Any, row: int = 0,
                 axis: str = "model") -> Any:
    """`params` (of tensors) placed on data row `row` of `mesh` by
    `specs` (a rule's tree): a leaf sharded over `axis` becomes its
    split_slices over the row's model devices, every other leaf goes
    whole to the row's first device."""
    devices = mesh.model_devices(row)
    spec_of = dict(_flat(specs, specs=True))

    def place(path, leaf):
        spec = _normalized(spec_of[path])
        if not _is_replicated(spec) and axis in spec:
            return split_slices(leaf, spec, devices)
        return torch.as_tensor(leaf).to(devices[0])

    return _map(place, params)


def set_model_devices(model, devices: Optional[Sequence]) -> int:
    """Split each transformer block of `model` over `devices`
    (models/transformer._Block `model_devices`), after the pairing's
    checks on the model's state dict (the reference's ValueError for a
    head count or FFN width that does not divide); one device, or None,
    is the one-device block. Returns the number of leaves split."""
    from torchbeast_tpu_torch.models.transformer import _Block

    devices = list(devices) if devices else None
    K = len(devices) if devices else 1
    specs = transformer_tp_shardings(K, model.state_dict())
    split = sum(not _is_replicated(spec)
                for _, spec in _flat(specs, specs=True))
    for module in model.modules():
        if isinstance(module, _Block):
            module.model_devices = devices if K > 1 else None
    return split
