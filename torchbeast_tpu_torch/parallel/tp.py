"""Tensor parallelism over a `model` mesh axis (counterpart of
torchbeast_tpu/parallel/tp.py).

The reference shards the transformer's blocks Megatron-style and lets XLA
insert one all-reduce per attention and one per FFN: q/k/v and the FFN's
up-projection split by column (heads, d_ff), the attention's out
projection and the FFN's down-projection by row. The port picks the same
leaves by the same rule and places them as the reference's polybeast
does (polybeast.py:989-1041): with K model devices, `set_model_devices`
keeps slice j of each split leaf resident on the row's j-th model device
(models/sharded.py), and each block of the row runs head group j and FFN
column group j there on those slices (models/transformer._Block), summing
the K partial out and down projections on the row's device in the order
j = 0..K-1 before the replicated biases and the residual are added. The
gradients of the slices land on their devices; once the optimizer is
realigned (sharded.shard_optimizer, which parallel/dp.ParallelLearner
runs) each model device holds 1/K of the split leaves and of their
RMSprop state. The checkpoint, weights.py and the acting copy read the
one-device tree through the assembly (models/sharded.local_view).

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

from torchbeast_tpu_torch.models import sharded
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


def set_model_devices(model, devices: Optional[Sequence]) -> int:
    """Split each transformer block of `model` over `devices`, after the
    pairing's checks on the one-device state dict (the reference's
    ValueError for a head count or FFN width that does not divide): slot
    j of each leaf the pairing splits, resident on devices[j], and the
    block's head and FFN groups run there (models/transformer._Block).
    One device, or None, puts the leaves back whole: the one-device
    block. Returns the number of leaves split."""
    devices = list(devices) if devices else None
    K = len(devices) if devices else 1
    specs = transformer_tp_shardings(K, sharded.local_view(model))
    if K == 1:
        sharded.unshard(model, "model")
        return 0
    leaves = {".".join(path): ("model", spec.index("model"))
              for path, spec in _flat(specs, specs=True)
              if not _is_replicated(spec)}
    return sharded.shard(model, leaves, {"model": devices})
