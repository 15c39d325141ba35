"""Expert parallelism over an `expert` mesh axis (counterpart of
torchbeast_tpu/parallel/ep.py).

The reference shards the leading `E` axis of the MoE expert kernels
(`w_in [E, d, ff]`, `w_out [E, ff, d]`) over `expert` and lets XLA turn
the dispatch and combine einsums into all-to-alls. The port picks the
same leaves by the same rule and splits the same axis: each MoE layer of
a data row runs expert group j on the row's j-th expert device
(models/moe.MoEFFN `expert_devices`), its weights copied there inside
the forward, and sums the groups' outputs on the row's device. The
leaves themselves stay whole on the row's device, where the optimizer
and the checkpoint see the one-device tree; the reference's memory
saving (each chip holding 1/K of the expert kernels and of their
optimizer state) is not the port's.

The leaf rule (the reference's expert_param_shardings): a leaf named
`w_in` or `w_out` of 3 or more dims whose leading dim divides by the
axis size, in a scope that also holds a `router` entry (the MoEFFN
signature: the pipelined families' stage-stacked `w_in`/`w_out` have no
router beside them, and the router and the biases stay replicated). It
applies to any tree of the reference's layout (nested dicts: the flax
params tree, the optimizer's params-shaped state) and to a torch state
dict (flat dotted names).
"""

from typing import Any, Sequence

import torch

from torchbeast_tpu_torch.models.moe import MoEFFN

EXPERT_KERNELS = ("w_in", "w_out")
# A leaf's spec: its leading axis over `expert` (the reference's
# P("expert")), or whole on every device (P()).
EXPERT = "expert"
REPLICATED = "replicated"


def _size(mesh_or_size, axis: str) -> int:
    if isinstance(mesh_or_size, int):
        return mesh_or_size
    return mesh_or_size.shape.get(axis, 1)


def _flat(tree, path=()):
    """(path tuple, leaf) of every leaf: nested dicts, lists and tuples
    by key or position, a dict's dotted keys split into their parts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + tuple(str(k).split(".")))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(
            tree)(out)
    return fn(path, tree)


def expert_param_shardings(mesh_or_size, tree: Any,
                           axis: str = "expert") -> Any:
    """`tree` with each leaf replaced by its spec: EXPERT for an expert
    kernel the rule picks (see the module docstring), REPLICATED for every
    other leaf. `mesh_or_size` is a Mesh (its `axis` size) or the size."""
    E = _size(mesh_or_size, axis)
    moe_scopes = set()
    for path, _ in _flat(tree):
        for i, t in enumerate(path):
            if t == "router":
                moe_scopes.add(path[:i])

    def rule(path, leaf):
        shape = getattr(leaf, "shape", None)
        if (E > 1 and path and path[-1] in EXPERT_KERNELS
                and path[:-1] in moe_scopes and shape is not None
                and len(shape) >= 3 and shape[0] % E == 0):
            return EXPERT
        return REPLICATED

    return _map(rule, tree)


def expert_slices(leaf: torch.Tensor, devices: Sequence) -> list:
    """The leaf's leading axis split into len(devices) equal groups, group
    j copied to devices[j]."""
    per = leaf.shape[0] // len(devices)
    return [leaf[j * per:(j + 1) * per].to(d)
            for j, d in enumerate(devices)]


def place_expert_params(mesh, tree: Any, row: int = 0,
                        axis: str = "expert") -> Any:
    """`tree` (of tensors) placed on data row `row` of `mesh`: each leaf
    the rule picks becomes its expert_slices over the row's expert
    devices, every other leaf goes whole to the row's first device."""
    devices = mesh.expert_devices(row)
    specs = expert_param_shardings(mesh, tree, axis)
    spec_of = dict(_flat(specs))

    def place(path, leaf):
        if spec_of[path] == EXPERT:
            return expert_slices(leaf, devices)
        return torch.as_tensor(leaf).to(devices[0])

    return _map(place, tree)


def set_expert_devices(model, devices: Sequence) -> int:
    """Split each MoE layer of `model` whose expert kernels the rule picks
    over `devices` (models/moe.MoEFFN `expert_devices`); one device, or
    None, is the one-device layer. Returns the number of expert leaves
    split."""
    devices = list(devices) if devices else None
    G = len(devices) if devices else 1
    specs = expert_param_shardings(G, model.state_dict())
    picked = {".".join(path[:-1]) for path, spec in _flat(specs)
              if spec == EXPERT}
    for name, module in model.named_modules():
        if isinstance(module, MoEFFN):
            module.expert_devices = devices if name in picked else None
    return 2 * len(picked)
