"""Expert parallelism over an `expert` mesh axis (counterpart of
torchbeast_tpu/parallel/ep.py).

The reference shards the leading `E` axis of the MoE expert kernels
(`w_in [E, d, ff]`, `w_out [E, ff, d]`) over `expert` and lets XLA turn
the dispatch and combine einsums into all-to-alls. The port picks the
same leaves by the same rule and splits the same axis: each MoE layer of
a data row runs expert group j on the row's j-th expert device
(models/moe.MoEFFN `expert_devices`) and sums the groups' outputs on the
row's device.

Where the reference places its params on the rule (polybeast's learner
mesh, polybeast.py:989-1041), `shard_expert_params` does too: each
picked leaf becomes G resident slices (models/sharded.py), slice j on
expert device j, so that device holds 1/G of the expert kernels and,
once the optimizer is realigned (sharded.shard_optimizer, which
parallel/dp.ParallelLearner runs), of their RMSprop state. The
checkpoint, weights.py and the acting copy read the one-device tree
through the assembly (models/sharded.local_view). Where the
reference passes the mesh to the MoE layers only (monobeast's and
anakin's expert mesh), `set_expert_devices` keeps the leaves whole on
the row's device and copies each group's kernels to its device inside
the forward.

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

from torchbeast_tpu_torch.models import sharded
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


def is_spec(tree) -> bool:
    """Whether `tree` is a leaf spec of parallel/tp.py: a tuple of mesh
    axis names and None (the empty tuple replicated)."""
    return isinstance(tree, tuple) and not hasattr(tree, "_fields") and all(
        s is None or isinstance(s, str) for s in tree)


def _flat(tree, path=(), specs=False):
    """(path tuple, leaf) of every leaf: nested dicts, lists and tuples
    by key or position, a dict's dotted keys split into their parts;
    with `specs`, a spec tuple (is_spec) is a leaf."""
    if specs and is_spec(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + tuple(str(k).split(".")), specs)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,), specs)
    else:
        yield path, tree


def _map(fn, tree, path=(), specs=False):
    if specs and is_spec(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + tuple(str(k).split(".")), specs)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, path + (i,), specs) for i, v in enumerate(tree)]
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


def shard_expert_params(model, devices: Sequence) -> int:
    """The reference's placement of the expert kernels over `devices`
    (two or more): each MoE layer of `model` whose `w_in` / `w_out` the
    rule picks keeps slice j of them resident on devices[j] and runs its
    expert group j there. Returns the number of leaves split."""
    set_expert_devices(model, devices)
    leaves = {".".join(path): (EXPERT, 0) for path, spec in _flat(
        expert_param_shardings(len(devices), sharded.local_view(model)))
        if spec == EXPERT}
    return sharded.shard(model, leaves, {EXPERT: list(devices)})
