"""Policy snapshots over the wire (counterpart of torchbeast_tpu/fleet/
snapshot_wire.py).

A fleet has inference slices on hosts the learner never touches; their
`PolicySnapshotStore`s are fed over the control plane. `build_snapshot`
turns the lead's acting params into a `wire.PolicySnapshot` message (the
TAG_SNAPSHOT frame shared by runtime/wire.py and the core's wire.h), and
`apply_snapshot` feeds a received one into a remote host's store.

The payload carries flattened leaves, not a tree, in the order and
layout the reference's message has: the leaves of the flax params tree
in jax.tree_util order (dict keys sorted at every level), each in flax's
layout (weights.py's leaf map: Dense kernels [in, out], the LSTM's gate
kernels apart, ...), bf16, beside the original dtype names. So a
snapshot built by either package applies in the other: every host
builds the same model, and the receiver rebuilds the tree against its
own (the port: its module's named parameters through weights.py).

Bit-exactness: the wire carries the bf16 leaves `serving.snapshot.
bf16_cast` would publish locally; the layout moves values without
arithmetic, and the remote's restore (bf16 -> original dtype) and its
store's own publish cast (back to bf16) round-trip every value exactly,
so `latest_on` on a remote slice serves the bits of a local replica at
the same version.

`param_leaves` and `params_from_leaves` carry a param list in the same
order and layout, in each param's own dtype (the fleet's param-sync
rounds, fleet/coordinator.py).

Version skew: delivery is asynchronous; a stale publish (version <= the
store's current snapshot) is rejected, counted and dropped: policy
versions on a serving host move strictly forward.
"""

import logging
from typing import List, Tuple

import numpy as np
import torch

from torchbeast_tpu_torch import weights
from torchbeast_tpu_torch.runtime.wire import BF16, PolicySnapshot, WireError
from torchbeast_tpu_torch.serving.snapshot import PolicySnapshotStore, bf16_cast

log = logging.getLogger(__name__)

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64}


def _flat(tree, path=()):
    """(path, leaf) of a nested dict in jax.tree_util's order: keys
    sorted at every level."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _flat(value, path + (key,))
        else:
            yield path + (key,), value


def leaf_sources(model: torch.nn.Module) -> List[Tuple[tuple, int]]:
    """(flax path, index into model.parameters()) of every leaf of the
    reference's params tree, in jax.tree_util order. Found by mapping
    params filled with their own index through weights.torch_to_jax:
    a leaf holds the index of the param it was cut from."""
    named = list(model.named_parameters())
    coded = {name: torch.full(p.shape, float(i))
             for i, (name, p) in enumerate(named)}
    return [(path, int(np.asarray(leaf).reshape(-1)[0]))
            for path, leaf in _flat(weights.torch_to_jax(coded))]


def _tree(model, tensors):
    """The reference's params tree of `tensors` (aligned with
    model.parameters()), f32 numpy leaves."""
    names = [n for n, _ in model.named_parameters()]
    return weights.torch_to_jax(dict(zip(names, tensors)))


def _to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """An f32 array of bf16 values -> the same values as wire.BF16."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(BF16)


def _from_bf16_bits(a) -> torch.Tensor:
    """A bf16 wire array (ml_dtypes' bfloat16 or wire.BF16) -> f32."""
    bits = np.ascontiguousarray(a).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).float()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _dtype_from_name(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[str(name)]
    except KeyError:
        raise WireError(f"snapshot carries unknown dtype {name!r}") from None


def build_snapshot(version: int, model: torch.nn.Module,
                   params=None) -> PolicySnapshot:
    """Lead side: `params` (aligned with model.parameters(); default the
    model's own) -> wire message. Applies THE publication cast
    (serving.snapshot.bf16_cast, the local store's), moves the bf16
    leaves to the host in the reference's layout and order, and records
    each leaf's original dtype name."""
    params = list(model.parameters()) if params is None else list(params)
    bf16, dtypes = bf16_cast(params)
    tree = _tree(model, [t.float() for t in bf16])
    sources = leaf_sources(model)
    leaves = [_to_bf16_bits(leaf) for _, leaf in _flat(tree)]
    names = [_dtype_name(dtypes[i]) for _, i in sources]
    return PolicySnapshot(int(version), leaves, names)


def _restore(model, leaves, dtypes):
    """Wire leaves (reference layout and order, f32 values) -> a list
    aligned with model.parameters(), each param in `dtypes[i]` on its
    param's device."""
    sources = leaf_sources(model)
    tree = {}
    for (path, _), leaf in zip(sources, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    state = weights.jax_to_torch(tree)
    return [state[name].to(device=p.device, dtype=dtypes[i])
            for i, (name, p) in enumerate(model.named_parameters())]


def apply_snapshot(store: PolicySnapshotStore, snap: PolicySnapshot,
                   template: torch.nn.Module, stale_counter=None) -> bool:
    """Remote side: feed a wire-delivered snapshot into the local store.

    `template` is the host's model (the same architecture on every host
    of the fleet): the flat leaves are rebuilt into its parameter list,
    restored to their recorded dtypes on its params' device, and
    published. Returns True when the snapshot was published; False when
    it was rejected as stale (snap.version <= the store's version;
    counted on `stale_counter` when given). The decoded leaves may view
    the transport's receive buffer: they are copied out here, before the
    reader's next recv."""
    if not isinstance(snap, PolicySnapshot):
        raise WireError(
            f"apply_snapshot needs a PolicySnapshot, "
            f"got {type(snap).__name__}"
        )
    if snap.version <= store.version:
        if stale_counter is not None:
            stale_counter.inc()
        log.warning(
            "Dropping stale policy snapshot v%d (store at v%d)",
            snap.version, store.version,
        )
        return False
    sources = leaf_sources(template)
    n = len(sources)
    if len(snap.params) != n or len(snap.dtypes) != n:
        raise WireError(
            f"snapshot v{snap.version} carries {len(snap.params)} leaves "
            f"/ {len(snap.dtypes)} dtypes for a {n}-leaf param template "
            "(model mismatch across the fleet?)"
        )
    dtypes = {}
    for (_, i), name in zip(sources, snap.dtypes):
        dtypes[i] = _dtype_from_name(name)
    restored = _restore(template, [_from_bf16_bits(a).numpy()
                                   for a in snap.params], dtypes)
    return store.publish(snap.version, restored)


def param_leaves(model: torch.nn.Module, params) -> list:
    """`params` (aligned with model.parameters()) as the reference's
    flat leaves: its tree order and layout, each leaf in its param's
    dtype (bf16 as wire.BF16), on the host."""
    params = list(params)
    tree = _tree(model, params)
    out = []
    for (path, i), (_, leaf) in zip(leaf_sources(model), _flat(tree)):
        out.append(_to_bf16_bits(leaf) if params[i].dtype == torch.bfloat16
                   else np.asarray(leaf, dtype=np.float32))
    return out


def params_from_leaves(model: torch.nn.Module, leaves, like) -> list:
    """Flat leaves in the reference's order and layout -> a list aligned
    with model.parameters(), each in the dtype and on the device of
    `like`'s entry."""
    values = [(_from_bf16_bits(a).numpy() if a.dtype.itemsize == 2
               and not np.issubdtype(a.dtype, np.floating)
               else np.asarray(a, dtype=np.float32)) for a in leaves]
    restored = _restore(model, values, {i: t.dtype
                                        for i, t in enumerate(like)})
    return [r.to(t.device) for r, t in zip(restored, like)]
