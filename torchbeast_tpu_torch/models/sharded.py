"""Sharded storage of a module's leaves: the port's counterpart of the
reference's params placed with `jax.device_put` on its TP and EP
shardings, and of its `local_view` (torchbeast_tpu/polybeast.py).

A leaf split over K devices is replaced, in its module, by K resident
parameters `<leaf>_slot0` .. `<leaf>_slot{K-1}`: slice j of the leaf
along one dim, on devices[j]. The module keeps the leaf's own name as
None (as a Linear without bias does), and the slots take its place in
the module's parameter order, so `model.parameters()` lists the one-device
leaves in their order with each split leaf's slices in slot order. The
forward reads the slots (models/moe.MoEFFN, models/transformer._Block),
the optimizer holds them, and their gradients land on their devices.

The one-device tree (the checkpoint's, weights.py's) comes from
`local_view`, which concatenates each split leaf's slices on its slot 0
device (the data row's); `split` cuts such a tree back into the slots,
and `Publisher` copies the slots into whole leaves kept elsewhere (the
acting copy's). A split leaf records its axis (`model` or `expert`), its dim
and its whole size along the dim; `local_view` refuses a leaf whose
slices do not cover it, as the reference's refuses a leaf sharded
across processes (the port's inner axes stay within a process, so this
never fires).
"""

import collections
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence

import torch
from torch import nn

SLOT = "{}_slot{}"


class Split(NamedTuple):
    """A split leaf: its mesh axis, the dim it is cut along, its whole
    size there and its number of slots."""

    axis: str
    dim: int
    size: int
    slots: int


def slots(module: nn.Module, leaf: str) -> Optional[List[torch.Tensor]]:
    """The resident slices of `module`'s leaf `leaf` in slot order, or
    None when the leaf is whole."""
    got = []
    params = module._parameters
    while True:
        p = params.get(SLOT.format(leaf, len(got)))
        if p is None:
            return got or None
        got.append(p)


def _record(model) -> Dict[str, Split]:
    return model.__dict__.setdefault("_split_leaves", {})


def is_sharded(model) -> bool:
    return bool(model.__dict__.get("_split_leaves"))


def _owner(model, name: str):
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


def _fresh(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of `t` on `device`, in storage of its own."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def _replace(module: nn.Module, leaf: str, new: Dict[str, Optional[
        nn.Parameter]]) -> None:
    """Put `new` (name -> parameter) in `module`'s parameter order where
    `leaf` stands (the slots after the leaf's own key), dropping the
    leaf's old slots."""
    old = {SLOT.format(leaf, j) for j in range(len(slots(module, leaf)
                                                    or ()))}
    params = collections.OrderedDict()
    for k, v in module._parameters.items():
        if k == leaf:
            params.update(new)
        elif k not in old:
            params[k] = v
    module._parameters = params


def shard(model, leaves: Mapping[str, tuple], devices: Mapping[
        str, Sequence]) -> int:
    """Split each leaf of `leaves` (its one-device name -> (axis, dim))
    into len(devices[axis]) resident slices, slice j on devices[axis][j].
    Leaves already split stay as they are. Returns the number split."""
    record = _record(model)
    n = 0
    for name, (axis, dim) in leaves.items():
        if name in record:
            continue
        module, leaf = _owner(model, name)
        p = module._parameters[leaf]
        devs = list(devices[axis])
        with torch.no_grad():
            new = {leaf: None}
            for j, (part, dev) in enumerate(
                    zip(p.detach().chunk(len(devs), dim), devs)):
                new[SLOT.format(leaf, j)] = nn.Parameter(
                    _fresh(part, dev), requires_grad=p.requires_grad)
        _replace(module, leaf, new)
        record[name] = Split(axis, dim, p.shape[dim], len(devs))
        n += 1
    return n


def unshard(model, axis: Optional[str] = None):
    """Put each split leaf (of `axis`, or every one) back whole, on its
    slot 0 device. Returns `model`."""
    record = _record(model)
    for name, sp in list(record.items()):
        if axis is not None and sp.axis != axis:
            continue
        module, leaf = _owner(model, name)
        parts = slots(module, leaf)
        with torch.no_grad():
            whole = nn.Parameter(_cat(name, sp, parts),
                                 requires_grad=parts[0].requires_grad)
        _replace(module, leaf, {leaf: whole})
        del record[name]
    return model


def _cat(name: str, sp: Split, parts) -> torch.Tensor:
    covered = sum(int(t.shape[sp.dim]) for t in parts)
    if len(parts) != sp.slots or covered != sp.size:
        raise ValueError(
            f"local_view: leaf {name} sharded ACROSS processes (host "
            f"covers {covered}/{sp.size} of its dim {sp.dim}); inner "
            "parallel axes must nest inside the data axis (parallel/"
            "mesh.py) for host-local inference and checkpointing")
    home = parts[0].device
    return torch.cat([t.detach().to(home) for t in parts], dim=sp.dim)


def _groups(model):
    """[(one-device name, Split or None, [parameter indices])] in the
    one-device order."""
    record = model.__dict__.get("_split_leaves", {})
    out, at = [], {}
    for i, (name, _) in enumerate(model.named_parameters()):
        prefix, _, leaf = name.rpartition(".")
        base, sep, _ = leaf.rpartition("_slot")
        whole = (f"{prefix}.{base}" if prefix else base) if sep else name
        if sep and whole in record:
            if whole not in at:
                at[whole] = len(out)
                out.append((whole, record[whole], []))
            out[at[whole]][2].append(i)
        else:
            out.append((name, None, [i]))
    return out


def whole_names(model) -> List[str]:
    """The one-device parameter names, in the one-device order."""
    return [name for name, _, _ in _groups(model)]


def local_view(model, tensors: Optional[Sequence[torch.Tensor]] = None
               ) -> "collections.OrderedDict[str, torch.Tensor]":
    """The one-device tree of `tensors` (aligned with
    model.parameters(): the params by default, or an optimizer list),
    one-device name -> tensor: a split leaf's slices concatenated on its
    slot 0 device (a new tensor), every other leaf as it is. The
    counterpart of the reference's local_view."""
    if tensors is None:
        tensors = [p.detach() for p in model.parameters()]
    tensors = list(tensors)
    return collections.OrderedDict(
        (name, tensors[idx[0]] if sp is None
         else _cat(name, sp, [tensors[i] for i in idx]))
        for name, sp, idx in _groups(model))


def split(model, whole: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
    """A one-device tree (name -> tensor) cut into a list aligned with
    model.parameters(): each slot's slice of its leaf, each whole leaf
    as it is (views, on the tree's devices)."""
    params = list(model.parameters())
    out = [None] * len(params)
    for name, sp, idx in _groups(model):
        t = whole[name]
        parts = [t] if sp is None else t.chunk(sp.slots, sp.dim)
        for i, part in zip(idx, parts):
            out[i] = part
    return out


def load(model, whole: Mapping[str, torch.Tensor]) -> None:
    """Copy a one-device tree into the model's params (its slots take
    their slices), checking every key and shape first."""
    names = whole_names(model)
    if sorted(names) != sorted(whole):
        missing = sorted(set(names) - set(whole))
        extra = sorted(set(whole) - set(names))
        raise KeyError(f"one-device tree mismatch: missing {missing}, "
                       f"unexpected {extra}")
    params = list(model.parameters())
    parts = split(model, whole)
    for p, t in zip(params, parts):
        if tuple(p.shape) != tuple(t.shape):
            raise ValueError(f"shape {tuple(t.shape)} for a parameter of "
                             f"{tuple(p.shape)}")
    with torch.no_grad():
        for p, t in zip(params, parts):
            p.copy_(t)


class Publisher:
    """Copies `model`'s params into `whole`, tensors in the one-device
    order (an acting copy's whole leaves). The destinations are cut once
    as the params are (`split`: a split leaf's slot j lands in its slice
    j), so a call allocates nothing; the pairs whose layouts match are
    one fused copy, the strided column slices one copy each."""

    def __init__(self, whole: Sequence[torch.Tensor], model):
        self.whole = list(whole)
        self.model = model
        dst = split(model, collections.OrderedDict(
            zip(whole_names(model), self.whole)))
        self.fused_dst, self.fused_src, self.strided = [], [], []
        for d, s in zip(dst, model.parameters()):
            if d.is_contiguous() and d.device == s.device:
                self.fused_dst.append(d)
                self.fused_src.append(s)
            else:
                self.strided.append((d, s))

    def __call__(self) -> None:
        with torch.no_grad():
            if self.fused_dst:
                torch._foreach_copy_(self.fused_dst, self.fused_src)
            for d, s in self.strided:
                d.copy_(s)


def positions(model) -> list:
    """Per parameter (model.parameters() order): None for a whole leaf,
    (axis, j) for slot j of a split leaf."""
    out = [None] * len(list(model.parameters()))
    for _, sp, idx in _groups(model):
        if sp is not None:
            for j, i in enumerate(idx):
                out[i] = (sp.axis, j)
    return out


def norm_groups(model) -> List[List[int]]:
    """The parameter indices of the global norm's partial sums, in their
    fixed order: the whole leaves (the row's device) first, then each
    split axis's slots 0..K-1 (`model`, then `expert`)."""
    pos = positions(model)
    keys = sorted({p for p in pos if p is not None},
                  key=lambda p: (p[0] != "model", p[1]))
    lead = [i for i, p in enumerate(pos) if p is None]
    return [lead] + [[i for i, p in enumerate(pos) if p == k]
                     for k in keys]


def shard_optimizer(optimizer, model) -> None:
    """Realign `optimizer` (built over the one-device params of `model`,
    before `shard`) with the model's slots: it holds model.parameters()
    and each params-shaped state list (nu, the momentum trace, the f32
    master) is cut into fresh slices on their slots' devices. Its global
    norm sums in norm_groups' order."""
    st = optimizer.state
    if getattr(optimizer, "layouts", None) is not None:
        raise ValueError(
            "the factored second moment does not mirror the params; it "
            "cannot be sharded")
    params = list(model.parameters())
    names = whole_names(model)

    def cut(tensors):
        if tensors is None:
            return None
        return [_fresh(part, p.device) for part, p in
                zip(split(model, dict(zip(names, tensors))), params)]

    optimizer.params = params
    optimizer.state = st._replace(nu=cut(st.nu), mom=cut(st.mom),
                                  master=cut(st.master))
    optimizer.norm_groups = norm_groups(model)


def slot_bytes(model, tensors: Optional[Sequence[torch.Tensor]] = None
               ) -> Dict[Optional[tuple], int]:
    """Bytes of `tensors` (aligned with model.parameters(); the params by
    default) by place: None for the whole leaves (on the data row's
    device), (axis, j) for the slices of slot j of `axis`."""
    if tensors is None:
        tensors = list(model.parameters())
    out = collections.Counter()
    for t, pos in zip(tensors, positions(model)):
        out[pos] += t.numel() * t.element_size()
    return dict(out)
