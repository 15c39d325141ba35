"""Checkpoint save/load with auto-resume (copy of
torchbeast_tpu/utils/checkpoint.py, over the port's own msgpack codec).

The file is the reference's own: one msgpack map (flax's format, see
utils/serialization.py) of params and opt_state, each packed to bytes
first as flax's `to_bytes` packs them, beside step, flags, stats and
extra. Params are the reference's flax tree (weights.torch_to_jax), and
the optimizer state is the tree the reference's optimizer of the same
--opt_impl, --precision and --momentum keeps (`opt_state_tree`), so a
checkpoint that either package writes resumes in the other.

The whole payload is msgpack, never pickle: drivers auto-resume from
whatever file sits at the checkpoint path, so a tampered savedir must not
be able to run code on restart. The write is atomic (tmp + rename), so a
preemption mid-write never leaves a torn file.
"""

import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from torchbeast_tpu_torch import weights
from torchbeast_tpu_torch.learner import RMSpropChain
from torchbeast_tpu_torch.utils import serialization

log = logging.getLogger(__name__)


def atomic_write(path: str, data: bytes) -> None:
    """tmp + rename so a crash mid-write never leaves a torn file."""
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_checkpoint(
    path: str,
    *,
    params: Any,
    opt_state: Any,
    step: int,
    flags: Optional[Dict] = None,
    stats: Optional[Dict] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """`params`, `opt_state` and each `extra` value: nested dicts with
    numpy or tensor leaves (None for an absent subtree)."""
    payload = {
        "params": serialization.to_bytes(params),
        "opt_state": serialization.to_bytes(opt_state),
        "step": step,
        "flags": dict(flags) if flags else {},
        "stats": dict(stats) if stats else {},
        "extra": {
            k: serialization.to_bytes(v) for k, v in (extra or {}).items()
        },
    }
    atomic_write(path, serialization.msgpack_serialize(payload))
    log.info("Saved checkpoint to %s (step %d)", path, step)


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def restore(template: Any, state: Any, path: str = "") -> Any:
    """`state` checked against `template`, a tree of the same structure:
    the same keys at every level, None where the template has None, and
    each leaf of the template's shape and dtype. Raises ValueError naming
    the first difference, so nothing is restored from a tree of another
    optimizer or precision."""
    where = path or "."
    if isinstance(template, dict):
        if not isinstance(state, dict) or set(state) != set(template):
            have = sorted(state) if isinstance(state, dict) else state
            raise ValueError(
                f"checkpoint tree at {where}: keys {have} where this run "
                f"has {sorted(template)}")
        return {k: restore(template[k], state[k], f"{path}/{k}")
                for k in template}
    if template is None or state is None:
        if template is not None or state is not None:
            raise ValueError(
                f"checkpoint tree at {where}: {type(state).__name__} where "
                f"this run has {type(template).__name__}")
        return None
    want = (tuple(np.shape(template)), _dtype_name(template))
    have = (tuple(np.shape(state)), _dtype_name(state))
    if want != have:
        raise ValueError(
            f"checkpoint leaf {where}: shape/dtype {have} where this run "
            f"has {want}")
    return state


def load_checkpoint(
    path: str,
    *,
    params_template: Any,
    opt_state_template: Any,
    extra_templates: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Restore onto templates (trees with the right structure, shapes and
    dtypes)."""
    payload = _read(path)
    out = {
        "params": restore(
            params_template,
            serialization.msgpack_restore(payload["params"])),
        "opt_state": restore(
            opt_state_template,
            serialization.msgpack_restore(payload["opt_state"])),
        "step": payload["step"],
        "flags": payload.get("flags", {}),
        "stats": payload.get("stats", {}),
    }
    extras = {}
    for k, template in (extra_templates or {}).items():
        if k in payload.get("extra", {}):
            extras[k] = restore(
                template, serialization.msgpack_restore(payload["extra"][k]))
    out["extra"] = extras
    return out


# ------------------------------------------- the port's train state


def _jax_tree(model, tensors):
    """A list aligned with model.parameters() as the reference's
    params-shaped tree ({"params": ...}), each leaf in its tensor's
    dtype: numpy for f32, a torch.bfloat16 tensor for bf16 (exactly)."""
    tree = weights.param_list_to_jax(model, tensors)
    if tensors[0].dtype != torch.bfloat16:
        return tree

    def narrow(t):
        if isinstance(t, dict):
            return {k: narrow(v) for k, v in t.items()}
        return torch.from_numpy(t).to(torch.bfloat16)

    return narrow(tree)


def params_tree(model) -> Dict[str, Any]:
    """The module's parameters as the reference's flax params tree."""
    return _jax_tree(model, [p.detach() for p in model.parameters()])


def _count(optimizer):
    return np.asarray(optimizer.state.count, np.int32)


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,)


def _factored_order(model):
    """(parameter index, view index) of every JAX leaf, in the order
    jax.tree_util.tree_leaves gives the reference's params (sorted
    paths): the order of its FactoredRmsState leaves."""
    named = dict(model.named_parameters())
    biases = {k: v for k, v in named.items() if k.endswith(".rel_bias")}
    keyed = []
    for i, (name, p) in enumerate(named.items()):
        # An attention projection finds its head count in its block's
        # rel_bias; the extra leaves are dropped again below.
        own = {name: p} if name in biases else {**biases, name: p}
        paths = [path for path in _walk(weights.torch_to_jax(own))
                 if name in biases or path[-1] != "rel_bias"]
        keyed += [(path, i, j) for j, path in enumerate(paths)]
    return [(i, j) for _, i, j in sorted(keyed)]


def _rms_chain_tree(model, optimizer):
    """The reference's _rmsprop_torch state (each tree params-shaped)."""
    st = optimizer.state
    trace = ({"trace": _jax_tree(model, st.mom)} if st.mom is not None
             else None)
    count = {"count": _count(optimizer)}
    if optimizer.lr_first:  # optax.rmsprop: rms, the LR, then the trace
        return {"0": {"nu": _jax_tree(model, st.nu)}, "1": count,
                "2": trace or {}}
    if optimizer.layouts is not None:
        leaves = {}
        for k, (i, j) in enumerate(_factored_order(model)):
            row, col, nu = st.nu[i][j]
            leaves[str(k)] = {"row": row, "col": col, "nu": nu}
        scale = {"leaves": leaves}
    else:
        scale = {"nu": _jax_tree(model, st.nu)}
    parts = [scale] + ([trace] if trace else []) + [count]
    return {str(k): part for k, part in enumerate(parts)}


def opt_state_tree(model, optimizer) -> Dict[str, Any]:
    """The optimizer's state as the tree of the reference's optimizer
    with the same options:

    - --opt_impl pallas (FusedTailState): {count, nu, mom, master};
    - --opt_impl xla (the optax chain): {"0": clip (empty), "1": the
      RMSprop chain}, under {"master", "inner"} for bf16-resident params.
    """
    st = optimizer.state
    if not isinstance(optimizer, RMSpropChain):
        return {
            "count": _count(optimizer),
            "nu": _jax_tree(model, st.nu),
            "mom": None if st.mom is None else _jax_tree(model, st.mom),
            "master": (None if st.master is None
                       else _jax_tree(model, st.master)),
        }
    chain = {"0": {}, "1": _rms_chain_tree(model, optimizer)}
    if st.master is None:
        return chain
    return {"master": _jax_tree(model, st.master), "inner": chain}


def _copy_list(model, dest, tree):
    """A params-shaped tree into a list aligned with model.parameters(),
    in place, each tensor keeping its dtype (bf16 values exactly)."""
    src = weights.param_list_from_jax(model, serialization.to_numpy(tree),
                                      like=dest)
    with torch.no_grad():
        for d, s in zip(dest, src):
            d.copy_(s)


def _load_state(model, optimizer, tree) -> None:
    st = optimizer.state
    if not isinstance(optimizer, RMSpropChain):
        scale, trace, count = tree, tree["mom"], tree["count"]
        master = tree["master"]
    else:
        master = tree["master"] if st.master is not None else None
        chain = (tree["inner"] if st.master is not None else tree)["1"]
        scale = chain["0"]
        if optimizer.lr_first:
            count, trace = chain["1"], chain["2"].get("trace")
        elif st.mom is not None:
            trace, count = chain["1"]["trace"], chain["2"]
        else:
            trace, count = None, chain["1"]
        count = count["count"]
    if getattr(optimizer, "layouts", None) is not None:
        with torch.no_grad():
            for k, (i, j) in enumerate(_factored_order(model)):
                leaf = scale["leaves"][str(k)]
                for d, name in zip(st.nu[i][j], ("row", "col", "nu")):
                    d.copy_(torch.from_numpy(np.array(leaf[name])))
    else:
        _copy_list(model, st.nu, scale["nu"])
    if trace is not None:
        _copy_list(model, st.mom, trace)
    if master is not None:
        _copy_list(model, st.master, master)
    optimizer.state = st._replace(count=int(np.asarray(count)))


def save_train_state(path: str, model, optimizer, *, step: int,
                     flags: Optional[Dict] = None,
                     stats: Optional[Dict] = None) -> None:
    """Checkpoint the module's params and the optimizer's state in the
    reference's trees."""
    save_checkpoint(path, params=params_tree(model),
                    opt_state=opt_state_tree(model, optimizer), step=step,
                    flags=flags, stats=stats)


def _read(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:1] == b"\x80":  # pickle protocol-2+ magic; msgpack's 0x80 head
        # byte would mean "empty fixmap", never a valid whole checkpoint.
        raise ValueError(
            f"{path} is a legacy pickle-format checkpoint; checkpoints are "
            "now msgpack (pickle auto-resume was an arbitrary-code-execution "
            "risk). Delete it or re-save with the current version."
        )
    return serialization.msgpack_restore(raw)


def _load_params(model, tree) -> None:
    state = weights.jax_to_torch(serialization.to_numpy(tree))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name])


def load_params(path: str, model) -> Dict[str, Any]:
    """Restore only the params of a checkpoint into the module (--mode
    test: any optimizer's checkpoint of the same model and precision).
    Returns its step, flags and stats."""
    payload = _read(path)
    _load_params(model, restore(
        params_tree(model), serialization.msgpack_restore(payload["params"])))
    return {k: payload.get(k, {}) for k in ("step", "flags", "stats")}


def load_train_state(path: str, model, optimizer) -> Dict[str, Any]:
    """Restore a checkpoint into the module's params and the optimizer's
    state, in place (the LR schedule continues from the restored count).
    A checkpoint of another optimizer, precision or model raises before
    anything is written. Returns its step, flags and stats."""
    restored = load_checkpoint(
        path, params_template=params_tree(model),
        opt_state_template=opt_state_tree(model, optimizer))
    _load_params(model, restored["params"])
    _load_state(model, optimizer, restored["opt_state"])
    return {k: restored[k] for k in ("step", "flags", "stats")}
