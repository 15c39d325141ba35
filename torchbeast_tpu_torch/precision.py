"""Precision policies: what dtype each tensor of the learner step lives in
(counterpart of torchbeast_tpu/precision.py; the port's own copy of its
`Policy` table, `get`, `resolve_flags`, `cast_params` and `cast_batch`).

One hard contract, as in the reference: V-trace, the losses, the gradient
norm and the RMSprop second-moment EMA are COMPUTED in float32 whatever
the storage dtype, and the master params stay float32. bfloat16 changes
what is stored and moved, never what is accumulated.

    f32           Everything float32.
    bf16_compute  The trunk computes in bfloat16 (the old
                  `--model_dtype bfloat16`, which aliases to it).
    bf16_train    bf16_compute, plus the recurrent core and policy head
                  compute in bfloat16, the params are bfloat16-resident
                  with an f32 master in the optimizer state, the RMSprop
                  second moment is stored bfloat16, and the float32
                  leaves of the staged batch and of the initial agent
                  state are cast to bfloat16 before they reach the card.

Models take `dtype` and `head_dtype` and cast at each layer, as the flax
modules do; nothing here uses `torch.autocast`, whose own per-op lists
would pick other ops than the reference's.
"""

import logging
from typing import NamedTuple, Optional

import torch

from torchbeast_tpu_torch import nest

log = logging.getLogger(__name__)

CHOICES = ("f32", "bf16_compute", "bf16_train")


class Policy(NamedTuple):
    """`compute_dtype`: the trunk's compute dtype; `head_dtype`: the
    recurrent core's and policy head's; `param_dtype`: the resident
    params ("bf16" keeps an f32 master in the optimizer state);
    `batch_dtype`: what float32 leaves of the staged batch and initial
    agent state become (None = stay float32); `opt_state_dtype`: the
    RMSprop second moment's storage, as learner.HParams takes it."""

    name: str
    compute_dtype: torch.dtype
    head_dtype: torch.dtype
    param_dtype: str
    batch_dtype: Optional[torch.dtype]
    opt_state_dtype: str


POLICIES = {
    "f32": Policy("f32", torch.float32, torch.float32, "f32", None, "f32"),
    "bf16_compute": Policy(
        "bf16_compute", torch.bfloat16, torch.float32, "f32", None, "f32"
    ),
    "bf16_train": Policy(
        "bf16_train", torch.bfloat16, torch.bfloat16, "bf16",
        torch.bfloat16, "bf16",
    ),
}


def get(name: str) -> Policy:
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(
            f"Unknown precision policy {name!r}; choices: {CHOICES}"
        ) from None


def resolve_flags(flags) -> Policy:
    """Flags -> Policy. `--model_dtype bfloat16` is a deprecated alias of
    `--precision bf16_compute` (warned once per process); with an explicit
    `--precision bf16_train` it is a conflict, not a priority rule."""
    name = getattr(flags, "precision", "f32") or "f32"
    legacy = getattr(flags, "model_dtype", None)
    if legacy and legacy != "float32":
        if name != "f32" and name != "bf16_compute":
            raise ValueError(
                f"--model_dtype {legacy} conflicts with --precision "
                f"{name}; drop the deprecated --model_dtype flag"
            )
        if not getattr(resolve_flags, "_warned_model_dtype", False):
            resolve_flags._warned_model_dtype = True
            log.warning(
                "--model_dtype bfloat16 is deprecated; use --precision "
                "bf16_compute (aliased for you). bf16_train additionally "
                "makes params/activations bf16-resident and compacts "
                "the staged batch and optimizer second moment."
            )
        name = "bf16_compute"
    return get(name)


def cast_params(module: torch.nn.Module, policy: Policy) -> torch.nn.Module:
    """The module's float32 params -> the policy's resident dtype, in
    place (memory formats kept). Cast BEFORE the optimizer is built: its
    f32 master copy is made from the resident params."""
    if policy.param_dtype == "bf16":
        for p in module.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return module


def cast_batch(tree, batch_dtype: Optional[torch.dtype] = None):
    """Float32 tensor leaves -> `batch_dtype`; every other leaf untouched.
    The driver applies it to the staged batch on the host, before the
    copy to the card, so the copy is half-width too, and to the initial
    agent state; the learner widens at the point of use."""
    if batch_dtype is None:
        return tree
    return nest.map(
        lambda t: t.to(batch_dtype) if torch.is_tensor(t)
        and t.dtype == torch.float32 else t, tree)
