"""Shared structured types (counterpart of torchbeast_tpu/types.py)."""

from typing import Any, NamedTuple


class AgentOutput(NamedTuple):
    """One policy step: `[T, B]` action (int64 in the port, int32 in the
    reference), `[T, B, A]` f32 logits and `[T, B]` f32 baseline."""

    action: Any
    policy_logits: Any
    baseline: Any
