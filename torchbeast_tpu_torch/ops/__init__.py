"""Ops of the port: V-trace, losses (IMPALA's and IMPACT's), pooling, the
optimizer tail, the transformer's attention and the LSTM layer's
recurrence, each kernel beside its plain PyTorch version (counterpart of
torchbeast_tpu/ops/; the LSTM's has none there)."""

from torchbeast_tpu_torch.ops._route import (  # noqa: F401
    add_counts,
    plain_on_device,
)
from torchbeast_tpu_torch.ops.attention import (  # noqa: F401
    transformer_attention,
    transformer_attention_bwd,
)
from torchbeast_tpu_torch.ops.impact import (  # noqa: F401
    impact_policy_losses,
)
from torchbeast_tpu_torch.ops.losses import (  # noqa: F401
    compute_baseline_loss,
    compute_entropy_loss,
    compute_policy_gradient_loss,
    vtrace_policy_losses,
)
from torchbeast_tpu_torch.ops.lstm import lstm_layer  # noqa: F401
from torchbeast_tpu_torch.ops.opt import rmsprop_tail  # noqa: F401
from torchbeast_tpu_torch.ops.pool import max_pool2d, pool_bwd  # noqa: F401
from torchbeast_tpu_torch.ops.vtrace import vtrace_targets  # noqa: F401

# The kernel wrappers, each with its plain integer `launches` counter.
KERNEL_WRAPPERS = (vtrace_targets, rmsprop_tail, pool_bwd,
                   transformer_attention, transformer_attention_bwd,
                   lstm_layer)


# Of those, the wrappers with a bf16 variant, each also counting the
# launches of that variant in `bf16_launches`.
BF16_WRAPPERS = (rmsprop_tail, pool_bwd, transformer_attention,
                 transformer_attention_bwd)


def reset_launch_counts() -> None:
    for wrapper in KERNEL_WRAPPERS:
        wrapper.launches = 0
    for wrapper in BF16_WRAPPERS:
        wrapper.bf16_launches = 0
    pool_bwd.vector_launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}


def bf16_launch_counts() -> dict:
    return {w.__name__: w.bf16_launches for w in BF16_WRAPPERS}


def launch_counters() -> list:
    """Every launch counter: (wrapper, attribute name) pairs."""
    return ([(w, "launches") for w in KERNEL_WRAPPERS]
            + [(w, "bf16_launches") for w in BF16_WRAPPERS]
            + [(pool_bwd, "vector_launches")])


def read_launch_counters() -> list:
    """The values of launch_counters(), in their order."""
    return [getattr(w, name) for w, name in launch_counters()]
