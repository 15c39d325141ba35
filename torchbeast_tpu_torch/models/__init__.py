"""Model registry (counterpart of torchbeast_tpu/models/__init__.py).

`create_model("shallow"|"deep"|"transformer", ...)`: monobeast's
AtariNet, polybeast's deep ResNet and the transformer policy. Unlike flax,
a torch module sizes its first layer at construction, so the frame shape
([H, W, C]) is an argument. `dtype` (the trunk's compute dtype) and
`head_dtype` (the core's and heads') come from the precision policy
(torchbeast_tpu_torch/precision.py).
"""

import torch

from torchbeast_tpu_torch.models.atari_net import AtariNet  # noqa: F401
from torchbeast_tpu_torch.models.cores import LSTMCore  # noqa: F401
from torchbeast_tpu_torch.models.resnet import ResNet  # noqa: F401
from torchbeast_tpu_torch.models.transformer import (  # noqa: F401
    TransformerNet,
)

_REGISTRY = {
    "shallow": AtariNet,
    "atari": AtariNet,
    "deep": ResNet,
    "resnet": ResNet,
    "transformer": TransformerNet,
}

# Reference families the port does not have yet -> the ROADMAP item that
# brings each.
NOT_PORTED = {
    "mlp": "Atari envs and the mlp model",
    "pipelined_mlp": "the transformer family",
    "pipelined_transformer": "the transformer family",
}


def create_model(name: str, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), dtype=torch.float32,
                 head_dtype=torch.float32, **kwargs):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"--model {name} is not in the port yet: ROADMAP.md Queue 1 "
            f"item '{NOT_PORTED[name]}'"
        )
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    if cls is TransformerNet and use_lstm:
        raise ValueError(
            "--use_lstm does not apply to the transformer family (its "
            "memory is the KV cache); drop the flag"
        )
    return cls(num_actions=num_actions, use_lstm=use_lstm,
               frame_shape=tuple(frame_shape), dtype=dtype,
               head_dtype=head_dtype, **kwargs)
