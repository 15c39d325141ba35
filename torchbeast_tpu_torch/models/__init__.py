"""Model registry (counterpart of torchbeast_tpu/models/__init__.py).

`create_model("shallow"|"deep", ...)`: monobeast's AtariNet and
polybeast's deep ResNet. Unlike flax, a torch module sizes its fc layer at
construction, so the frame shape ([H, W, C]) is an argument.
"""

from torchbeast_tpu_torch.models.atari_net import AtariNet  # noqa: F401
from torchbeast_tpu_torch.models.cores import LSTMCore  # noqa: F401
from torchbeast_tpu_torch.models.resnet import ResNet  # noqa: F401

_REGISTRY = {
    "shallow": AtariNet,
    "atari": AtariNet,
    "deep": ResNet,
    "resnet": ResNet,
}

# Reference families the port does not have yet -> the ROADMAP item that
# brings each.
NOT_PORTED = {
    "mlp": "Atari envs and the mlp model",
    "pipelined_mlp": "the transformer family",
    "transformer": "the transformer family",
    "pipelined_transformer": "the transformer family",
}


def create_model(name: str, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), **kwargs):
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
    return cls(num_actions=num_actions, use_lstm=use_lstm,
               frame_shape=tuple(frame_shape), **kwargs)
