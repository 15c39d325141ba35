"""Model registry (counterpart of torchbeast_tpu/models/__init__.py).

`create_model(name, ...)` for every family of the reference's registry:
monobeast's AtariNet ("shallow"), polybeast's deep ResNet ("deep"), the
MLP policy ("mlp"), the transformer policy ("transformer") and the two
stage-stacked families ("pipelined_mlp", "pipelined_transformer"), which
run their stage towers sequentially on one device; and one family of the
port's own, with no counterpart in the reference: DeepSeek-V2's block as
the policy core ("deepseek_v2_lite", models/deepseek_v2.py: latent
attention over a rolling latent cache, a dropless MoE with shared
experts), whose defaults are DeepSeek-V2-Lite's published widths and
whose `num_layers`, `experts_held` and `memory_len` kwargs cut it.
Unlike flax, a torch module sizes its first layer at construction, so
the frame shape ([H, W, C]) is an argument. `dtype` (the trunk's compute
dtype) and `head_dtype` (the core's and heads') come from the precision
policy (torchbeast_tpu_torch/precision.py). The remat levers
(runtime/remat_plan.py model_kwargs: `remat` of the deep trunk and the
transformer families, `core_remat` of the LSTM core) pass through
`kwargs` to the model, and so do the transformer's `num_experts` and
`moe_top_k` (models/moe.py), which only deepseek_v2_lite also takes.
"""

import torch

from torchbeast_tpu_torch.models.atari_net import AtariNet  # noqa: F401
from torchbeast_tpu_torch.models.cores import LSTMCore  # noqa: F401
from torchbeast_tpu_torch.models.deepseek_v2 import (  # noqa: F401
    DeepSeekV2Net,
)
from torchbeast_tpu_torch.models.mlp import MLPNet  # noqa: F401
from torchbeast_tpu_torch.models.pipelined import (  # noqa: F401
    PipelinedMLPNet,
)
from torchbeast_tpu_torch.models.resnet import ResNet  # noqa: F401
from torchbeast_tpu_torch.models.transformer import (  # noqa: F401
    TransformerNet,
)
from torchbeast_tpu_torch.models.transformer_pp import (  # noqa: F401
    PipelinedTransformerNet,
)

_REGISTRY = {
    "shallow": AtariNet,
    "atari": AtariNet,
    "deep": ResNet,
    "resnet": ResNet,
    "mlp": MLPNet,
    "pipelined_mlp": PipelinedMLPNet,
    "transformer": TransformerNet,
    "pipelined_transformer": PipelinedTransformerNet,
    "deepseek_v2_lite": DeepSeekV2Net,
}

# Reference families the port does not have yet -> the ROADMAP item that
# brings each.
NOT_PORTED = {}


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
    if kwargs.get("num_experts") and cls not in (TransformerNet,
                                                  DeepSeekV2Net):
        raise ValueError(
            "--num_experts applies to --model transformer only (the "
            "conv/MLP families have no MoE formulation)"
        )
    if cls in (TransformerNet, PipelinedTransformerNet) and use_lstm:
        raise ValueError(
            "--use_lstm does not apply to the transformer family (its "
            "memory is the KV cache); drop the flag"
        )
    if cls is DeepSeekV2Net and use_lstm:
        raise ValueError(
            "--use_lstm does not apply to deepseek_v2_lite (its memory is "
            "the latent cache); drop the flag"
        )
    return cls(num_actions=num_actions, use_lstm=use_lstm,
               frame_shape=tuple(frame_shape), dtype=dtype,
               head_dtype=head_dtype, **kwargs)
