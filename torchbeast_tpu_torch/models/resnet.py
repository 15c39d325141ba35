"""Deep IMPALA ResNet (counterpart of torchbeast_tpu/models/resnet.py).

Three sections of [3x3 conv -> 3x3/2 max-pool -> 2 residual double-conv
blocks] with 16/32/32 channels, fc to 256, the clipped reward appended to
the core input, optional 1-layer LSTM(256). Residual blocks use
pre-activation ordering (ReLU-conv-ReLU-conv, then add).

Inside the trunk tensors are NCHW in channels_last memory format, i.e.
physically NHWC as in the reference, which is also the layout the pool
backward kernel reads. The trunk output is flattened in NHWC order, as
the reference flattens, so the fc weight is the reference's kernel
transposed. Submodule names follow the reference's flax scopes
(trunk.feat_conv_0, trunk.res_0_0_conv1, ..., head.policy), which is what
`weights.py` maps between.

`dtype` is the trunk's compute dtype (convs, pool, fc) and `head_dtype`
the core's and heads' (torchbeast_tpu_torch/precision.py); the trunk's
output and the clipped reward are cast to `head_dtype`, as the reference
casts them. A bf16 trunk stays channels_last, so the pool backward
kernel keeps its 16-byte path.

Remat levers, as the reference's (runtime/remat_plan.py plans them):
`remat` on the trunk, one value for every stage or one per stage, each
False (keep every activation), True (recompute the whole stage in the
backward, keeping only its input) or "front" (recompute only the conv
and pool at the head of the stage, whose pre-pool output is the stage's
largest activation; the residual blocks' activations stay kept);
`core_remat` on the LSTM core (models/cores.LSTMCore.remat). A remat
region runs through models/layers.checkpointed: the parameters and their
names, and the forward's values, are the same under every plan, and under
torch.no_grad() no region is recomputed. A recomputed pool input is the
conv's output again, channels_last, so the pool backward kernel keeps its
16-byte path.
"""

from typing import Any, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models.cores import (
    RecurrentPolicyHead,
    lstm_initial_state,
)
from torchbeast_tpu_torch.models.layers import (
    Conv,
    Dense,
    checkpointed,
    conv2d,
    linear,
)
from torchbeast_tpu_torch.ops.pool import max_pool2d, pooled_size


def _stage_flags(remat, num_stages: int) -> Tuple:
    """`remat` (one value, or one per stage) -> one flag per stage, each
    checked as the reference checks it."""
    flags = (tuple(remat) if isinstance(remat, (tuple, list))
             else (remat,) * num_stages)
    if len(flags) != num_stages:
        raise ValueError(
            f"remat={remat!r} must have one flag per stage "
            f"({num_stages})"
        )
    for f in flags:
        if f not in (False, True, "front"):
            raise ValueError(
                f"remat flag {f!r} must be False, True, or 'front'"
            )
    return flags


class ResNetBase(nn.Module):
    """Conv trunk: [N, H, W, C] uint8 frames -> [N, 256] features.
    `remat`: see the module docstring."""

    def __init__(self, frame_shape, channels: Sequence[int] = (16, 32, 32),
                 dtype=torch.float32, out_dtype=torch.float32,
                 remat: Any = False):
        super().__init__()
        H, W, C = frame_shape
        self.channels = tuple(channels)
        self.dtype, self.out_dtype = dtype, out_dtype
        self.remat = _stage_flags(remat, len(self.channels))
        in_ch = C
        for i, ch in enumerate(self.channels):
            setattr(self, f"feat_conv_{i}", Conv(in_ch, ch, 3, 1, 1))
            for j in range(2):
                for k in (1, 2):
                    setattr(self, f"res_{i}_{j}_conv{k}",
                            Conv(ch, ch, 3, 1, 1))
            in_ch = ch
            H, W = pooled_size(H), pooled_size(W)
        self.fc = Dense(H * W * in_ch, 256)

    def _conv(self, name, x):
        return conv2d(getattr(self, name), x, self.dtype)

    def _stage_front(self, x, i: int):
        """conv + pool: the stage's only activation at its input's
        resolution."""
        return max_pool2d(self._conv(f"feat_conv_{i}", x))

    def _stage_rest(self, x, i: int):
        for j in range(2):
            res_input = x
            x = F.relu(x)
            x = self._conv(f"res_{i}_{j}_conv1", x)
            x = F.relu(x)
            x = self._conv(f"res_{i}_{j}_conv2", x)
            x = x + res_input
        return x

    def _stage(self, x, i: int):
        return self._stage_rest(self._stage_front(x, i), i)

    def forward(self, frames):
        N = frames.shape[0]
        # NHWC bytes viewed as NCHW: a channels_last tensor, no copy.
        x = frames.permute(0, 3, 1, 2).to(self.dtype) / 255.0
        for i, flag in enumerate(self.remat):
            if flag == "front":
                x = self._stage_rest(
                    checkpointed(self._stage_front, x, i), i)
            elif flag:
                x = checkpointed(self._stage, x, i)
            else:
                x = self._stage(x, i)
        x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(N, -1)  # NHWC flatten
        return F.relu(linear(self.fc, x, self.dtype)).to(self.out_dtype)


class ResNet(nn.Module):
    """forward(inputs, core_state=(), sample_action=True, generator=None)
    -> (AgentOutput, core_state); inputs is a dict of time-major tensors:
    frame [T, B, H, W, C] uint8, reward [T, B], done [T, B] bool.
    `remat` is the trunk's (ResNetBase), `core_remat` the LSTM core's."""

    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4),
                 trunk_channels: Sequence[int] = (16, 32, 32),
                 hidden_size: int = 256, dtype=torch.float32,
                 head_dtype=torch.float32, remat: Any = False,
                 core_remat: bool = False):
        super().__init__()
        self.use_lstm = use_lstm
        self.hidden_size = hidden_size
        self.head_dtype = head_dtype
        self.trunk = ResNetBase(frame_shape, trunk_channels, dtype,
                                out_dtype=head_dtype, remat=remat)
        self.head = RecurrentPolicyHead(
            256 + 1, num_actions, use_lstm, hidden_size, num_layers=1,
            dtype=head_dtype, remat=core_remat,
        )
        self.to(memory_format=torch.channels_last)

    def forward(self, inputs, core_state=(), sample_action: bool = True,
                generator=None):
        frame = inputs["frame"]
        T, B = frame.shape[:2]
        x = self.trunk(frame.reshape((T * B,) + tuple(frame.shape[2:])))
        clipped_reward = torch.clamp(
            inputs["reward"].float(), -1, 1
        ).reshape(T * B, 1).to(self.head_dtype)
        core_input = torch.cat([x, clipped_reward], dim=-1)
        return self.head(core_input, inputs["done"], core_state, T, B,
                         sample_action, generator)

    def initial_state(self, batch_size: int, device=None) -> Tuple:
        return lstm_initial_state(
            self.use_lstm, 1, self.hidden_size, batch_size, device
        )
