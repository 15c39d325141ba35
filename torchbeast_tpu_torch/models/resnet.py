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

The reference rematerializes each trunk stage in the backward (flax
nn.remat) to fit a 16 GB TPU; the port keeps every activation: T=80,
B=32 fits the H100's 80 GB without it.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models.cores import (
    RecurrentPolicyHead,
    lstm_initial_state,
)
from torchbeast_tpu_torch.models.layers import Conv, Dense, conv2d, linear
from torchbeast_tpu_torch.ops.pool import max_pool2d, pooled_size


class ResNetBase(nn.Module):
    """Conv trunk: [N, H, W, C] uint8 frames -> [N, 256] features."""

    def __init__(self, frame_shape, channels: Sequence[int] = (16, 32, 32),
                 dtype=torch.float32, out_dtype=torch.float32):
        super().__init__()
        H, W, C = frame_shape
        self.channels = tuple(channels)
        self.dtype, self.out_dtype = dtype, out_dtype
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

    def forward(self, frames):
        N = frames.shape[0]
        # NHWC bytes viewed as NCHW: a channels_last tensor, no copy.
        x = frames.permute(0, 3, 1, 2).to(self.dtype) / 255.0
        conv = lambda name, x: conv2d(getattr(self, name), x,  # noqa: E731
                                      self.dtype)
        for i in range(len(self.channels)):
            x = conv(f"feat_conv_{i}", x)
            x = max_pool2d(x)
            for j in range(2):
                res_input = x
                x = F.relu(x)
                x = conv(f"res_{i}_{j}_conv1", x)
                x = F.relu(x)
                x = conv(f"res_{i}_{j}_conv2", x)
                x = x + res_input
        x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(N, -1)  # NHWC flatten
        return F.relu(linear(self.fc, x, self.dtype)).to(self.out_dtype)


class ResNet(nn.Module):
    """forward(inputs, core_state=(), sample_action=True, generator=None)
    -> (AgentOutput, core_state); inputs is a dict of time-major tensors:
    frame [T, B, H, W, C] uint8, reward [T, B], done [T, B] bool."""

    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4),
                 trunk_channels: Sequence[int] = (16, 32, 32),
                 hidden_size: int = 256, dtype=torch.float32,
                 head_dtype=torch.float32):
        super().__init__()
        self.use_lstm = use_lstm
        self.hidden_size = hidden_size
        self.head_dtype = head_dtype
        self.trunk = ResNetBase(frame_shape, trunk_channels, dtype,
                                out_dtype=head_dtype)
        self.head = RecurrentPolicyHead(
            256 + 1, num_actions, use_lstm, hidden_size, num_layers=1,
            dtype=head_dtype,
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
