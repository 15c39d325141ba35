"""Shallow Atari network, monobeast's default model (counterpart of
torchbeast_tpu/models/atari_net.py).

Conv 32x8/4 -> 64x4/2 -> 64x3/1 (VALID), fc 512, then the clipped reward
and the one-hot last action join the core input; the optional LSTM has 2
layers of width 512 + A + 1. Frames are read as NHWC (channels_last) and
the conv output is flattened in NHWC order, as the reference flattens.
Submodule names follow the reference's flax scopes (Conv_0, Dense_0,
head.policy, ...). `dtype` is the convs' and fc's compute dtype,
`head_dtype` the core's and heads' (torchbeast_tpu_torch/precision.py):
the fc output, the clipped reward and the one-hot action join the core
input in `head_dtype`, as in the reference.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models.cores import (
    RecurrentPolicyHead,
    lstm_initial_state,
)
from torchbeast_tpu_torch.models.layers import Conv, Dense, conv2d, linear


def _valid(n: int, k: int, s: int) -> int:
    return (n - k) // s + 1


class AtariNet(nn.Module):
    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), dtype=torch.float32,
                 head_dtype=torch.float32):
        super().__init__()
        H, W, C = frame_shape
        self.num_actions = num_actions
        self.use_lstm = use_lstm
        self.dtype, self.head_dtype = dtype, head_dtype
        self.Conv_0 = Conv(C, 32, 8, 4)
        self.Conv_1 = Conv(32, 64, 4, 2)
        self.Conv_2 = Conv(64, 64, 3, 1)
        for k, s in ((8, 4), (4, 2), (3, 1)):
            H, W = _valid(H, k, s), _valid(W, k, s)
        self.Dense_0 = Dense(H * W * 64, 512)
        self.head = RecurrentPolicyHead(
            self.core_output_size, num_actions, use_lstm,
            hidden_size=self.core_output_size, num_layers=2,
            dtype=head_dtype,
        )
        self.to(memory_format=torch.channels_last)

    @property
    def core_output_size(self) -> int:
        # fc output + clipped reward + one-hot last action.
        return 512 + self.num_actions + 1

    def forward(self, inputs, core_state=(), sample_action: bool = True,
                generator=None):
        frame = inputs["frame"]
        T, B = frame.shape[:2]
        x = frame.reshape((T * B,) + tuple(frame.shape[2:]))
        x = x.permute(0, 3, 1, 2).to(self.dtype) / 255.0
        for conv in (self.Conv_0, self.Conv_1, self.Conv_2):
            x = F.relu(conv2d(conv, x, self.dtype))
        x = x.permute(0, 2, 3, 1).reshape(T * B, -1)  # NHWC flatten
        x = F.relu(linear(self.Dense_0, x, self.dtype)).to(self.head_dtype)
        one_hot_last_action = F.one_hot(
            inputs["last_action"].reshape(T * B).long(), self.num_actions
        ).to(self.head_dtype)
        clipped_reward = torch.clamp(
            inputs["reward"].float(), -1, 1
        ).reshape(T * B, 1).to(self.head_dtype)
        core_input = torch.cat(
            [x, clipped_reward, one_hot_last_action], dim=-1
        )
        return self.head(core_input, inputs["done"], core_state, T, B,
                         sample_action, generator)

    def initial_state(self, batch_size: int, device=None) -> Tuple:
        return lstm_initial_state(
            self.use_lstm, 2, self.core_output_size, batch_size, device
        )
