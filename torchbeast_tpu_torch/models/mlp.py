"""Small MLP policy for low-dimensional and tiny-frame envs (Catch, the
chaos harness's runs), the counterpart of torchbeast_tpu/models/mlp.py.

The frame is flattened in its own [H, W, C] order and scaled by 1/255,
then Dense layers of `hidden_sizes` (128, 128) with ReLU; the clipped
reward and the one-hot last action join the core input, and the shared
RecurrentPolicyHead (optional one-layer LSTM of width hidden + A + 1)
gives the policy and baseline. Submodule names follow the reference's
flax scopes (Dense_0, Dense_1, head.*), so weights.py converts its
params both ways; its fresh weights are flax's draw (models/layers.Dense).
`dtype` is the Dense layers' compute dtype, `head_dtype` the core's and
heads' (torchbeast_tpu_torch/precision.py). `core_remat` is the LSTM
core's remat lever (models/cores.LSTMCore.remat).
"""

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models.cores import (
    RecurrentPolicyHead,
    lstm_initial_state,
)
from torchbeast_tpu_torch.models.layers import Dense, linear


class MLPNet(nn.Module):
    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), dtype=torch.float32,
                 head_dtype=torch.float32,
                 hidden_sizes: Sequence[int] = (128, 128),
                 core_remat: bool = False):
        super().__init__()
        self.num_actions = num_actions
        self.use_lstm = use_lstm
        self.dtype, self.head_dtype = dtype, head_dtype
        self.hidden_sizes = tuple(hidden_sizes)
        width = int(np.prod(frame_shape))
        for i, size in enumerate(self.hidden_sizes):
            setattr(self, f"Dense_{i}", Dense(width, size))
            width = size
        self.head = RecurrentPolicyHead(
            self.core_size, num_actions, use_lstm,
            hidden_size=self.core_size, num_layers=1, dtype=head_dtype,
            remat=core_remat,
        )

    @property
    def core_size(self) -> int:
        # Last hidden layer + clipped reward + one-hot last action.
        return self.hidden_sizes[-1] + self.num_actions + 1

    def forward(self, inputs, core_state=(), sample_action: bool = True,
                generator=None):
        frame = inputs["frame"]
        T, B = frame.shape[:2]
        x = frame.reshape(T * B, -1).to(self.dtype) / 255.0
        for i in range(len(self.hidden_sizes)):
            x = F.relu(linear(getattr(self, f"Dense_{i}"), x, self.dtype))
        x = x.to(self.head_dtype)
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
        return lstm_initial_state(self.use_lstm, 1, self.core_size,
                                  batch_size, device)
