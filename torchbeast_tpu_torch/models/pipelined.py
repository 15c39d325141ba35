"""Deep residual-MLP policy with a stage-stacked torso (counterpart of
torchbeast_tpu/models/pipelined.py, on one device).

The reference keeps every stage's parameters as one stacked `[S, ...]`
leaf so that the tower can shard over a `pipe` mesh axis; without a mesh
it runs the same parameters as a sequential loop over the stages, which
is what this module does. The GPipe schedule (the reference's
parallel/pp.py) is ROADMAP.md Queue 1 item 'pipeline parallel'.

Forward, as the reference's: the frame flattened in its [H, W, C] order,
cast to f32 and scaled by 1/255; the `encoder` Dense to d_model, plus the
`extras` Dense of the clipped reward and the one-hot last action; then
`num_stages` residual blocks x + Dense(d)(gelu(Dense(4d)(LN(x)))), gelu
the tanh form (flax's `nn.gelu`), LayerNorm with epsilon 1e-6; the final
LayerNorm (`final_scale`, `final_bias`); and the shared RecurrentPolicyHead
(optional one-layer LSTM of width d_model) in `head_dtype`.

Parameters, under the reference's names and in its layout: `encoder`,
`extras` (Linear layers, as weights.py maps Denses), the stacked
`ln_scale` [S, d], `ln_bias` [S, d], `w_in` [S, d, 4d], `b_in` [S, 4d],
`w_out` [S, 4d, d], `b_out` [S, d] (STAGE_PARAM_NAMES), `final_scale`,
`final_bias` and `head`. No stacked leaf is named `weight`, so weights.py
carries each across as it is.

Fresh weights are flax's (models/init.py): w_in and w_out are drawn by
`lecun_normal()` on the rank-3 leaf, whose leading stage axis flax counts
in the receptive field, so fan_in is S * d for w_in and S * 4d for w_out
(the init scale follows --pipeline_stages, as in the reference).

Precision: the trunk computes in f32 whatever `dtype` says, as the
reference's does (its frame is cast to f32, its Denses carry no dtype and
it never reads `dtype`). Under bf16_train the params are bf16-resident,
and each product runs in the promoted type of its operands, f32
(layers.promoted_einsum), as jax promotes f32 @ bf16. `dtype` is kept
for the registry's uniformity. `core_remat` is the LSTM core's remat
lever (models/cores.LSTMCore.remat).
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models import init
from torchbeast_tpu_torch.models.cores import (
    RecurrentPolicyHead,
    lstm_initial_state,
)
from torchbeast_tpu_torch.models.layers import (
    Dense,
    layer_norm_of,
    linear,
    promoted_einsum,
)

LAYER_NORM_EPS = 1e-6


class PipelinedMLPNet(nn.Module):
    """forward(inputs, core_state=(), sample_action=True, generator=None)
    -> (AgentOutput, new core_state), the interface of every family."""

    STAGE_PARAM_NAMES = (
        "ln_scale", "ln_bias", "w_in", "b_in", "w_out", "b_out",
    )

    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), num_stages: int = 4,
                 d_model: int = 128, dtype=torch.float32,
                 head_dtype=torch.float32, core_remat: bool = False):
        super().__init__()
        self.num_actions = num_actions
        self.use_lstm = use_lstm
        self.num_stages = num_stages
        self.d_model = d_model
        self.dtype = dtype
        S, d, ff = num_stages, d_model, 4 * d_model
        self.encoder = Dense(int(np.prod(frame_shape)), d)
        self.extras = Dense(1 + num_actions, d)
        self.ln_scale = nn.Parameter(torch.ones(S, d))
        self.ln_bias = nn.Parameter(torch.zeros(S, d))
        self.w_in = nn.Parameter(torch.empty(S, d, ff))
        self.b_in = nn.Parameter(torch.zeros(S, ff))
        self.w_out = nn.Parameter(torch.empty(S, ff, d))
        self.b_out = nn.Parameter(torch.zeros(S, d))
        self.final_scale = nn.Parameter(torch.ones(d))
        self.final_bias = nn.Parameter(torch.zeros(d))
        self.head = RecurrentPolicyHead(
            d, num_actions, use_lstm, hidden_size=d, num_layers=1,
            dtype=head_dtype, remat=core_remat,
        )
        init.lecun_normal_(self.w_in, S * d)
        init.lecun_normal_(self.w_out, S * ff)

    def _stage(self, s: int, x):
        """One residual block on stage s's slice of the stacked params."""
        h = layer_norm_of(x, self.ln_scale[s], self.ln_bias[s],
                          LAYER_NORM_EPS)
        h = F.gelu(promoted_einsum("nd,df->nf", h, self.w_in[s])
                   + self.b_in[s], approximate="tanh")
        return x + (promoted_einsum("nf,fd->nd", h, self.w_out[s])
                    + self.b_out[s])

    def forward(self, inputs, core_state=(), sample_action: bool = True,
                generator=None):
        frame = inputs["frame"]
        T, B = frame.shape[:2]
        x = linear(self.encoder, frame.reshape(T * B, -1).float() / 255.0)
        one_hot = F.one_hot(inputs["last_action"].reshape(T * B).long(),
                            self.num_actions).float()
        reward = torch.clamp(inputs["reward"].float(), -1, 1).reshape(
            T * B, 1)
        x = x + linear(self.extras, torch.cat([reward, one_hot], dim=-1))
        for s in range(self.num_stages):
            x = self._stage(s, x)
        x = layer_norm_of(x, self.final_scale, self.final_bias,
                          LAYER_NORM_EPS)
        return self.head(x, inputs["done"], core_state, T, B, sample_action,
                         generator)

    def initial_state(self, batch_size: int, device=None) -> Tuple:
        return lstm_initial_state(self.use_lstm, 1, self.d_model,
                                  batch_size, device)
