"""Deep residual-MLP policy with a stage-stacked torso (counterpart of
torchbeast_tpu/models/pipelined.py).

The reference keeps every stage's parameters as one stacked `[S, ...]`
leaf so that the tower can run as a pipeline over a `pipe` mesh axis;
without a mesh it runs the same parameters as a sequential loop over the
stages. So does this module: with `mesh` set (parallel/pp.set_pipeline)
the [T*B, d] tokens run through parallel/pp.pipeline_apply_multi, the
GPipe schedule over the mesh's pipe devices (k passes for k stages a
device); the stage count must be a multiple of the pipe axis. A batch
whose tokens do not divide into the microbatches (an acting step, a
small inference bucket) takes the sequential loop on the same params,
as in the reference; `last_pipelined` says which path the last forward
took.

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


def _pp():
    """parallel/pp.py, imported at first use: the parallel package
    imports the learner, which imports the models."""
    from torchbeast_tpu_torch.parallel import pp

    return pp


def _stage_fn(p, x, carry, shared):
    """One residual block on one stage's params `p` (the stacked leaves'
    slices, by name)."""
    h = layer_norm_of(x, p["ln_scale"], p["ln_bias"], LAYER_NORM_EPS)
    h = F.gelu(promoted_einsum("nd,df->nf", h, p["w_in"]) + p["b_in"],
               approximate="tanh")
    return x + (promoted_einsum("nf,fd->nd", h, p["w_out"])
                + p["b_out"]), carry


def check_pipe_axis(mesh, axis: str, depth: int, what: str,
                    note: str = "") -> None:
    """The reference's check that the tower's depth is a multiple of the
    pipe axis."""
    if mesh is not None and depth % mesh.shape[axis] != 0:
        raise ValueError(
            f"{what}={depth} must be a multiple of the "
            f"`{axis}` axis size {mesh.shape[axis]}{note}"
        )


class PipelinedMLPNet(nn.Module):
    """forward(inputs, core_state=(), sample_action=True, generator=None)
    -> (AgentOutput, new core_state), the interface of every family."""

    STAGE_PARAM_NAMES = (
        "ln_scale", "ln_bias", "w_in", "b_in", "w_out", "b_out",
    )

    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), num_stages: int = 4,
                 d_model: int = 128, dtype=torch.float32,
                 head_dtype=torch.float32, core_remat: bool = False,
                 mesh=None, pipe_axis: str = "pipe",
                 n_microbatches=None, batch_axis=None):
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
        self.last_pipelined = False
        _pp().set_pipeline(self, mesh, n_microbatches, batch_axis, pipe_axis)

    def check_pipe_axis(self):
        check_pipe_axis(self.mesh, self.pipe_axis, self.num_stages,
                        "num_stages", " (k stages per device run as k "
                        "pipeline passes)")

    def stage_params(self) -> dict:
        return {name: getattr(self, name)
                for name in self.STAGE_PARAM_NAMES}

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
        stacked = self.stage_params()
        self.check_pipe_axis()
        self.last_pipelined = self.mesh is not None and _pp().can_pipeline(
            self.mesh, T * B, self.pipe_axis, self.n_microbatches,
            self.batch_axis)
        if self.last_pipelined:
            x, _ = _pp().pipeline_apply_multi(
                _stage_fn, stacked, x, mesh=self.mesh, axis=self.pipe_axis,
                n_microbatches=self.n_microbatches,
                batch_axis=self.batch_axis)
        else:
            for s in range(self.num_stages):
                x, _ = _stage_fn({k: v[s] for k, v in stacked.items()}, x,
                                 None, None)
        x = layer_norm_of(x, self.final_scale, self.final_bias,
                          LAYER_NORM_EPS)
        return self.head(x, inputs["done"], core_state, T, B, sample_action,
                         generator)

    def initial_state(self, batch_size: int, device=None) -> Tuple:
        return lstm_initial_state(self.use_lstm, 1, self.d_model,
                                  batch_size, device)
