"""Recurrent core and policy head (counterpart of
torchbeast_tpu/models/cores.py).

Core state layout matches the reference: a tuple `(h, c)`, each
`[num_layers, B, hidden_size]`, f32 at the module boundary whatever the
compute dtype.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch import marks
from torchbeast_tpu_torch.models import init
from torchbeast_tpu_torch.models.layers import Dense, checkpointed, linear
from torchbeast_tpu_torch.ops.lstm import lstm_cell, lstm_layer
from torchbeast_tpu_torch.types import AgentOutput


class LSTMCore(nn.Module):
    """A stacked LSTM stepped over the time axis with episode-boundary
    reset: wherever an episode ended before step t (done), the carried
    state is zeroed before the step.

    Per layer l the parameters are `weight_ih_l{l}` [4H, D],
    `weight_hh_l{l}` [4H, H] and one bias `bias_hh_l{l}` [4H], gates in
    torch's i, f, g, o order. flax's OptimizedLSTMCell has a single bias
    (on the hidden-side kernels); a second, input-side bias would receive
    the same gradient and take twice the reference's bias step, so there
    is none.

    `dtype` is the compute dtype (--precision bf16_train: bf16). Input,
    carry, done mask and weights are cast to it, as the reference casts
    its scanned carry; the new state is upcast to f32, the core output
    stays in `dtype`.

    `remat` recomputes each time step's cell in the backward
    (models/layers.checkpointed, the reference's nn.remat around its
    scanned step): only the carried states and the step inputs are kept,
    the gate activations are recomputed. It is the `core` stage of the
    remat planner (runtime/remat_plan.py); the forward's values, the
    parameters and their names are the same either way.

    At f32 the core runs layer-major: each layer's input product for all
    steps at once, the bias with it (it takes the same gradient there),
    then the layer's recurrence, whose output is the next layer's input.
    Without remat that recurrence is `ops.lstm_layer`, the hand-written
    kernels on a card (`fused`); under remat it is the same cell stepped
    in PyTorch, each step checkpointed, since the kernels keep the gate
    activations for their backward. At any other compute dtype the core
    steps all layers a step at a time, as the reference scans. Both
    choices are fixed when the module is built.

    forward(core_input [T, B, D], notdone [T, B], (h, c)) ->
        (core_output [T, B, H], (h, c))
    """

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype
        self.remat = bool(remat)
        self.layer_major = dtype == torch.float32
        self.fused = self.layer_major and not self.remat
        for layer in range(num_layers):
            d = input_size if layer == 0 else hidden_size
            for name, shape in (
                (f"weight_ih_l{layer}", (4 * hidden_size, d)),
                (f"weight_hh_l{layer}", (4 * hidden_size, hidden_size)),
                (f"bias_hh_l{layer}", (4 * hidden_size,)),
            ):
                self.register_parameter(name, nn.Parameter(torch.empty(shape)))
        self.reset_parameters()

    def reset_parameters(self):
        """flax's OptimizedLSTMCell defaults: lecun_normal input kernels
        (each gate's fan_in is the layer's input width D), an orthogonal
        recurrent kernel per gate, zero biases."""
        for layer in range(self.num_layers):
            w_ih = getattr(self, f"weight_ih_l{layer}")
            init.lecun_normal_(w_ih, w_ih.shape[1])
            init.orthogonal_gates_(getattr(self, f"weight_hh_l{layer}"))
            nn.init.zeros_(getattr(self, f"bias_hh_l{layer}"))

    def forward(self, core_input, notdone, core_state):
        if self.layer_major:
            return self._layer_major(core_input.float(), notdone.float(),
                                     core_state)
        core_input = core_input.to(self.dtype)
        notdone = notdone.to(self.dtype)
        h, c = (s.to(self.dtype) for s in core_state)
        hs = list(h.unbind(0))
        cs = list(c.unbind(0))
        # Every weight in the compute dtype, once for all steps.
        w = {name: p.to(self.dtype) for name, p in self.named_parameters()}
        # Layer 0's input projection for every step in one product.
        x_proj = F.linear(core_input, w["weight_ih_l0"])
        outputs = []
        for t in range(core_input.shape[0]):
            if self.remat:
                y, *state = checkpointed(self._step, w, x_proj[t],
                                         notdone[t], *hs, *cs)
            else:
                y, *state = self._step(w, x_proj[t], notdone[t], *hs, *cs)
            hs = state[:self.num_layers]
            cs = state[self.num_layers:]
            outputs.append(y)
        return torch.stack(outputs), (torch.stack(hs).float(),
                                      torch.stack(cs).float())

    def _layer_major(self, x, notdone, core_state):
        hs, cs = [], []
        for layer, (h, c) in enumerate(zip(*core_state)):
            h, c = h.float(), c.float()
            # The weights in f32, whatever their resident dtype.
            w_ih, w_hh, bias = (getattr(self, f"{name}_l{layer}").float()
                                for name in ("weight_ih", "weight_hh",
                                             "bias_hh"))
            x_proj = F.linear(x, w_ih, bias)
            if self.fused:
                x, h, c = lstm_layer(x_proj, notdone, h, c, w_hh)
            else:
                steps = []
                for t in range(x_proj.shape[0]):
                    h, c = checkpointed(lstm_cell, x_proj[t], notdone[t], h,
                                        c, w_hh)
                    steps.append(h)
                x = torch.stack(steps)
            hs.append(h)
            cs.append(c)
        return x, (torch.stack(hs), torch.stack(cs))

    def _step(self, w, x_proj_t, notdone_t, *state):
        """One time step of every layer: (x_proj_t [B, 4H], notdone_t [B],
        h_0..h_{L-1}, c_0..c_{L-1}) -> (y, h_0.., c_0..)."""
        hs = list(state[:self.num_layers])
        cs = list(state[self.num_layers:])
        nd = notdone_t.unsqueeze(-1)
        y = None
        for layer in range(self.num_layers):
            h_l = hs[layer] * nd
            c_l = cs[layer] * nd
            gates = F.linear(
                h_l, w[f"weight_hh_l{layer}"], w[f"bias_hh_l{layer}"],
            ) + (
                x_proj_t if layer == 0
                else F.linear(y, w[f"weight_ih_l{layer}"])
            )
            i, f, g, o = gates.chunk(4, dim=-1)
            c_l = torch.sigmoid(f) * c_l + torch.sigmoid(i) * torch.tanh(g)
            h_l = torch.sigmoid(o) * torch.tanh(c_l)
            hs[layer], cs[layer] = h_l, c_l
            y = h_l
        return (y, *hs, *cs)


def lstm_initial_state(use_lstm: bool, num_layers: int, hidden_size: int,
                       batch_size: int, device=None) -> Tuple:
    """Zero (h, c) state, or () for feed-forward nets."""
    if not use_lstm:
        return ()
    shape = (num_layers, batch_size, hidden_size)
    return (
        torch.zeros(shape, device=device),
        torch.zeros(shape, device=device),
    )


class RecurrentPolicyHead(nn.Module):
    """Optional LSTM core + policy/baseline heads + action selection, the
    shared tail of every model family. Takes `[T*B, D]` core inputs and
    the `[T, B]` done mask; returns (AgentOutput with `[T, B, ...]`
    fields, new core state). `dtype` is the head's compute dtype (the
    core and the policy/baseline projections); logits and baseline are
    f32 at the head boundary under every policy. `remat` goes to the
    LSTM core (LSTMCore.remat; nothing without one)."""

    def __init__(self, input_size: int, num_actions: int, use_lstm: bool,
                 hidden_size: int, num_layers: int, dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.num_actions = num_actions
        self.use_lstm = use_lstm
        self.dtype = dtype
        if use_lstm:
            self.core = LSTMCore(input_size, hidden_size, num_layers, dtype,
                                 remat=remat)
            out = hidden_size
        else:
            out = input_size
        self.policy = Dense(out, num_actions)
        self.baseline = Dense(out, 1)

    def forward(self, core_input, done, core_state, T, B, sample_action,
                generator=None):
        # The trunk ends here and the core's output ends the core: device
        # marks of a recorded learner update (marks.py), forward and back.
        core_input = marks.boundary(core_input, marks.HEAD_IN,
                                    marks.HEAD_IN_GRAD)
        core_input = core_input.to(self.dtype)
        if self.use_lstm:
            notdone = 1.0 - done.float()
            core_output, core_state = self.core(
                core_input.reshape(T, B, -1), notdone, core_state
            )
            core_output = marks.boundary(core_output, marks.CORE_OUT,
                                         marks.CORE_OUT_GRAD)
            core_output = core_output.reshape(T * B, -1)
        else:
            core_output = core_input
            core_state = ()
        policy_logits = linear(self.policy, core_output, self.dtype).float()
        baseline = linear(self.baseline, core_output, self.dtype).float()
        if sample_action:
            action = torch.multinomial(
                F.softmax(policy_logits, dim=-1), 1, generator=generator
            ).squeeze(-1)
        else:
            action = torch.argmax(policy_logits, dim=-1)
        return (
            AgentOutput(
                action=action.reshape(T, B),
                policy_logits=policy_logits.reshape(T, B, self.num_actions),
                baseline=baseline.reshape(T, B),
            ),
            core_state,
        )
