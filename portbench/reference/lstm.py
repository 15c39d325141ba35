"""A stacked LSTM stepped over time with episode resets, in plain PyTorch.

Layer l holds `weight_ih_l{l}` [4H, D_l], `weight_hh_l{l}` [4H, H] and one
bias `bias_hh_l{l}` [4H], the gates in the order input, forget, cell,
output. At step t, wherever the frame starts an episode (notdone[t] = 0),
the carried h and c are zeroed before the step.
"""

import torch


def param_shapes(prefix: str, input_size: int, hidden: int, layers: int):
    shapes = []
    for layer in range(layers):
        d = input_size if layer == 0 else hidden
        shapes += [(f"{prefix}weight_ih_l{layer}", (4 * hidden, d)),
                   (f"{prefix}weight_hh_l{layer}", (4 * hidden, hidden)),
                   (f"{prefix}bias_hh_l{layer}", (4 * hidden,))]
    return shapes


def forward(params, prefix: str, x, notdone, state, layers: int):
    """x [T, B, D], notdone [T, B], state (h, c) each [layers, B, H] ->
    (outputs [T, B, H], (h, c))."""
    h = list(state[0].unbind(0))
    c = list(state[1].unbind(0))
    outputs = []
    for t in range(x.shape[0]):
        keep = notdone[t].unsqueeze(-1)
        y = x[t]
        for layer in range(layers):
            w_ih = params[f"{prefix}weight_ih_l{layer}"]
            w_hh = params[f"{prefix}weight_hh_l{layer}"]
            b = params[f"{prefix}bias_hh_l{layer}"]
            h_l, c_l = h[layer] * keep, c[layer] * keep
            gates = y @ w_ih.t() + h_l @ w_hh.t() + b
            i, f, g, o = gates.chunk(4, dim=-1)
            c_l = torch.sigmoid(f) * c_l + torch.sigmoid(i) * torch.tanh(g)
            h_l = torch.sigmoid(o) * torch.tanh(c_l)
            h[layer], c[layer] = h_l, c_l
            y = h_l
        outputs.append(y)
    return torch.stack(outputs), (torch.stack(h), torch.stack(c))
