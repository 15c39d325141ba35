"""One LSTM layer's recurrence over every step, for the layer-major core
(models/cores.LSTMCore).

The reference has no kernel here: its core is flax's OptimizedLSTMCell
under lax.scan, left to XLA. `lstm_layer` takes a layer's input
projection for every step (bias included) and runs the recurrence:

- CPU: `lstm_layer_plain`, the cell stepped in PyTorch (`lstm_cell`);
- CUDA: `csrc/lstm.cu`, one launch a step forward (`lstm_step_fwd_kernel`)
  and one a step back (`lstm_step_bwd_kernel`), through `_LSTMLayer`. What
  is off the recurrence runs once for all steps, as plain products: the
  weight gradient sum_t dgates_t^T (h_{t-1} * nd_t) as one product over
  [4H, T * B] x [T * B, H], and d h0 from the last step's dgates.

All f32: the core takes this path only at an f32 compute dtype.
"""

import torch
import torch.nn.functional as F

from torchbeast_tpu_torch.ops import _build
from torchbeast_tpu_torch.ops._route import (
    add_counts,
    note_bytes,
    require,
    use_kernel,
)


def lstm_cell(x_proj_t, notdone_t, h, c, weight_hh):
    """One step: (x_proj_t [B, 4H], notdone_t [B], h, c [B, H], weight_hh
    [4H, H]) -> (h, c). The carried state is zeroed where notdone_t is 0;
    gates in torch's i, f, g, o order."""
    nd = notdone_t.unsqueeze(-1)
    gates = x_proj_t + F.linear(h * nd, weight_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * (c * nd) + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_layer_plain(x_proj, notdone, h0, c0, weight_hh):
    """The plain PyTorch version of the kernels: `lstm_cell` stepped over
    the T steps of x_proj."""
    h, c = h0, c0
    hs = []
    for t in range(x_proj.shape[0]):
        h, c = lstm_cell(x_proj[t], notdone[t], h, c, weight_hh)
        hs.append(h)
    return torch.stack(hs), h, c


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(x_proj, notdone, h0, c0, weight_hh, keep_gates):
    """The T forward launches: (h_seq, h_T, c_T, c_seq, gates or None)."""
    T, B, H4 = x_proj.shape
    h_seq = x_proj.new_empty((T, B, H4 // 4))
    c_seq = torch.empty_like(h_seq)
    gates = torch.empty_like(x_proj) if keep_gates else None
    h_T, c_T = torch.empty_like(h0), torch.empty_like(c0)
    with torch.cuda.device(x_proj.device):
        status = _build.library().tbt_lstm_fwd(
            x_proj.data_ptr(), notdone.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), weight_hh.data_ptr(), h_seq.data_ptr(),
            c_seq.data_ptr(), None if gates is None else gates.data_ptr(),
            h_T.data_ptr(), c_T.data_ptr(), T, B, H4 // 4, _stream(x_proj))
    _build.check(status, "lstm_layer")
    add_counts([(lstm_layer, "launches", T)])
    note_bytes(x_proj, notdone, h0, c0, weight_hh, h_seq, c_seq, gates, h_T,
               c_T)
    return h_seq, h_T, c_T, c_seq, gates


class _LSTMLayer(torch.autograd.Function):
    """The kernels' forward and backward; `d x_proj` is dgates itself."""

    @staticmethod
    def forward(ctx, x_proj, notdone, h0, c0, weight_hh):
        h_seq, h_T, c_T, c_seq, gates = _forward(
            x_proj, notdone, h0, c0, weight_hh, keep_gates=True)
        ctx.save_for_backward(notdone, h0, c0, weight_hh, h_seq)
        ctx.c_seq, ctx.gates = c_seq, gates
        ctx.set_materialize_grads(False)
        return h_seq, h_T, c_T

    @staticmethod
    def backward(ctx, dh_seq, dh_T, dc_T):
        notdone, h0, c0, weight_hh, h_seq = ctx.saved_tensors
        c_seq, gates = ctx.c_seq, ctx.gates
        T, B, H = h_seq.shape
        dc = (torch.zeros_like(c0) if dc_T is None
              else dc_T.contiguous().clone())
        dh_seq = None if dh_seq is None else dh_seq.contiguous()
        dh_T = None if dh_T is None else dh_T.contiguous()
        dgates = torch.empty_like(gates)
        with torch.cuda.device(gates.device):
            status = _build.library().tbt_lstm_bwd(
                notdone.data_ptr(), weight_hh.data_ptr(), gates.data_ptr(),
                c_seq.data_ptr(), c0.data_ptr(),
                None if dh_seq is None else dh_seq.data_ptr(),
                None if dh_T is None else dh_T.data_ptr(), dc.data_ptr(),
                dgates.data_ptr(), T, B, H, _stream(gates))
        _build.check(status, "lstm_layer")
        add_counts([(lstm_layer, "launches", T)])
        note_bytes(notdone, weight_hh, gates, c_seq, c0, dh_seq, dh_T, dc,
                   dgates)
        nd = notdone.unsqueeze(-1)
        dh0 = dw = None
        if ctx.needs_input_grad[2]:
            dh0 = (dgates[0] @ weight_hh) * nd[0]
        if ctx.needs_input_grad[4]:
            h_prev = torch.cat([h0.unsqueeze(0), h_seq[:-1]]) * nd
            dw = dgates.reshape(T * B, 4 * H).t() @ h_prev.reshape(T * B, H)
        return (dgates, None, dh0, dc if ctx.needs_input_grad[3] else None,
                dw)


def lstm_layer(x_proj, notdone, h0, c0, weight_hh):
    """One LSTM layer over T steps. x_proj [T, B, 4H]: the layer's input
    product for every step, bias included; notdone [T, B]: 0 where the
    carried state resets before the step; h0, c0 [B, H]; weight_hh
    [4H, H]; all f32. Returns (h_seq [T, B, H], h_T, c_T).

    A CUDA tensor launches csrc/lstm.cu (T launches forward and, under a
    gradient, T back, counted in `lstm_layer.launches`); a CPU tensor
    takes `lstm_layer_plain`."""
    name = "lstm_layer"
    require(x_proj.dim() == 3 and x_proj.shape[-1] % 4 == 0, name,
            f"x_proj must be [T, B, 4H], got {tuple(x_proj.shape)}")
    T, B, H4 = x_proj.shape
    H = H4 // 4
    for what, t, shape in (("notdone", notdone, (T, B)), ("h0", h0, (B, H)),
                           ("c0", c0, (B, H)),
                           ("weight_hh", weight_hh, (H4, H))):
        require(tuple(t.shape) == shape, name,
                f"{what} {tuple(t.shape)} must be {shape}")
        require(t.dtype == torch.float32, name, f"{what} dtype {t.dtype}: f32")
        require(t.device == x_proj.device, name, "inputs on two devices")
    require(x_proj.dtype == torch.float32, name,
            f"x_proj dtype {x_proj.dtype}: f32")
    if not use_kernel(x_proj, name):
        return lstm_layer_plain(x_proj, notdone, h0, c0, weight_hh)
    args = [t.contiguous() for t in (x_proj, notdone, h0, c0, weight_hh)]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj, h0, c0, weight_hh)):
        return _LSTMLayer.apply(*args)
    return _forward(*args, keep_gates=False)[:3]


lstm_layer.launches = 0
