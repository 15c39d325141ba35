"""The layer-major LSTM core (models/cores.LSTMCore at f32) and the plain
version of its recurrence kernel (ops/lstm.lstm_layer_plain) against the
per-step formulation the core had before it went layer-major: every layer
stepped a time step at a time, the bias on the hidden-side product.

Only the order of summation differs, so forward values and every gradient
(of each parameter, of the state and of the layer's input product) agree
to f32 rounding. The kernels themselves run on the card only
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchbeast_tpu_torch import ops
from torchbeast_tpu_torch.models.cores import LSTMCore
from torchbeast_tpu_torch.ops import lstm

T, B = 6, 3

# f32 rounding over a few steps; the two forms sum in another order.
TOL = dict(rtol=1e-5, atol=1e-6)


def per_step_core(params, core_input, notdone, core_state, num_layers):
    """The core before it went layer-major: layer 0's input product for
    all steps, then each step through every layer, bias on the hidden
    side."""
    hs = list(core_state[0].unbind(0))
    cs = list(core_state[1].unbind(0))
    x_proj = F.linear(core_input, params["weight_ih_l0"])
    outputs = []
    for t in range(core_input.shape[0]):
        nd = notdone[t].unsqueeze(-1)
        y = None
        for layer in range(num_layers):
            h_l = hs[layer] * nd
            c_l = cs[layer] * nd
            gates = F.linear(
                h_l, params[f"weight_hh_l{layer}"],
                params[f"bias_hh_l{layer}"],
            ) + (x_proj[t] if layer == 0
                 else F.linear(y, params[f"weight_ih_l{layer}"]))
            i, f, g, o = gates.chunk(4, dim=-1)
            c_l = torch.sigmoid(f) * c_l + torch.sigmoid(i) * torch.tanh(g)
            h_l = torch.sigmoid(o) * torch.tanh(c_l)
            hs[layer], cs[layer] = h_l, c_l
            y = h_l
        outputs.append(y)
    return torch.stack(outputs), (torch.stack(hs), torch.stack(cs))


def per_step_layer(x_proj, notdone, h0, c0, weight_hh):
    """One layer of the same per-step form, its input product given."""
    h, c = h0, c0
    outputs = []
    for t in range(x_proj.shape[0]):
        nd = notdone[t].unsqueeze(-1)
        gates = F.linear(h * nd, weight_hh) + x_proj[t]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * (c * nd) + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outputs.append(h)
    return torch.stack(outputs), h, c


def _notdone(pattern, t=T, b=B, seed=0):
    """[t, b]: 0 where an episode ended before the step."""
    done = np.zeros((t, b), dtype=bool)
    if pattern == "first":
        done[0] = True
    elif pattern == "middle":
        done[t // 2, ::2] = True
    elif pattern == "last":
        done[-1, 1:] = True
    elif pattern == "all":
        done[:] = True
    elif pattern == "random":
        done = np.random.default_rng(seed).random((t, b)) < 0.3
    return torch.from_numpy(1.0 - done.astype(np.float32))


def _leaf(rng, shape, scale=0.5):
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)
    ).requires_grad_()


def _weights(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


PATTERNS = ["none", "first", "middle", "last", "all", "random"]
# (input width, hidden width, layers): the shallow network's core (fc 512
# + 6 actions + 1 reward in, 2 layers of 519) and the deep one's (256).
SIZES = [(519, 519, 2), (257, 256, 1)]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("size", SIZES, ids=["h519x2", "h256x1"])
def test_layer_major_core_matches_per_step_core(pattern, size):
    d, hidden, layers = size
    torch.manual_seed(0)
    core = LSTMCore(d, hidden, layers)
    assert core.fused and core.layer_major
    with torch.no_grad():
        for name, p in core.named_parameters():
            if name.startswith("bias"):
                p.normal_(0.0, 0.1)
    rng = np.random.default_rng(1)
    x = _leaf(rng, (T, B, d), 1.0)
    state = (_leaf(rng, (layers, B, hidden)), _leaf(rng, (layers, B, hidden)))
    notdone = _notdone(pattern)
    params = dict(core.named_parameters())

    got = core(x, notdone, state)
    want = per_step_core(params, x, notdone, state, layers)
    leaves = [x, *state, *params.values()]
    outs = []
    for out, (h, c) in (got, want):
        loss = sum((t * _weights(t.shape, 100 + i)).sum()
                   for i, t in enumerate((out, h, c)))
        outs.append((out, h, c, torch.autograd.grad(loss, leaves)))
    for g, w in zip(outs[0][:3], outs[1][:3]):
        torch.testing.assert_close(g, w, **TOL)
    names = ["x", "h0", "c0", *params]
    for name, g, w in zip(names, outs[0][3], outs[1][3]):
        torch.testing.assert_close(g, w, **TOL, msg=name)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("hidden", [519, 256])
def test_plain_layer_matches_per_step_layer(pattern, hidden):
    rng = np.random.default_rng(2)
    x_proj = _leaf(rng, (T, B, 4 * hidden), 1.0)
    h0, c0 = _leaf(rng, (B, hidden)), _leaf(rng, (B, hidden))
    w = _leaf(rng, (4 * hidden, hidden), hidden ** -0.5)
    notdone = _notdone(pattern, seed=3)
    leaves = [x_proj, h0, c0, w]
    results = []
    for fn in (lstm.lstm_layer, per_step_layer):
        h_seq, h_T, c_T = fn(x_proj, notdone, h0, c0, w)
        loss = sum((t * _weights(t.shape, 7 + i)).sum()
                   for i, t in enumerate((h_seq, h_T, c_T)))
        results.append((h_seq, h_T, c_T, torch.autograd.grad(loss, leaves)))
    for g, wt in zip(results[0][:3], results[1][:3]):
        torch.testing.assert_close(g, wt, **TOL)
    for name, g, wt in zip(["x_proj", "h0", "c0", "weight_hh"],
                           results[0][3], results[1][3]):
        torch.testing.assert_close(g, wt, **TOL, msg=name)


def test_acting_shape_without_a_gradient_matches():
    """T=1 under torch.no_grad, as an acting step runs the core."""
    torch.manual_seed(0)
    core = LSTMCore(519, 519, 2)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 32, 519)).astype(np.float32))
    state = tuple(torch.from_numpy(0.5 * rng.standard_normal(
        (2, 32, 519)).astype(np.float32)) for _ in range(2))
    notdone = _notdone("random", 1, 32)
    with torch.no_grad():
        got = core(x, notdone, state)
        want = per_step_core(dict(core.named_parameters()), x, notdone,
                             state, 2)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("dtype,remat,layer_major,fused", [
    (torch.float32, False, True, True),
    (torch.float32, True, True, False),
    (torch.bfloat16, False, False, False),
    (torch.bfloat16, True, False, False),
])
def test_the_path_is_fixed_at_build(dtype, remat, layer_major, fused):
    core = LSTMCore(8, 4, 2, dtype=dtype, remat=remat)
    assert (core.layer_major, core.fused) == (layer_major, fused)


def test_remat_steps_the_same_cell_bit_for_bit():
    """Under remat the layer-major core steps `lstm_cell`, checkpointed:
    the plain version's values and gradients exactly."""
    rng = np.random.default_rng(5)
    x = _leaf(rng, (T, B, 10), 1.0)
    notdone = _notdone("random", seed=6)
    runs = []
    for remat in (False, True):
        torch.manual_seed(0)
        core = LSTMCore(10, 7, 2, remat=remat)
        state = (torch.full((2, B, 7), 0.5), torch.full((2, B, 7), -0.5))
        out, (h, c) = core(x, notdone, state)
        loss = out.sum() + (h * 2).sum() + (c * 3).sum()
        runs.append((out, h, c, torch.autograd.grad(
            loss, [x, *core.parameters()])))
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0][3], runs[1][3]):
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(7)
    args = (_leaf(rng, (2, B, 16)), _notdone("none", 2),
            _leaf(rng, (B, 4)), _leaf(rng, (B, 4)), _leaf(rng, (16, 4)))
    before = ops.launch_counts()["lstm_layer"]
    got = lstm.lstm_layer(*args)
    want = lstm.lstm_layer_plain(*args)
    assert ops.launch_counts()["lstm_layer"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["x_rank", "x_width", "notdone", "h0",
                                  "weight", "dtype"])
def test_lstm_layer_rejects_bad_inputs(case):
    args = {"x_proj": torch.zeros(2, B, 16), "notdone": torch.ones(2, B),
            "h0": torch.zeros(B, 4), "c0": torch.zeros(B, 4),
            "weight_hh": torch.zeros(16, 4)}
    bad = {"x_rank": ("x_proj", torch.zeros(2, 16)),
           "x_width": ("x_proj", torch.zeros(2, B, 15)),
           "notdone": ("notdone", torch.ones(3, B)),
           "h0": ("h0", torch.zeros(B, 5)),
           "weight": ("weight_hh", torch.zeros(4, 16)),
           "dtype": ("c0", torch.zeros(B, 4, dtype=torch.float64))}[case]
    args[bad[0]] = bad[1]
    with pytest.raises(ValueError, match="lstm_layer"):
        lstm.lstm_layer(**args)
