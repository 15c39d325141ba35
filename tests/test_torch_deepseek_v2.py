"""The port's DeepSeek-V2 family (torchbeast_tpu_torch/models/deepseek_v2.py,
models/moe.DroplessMoE) against the benchmark's plain reference
(portbench/reference/deepseek_v2_lite.py) on the CPU, at a small size with
seeded random weights: d 64, 4 heads, kv_lora 32, nope 16, rope 8, v 16,
8 experts with top-2, 4 held, 1 shared, T=6, B=3, M=8, with dones and a
partly valid cache. Also the YaRN frequencies and logit factor against
their formulas, the router (every pick kept, ties to the lower index),
the expert share, stepwise acting against the batch forward, monobeast's
flags, the check's readings through portbench's harness, and the summed
device regions through the host recorder.

Tolerances: the program and the reference compute in f32 on the CPU in
different orders (MLA absorbed against per-head keys and values formed
whole, sorted tile dispatch against a loop over experts), so values agree
to a few f32 ulps of their scale: rtol 1e-5, atol 1e-6 (1e-5 for the
gradients, sums over every token).
"""

import copy
import math
import types

import numpy as np
import pytest
import torch

from portbench import check, generate, harness
from portbench.reference import deepseek_v2_lite as ref
from torchbeast_tpu_torch import learner, marks, monobeast, telemetry
from torchbeast_tpu_torch.models import create_model, deepseek_v2, moe
from torchbeast_tpu_torch.telemetry import metrics
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

A, FRAME, T, B, M = 4, (4, 4, 2), 6, 3, 8
CPU = torch.device("cpu")
NET = dict(d_model=64, num_layers=3, first_dense=1, num_heads=4,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           kv_lora_rank=32, dense_width=96, num_experts=8, experts_held=4,
           top_k=2, expert_width=24, num_shared=1,
           routed_scaling_factor=1.0, aux_loss_alpha=0.001, memory_len=M,
           rope_theta=10000.0, rope_scaling=dict(deepseek_v2.YARN),
           rms_eps=1e-6)
# The same sizes as create_model kwargs; tiles of 4 rows, so an expert's
# picks span several tiles.
KW = dict(num_layers=3, first_dense=1, d_model=64, num_heads=4,
          qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
          kv_lora_rank=32, dense_width=96, num_experts=8, experts_held=4,
          moe_top_k=2, expert_width=24, num_shared=1, memory_len=M,
          tile_rows=4)
RTOL, ATOL = 1e-5, 1e-6


def _weights(seed, net=NET):
    return generate.weights(ref.param_shapes(net, FRAME, A), seed, CPU)


def _model(weights, **kw):
    model = create_model("deepseek_v2_lite", A, frame_shape=FRAME,
                         **{**KW, **kw})
    params = dict(model.named_parameters())
    assert set(params) == set(weights)
    with torch.no_grad():
        for k, v in weights.items():
            params[k].copy_(v)
    return model


def _inputs(seed, t=T):
    traffic = dict(unroll_length=t - 1, batch_size=B, rollouts=1,
                   done_probability=0.2, episode_step_high=100,
                   state_scale=0.5)
    batch = generate.rollouts(traffic, dict(num_actions=A,
                                            frame_shape=list(FRAME)),
                              seed, CPU)[0]
    batch["done"][2, 0] = True
    batch["done"][0, 1] = True
    state = list(generate.states(ref.state_shapes(NET, A, B), traffic, seed,
                                 CPU)[0])
    gen = torch.Generator().manual_seed(seed)
    for i in range(2, len(state), 3):  # a partly valid cache
        state[i] = state[i] * (torch.rand(M, B, generator=gen) < 0.7)
    return batch, tuple(state)


def test_parameter_tree_is_the_references():
    model = create_model("deepseek_v2_lite", A, frame_shape=FRAME, **KW)
    got = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    assert sorted(got) == sorted(ref.param_shapes(NET, FRAME, A))
    assert len(got) == 4 + 10 + 2 * 14 + 5


def test_each_expert_is_drawn_at_its_own_fan_in():
    """The held experts' leaves are matrices, [held * out, in], so the
    benchmark's draw (one normal scaled by 1/sqrt of a leaf's row width)
    gives every expert's gate and up 1/sqrt(d) and its down
    1/sqrt(expert_width), as the shared experts' Linears get; and the
    program's init draws them at the same fan-ins."""
    net = dict(NET, d_model=256, expert_width=384)
    w = generate.weights(ref.param_shapes(net, FRAME, A), 2, CPU)
    model = create_model("deepseek_v2_lite", A, frame_shape=FRAME,
                         **dict(KW, d_model=256, expert_width=384))
    params = dict(model.named_parameters())
    for name, fan_in in (("w_gate", 256), ("w_up", 256), ("w_down", 384)):
        drawn = w[f"layer_1.moe.{name}"]
        assert drawn.dim() == 2
        assert abs(float(drawn.std()) * math.sqrt(fan_in) - 1) < 0.01
        init_std = float(params[f"layer_1.moe.{name}"].detach().std())
        assert abs(init_std * math.sqrt(fan_in) - 1) < 0.05
    for name in ("gate", "up", "down"):
        shared = w[f"layer_1.moe.shared.{name}.weight"]
        routed = w[f"layer_1.moe.w_{name}"]
        assert abs(float(shared.std()) / float(routed.std()) - 1) < 0.02


def test_forward_matches_reference():
    """Logits, baseline, every layer's new latent state and the summed
    balance loss."""
    w = _weights(5)
    model = _model(w)
    batch, state = _inputs(5)
    with moe.recording_losses() as recorded, torch.no_grad():
        out, new_state = model(batch, state, sample_action=False)
        logits, baseline, ref_state, aux = ref.forward_with_aux(
            w, batch, state, NET, A)
    assert len(recorded) == 2
    torch.testing.assert_close(out.policy_logits, logits, rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(out.baseline, baseline, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(sum(recorded.values()), aux, rtol=RTOL,
                               atol=1e-9)
    assert float(aux) > 0
    assert len(new_state) == len(ref_state) == 9
    for got, want in zip(new_state, ref_state):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_every_gradient_matches_reference():
    """The gradient of every leaf of a loss over the logits, the baseline
    and the balance loss; the reference's `forward`, whose balance-loss
    gradient rides the logits, gives the same gradients."""
    w = _weights(6)
    model = _model(w)
    batch, state = _inputs(6)
    gen = torch.Generator().manual_seed(1)
    r1 = torch.randn(T, B, A, generator=gen)
    r2 = torch.randn(T, B, generator=gen)
    with moe.recording_losses() as recorded:
        out, _ = model(batch, state, sample_action=False)
    loss = ((out.policy_logits * r1).sum() + (out.baseline * r2).sum()
            + sum(recorded.values()))
    names = [n for n, _ in model.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    logits, baseline, _, aux = ref.forward_with_aux(wr, batch, state, NET, A)
    ref_loss = (logits * r1).sum() + (baseline * r2).sum() + aux
    want = dict(zip(wr, torch.autograd.grad(ref_loss, list(wr.values()))))
    logits, baseline = ref.forward(wr, batch, state, NET, A)
    hooked = dict(zip(wr, torch.autograd.grad(
        (logits * r1).sum() + (baseline * r2).sum(), list(wr.values()))))
    assert set(got) == set(want)
    for k in names:
        scale = max(float(want[k].abs().max()), 1e-3)
        torch.testing.assert_close(got[k] / scale, want[k] / scale,
                                   rtol=RTOL, atol=1e-5, msg=k)
        torch.testing.assert_close(hooked[k], want[k], rtol=1e-6,
                                   atol=1e-9, msg=k)
    # The balance loss reaches the routers.
    assert all(float(got[f"layer_{i}.moe.router.weight"].abs().sum()) > 0
               for i in (1, 2))


def test_acting_at_t1_equals_the_batch_forward():
    """T stepwise T=1 forwards, the state carried, give the batch
    forward's logits, baseline and final state."""
    model = _model(_weights(7))
    batch, state = _inputs(7)
    with torch.no_grad():
        out, batch_state = model(batch, state, sample_action=False)
        carry, logits, baseline = state, [], []
        for t in range(T):
            step = {k: v[t:t + 1] for k, v in batch.items()}
            o, carry = model(step, carry, sample_action=False)
            logits.append(o.policy_logits)
            baseline.append(o.baseline)
    torch.testing.assert_close(torch.cat(logits), out.policy_logits,
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(torch.cat(baseline), out.baseline,
                               rtol=RTOL, atol=ATOL)
    for got, want in zip(carry, batch_state):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _moe_layer(held, offset, router, experts, shared):
    layer = moe.DroplessMoE(16, 12, num_experts=8, top_k=3,
                            experts_held=held, expert_offset=offset,
                            num_shared=1, tile_rows=4)
    with torch.no_grad():
        layer.router.weight.copy_(router)
        for name, w in experts.items():
            getattr(layer, name).copy_(
                w[offset:offset + held].reshape(-1, w.shape[-1]))
        for name, w in shared.items():
            getattr(layer.shared, name).weight.copy_(w)
    return layer


def test_expert_share_halves_add_up_to_the_uncut_layer():
    """Two devices' halves (experts 0-3 and 4-7): their routed outputs,
    with the shared expert counted once, equal the reference layer that
    holds all 8."""
    gen = torch.Generator().manual_seed(3)
    router = torch.randn(8, 16, generator=gen)
    experts = {"w_gate": torch.randn(8, 12, 16, generator=gen) * 0.3,
               "w_up": torch.randn(8, 12, 16, generator=gen) * 0.3,
               "w_down": torch.randn(8, 16, 12, generator=gen) * 0.3}
    shared = {n: torch.randn(s, generator=gen) * 0.3 for n, s in
              (("gate", (12, 16)), ("up", (12, 16)), ("down", (16, 12)))}
    x = torch.randn(20, 16, generator=gen)
    low = _moe_layer(4, 0, router, experts, shared)
    high = _moe_layer(4, 4, router, experts, shared)
    with torch.no_grad():
        halves = low(x, sequences=4) + high(x, sequences=4) - low.shared(x)
    net = dict(num_experts=8, top_k=3, experts_held=8,
               routed_scaling_factor=1.0, aux_loss_alpha=0.001)
    p = {"l.moe.router.weight": router,
         **{f"l.moe.{k}": v.reshape(-1, v.shape[-1])
            for k, v in experts.items()},
         **{f"l.moe.shared.{k}.weight": v for k, v in shared.items()}}
    with torch.no_grad():
        whole, _ = ref._moe(p, "l.", x.view(5, 4, 16), net)
    torch.testing.assert_close(halves, whole.view(20, 16), rtol=RTOL,
                               atol=ATOL)


def test_router_keeps_every_pick_and_breaks_ties_by_index():
    """Every probability ties (a zero router): each token picks experts
    0 and 1, the lower indices, and the held expert 0 takes every token,
    so one expert's picks fill five tiles; none is dropped, and the
    output is the reference's."""
    layer = moe.DroplessMoE(16, 12, num_experts=8, top_k=2, experts_held=4,
                            num_shared=1, tile_rows=4)
    with torch.no_grad():
        layer.router.weight.zero_()
    x = torch.randn(18, 16, generator=torch.Generator().manual_seed(4))
    probs, gate, idx = layer.route(x)
    assert (idx == torch.tensor([0, 1])).all()
    assert torch.equal(ref._top_k(probs, 2), idx)
    row_token, row_gate, tile_expert, counts = layer.dispatch(idx, gate)
    assert counts.tolist() == [18, 18, 0, 0]
    assert int((row_gate > 0).sum()) == 36  # every pick has its row
    assert sorted(row_token[row_gate > 0].tolist()) == sorted(
        list(range(18)) * 2)
    assert tile_expert.tolist()[:10] == [0] * 5 + [1] * 5
    assert layer.tiles(18) * 4 == row_token.numel()
    net = dict(num_experts=8, top_k=2, experts_held=4,
               routed_scaling_factor=1.0, aux_loss_alpha=0.001)
    p = {"l.moe.router.weight": layer.router.weight,
         "l.moe.w_gate": layer.w_gate, "l.moe.w_up": layer.w_up,
         "l.moe.w_down": layer.w_down,
         **{f"l.moe.shared.{k}.weight": getattr(layer.shared, k).weight
            for k in ("gate", "up", "down")}}
    with torch.no_grad():
        whole, _ = ref._moe(p, "l.", x.view(6, 3, 16), net)
        torch.testing.assert_close(layer(x, sequences=3),
                                   whole.view(18, 16), rtol=RTOL, atol=ATOL)


def test_yarn_frequencies_and_logit_factor_follow_their_formulas():
    y = deepseek_v2.YARN
    got = deepseek_v2.yarn_inv_freq(64, 1e4, y["factor"],
                                    y["original_max_position_embeddings"],
                                    y["beta_fast"], y["beta_slow"])

    def dim_of(rotations):  # YaRN's correction dimension
        return 64 * math.log(4096 / (rotations * 2 * math.pi)) / (
            2 * math.log(1e4))

    low, high = math.floor(dim_of(32)), math.ceil(dim_of(1))
    want = []
    for i in range(32):
        theta = 1e4 ** (-2 * i / 64)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(theta / 40 * ramp + theta * (1 - ramp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    torch.testing.assert_close(ref.inv_freq(dict(NET, qk_rope_head_dim=64)),
                               got, rtol=0, atol=0)
    assert (low, high) == (10, 23)
    factor = (0.1 * 0.707 * math.log(40) + 1) ** 2
    model = create_model("deepseek_v2_lite", A, frame_shape=FRAME, **KW)
    assert model.softmax_scale == pytest.approx(24 ** -0.5 * factor,
                                                rel=1e-12)
    assert ref.softmax_scale(dict(NET, qk_nope_head_dim=128,
                                  qk_rope_head_dim=64)) == pytest.approx(
        192 ** -0.5 * factor, rel=1e-12)


def test_yarn_frequencies_match_transformers():
    """The installed transformers' own YaRN (read, not imported by the
    port) at DeepSeek-V2-Lite's rope_scaling."""
    rope_utils = pytest.importorskip("transformers.modeling_rope_utils")
    config = types.SimpleNamespace(
        rope_theta=1e4, hidden_size=2048, num_attention_heads=16,
        head_dim=64, max_position_embeddings=163840,
        rope_scaling=dict(deepseek_v2.YARN, type="yarn"))
    theirs, attention_factor = rope_utils._compute_yarn_parameters(config,
                                                                   CPU)
    ours = deepseek_v2.yarn_inv_freq(
        64, 1e4, 40.0, 4096, 32.0, 1.0)
    torch.testing.assert_close(ours, theirs, rtol=1e-6, atol=0)
    assert attention_factor == pytest.approx(1.0)  # mscale == mscale_all_dim


def test_forward_flops_counts_the_absorbed_form():
    """The cell's forward FLOPs a frame, by hand from the published
    widths."""
    net = dict(NET, d_model=2048, num_layers=5, num_heads=16,
               qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
               kv_lora_rank=512, dense_width=10944, num_experts=64,
               experts_held=32, top_k=6, expert_width=1408, num_shared=2,
               memory_len=1024)
    d = 2048
    mla = 2 * (d * 16 * 192 + d * 576 + 16 * 128 * 512 + 16 * 1025 * 576
               + 16 * 1025 * 512 + 16 * 512 * 128 + 16 * 128 * d)
    moe_layer = 2 * (d * 64 + 3 * 3 * d * 1408 + 3 * d * 2816)
    want = (2 * d * (84 * 84 * 4 + 7) + 5 * mla + 2 * 3 * d * 10944
            + 4 * moe_layer + 2 * d * 7)
    assert ref.forward_flops(net, (84, 84, 4), 6) == want
    shapes = ref.param_shapes(net, (84, 84, 4), 6)
    assert len(shapes) == 75
    assert sum(math.prod(s) for _, s in shapes) == 1_370_939_911


def _tiny_flags(*extra):
    return monobeast.make_parser().parse_args([
        "--disable_cuda", "--model", "deepseek_v2_lite", "--num_layers",
        "3", "--experts_held", "4", "--memory_len", str(M), "--vtrace_impl",
        "pallas", "--opt_impl", "pallas", "--unroll_length", str(T - 1),
        "--batch_size", str(B), *extra])


@pytest.fixture
def tiny_widths(monkeypatch):
    """monobeast's create_model with the test's small widths: the flags
    set the cut, the published widths are too large for a CPU test."""
    real = monobeast.create_model

    def small(name, **kw):
        assert name == "deepseek_v2_lite"
        return real(name, **{**KW, **kw})

    monkeypatch.setattr(monobeast, "create_model", small)


def test_flags_build_the_cut_and_one_learner_update_runs(tiny_widths):
    flags = _tiny_flags()
    model = monobeast.build_model(flags, A, FRAME, CPU)
    assert model.num_layers == 3 and model.memory_len == M
    assert model.layer_1.moe.experts_held == 4
    assert model.layer_1.moe.num_experts == 8
    hp = monobeast.hparams_from_flags(flags)
    optimizer = learner.make_optimizer(hp, list(model.parameters()))
    step = learner.make_update_dispatch(model, optimizer, hp)
    batch, state = _inputs(8)
    stats = step(batch, state)
    assert float(stats["aux_loss"]) > 0
    assert math.isfinite(float(stats["total_loss"]))
    with pytest.raises(ValueError, match="transformer"):
        monobeast.build_model(_tiny_flags("--num_experts", "8"), A, FRAME,
                              CPU)
    with pytest.raises(ValueError, match="deepseek_v2_lite only"):
        monobeast._deepseek_cut(monobeast.make_parser().parse_args(
            ["--model", "deep", "--num_layers", "3"]))
    with pytest.raises(ValueError, match="use_lstm"):
        create_model("deepseek_v2_lite", A, use_lstm=True, **KW)


def test_checked_updates_match_the_reference_through_the_harness(
        tiny_widths):
    """The benchmark's check at a small size on the CPU: the program
    built by portbench.harness from the configuration's flags, its three
    checked updates against the reference's, every number far under its
    limit."""
    from portbench import cells

    cell = cells.load("v2lite.learn")
    config = copy.deepcopy(cell.config)
    config["net"] = dict(NET)
    config["argv"] = [a if a not in ("5", "32", "1024") else
                      {"5": "3", "32": "4", "1024": str(M)}[a]
                      for a in config["argv"]]
    config["frame_shape"] = list(FRAME)
    config["num_actions"] = A
    traffic = dict(cell.traffic, unroll_length=T - 1, batch_size=B)
    with harness.configured(config):
        found = harness.program_readings(
            harness.build(config, traffic, 11, CPU))
    ref_readings = check.reference_readings(config, traffic, 11, CPU)
    gaps = check.gaps(found, ref_readings, config["leaf_groups"])
    for number in ("grad_gap", "grad_err", "step_gap", "change_gap"):
        assert gaps[number] < 1e-4, (number, gaps)
    # The reference's loss value leaves the balance loss out (its
    # gradient rides the logits): the first losses differ by it alone.
    net = config["net"]
    shapes = ref.param_shapes(net, FRAME, A)
    batch = generate.rollouts(traffic, config, 11, CPU)[0]
    state = generate.states(ref.state_shapes(net, A, B), traffic, 11,
                            CPU)[0]
    with torch.no_grad():
        aux = ref.forward_with_aux(generate.weights(shapes, 11, CPU), batch,
                                   state, net, A)[3]
    assert float(aux) > 0
    assert abs(found[0][0] - ref_readings[0][0] - float(aux)) < 1e-5 * abs(
        ref_readings[0][0])
    assert set(gaps) >= {f"grad_err.{g}" for g in config["leaf_groups"]}


@pytest.fixture
def telemetry_on():
    was = telemetry.is_enabled()
    telemetry.set_enabled(True)
    yield
    telemetry.set_enabled(was)


def _host_update(model, acc):
    """One eager update of `model` under a HostRecorder on `acc`."""
    hp = learner.HParams(unroll_length=T - 1, batch_size=B)
    optimizer = learner.make_optimizer(hp, list(model.parameters()))
    step = learner.update_body(model, optimizer, hp)
    recorder = marks.HostRecorder(acc)
    batch, state = _inputs(9)
    with marks.recording(recorder):
        step(batch, state)
    return recorder


def test_summed_regions_fold_one_sum_an_update(telemetry_on):
    """A summed region entered five times in an update folds once, the
    sum of its five intervals, forward and back; the boundary regions
    read as before."""
    acc = marks.Accumulator(CPU)
    recorder = marks.HostRecorder(acc)
    registry = metrics.MetricsRegistry()
    x = torch.ones(3, requires_grad=True)
    with marks.recording(recorder):
        marks.stamp(marks.START)
        y = x
        spans = []
        for _ in range(5):
            y = marks.region_in(y, marks.MLA)
            t0 = int(acc.slots[marks.entered_slot(0)])
            y = y * 2.0
            y = marks.region_out(y, marks.MLA)
            spans.append(int(acc.slots[marks.summed_slot(0)]))
            assert int(acc.slots[marks.entered_slot(0)]) == t0
        marks.stamp(marks.BACKWARD)
        y.sum().backward()
        marks.stamp(marks.STEP)
        marks.stamp(marks.END)
    assert spans == sorted(spans) and spans[0] > 0
    acc.collect(registry)
    snap = telemetry.snapshot(registry)["histograms"]
    fwd = snap["learner.device.mla_fwd_s"]
    bwd = snap["learner.device.mla_bwd_s"]
    assert fwd["count"] == 1 and bwd["count"] == 1
    assert fwd["total"] == pytest.approx(spans[-1] * 1e-9)
    assert bwd["total"] > 0
    # The boundary regions: start to backward, backward to step, opt.
    assert {"learner.device.start_backward_s", "learner.device.update_s",
            "learner.device.opt_s"} <= set(snap)
    assert "learner.device.moe_fwd_s" not in snap


def test_model_update_folds_mla_moe_and_the_peak_load(telemetry_on):
    """An eager update of the family under the host recorder: the MLA and
    MoE regions, forward and back, one observation each an update
    beside the trunk's; the peak expert load an update (>= 1)."""
    model = _model(_weights(9))
    acc = marks.Accumulator(CPU)
    for _ in range(2):
        _host_update(model, acc)
    registry = metrics.MetricsRegistry()
    acc.collect(registry)
    snap = telemetry.snapshot(registry)["histograms"]
    for name in ("mla_fwd", "mla_bwd", "moe_fwd", "moe_bwd", "trunk_fwd",
                 "trunk_bwd", "loss_fwd", "loss_bwd", "opt"):
        assert snap[f"learner.device.{name}_s"]["count"] == 2, name
    trunk = snap["learner.device.trunk_fwd_s"]["total"]
    inner = sum(snap[f"learner.device.{n}_fwd_s"]["total"]
                for n in ("mla", "moe"))
    assert 0 < inner < trunk
    load = snap["learner.moe.peak_load"]
    assert load["count"] == 2 and 1.0 <= load["max"] <= 4.0
