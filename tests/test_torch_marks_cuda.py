"""The learner update's device marks (torchbeast_tpu_torch/marks.py) in a
captured update on the card: IMPALA's deep network with its LSTM at the
learner's shape (T=80, B=32), captured by graphs.CapturedUpdate with
telemetry on and replayed. Every test needs a CUDA device and skips
without one; the module imports no jax, so on the GPU machine it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_marks_cuda.py
"""

import contextlib
import json
import threading
import urllib.request

import pytest
import torch

from torchbeast_tpu_torch import (graphs, learner, marks, profile_update,
                                  telemetry)
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.telemetry import metrics
from torchbeast_tpu_torch.utils import prof

pytestmark = pytest.mark.cuda

REPLAYS = 20
REGIONS = ["trunk_fwd", "core_fwd", "loss_fwd", "loss_bwd", "core_bwd",
           "trunk_bwd", "opt"]
ORDER = [marks.START, marks.HEAD_IN, marks.CORE_OUT, marks.BACKWARD,
         marks.CORE_OUT_GRAD, marks.HEAD_IN_GRAD, marks.STEP, marks.END]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the marks run only in a graph")
    return torch.device("cuda", 0)


def _dispatch(card, telemetry_on=True, k=1, **model_kw):
    """(instrumented dispatch, its CapturedUpdate, the static inputs): a
    deep + LSTM update (k > 1: a superstep of k) captured with telemetry
    on or off."""
    torch.manual_seed(0)
    model = create_model("deep", profile_update.NUM_ACTIONS, use_lstm=True,
                         **model_kw)
    model = model.to(card)
    hp = learner.HParams(unroll_length=profile_update.T,
                         batch_size=profile_update.B, vtrace_impl="pallas",
                         opt_impl="pallas")
    optimizer = learner.make_optimizer(hp, list(model.parameters()))
    graph = learner.make_update_dispatch(model, optimizer, hp, k=k)
    batch = profile_update.random_batch(0, card)
    state = model.initial_state(profile_update.B, card)
    if k > 1:
        batch = {key: torch.stack([v] * k) for key, v in batch.items()}
        state = tuple(torch.stack([s] * k) for s in state)
    was = telemetry.is_enabled()
    telemetry.set_enabled(telemetry_on)
    try:
        graph.capture(batch, state)
    finally:
        telemetry.set_enabled(was)
    step = learner.instrument_update_step(
        graph, registry=metrics.MetricsRegistry(), superstep_k=k)
    # The graph's own static buffers: a call copies nothing in.
    return step, graph, (graph._batch, graph._state)


def _device(snap):
    return {name[len("learner.device."):-2]: h for name, h in
            snap["histograms"].items() if name.startswith("learner.device.")}


def _traced(fn, tmp_path):
    """The chrome trace events of one call of fn() (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _kernels(events):
    """The device kernels' names, in the order they ran."""
    return [ev["name"] for ev in sorted(
        (ev for ev in events if ev.get("cat") == "kernel"),
        key=lambda ev: ev["ts"])]


def test_replays_fold_every_region_and_match_cuda_events(card):
    step, graph, inputs = _dispatch(card)
    before = _device(telemetry.snapshot())
    events = []
    for _ in range(REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(*inputs)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    after = _device(telemetry.snapshot())

    def new(name, key):
        return after[name][key] - before.get(name, {}).get(key, 0)

    # Only replays count: the capture's warm-ups run without marks.
    assert new("update", "count") == REPLAYS
    assert all(new(r, "count") == REPLAYS for r in REGIONS)
    assert new("gap", "count") >= REPLAYS - 1
    span = new("update", "total")
    assert sum(new(r, "total") for r in REGIONS) == pytest.approx(
        span, rel=0.01)
    timed = sum(s.elapsed_time(e) for s, e in events) / 1e3
    assert span == pytest.approx(timed, rel=0.03)
    print(f"update span {span / REPLAYS * 1e3:.3f} ms, CUDA events "
          f"{timed / REPLAYS * 1e3:.3f} ms; " + ", ".join(
              f"{r} {new(r, 'total') / REPLAYS * 1e3:.3f}" for r in REGIONS))


def test_a_replay_runs_every_mark_in_order(card, tmp_path):
    _, graph, inputs = _dispatch(card)
    events = _traced(lambda: graph(*inputs), tmp_path)
    names = _kernels(events)
    found = [(i, n) for i, n in enumerate(names) if "tbt_mark<" in n]
    order = [marks.mark_index(n) for _, n in found]
    assert order == ORDER
    assert found[0][0] == 0  # the update's first kernel
    # Every region holds work of its own.
    positions = [i for i, _ in found]
    assert all(b - a > 1 for a, b in zip(positions, positions[1:]))
    (update,) = marks.split_trace(events)
    assert sorted(update) == sorted(REGIONS)
    # Every kernel between the first mark and the last lies in a region
    # (beside the copies and sets, which are no kernels).
    inside = set(names[positions[0]:positions[-1]])
    assert set().union(*update.values()) & set(names) == {
        n for n in inside if marks.mark_index(n) is None}


def test_telemetry_off_captures_no_mark(card, tmp_path):
    _, graph, inputs = _dispatch(card, telemetry_on=False)
    names = _kernels(_traced(lambda: graph(*inputs), tmp_path))
    assert names and not any("tbt_mark" in n for n in names)


def test_profile_dir_trace_merges_dispatch_spans(card, tmp_path):
    step, _, inputs = _dispatch(card)
    step(*inputs)
    torch.cuda.synchronize()
    trace = prof.DeviceTrace(str(tmp_path))
    for _ in range(4):
        step(*inputs)
    torch.cuda.synchronize()
    with open(trace.stop()) as f:
        events = json.load(f)["traceEvents"]
    spans = [ev for ev in events if ev.get("name") == "learner.dispatch"]
    replays = [ev for ev in events if ev.get("name") == "graph.replay"]
    launches = [ev for ev in events if ev.get("cat") == "cuda_runtime"
                and "GraphLaunch" in ev.get("name", "")]
    assert len(spans) == len(replays) == len(launches) == 4
    for launch in launches:
        assert any(s["ts"] - 50 <= launch["ts"] and launch["ts"]
                   + launch["dur"] <= s["ts"] + s["dur"] + 50 for s in spans)
    assert len(profile_update.update_windows(events)) >= 2


def _replayed(step, inputs, replays):
    """{series: (new count, new total s)} over `replays` calls."""
    before = _device(telemetry.snapshot())
    for _ in range(replays):
        step(*inputs)
    torch.cuda.synchronize()
    after = _device(telemetry.snapshot())
    return {name: tuple(h[key] - before.get(name, {}).get(key, 0)
                        for key in ("count", "total"))
            for name, h in after.items()}


@pytest.mark.parametrize("k, model_kw", [
    (2, {}),
    (1, {"remat": (True, "front", True), "core_remat": True}),
], ids=["superstep_k2", "remat_trunk_and_core"])
def test_marks_in_order_under_a_superstep_and_a_remat_plan(card, tmp_path,
                                                           k, model_kw):
    """A K=2 superstep folds two updates a replay, and its gap once; a
    remat plan that recomputes the trunk and the core in the backward
    leaves the marks where they were, once each an update."""
    step, graph, inputs = _dispatch(card, k=k, **model_kw)
    names = _kernels(_traced(lambda: graph(*inputs), tmp_path))
    assert [marks.mark_index(n) for n in names
            if "tbt_mark<" in n] == ORDER * k
    new = _replayed(step, inputs, 5)
    assert new["update"][0] == 5 * k
    assert all(new[r][0] == 5 * k for r in REGIONS)
    assert new["gap"][0] == 5  # a dispatch's first update only
    assert sum(new[r][1] for r in REGIONS) == pytest.approx(
        new["update"][1], rel=0.01)


def test_metrics_scrapes_during_captures_leave_them_valid(card,
                                                         monkeypatch):
    """The drivers start the /metrics server before they capture; a
    scrape's snapshot runs the marks' collector, whose copy to the host
    would invalidate a capture open on the main thread. Scrape in a loop
    while three updates are captured."""
    _dispatch(card)  # the marks' collector is registered from here
    real, held_off = graphs.outside_capture, []

    @contextlib.contextmanager
    def counting():
        with real() as free:
            held_off.append(not free)
            yield free

    monkeypatch.setattr(graphs, "outside_capture", counting)
    server = telemetry.PrometheusServer(port=0).start()
    stop, scrapes, errors = threading.Event(), [], []

    def scrape():
        url = f"http://127.0.0.1:{server.port}/metrics"
        while not stop.is_set():
            try:
                with urllib.request.urlopen(url, timeout=60) as reply:
                    scrapes.append(reply.read())
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    thread = threading.Thread(target=scrape, daemon=True)
    thread.start()
    try:
        captured = [_dispatch(card) for _ in range(3)]
    finally:
        stop.set()
        thread.join(60)
        server.stop()
    assert not errors and scrapes
    assert any(held_off), "no scrape came while a capture was open"
    before = _device(telemetry.snapshot())
    for step, _, inputs in captured:
        step(*inputs)
    torch.cuda.synchronize()
    after = _device(telemetry.snapshot())
    assert after["update"]["count"] - before["update"]["count"] == 3


# A spin of about 0.1 ms at the H100's clocks (torch.cuda._sleep counts
# cycles).
SPIN = 200_000


def test_a_summed_region_folds_five_intervals_an_update(card):
    """A captured update that enters MLA five times around a spin and MOE
    once around a spin five times as long: each folds one observation a
    replay, the sum of its intervals, so the two read alike; the update's
    span holds both."""
    recorder = marks.device_recorder(card)
    x = torch.ones(1, device=card)

    def body():
        with marks.recording(recorder):
            marks.stamp(marks.START)
            for _ in range(5):
                marks.region_in(x, marks.MLA)
                torch.cuda._sleep(SPIN)
                marks.region_out(x, marks.MLA)
            marks.region_in(x, marks.MOE)
            torch.cuda._sleep(5 * SPIN)
            marks.region_out(x, marks.MOE)
            marks.stamp(marks.END)

    graph = torch.cuda.CUDAGraph()
    with graphs._capture_open(), torch.cuda.graph(graph):
        body()
    before = _device(telemetry.snapshot())
    for _ in range(REPLAYS):
        graph.replay()
    torch.cuda.synchronize()
    after = _device(telemetry.snapshot())

    def new(name, key):
        return after[name][key] - before.get(name, {}).get(key, 0)

    assert new("mla_fwd", "count") == new("moe_fwd", "count") == REPLAYS
    assert "mla_bwd" not in after or new("mla_bwd", "count") == 0
    mla, moe = new("mla_fwd", "total"), new("moe_fwd", "total")
    assert mla == pytest.approx(moe, rel=0.1)
    assert new("update", "count") == REPLAYS
    assert mla + moe < new("update", "total")
    print(f"mla {mla / REPLAYS * 1e3:.4f} ms (5 spans), moe "
          f"{moe / REPLAYS * 1e3:.4f} ms (1 span)")


def test_deepseek_update_folds_its_regions_in_the_graph(card):
    """The DeepSeek-V2 family at a small size (5 layers) in a captured
    update: MLA five times and MOE four times an update, forward and
    back, each one observation a replay, inside the trunk's regions; the
    boundary regions read as before; the peak expert load folds too. The
    captured update leaves the parameters an eager update leaves."""
    kw = dict(num_layers=5, d_model=64, num_heads=4, qk_nope_head_dim=16,
              qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
              dense_width=96, num_experts=8, experts_held=4, moe_top_k=2,
              expert_width=24, num_shared=1, memory_len=16, tile_rows=8)
    hp = learner.HParams(unroll_length=profile_update.T,
                         batch_size=profile_update.B, vtrace_impl="pallas",
                         opt_impl="pallas")
    torch.manual_seed(0)
    models = [create_model("deepseek_v2_lite", profile_update.NUM_ACTIONS,
                           device=card, **kw) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    batch = profile_update.random_batch(0, card)
    state = tuple(s.normal_() for s in models[0].initial_state(
        profile_update.B, card))
    steps = []
    for capture, model in zip((True, False), models):
        optimizer = learner.make_optimizer(hp, list(model.parameters()))
        steps.append(learner.make_update_dispatch(model, optimizer, hp,
                                                  capture=capture))
    was = telemetry.is_enabled()
    telemetry.set_enabled(True)
    try:
        steps[0].capture(batch, state)
    finally:
        telemetry.set_enabled(was)
    before = _device(telemetry.snapshot())
    load_before = telemetry.snapshot()["histograms"].get(
        "learner.moe.peak_load", {}).get("count", 0)
    steps[0](batch, state)
    steps[1](batch, state)
    torch.cuda.synchronize()
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    for _ in range(4):
        steps[0](batch, state)
    torch.cuda.synchronize()
    snap = telemetry.snapshot()
    after = _device(snap)

    def new(name, key):
        return after[name][key] - before.get(name, {}).get(key, 0)

    for name in ("mla_fwd", "mla_bwd", "moe_fwd", "moe_bwd", "trunk_fwd",
                 "trunk_bwd", "loss_fwd", "loss_bwd", "opt", "update"):
        assert new(name, "count") == 5, name
    assert (new("mla_fwd", "total") + new("moe_fwd", "total")
            < new("trunk_fwd", "total"))
    assert (new("mla_bwd", "total") + new("moe_bwd", "total")
            < new("trunk_bwd", "total"))
    load = snap["histograms"]["learner.moe.peak_load"]
    assert load["count"] - load_before == 5 and load["max"] >= 1.0
