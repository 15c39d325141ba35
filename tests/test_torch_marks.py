"""The learner update's device marks (torchbeast_tpu_torch/marks.py) on
the CPU, with a plain stamp source: a HostRecorder stamps
time.perf_counter_ns() and folds in Python as csrc/mark.cu folds on the
card, and an eager update on the CPU runs synchronously. Also the
telemetry registry's collectors, the --profile_dir trace that merges the
Tracer's spans onto the profiler's clock (utils/prof.py), and the
benchmark's four readers of the marks' series (portbench/regions.py).
The marks inside a captured graph on the card are
tests/test_torch_marks_cuda.py's."""

import importlib.util
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from torchbeast_tpu_torch import (graphs, learner, marks, profile_update,
                                  telemetry)
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.telemetry import metrics
from torchbeast_tpu_torch.utils import prof
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A, FRAME = 4, 2, 4, (12, 12, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WITH_CORE = [marks.START, marks.HEAD_IN, marks.CORE_OUT, marks.BACKWARD,
             marks.CORE_OUT_GRAD, marks.HEAD_IN_GRAD, marks.STEP, marks.END]
WITHOUT_CORE = [marks.START, marks.HEAD_IN, marks.BACKWARD,
                marks.HEAD_IN_GRAD, marks.STEP, marks.END]
REGIONS = ["trunk_fwd", "core_fwd", "loss_fwd", "loss_bwd", "core_bwd",
           "trunk_bwd", "opt"]


@pytest.fixture(autouse=True)
def telemetry_on():
    """The global gate on (a driver test in the same process may have
    left it off with --no_telemetry), as it was after."""
    was = telemetry.is_enabled()
    telemetry.set_enabled(True)
    yield
    telemetry.set_enabled(was)


def _batch(seed, k=None):
    rng = np.random.default_rng(seed)
    lead = (T + 1, B) if k is None else (k, T + 1, B)
    arrays = {
        "frame": rng.integers(0, 256, lead + FRAME, dtype=np.uint8),
        "reward": rng.standard_normal(lead).astype(np.float32),
        "done": rng.random(lead) < 0.2,
        "episode_return": rng.standard_normal(lead).astype(np.float32),
        "episode_step": rng.integers(0, 100, lead).astype(np.int32),
        "last_action": rng.integers(0, A, lead).astype(np.int32),
        "action": rng.integers(0, A, lead).astype(np.int32),
        "policy_logits": rng.standard_normal(lead + (A,)).astype(np.float32),
        "baseline": rng.standard_normal(lead).astype(np.float32),
    }
    return {key: torch.from_numpy(v) for key, v in arrays.items()}


def _state(model, k=None):
    state = model.initial_state(B)
    if k is not None:
        state = tuple(torch.stack([s] * k) for s in state)
    return state


def _learner(use_lstm=True, seed=0, **model_kw):
    torch.manual_seed(seed)
    model = create_model("deep", A, use_lstm=use_lstm, frame_shape=FRAME,
                         **model_kw)
    hp = learner.HParams(unroll_length=T, batch_size=B,
                         total_steps=T * B * 100, vtrace_impl="pallas",
                         opt_impl="pallas", entropy_cost=0.01)
    optimizer = learner.make_optimizer(hp, list(model.parameters()))
    return model, optimizer, hp


def _recorded(dispatches, k=1, **kw):
    """(recorder, private registry) after `dispatches` eager dispatches of
    a deep model's update, each recorded as a captured dispatch is."""
    model, optimizer, hp = _learner(**kw)
    step = learner.make_update_dispatch(model, optimizer, hp, k=k)
    registry = metrics.MetricsRegistry()
    recorder = marks.HostRecorder(marks.Accumulator("cpu", registry))
    stack = k if k > 1 else None
    for i in range(dispatches):
        with marks.recording(recorder):
            step(_batch(i, stack), _state(model, stack))
    return recorder, registry


def _sums(recorder):
    """{series name: (count, sum ns)} from the accumulator's rows."""
    table = recorder.acc.table
    return {name: (int(table[r, marks.COUNT]), int(table[r, marks.SUM]))
            for name, r in recorder.acc._rows.items()}


@pytest.mark.parametrize("use_lstm", [True, False])
def test_regions_in_order_once_an_update_covering_its_span(use_lstm):
    recorder, registry = _recorded(3, use_lstm=use_lstm)
    order = WITH_CORE if use_lstm else WITHOUT_CORE
    for dispatch in (1, 2, 3):
        stamps = [(i, ns) for d, u, i, ns in recorder.stamps
                  if d == dispatch and u == 1]
        assert [i for i, _ in stamps] == order
        assert [ns for _, ns in stamps] == sorted(ns for _, ns in stamps)
    sums = _sums(recorder)
    names = [r for r in REGIONS if use_lstm or "core" not in r]
    assert [n for n in sums if n in REGIONS] == names
    assert all(sums[n][0] == 3 for n in names + ["update"])
    # Each region runs from one mark to the next: no gap, no overlap.
    assert sum(sums[n][1] for n in names) == sums["update"][1]
    assert sums["gap"][0] == 2  # between dispatches, not before the first
    snap = telemetry.snapshot(registry)["histograms"]
    assert sorted(snap) == sorted(
        f"learner.device.{n}_s" for n in names + ["update", "gap"])
    assert snap["learner.device.update_s"]["total"] == pytest.approx(
        sums["update"][1] * 1e-9, rel=1e-12)


def test_superstep_gives_two_samples_a_dispatch():
    recorder, _ = _recorded(2, k=2)
    assert [(d, u) for d, u, i, _ in recorder.stamps
            if i == marks.START] == [(1, 1), (1, 2), (2, 1), (2, 2)]
    for d, u in ((1, 1), (1, 2), (2, 1), (2, 2)):
        assert [i for d2, u2, i, _ in recorder.stamps
                if (d2, u2) == (d, u)] == WITH_CORE
    sums = _sums(recorder)
    assert all(sums[n][0] == 4 for n in REGIONS + ["update"])
    assert sums["gap"][0] == 1  # a dispatch's first update only
    assert sum(sums[n][1] for n in REGIONS) == sums["update"][1]


def test_remat_keeps_the_stamps_in_order():
    recorder, _ = _recorded(2, remat=(True, "front", True), core_remat=True)
    for dispatch in (1, 2):
        assert [i for d, _, i, _ in recorder.stamps
                if d == dispatch] == WITH_CORE


def test_marks_leave_gradients_and_parameters_bitwise_equal():
    runs = []
    for recorded in (False, True):
        model, optimizer, hp = _learner(seed=3)
        step = learner.make_update_dispatch(model, optimizer, hp)
        recorder = marks.HostRecorder(
            marks.Accumulator("cpu", metrics.MetricsRegistry()))
        for i in range(3):
            with marks.recording(recorder if recorded else None):
                step(_batch(i), _state(model))
        params = list(model.parameters())
        with marks.recording(recorder if recorded else None):
            loss, _ = learner.compute_loss(model, _batch(9), _state(model),
                                           hp)
            grads = torch.autograd.grad(loss, params)
        assert bool(recorder.stamps) == recorded
        runs.append([p.detach().clone() for p in params] + list(grads)
                    + list(optimizer.state.nu))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_marks_do_nothing_outside_a_recording():
    x = torch.ones(3, requires_grad=True)
    assert marks.boundary(x, marks.HEAD_IN, marks.HEAD_IN_GRAD) is x
    marks.stamp(marks.START)  # no recorder: nothing to stamp into
    recorder = marks.HostRecorder(marks.Accumulator("cpu"))
    with marks.recording(recorder):
        y = marks.boundary(x, marks.HEAD_IN, marks.HEAD_IN_GRAD)
    y.sum().backward()  # the backward mark goes to the forward's recorder
    assert [i for _, _, i, _ in recorder.stamps] == [marks.HEAD_IN,
                                                     marks.HEAD_IN_GRAD]


def test_thresholds_are_the_registrys_buckets():
    thr = marks.thresholds()
    assert thr[0] == 0 and thr == sorted(thr) and len(thr) == marks.BUCKETS
    for i in range(1, marks.BUCKETS):
        assert metrics.bucket_index(thr[i] * 1e-9) >= i
        assert metrics.bucket_index((thr[i] - 1) * 1e-9) < i


def test_fold_matches_histogram_observe():
    rng = np.random.default_rng(0)
    thr = marks.thresholds()
    durations = [0, 1, 2, 3, 999, 1000, 1001, 123_456, 49_937_000,
                 10 ** 12] + [thr[i] + d for i in (6, 40, 90, 150)
                              for d in (-1, 0, 1)]
    durations += [int(v) for v in rng.integers(1, 10 ** 9, 200)]
    registry = metrics.MetricsRegistry()
    acc = marks.Accumulator("cpu", registry)
    recorder = marks.HostRecorder(acc)
    row = acc.row("update")
    for d in durations[:50]:
        recorder.observe(row, d)
    telemetry.snapshot(registry)  # a first collect, then the rest
    for d in durations[50:]:
        recorder.observe(row, d)
    folded = telemetry.snapshot(registry)["histograms"][
        "learner.device.update_s"]
    plain = metrics.Histogram("plain")
    for d in durations:
        plain.observe(d * 1e-9)
    want = plain.stats()
    assert folded["buckets"] == want["buckets"]
    assert folded["count"] == want["count"] == len(durations)
    for key in ("total", "total_sq", "min", "max"):
        assert folded[key] == pytest.approx(want[key], rel=1e-12), key
    # A third snapshot adds nothing: the collector merges only news.
    again = telemetry.snapshot(registry)["histograms"][
        "learner.device.update_s"]
    assert again["count"] == want["count"]


def test_snapshot_runs_each_collector_once_and_survives_a_failing_one():
    registry = metrics.MetricsRegistry()
    calls = []
    registry.add_collector(lambda reg: calls.append(reg))
    registry.add_collector(lambda reg: 1 / 0)
    registry.add_collector(lambda reg: reg.counter("collected").inc())
    snap = telemetry.snapshot(registry)
    assert calls == [registry] and snap["counters"] == {"collected": 1.0}


def test_a_snapshot_while_a_capture_is_open_merges_nothing():
    """A snapshot on another thread (the /metrics server's) during a
    capture: the collector makes no copy, and the next snapshot merges
    what it left."""
    _, registry = _recorded(2)
    with graphs._capture_open():
        snap = telemetry.snapshot(registry)
    assert not any(name.startswith("learner.device.")
                   for name in snap["histograms"])
    snap = telemetry.snapshot(registry)
    assert snap["histograms"]["learner.device.update_s"]["count"] == 2


def test_a_capture_waits_for_a_collect_in_flight():
    copying, copied, order = threading.Event(), threading.Event(), []

    def collect():
        with graphs.outside_capture() as free:
            assert free
            copying.set()
            copied.wait(10)
            order.append("copy")

    def capture():
        with graphs._capture_open():
            order.append("capture")

    threads = [threading.Thread(target=collect),
               threading.Thread(target=capture)]
    threads[0].start()
    assert copying.wait(10)
    threads[1].start()
    time.sleep(0.05)
    assert order == []
    copied.set()
    for thread in threads:
        thread.join(10)
    assert order == ["copy", "capture"]
    with graphs.outside_capture() as free:
        assert free


def test_profile_dir_trace_spans_enclose_their_dispatch(tmp_path):
    model, optimizer, hp = _learner(use_lstm=False)
    step = learner.instrument_update_step(
        learner.make_update_dispatch(model, optimizer, hp),
        registry=metrics.MetricsRegistry())
    batches = [_batch(i) for i in range(3)]
    step(batches[0], _state(model))  # the first dispatch counts bytes
    trace = prof.DeviceTrace(str(tmp_path))
    for batch in batches:
        time.sleep(0.005)
        step(batch, _state(model))
    time.sleep(0.005)
    path = trace.stop()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((ev for ev in events
                    if ev.get("name") == "learner.dispatch"),
                   key=lambda ev: ev["ts"])
    assert len(spans) == 3
    ops = [ev for ev in events if ev.get("cat") == "cpu_op"
           and ev.get("tid") == spans[0]["tid"]]
    for i, span in enumerate(spans):
        lo = spans[i - 1]["ts"] + spans[i - 1]["dur"] if i else -1e30
        hi = spans[i + 1]["ts"] if i + 1 < len(spans) else 1e30
        own = [ev for ev in ops if lo < ev["ts"] < hi]
        assert own, "no profiler op between the dispatches"
        assert span["ts"] <= min(ev["ts"] for ev in own) + 50
        assert span["ts"] + span["dur"] >= max(
            ev["ts"] + ev.get("dur", 0) for ev in own) - 50


def test_clock_map_places_host_events_on_the_profilers_clock():
    samples = [("tbt.clock.start.0", 10.0, 10.000004),
               ("tbt.clock.start.1", 10.1, 10.100001),
               ("tbt.clock.stop.0", 20.0, 20.000001)]
    # The profiler's clock: 5e6 us ahead, 1% faster than perf_counter's.
    clock = lambda t: 5e6 + 1.01e6 * t  # noqa: E731
    trace = [{"name": "tbt.clock.start.1", "ts": clock(10.1000005),
              "pid": 42, "tid": 7, "cat": "user_annotation"},
             {"name": "tbt.clock.stop.0", "ts": clock(20.0000005),
              "pid": 42, "tid": 7, "cat": "user_annotation"}]
    host = [{"name": "learner.dispatch", "cat": "learner", "ph": "X",
             "ts": 15e6, "dur": 1000.0, "pid": 0, "tid": 1},
            {"name": "early", "cat": "learner", "ph": "X", "ts": 5e6,
             "dur": 1.0, "pid": 0, "tid": 1}]
    merged = prof.merge_host_events(trace, host, samples, {1: 4321},
                                    (10.0, 20.000001))
    (span,) = merged[len(trace):]
    assert span["ts"] == pytest.approx(clock(15.0), abs=1e-3)
    assert span["dur"] == pytest.approx(1010.0)
    assert (span["pid"], span["tid"]) == (42, 4321)
    assert prof.merge_host_events(trace[:0], host, samples, {},
                                  (0.0, 30.0)) == []


def _tail_trace():
    """profile_update's synthetic trace of one whole update window."""
    api = lambda tid, ts, corr: {  # noqa: E731
        "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
        "ts": ts, "dur": 5, "args": {"correlation": corr}}
    kernel = lambda name, ts, dur, corr: {  # noqa: E731
        "cat": "kernel", "name": name, "tid": 7, "ts": ts, "dur": dur,
        "args": {"correlation": corr}}
    return [api(1, 0, 10), kernel("rmsprop_tail_kernel", 100, 20, 10),
            api(1, 200, 11), kernel("conv_fprop", 300, 100, 11),
            api(1, 600, 14), kernel("rmsprop_tail_kernel", 900, 20, 14),
            {"name": "tbt.clock.start.0", "ts": 0.0, "pid": 1, "tid": 1,
             "cat": "user_annotation"}]


def test_update_windows_read_the_merged_trace():
    events = _tail_trace()
    host = [{"name": n, "cat": "learner", "ph": "X", "ts": ts, "dur": 300.0,
             "pid": 0, "tid": 1, "args": {"k": 1}}
            for n, ts in (("learner.dispatch", 200.0),
                          ("graph.replay", 250.0))]
    merged = prof.merge_host_events(
        events, host, [("tbt.clock.start.0", 0.0, 0.0)], {}, (0.0, 1.0))
    assert len(merged) == len(events) + 2
    assert (profile_update.update_windows(merged)
            == profile_update.update_windows(events))


def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _hist(total_s, count):
    return dict(metrics.hist_stats({10: count}, total_s, 0.0),
                total=total_s)


def test_portbench_readers_from_a_faked_snapshot(monkeypatch):
    series = {"trunk_fwd": 10.0, "trunk_bwd": 30.0, "core_fwd": 4.0,
              "core_bwd": 12.0, "loss_fwd": 0.5, "loss_bwd": 0.75,
              "opt": 0.25}  # seconds over 1,000 updates
    fake = {"histograms": {f"learner.device.{k}_s": _hist(v, 1000)
                           for k, v in series.items()}}
    monkeypatch.setattr(telemetry, "snapshot", lambda *a: fake)
    got = {name: _reader(name)(None)
           for name in ("trunk_ms", "core_ms", "loss_ms", "opt_ms")}
    assert got == pytest.approx({"trunk_ms": 40.0, "core_ms": 16.0,
                                 "loss_ms": 1.25, "opt_ms": 0.25})
    del fake["histograms"]["learner.device.core_bwd_s"]
    assert _reader("core_ms")(None) is None


@pytest.mark.parametrize("name", ["trunk_ms", "core_ms", "loss_ms",
                                  "opt_ms"])
def test_portbench_readers_return_none_on_the_cpu(name):
    """No graph is captured on the CPU, so the series do not exist."""
    assert _reader(name)(None) is None


def test_a_recomputed_mark_keeps_its_first_stamp():
    """A mark inside a region that remat recomputes in the backward runs
    twice; its slot keeps the forward's stamp."""
    from torchbeast_tpu_torch.models.layers import checkpointed

    def region(x):
        return torch.tanh(marks.boundary(x * 2, marks.CORE_OUT,
                                         marks.CORE_OUT_GRAD))

    recorder = marks.HostRecorder(marks.Accumulator("cpu"))
    x = torch.ones(3, requires_grad=True)
    with marks.recording(recorder):
        checkpointed(region, x).sum().backward()
    slots = recorder.acc.slots
    first = [ns for _, _, i, ns in recorder.stamps if i == marks.CORE_OUT]
    assert [i for _, _, i, _ in recorder.stamps] == [marks.CORE_OUT,
                                                     marks.CORE_OUT_GRAD]
    assert int(slots[marks.CORE_OUT]) == first[0]


def test_split_trace_puts_each_device_op_in_its_region():
    def op(name, ts, dur=10.0, cat="kernel"):
        return {"cat": cat, "name": name, "ts": ts, "dur": dur}

    def mark(i, ts):
        return op(f"void tbt_mark<{i}>(long long*, long long*)", ts, 1.0)

    events = [op("stage_in", 0, cat="gpu_memcpy"), mark(0, 20),
              op("conv", 30), op("cudnn::convertTensor_kernel", 45),
              mark(1, 60), op("gemm", 70), mark(2, 90), op("vtrace", 100),
              mark(3, 120), op("vtrace_bwd", 130), mark(4, 150),
              op("gemm", 160), op("gemm", 175), mark(5, 190),
              op("cudnn::convertTensor_kernel", 200), mark(6, 220),
              op("rmsprop_tail", 230), mark(7, 250), op("clone", 260),
              {"cat": "cpu_op", "name": "aten::add", "ts": 35, "dur": 1}]
    (update,) = marks.split_trace(events)
    assert update == {
        "trunk_fwd": {"conv": 10.0, "cudnn::convertTensor_kernel": 10.0},
        "core_fwd": {"gemm": 10.0}, "loss_fwd": {"vtrace": 10.0},
        "loss_bwd": {"vtrace_bwd": 10.0}, "core_bwd": {"gemm": 20.0},
        "trunk_bwd": {"cudnn::convertTensor_kernel": 10.0},
        "opt": {"rmsprop_tail": 10.0}}
    assert marks.split_trace(events[:-4]) == []  # no END: no whole update
