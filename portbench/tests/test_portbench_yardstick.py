"""The yardstick's arithmetic pinned to hand counts, the window's
arithmetic on synthetic completions, and the trace's reduction on
synthetic events."""

import math
import statistics

import numpy as np
import pytest

from portbench import cells, harness, reference, trace, yardstick

DEEP = {"channels": [16, 32, 32], "fc": 256, "lstm_hidden": 256,
        "lstm_layers": 1}
SHALLOW = {"fc": 512, "lstm_layers": 2}
FRAME = (84, 84, 4)


def test_deep_forward_flops_by_hand():
    # Multiply-adds a frame: section convs at 84, 42 and 21, each section's
    # four residual convs after its pool (42, 21, 11); fc 11*11*32 -> 256;
    # the LSTM's 4 gates over 257 + 256 inputs; the two heads.
    convs = (84 * 84 * 16 * 4 * 9 + 4 * 42 * 42 * 16 * 16 * 9
             + 42 * 42 * 32 * 16 * 9 + 4 * 21 * 21 * 32 * 32 * 9
             + 21 * 21 * 32 * 32 * 9 + 4 * 11 * 11 * 32 * 32 * 9)
    macs = convs + 3872 * 256 + 4 * 256 * (257 + 256) + 256 * 7
    net = reference.network("impala_resnet")
    assert net.forward_flops(DEEP, FRAME, 6) == 2 * macs == 109_499_904


def test_shallow_forward_flops_by_hand():
    convs = 20 * 20 * 32 * 4 * 64 + 9 * 9 * 64 * 32 * 16 + 7 * 7 * 64 * 64 * 9
    macs = convs + 3136 * 512 + 2 * 4 * 519 * (519 + 519) + 519 * 7
    net = reference.network("atari_net")
    assert net.forward_flops(SHALLOW, FRAME, 6) == 2 * macs == 27_312_770


@pytest.mark.parametrize("name,net,count", [
    ("impala_resnet", DEEP, 1_617_367), ("atari_net", SHALLOW, 6_001_696)])
def test_parameter_counts(name, net, count):
    shapes = reference.network(name).param_shapes(net, FRAME, 6)
    assert sum(math.prod(s) for _, s in shapes) == count


def test_pool_bwd_bound_is_row_3s():
    pools = reference.network("impala_resnet").pools(DEEP, FRAME)
    assert pools == [(16, 84, 84), (32, 42, 42), (32, 21, 21)]
    nbytes = yardstick.pool_bwd_bytes(81 * 32, pools, 4)
    assert nbytes == 4_762_312_704
    assert yardstick.bytes_ms(nbytes) == pytest.approx(1.422, abs=5e-4)


def test_opt_tail_bound():
    assert yardstick.bytes_ms(yardstick.rmsprop_tail_bytes(1_617_367)) == (
        pytest.approx(0.00966, abs=5e-6))


def test_rate_takes_all_the_work_over_all_the_time():
    completions = [50.0 * (i + 1) for i in range(100)]
    assert yardstick.rate(2560, completions) == pytest.approx(51_200.0)
    # One stall of a second in the middle lowers the rate by all of it.
    stalled = [c + (1000.0 if i >= 50 else 0.0)
               for i, c in enumerate(completions)]
    assert yardstick.rate(2560, stalled) == pytest.approx(
        100 * 2560 / 6.0)


def test_step_p95_sees_a_stall_that_a_median_of_chunks_misses():
    completions, t = [], 0.0
    for i in range(400):
        t += 250.0 if i % 10 == 7 else 50.0  # stalls in every chunk
        completions.append(t)
    intervals = yardstick.intervals_ms(completions)
    assert len(intervals) == 400 and intervals[0] == 50.0
    chunk_medians = [statistics.median(intervals[j:j + 20])
                     for j in range(0, 400, 20)]
    assert statistics.median(chunk_medians) == 50.0
    assert yardstick.percentile(intervals, 95) == 250.0


def test_percentile_is_numpys_linear():
    values = list(np.random.default_rng(0).random(37))
    for q in (5, 50, 95, 99):
        assert yardstick.percentile(values, q) == pytest.approx(
            float(np.percentile(values, q)))


def test_union_counts_overlaps_once():
    spans = [(0, 10), (5, 15), (20, 30), (-5, 1)]
    assert yardstick.union_us(spans, 0, 25) == 20.0


def test_groups():
    assert yardstick.group("pool_bwd_kernel<float, 4>") == "port kernels"
    assert yardstick.group(
        "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32") == "convolution"
    assert yardstick.group("sm90_xmma_gemm_f32f32_f32f32") == (
        "matrix product")
    assert yardstick.group("vectorized_elementwise_kernel") == "other"


@pytest.mark.parametrize("name", [
    "void at::native::(anonymous namespace)::max_pool_forward_nhwc<float, "
    "float>(float const*, int, int, int, int, int, int, int, int, int)",
    "void at::native::(anonymous namespace)::max_pool_backward_nhwc<float, "
    "float>(float const*, long const*, int, int, int, int, int)",
    "void at::native::(anonymous namespace)::max_pool_backward_nchw<float, "
    "float>(float const*, long const*, int, int, int, int, int)",
    "void at::native::(anonymous namespace)::avg_pool2d_out_cuda_frame_nhwc"
    "<float, float>(int, float const*, int)",
])
def test_pooling_is_not_a_convolution(name):
    assert yardstick.group(name) == "pooling"


@pytest.mark.parametrize("name", [
    "void cudnn::engines_precompiled::convertTensor_kernel<float, float, "
    "float, (cudnnKernelDataType_t)2>(float, float const*",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_s1688dgrad_optimized_"
    "tf32_256x64_16x4_nhwc_unity_stride_align4>",
    "sm90_xmma_wgrad_indexed_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc"
    "_tilesize64x64x32_warpgroupsize1x1x1_g1_execute_segment_k",
])
def test_cudnn_kernels_are_convolutions(name):
    assert yardstick.group(name) == "convolution"


def _events(starts=(0.0, 100.0), correlate=False):
    """Dispatches: each a span on the host with three API calls in it
    and one outside, and two kernels on the card with a gap between,
    tied to the span's first call where `correlate`."""
    ev = []
    for d, t in enumerate(starts):
        corr = {"correlation": d} if correlate else {}
        ev.append({"cat": "user_annotation", "name": trace.SPAN, "tid": 1,
                   "ts": t, "dur": 10.0})
        ev += [{"cat": "cuda_runtime", "name": "cudaGraphLaunch", "tid": 1,
                "ts": t + k, "dur": 1.0, "args": corr if k == 1 else {}}
               for k in (1, 2, 3)]
        ev.append({"cat": "cuda_runtime", "name": "cudaEventRecord",
                   "tid": 1, "ts": t + 20, "dur": 1.0})
        ev += [{"cat": "kernel", "name": "pool_bwd_kernel", "ts": t + 10,
                "dur": 30.0, "args": corr},
               {"cat": "kernel", "name": "sm90_xmma_gemm", "ts": t + 50,
                "dur": 20.0, "args": corr}]
    return ev


def test_trace_window_starts_when_the_first_dispatch_completes():
    """Three dispatches, the first launched onto an idle card: the window
    runs from its end (70) to the last's (270) and holds two updates."""
    t = trace.summarize(_events((0.0, 100.0, 200.0), correlate=True), 3)
    assert t.updates == 2 and t.window_us == 200.0 and t.busy_us == 100.0
    assert t.api_calls_per_dispatch == 3
    assert trace.device_ms_per_update(
        t, lambda n: n.startswith("pool")) == pytest.approx(0.03)


def test_trace_summary():
    t = trace.summarize(_events(), 2)
    assert t.api_calls_per_dispatch == 3
    assert t.window_us == 160.0 and t.busy_us == 100.0
    assert trace.device_ms_per_update(
        t, lambda n: n.startswith("pool")) == pytest.approx(0.03)
    assert trace.device_ms_per_update(t, lambda n: "conv" in n) is None
    names = [n for n, _ in t.breakdown["device_ops"]]
    assert names == ["pool_bwd_kernel", "sm90_xmma_gemm"]
    assert len(t.breakdown["idle_gaps"]) == 3
    assert t.breakdown["idle_gaps"][0][1] == pytest.approx(40e-6)


def test_idle_share_is_the_windows_time_between_dispatches():
    """Three updates: the card waits 1 ms for the first and 2 ms for the
    third (a host stall), and is busy in between: 3 of 30 ms idle."""
    win = harness.Window(completions_ms=[10.0, 18.0, 30.0],
                         durations_ms=[9.0, 8.0, 10.0], failed=0)
    ctx = harness.Context(None, None, None, 0.0, win, None, None)
    read = cells.reader("device_idle_share")
    assert read(ctx) == pytest.approx(10.0)
    back_to_back = win._replace(durations_ms=[10.0, 8.0, 12.0])
    assert read(ctx._replace(window=back_to_back)) == pytest.approx(0.0)
