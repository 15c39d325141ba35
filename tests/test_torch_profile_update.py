"""The port's update profiler (torchbeast_tpu_torch/profile_update.py):
how it files device kernel names into groups, and the slice's random
batch that it shares with chip_smoke.py. The profile itself needs a CUDA
device; these parts run on the CPU."""

import numpy as np
import pytest
import torch

from torchbeast_tpu_torch import profile_update
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401


@pytest.mark.parametrize("name,group", [
    ("(anonymous namespace)::vtrace_targets_kernel(float const*, int, int)",
     "port kernels"),
    ("(anonymous namespace)::rmsprop_sumsq_kernel(LeafTable, double*)",
     "port kernels"),
    ("(anonymous namespace)::rmsprop_apply_kernel(LeafTable, double const*,"
     " int, float*, Hyper)", "port kernels"),
    ("(anonymous namespace)::pool_bwd_kernel(float const*, float*)",
     "port kernels"),
    ("(anonymous namespace)::rmsprop_tail_kernel(LeafTable, double*, "
     "float*, Hyper)", "port kernels"),
    ("void (anonymous namespace)::attention_bwd_kernel<1, 8>(float const*, "
     "float const*, BwdShape, float)", "port kernels"),
    ("void (anonymous namespace)::attention_fwd_kernel<4, 1>(float const*, "
     "FwdShape, float)", "port kernels"),
    ("void (anonymous namespace)::lstm_step_fwd_kernel<4>(float const*, "
     "float const*, float*, int, int)", "port kernels"),
    ("void (anonymous namespace)::lstm_step_bwd_kernel<2>(float const*, "
     "float*, float*, int, int)", "port kernels"),
    # cuDNN convolutions: Hopper xmma kernels carry their direction.
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x16_warpgroupsize1x1x1", "convolution"),
    ("sm90_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc",
     "convolution"),
    ("sm90_xmma_wgrad_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc",
     "convolution"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float>",
     "convolution"),
    ("void xmma_cudnn::gemm::kernel<implicit_gemm_wgrad_traits>",
     "convolution"),
    # cuBLAS products, Hopper xmma included.
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_warpgroup",
     "matrix product"),
    ("ampere_sgemm_128x64_tn", "matrix product"),
    ("nvjet_tst_64x64_64x13_2x4_h_bz_bias_TNT", "matrix product"),
    ("void (anonymous namespace)::pool_bwd_kernel<__nv_bfloat16, 8>("
     "__nv_bfloat16 const*)", "port kernels"),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemm",
     "convolution"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128>",
     "matrix product"),
    ("void at::native::multi_tensor_apply_kernel<TensorListMetadata<2>>",
     "other"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>", "other"),
])
def test_group_files_kernel_names(name, group):
    assert profile_update._group(name) == group


def test_random_batch_is_the_slice_batch_and_seeded():
    T, B, A = profile_update.T, profile_update.B, profile_update.NUM_ACTIONS
    assert (T, B, A) == (80, 32, 6)
    batch = profile_update.random_batch(0, torch.device("cpu"))
    assert batch["frame"].shape == (T + 1, B, 84, 84, 4)
    assert batch["frame"].dtype == torch.uint8
    assert batch["policy_logits"].shape == (T + 1, B, A)
    assert batch["done"].dtype == torch.bool
    for key in ("reward", "baseline", "action", "last_action"):
        assert batch[key].shape == (T + 1, B)
    assert int(batch["action"].max()) < A
    again = profile_update.random_batch(0, torch.device("cpu"))
    for key, value in batch.items():
        np.testing.assert_array_equal(value.numpy(), again[key].numpy())


def _api(tid, ts, dur, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr, cat="kernel"):
    return {"cat": cat, "name": name, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_update_windows_split_a_trace_by_launching_thread():
    """Two updates of the learner (thread 1, its backward on thread 3)
    with acting kernels (thread 2) between them, in a chrome trace's
    terms (microseconds)."""
    events = [
        _api(1, 0, 5, 10), _kernel("rmsprop_tail_kernel", 100, 20, 10),
        # Update 2: learner calls at 200, 300 and 600 (gaps 95, 295 us).
        _api(1, 200, 5, 11), _kernel("conv_fprop", 300, 100, 11),
        _api(2, 250, 5, 12), _kernel("acting_gemm", 350, 100, 12),
        _api(3, 260, 40, 15), _kernel("pool_bwd_kernel", 460, 30, 15),
        _api(1, 300, 5, 13), _kernel("elementwise", 600, 50, 13),
        _kernel("copy", 700, 10, 99, cat="gpu_memcpy"),  # no API event
        _api(1, 600, 10, 14), _kernel("rmsprop_tail_kernel", 900, 20, 14),
        {"cat": "cpu_op", "name": "aten::add", "tid": 1, "ts": 0, "dur": 1},
    ]
    (window,) = profile_update.update_windows(events)
    assert window["ms"] == pytest.approx((920 - 120) / 1e3)
    # Busy: [300, 450] + [460, 490] + [600, 650] + [700, 710] + [900, 920].
    assert window["device_busy_ms"] == pytest.approx(260 / 1e3)
    assert [window[f"{who}_kernels"] for who in (
        "learner", "backward", "other", "unattributed")] == [3, 1, 1, 0]
    assert window["learner_kernel_ms"] == pytest.approx(170 / 1e3)
    assert window["backward_kernel_ms"] == pytest.approx(30 / 1e3)
    assert window["other_kernel_ms"] == pytest.approx(100 / 1e3)
    assert window["unattributed_copies"] == 1
    assert (window["learner_threads"], window["other_threads"]) == (1, 1)
    assert window["learner_api_calls"] == 3
    assert window["learner_api_ms"] == pytest.approx(20 / 1e3)
    assert window["learner_api_gap_ms_median"] == pytest.approx(195 / 1e3)
    assert window["learner_api_gap_ms_sum"] == pytest.approx(390 / 1e3)
    assert window["learner_longest_gaps"][0] == [
        pytest.approx(295 / 1e3), "elementwise", "rmsprop_tail_kernel"]
    assert window["learner_longest_calls"][0] == [
        pytest.approx(10 / 1e3), "rmsprop_tail_kernel"]
    median = profile_update.median_window([window, window])
    assert median["ms"] == window["ms"]
    assert "learner_longest_gaps" not in median


def test_update_windows_need_two_tails():
    events = [_api(1, 0, 5, 10), _kernel("rmsprop_tail_kernel", 100, 20, 10)]
    with pytest.raises(ValueError, match="no whole update"):
        profile_update.update_windows(events)


def test_polybeast_argv_is_the_reference_parsers_deep_path(tmp_path):
    from torchbeast_tpu import polybeast as jax_polybeast

    argv = profile_update.polybeast_argv(str(tmp_path), "x")
    flags = jax_polybeast.make_parser().parse_args(argv)
    assert (flags.model, flags.use_lstm, flags.unroll_length,
            flags.batch_size, flags.num_servers) == ("deep", True, 80, 32, 16)
    assert (flags.vtrace_impl, flags.opt_impl) == ("pallas", "pallas")
