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
