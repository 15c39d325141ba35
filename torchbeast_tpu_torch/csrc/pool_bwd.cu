// Gradient of the 3x3, stride-2, pad-1 max-pool with respect to its input,
// crediting EVERY input position that ties at its window's max.
//
// Replaces the TPU kernel torchbeast_tpu/ops/pallas_pool.py::_kernel
// (launched by pool_bwd; helpers _doubled_grid and _auto_block_n):
//
//   gx[n, h, w, c] = sum over output windows (oh, ow) that cover (h, w) of
//                    g[n, oh, ow, c] * (x[n, h, w, c] == y[n, oh, ow, c])
//
// Design: gather form, one thread per input element, no atomics. Window oh
// covers input rows 2*oh-1 .. 2*oh+1, so row h is covered by
// oh in [h >> 1, (h + 1) >> 1] (clamped to the output): at most 2 x 2
// windows, read straight from y and g. The TPU kernel's doubled grid (a 2x
// upsampled, padded copy of y and of g, built for the TPU's lane layout) is
// not built: it would write two input-sized arrays the GPU does not need.
// Tensors are NHWC in memory (PyTorch channels_last), so consecutive
// threads handle consecutive channels and every access is coalesced.
//
// Windows are visited from the highest (oh, ow) down, the order in which
// the plain tap-sum (ops/pool.py::pool_bwd_plain, and the reference's
// ops/pool.py::_bwd) adds its taps, so the two agree bit for bit.
//
// Bound on the H100: bytes. x and gx are input-sized, y and g output-sized,
// f32: at the deep trunk's stage 1 (N=2592, 84x84x16 -> 42x42x16) that is
// 2.93 GB, about 0.87 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

__global__ void pool_bwd_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ g,
                                float* __restrict__ gx, int N, int H, int W,
                                int C, int Ho, int Wo) {
  const long long total = static_cast<long long>(N) * H * W * C;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < total; idx += stride) {
    const int c = static_cast<int>(idx % C);
    long long r = idx / C;
    const int w = static_cast<int>(r % W);
    r /= W;
    const int h = static_cast<int>(r % H);
    const long long n = r / H;
    const float xv = x[idx];
    const int oh_lo = h >> 1;
    const int oh_hi = min((h + 1) >> 1, Ho - 1);
    const int ow_lo = w >> 1;
    const int ow_hi = min((w + 1) >> 1, Wo - 1);
    float acc = 0.f;
    for (int oh = oh_hi; oh >= oh_lo; --oh) {
      for (int ow = ow_hi; ow >= ow_lo; --ow) {
        const long long o = ((n * Ho + oh) * Wo + ow) * C + c;
        if (xv == y[o]) acc += g[o];
      }
    }
    gx[idx] = acc;
  }
}

}  // namespace

TBT_API int tbt_pool_bwd(const float* x, const float* y, const float* g,
                         float* gx, int N, int H, int W, int C, int Ho, int Wo,
                         void* stream) {
  const long long total = static_cast<long long>(N) * H * W * C;
  pool_bwd_kernel<<<tbt::grid_for(total), tbt::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, y, g, gx, N, H, W,
                                                         C, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}
