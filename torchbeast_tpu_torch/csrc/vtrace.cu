// V-trace targets: vs and the policy-gradient advantages in one reverse
// pass over the unroll.
//
// Replaces the TPU kernel torchbeast_tpu/ops/pallas_vtrace.py::_kernel
// (launched by _targets_impl through vtrace_targets). Per batch column b:
//
//   acc_t   = delta_t + a_t * acc_{t+1}        (acc_T = 0, a_t = disc_t c_t)
//   vs_t    = acc_t + V_t
//   pgadv_t = pgrho_t * (r_t + disc_t * vs_{t+1} - V_t)   (vs_T = bootstrap)
//
// Design: one thread per column; the carry (acc, vs_{t+1}) lives in
// registers while the loop walks t from T-1 down to 0, so the accumulator
// never touches device memory. Inputs are row-major [T, B], so the threads
// of a warp read neighbouring columns of one row: every load and store is
// coalesced. The TPU kernel's VMEM scratch carry becomes the two registers.
//
// Bound on the H100: 6 [T, B] reads, 2 [T, B] writes and a [B] read of f32
// (at T=80, B=32 about 82 KB, well under a microsecond at 3.35 TB/s); the
// T-step dependent chain and the launch latency are what the time shows.
//
// Arithmetic uses the round-to-nearest intrinsics so no multiply-add is
// contracted: the kernel repeats the plain PyTorch recursion
// (ops/vtrace.py::vtrace_targets_plain) operation for operation, bit for
// bit.
#include "common.cuh"

namespace {

__global__ void vtrace_targets_kernel(
    const float* __restrict__ a, const float* __restrict__ deltas,
    const float* __restrict__ pgrho, const float* __restrict__ rewards,
    const float* __restrict__ discounts, const float* __restrict__ values,
    const float* __restrict__ boot, float* __restrict__ vs,
    float* __restrict__ pg, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float acc = 0.f;
  float vs_next = boot[b];
  for (int t = T - 1; t >= 0; --t) {
    const long long i = static_cast<long long>(t) * B + b;
    const float v = values[i];
    acc = __fadd_rn(deltas[i], __fmul_rn(a[i], acc));
    const float vs_t = __fadd_rn(acc, v);
    const float target =
        __fadd_rn(rewards[i], __fmul_rn(discounts[i], vs_next));
    pg[i] = __fmul_rn(pgrho[i], __fsub_rn(target, v));
    vs[i] = vs_t;
    vs_next = vs_t;
  }
}

}  // namespace

TBT_API int tbt_vtrace_targets(const float* a, const float* deltas,
                               const float* pgrho, const float* rewards,
                               const float* discounts, const float* values,
                               const float* boot, float* vs, float* pg, int T,
                               int B, void* stream) {
  constexpr int kColumnsPerBlock = 128;
  const int blocks = (B + kColumnsPerBlock - 1) / kColumnsPerBlock;
  vtrace_targets_kernel<<<blocks, kColumnsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, deltas, pgrho, rewards, discounts, values, boot, vs, pg, T, B);
  return static_cast<int>(cudaGetLastError());
}

TBT_API const char* tbt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
