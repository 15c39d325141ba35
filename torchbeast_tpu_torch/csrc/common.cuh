// Shared helpers for the port's CUDA kernels (built by ops/_build.py).
//
// Every entry point has a plain C interface (loaded with ctypes), launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TBT_API extern "C" __attribute__((visibility("default")))

namespace tbt {

constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

// Storage types of the kernels' global tensors: f32, or bf16 (widened on
// read, arithmetic in f32, narrowed on write with round-to-nearest-even,
// as the reference's astype does).
__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ inline T from_float(float v);
template <>
__device__ inline float from_float<float>(float v) { return v; }
template <>
__device__ inline bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements in one access: 16 bytes of f32, 8 of bf16.
__device__ inline void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ inline void load4(const bf16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ inline void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ inline void store4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Blocks for a grid-stride loop over n items, capped so the grid stays
// well inside the launch limits; the loop covers whatever is left.
inline int grid_for(long long n, int threads = kThreads,
                    long long cap = 1 << 20) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks);
}

// Whether a pointer allows 16-byte (float4) accesses.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Whether a pointer allows accesses of `bytes` (a power of two) at once.
inline bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Sum a double over the block (blockDim.x a power of two, at most
// kThreads) in a fixed order; every thread gets the total.
__device__ inline double block_sum(double v, double* scratch) {
  scratch[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) scratch[threadIdx.x] += scratch[threadIdx.x + s];
    __syncthreads();
  }
  const double total = scratch[0];
  __syncthreads();
  return total;
}

}  // namespace tbt
