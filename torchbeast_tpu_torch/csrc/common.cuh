// Shared helpers for the port's CUDA kernels (built by ops/_build.py).
//
// Every entry point has a plain C interface (loaded with ctypes), launches
// on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TBT_API extern "C" __attribute__((visibility("default")))

namespace tbt {

constexpr int kThreads = 256;

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
