// The learner's optimizer tail over every parameter leaf in two launches:
// global-norm clip -> torch-RMSprop second moment -> optional momentum
// trace -> learning-rate apply, updating params, nu and mom IN PLACE.
//
// Replaces the TPU kernel torchbeast_tpu/ops/pallas_opt.py::_tail_kernel
// (launched once per leaf, or per leading-axis chunk, by _run_leaf; chunk
// size from _leaf_grid). The JAX kernel returns new arrays; here the
// wrapper hands the kernel the live parameter, nu and mom tensors and they
// are overwritten in place, so no parameter-sized output is allocated.
//
//   launch 1  partial sums of g^2 (f64) over all leaves, one per block
//   launch 2  every block finishes the norm from the partials (the same
//             fixed order in every block, no atomics; block 0 also writes
//             the squared norm out, the learner's grad_norm stat), then
//             per element:
//               g    = g * (max_norm / |g|)      only when |g| >= max_norm
//               nu   = alpha * nu + ((1 - alpha) * g) * g
//               upd  = g / (sqrt(nu) + eps)
//               upd  = momentum * mom + upd;  mom = upd   (momentum > 0)
//               p    = p - lr * upd
//
// Design: the leaves ride in one table passed by value as a kernel
// parameter (multi-tensor apply, at most kMaxLeaves pointers per role), so
// the whole tree is two launches where the JAX kernel takes one per leaf
// (about 48 for the deep ResNet with an LSTM). Each thread walks a
// grid-stride range of the concatenated element space and advances a leaf
// cursor as it crosses leaf boundaries.
//
// Bound on the H100: bytes. 1.62 M f32 params: the norm pass reads g
// (6.5 MB); the update reads g, nu, p and writes nu, p (32 MB, plus 8 MB
// with momentum): about 12 us at 3.35 TB/s.
//
// Arithmetic uses the round-to-nearest intrinsics so no multiply-add is
// contracted: the update repeats the plain PyTorch version
// (ops/opt.py::rmsprop_tail_plain) operation for operation.
#include "common.cuh"

namespace {

constexpr int kMaxLeaves = 64;

struct LeafTable {
  float* param[kMaxLeaves];
  const float* grad[kMaxLeaves];
  float* nu[kMaxLeaves];
  float* mom[kMaxLeaves];
  long long offset[kMaxLeaves + 1];  // prefix sums of the leaves' numel
  int n;
};

struct Hyper {
  float lr, alpha, one_minus_alpha, eps, momentum, max_norm;
  int clip, has_mom;
};

// The leaf holding global element i: the last l with offset[l] <= i.
__device__ inline int find_leaf(const LeafTable& t, long long i) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.offset[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void rmsprop_sumsq_kernel(const LeafTable t,
                                     double* __restrict__ partials) {
  __shared__ double scratch[tbt::kThreads];
  const long long total = t.offset[t.n];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  double s = 0.0;
  if (i < total) {
    int leaf = find_leaf(t, i);
    for (; i < total; i += stride) {
      while (i >= t.offset[leaf + 1]) ++leaf;
      const double v = t.grad[leaf][i - t.offset[leaf]];
      s += v * v;
    }
  }
  const double block_total = tbt::block_sum(s, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = block_total;
}

__global__ void rmsprop_apply_kernel(const LeafTable t,
                                     const double* __restrict__ partials,
                                     int n_partials,
                                     float* __restrict__ sumsq_out,
                                     const Hyper h) {
  __shared__ double scratch[tbt::kThreads];
  double s = 0.0;
  for (int k = threadIdx.x; k < n_partials; k += blockDim.x) s += partials[k];
  const float sumsq = static_cast<float>(tbt::block_sum(s, scratch));
  if (blockIdx.x == 0 && threadIdx.x == 0) *sumsq_out = sumsq;
  float scale = 1.f;
  bool rescale = false;
  if (h.clip) {
    const float gnorm = sqrtf(sumsq);
    if (!(gnorm < h.max_norm)) {
      scale = __fdiv_rn(h.max_norm, gnorm);
      rescale = true;
    }
  }
  const long long total = t.offset[t.n];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int leaf = find_leaf(t, i);
  for (; i < total; i += stride) {
    while (i >= t.offset[leaf + 1]) ++leaf;
    const long long j = i - t.offset[leaf];
    float g = t.grad[leaf][j];
    if (rescale) g = __fmul_rn(g, scale);
    const float nu = __fadd_rn(__fmul_rn(h.alpha, t.nu[leaf][j]),
                               __fmul_rn(__fmul_rn(h.one_minus_alpha, g), g));
    float upd = __fdiv_rn(g, __fadd_rn(__fsqrt_rn(nu), h.eps));
    if (h.has_mom) {
      upd = __fadd_rn(__fmul_rn(h.momentum, t.mom[leaf][j]), upd);
      t.mom[leaf][j] = upd;
    }
    t.nu[leaf][j] = nu;
    t.param[leaf][j] = __fsub_rn(t.param[leaf][j], __fmul_rn(h.lr, upd));
  }
}

}  // namespace

TBT_API int tbt_rmsprop_tail(void* const* params, void* const* grads,
                             void* const* nus, void* const* moms,
                             const long long* numels, int n_leaves,
                             double* partials, int n_partials,
                             float* sumsq, float lr,
                             float alpha, float one_minus_alpha, float eps,
                             float momentum, float max_norm, int clip,
                             int has_mom, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LeafTable t;
  t.n = n_leaves;
  t.offset[0] = 0;
  for (int l = 0; l < n_leaves; ++l) {
    t.param[l] = static_cast<float*>(params[l]);
    t.grad[l] = static_cast<const float*>(grads[l]);
    t.nu[l] = static_cast<float*>(nus[l]);
    t.mom[l] = has_mom ? static_cast<float*>(moms[l]) : nullptr;
    t.offset[l + 1] = t.offset[l] + numels[l];
  }
  const Hyper h{lr, alpha, one_minus_alpha, eps, momentum, max_norm, clip,
                has_mom};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rmsprop_sumsq_kernel<<<n_partials, tbt::kThreads, 0, s>>>(t, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = tbt::grid_for(t.offset[n_leaves]);
  rmsprop_apply_kernel<<<blocks, tbt::kThreads, 0, s>>>(t, partials,
                                                        n_partials, sumsq, h);
  return static_cast<int>(cudaGetLastError());
}
