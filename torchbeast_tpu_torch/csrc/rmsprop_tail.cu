// The learner's optimizer tail over every parameter leaf in one launch:
// global-norm clip -> torch-RMSprop second moment -> optional momentum
// trace -> learning-rate apply, updating params, nu and mom IN PLACE.
//
// Replaces the TPU kernel torchbeast_tpu/ops/pallas_opt.py::_tail_kernel
// (launched once per leaf, or per leading-axis chunk, by _run_leaf; chunk
// size from _leaf_grid). The JAX kernel returns new arrays; here the
// wrapper hands the kernel the live parameter, nu and mom tensors and they
// are overwritten in place, so no parameter-sized output is allocated.
//
//   pass 1  each block's partial sum of g^2 (f64) over its share of the
//           leaves; then a grid-wide barrier
//   pass 2  every block finishes the norm from the partials once (the
//           same fixed order in every block, no atomics; block 0 also
//           writes the squared norm out, the learner's grad_norm stat),
//           then per element:
//             g    = g * (max_norm / |g|)      only when |g| >= max_norm
//             nu   = alpha * nu + ((1 - alpha) * g) * g
//             upd  = g / (sqrt(nu) + eps)
//             upd  = momentum * mom + upd;  mom = upd   (momentum > 0)
//             w    = w - lr * upd
//
// The learning rate is read from device memory (`lr`, one f32 the learner
// computes from its device-resident update count), not passed by value, so
// a launch captured in a CUDA graph applies each replay's own rate.
//
// Storage types, as in the reference's --precision policies: the params
// (and so their gradients) are f32 or bf16, nu f32 or bf16 (bf16 when the
// params are), mom always f32. With f32 params, w is the param itself.
// With bf16 params (bf16_train) w is the f32 master, a separate table
// column: the update reads and writes the master in f32 and writes the
// param as bf16(master), the reference's resident narrowing cast. bf16
// values are widened on
// read and every operation runs in f32 (the f32-accumulate contract); nu
// and the param are narrowed on write, rounding to nearest even.
//
// Design. The leaves ride in one table passed by value as a kernel
// parameter (multi-tensor apply), at most kMaxLeaves = 256 leaves: 12.3
// KB at f32, 14.4 KB with bf16's master column, above the classic 4 KB
// limit of a launch's parameters and within the 32,764 bytes that CUDA
// 12.1 and later take on Volta and newer cards, cooperative launches and
// graph capture included. The kernel reads it where it lies, in the
// constant bank.
// Each leaf is cut into units of 4 elements, numbered across the leaves
// (the table holds each leaf's first unit), and the grid is persistent:
// cooperative, at most the blocks the card holds at once, so the grid-wide
// barrier (cooperative_groups grid sync) is safe and the whole tree is one
// launch. A thread takes units tid, tid + S, tid + 2 S, ... (S the grid's
// threads) of the numbering, so every block's share differs by at most one
// unit; it finds its first unit's leaf by a binary search once a pass and
// then only steps its leaf cursor forward. A unit is one access of each
// role (16 bytes of f32, 8 of bf16) where the leaf's pointers are aligned
// for it; a leaf's ragged end (its last numel % 4 elements, e.g. the
// 6-element policy bias) and any unaligned leaf take scalar accesses.
// Pass 2 reads g again from the 50 MB L2, where pass 1 left it (6.5 MB for
// the deep model's f32 tree, 16 MB for the transformer's); a tree whose
// gradients outgrow L2 (DeepSeek-V2-Lite's cut, 5.5 GB) reads them twice
// from HBM.
//
// Bound on the H100 (3.35 TB/s): bytes, counting each input read once and
// each output written once. f32: g, nu, p in and nu, p out, 20 B a
// parameter (28 B with momentum); 1,617,367 params (the deep model with
// its LSTM): 32.3 MB, 9.66 us; 4,012,047 (the transformer): 80.2 MB,
// 24.0 us. bf16_train: g 2, nu 2 + 2, master 4 + 4, param 2: 16 B a
// parameter, 7.72 us and 19.2 us. Measured times beside these are in
// PERF.md.
//
// Arithmetic uses the round-to-nearest intrinsics so no multiply-add is
// contracted: the update repeats the plain PyTorch version
// (ops/opt.py::rmsprop_tail_plain) operation for operation.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLeaves = 256;
constexpr int kTailThreads = 256;
constexpr int kTailBlocksPerSm = 4;  // the grid: at most this many an SM
constexpr unsigned kFull = 0xffffffffu;

// The f32 master column, which only bf16 params have (f32 params are their
// own master). For f32 params it is an empty base.
template <typename PT>
struct MasterColumn {};
template <>
struct MasterColumn<tbt::bf16> {
  float* master[kMaxLeaves];
};

// PT: the params' (and gradients') storage type, NT: nu's.
template <typename PT, typename NT>
struct LeafTable : MasterColumn<PT> {
  static constexpr bool kMaster = std::is_same<PT, tbt::bf16>::value;
  PT* param[kMaxLeaves];
  const PT* grad[kMaxLeaves];
  NT* nu[kMaxLeaves];
  float* mom[kMaxLeaves];
  long long numel[kMaxLeaves];
  long long unit0[kMaxLeaves + 1];  // each leaf's first unit of 4 elements
  // bit l % 64 of word l / 64: leaf l takes 4-wide accesses
  unsigned long long vec[kMaxLeaves / 64];
  int n;
};

struct Hyper {
  const float* lr;  // device memory: this update's learning rate
  float alpha, one_minus_alpha, eps, momentum, max_norm;
  int clip, has_mom;
};

// The leaf holding unit u: the last l with unit0[l] <= u.
template <typename Table>
__device__ inline int find_leaf(const Table& t, long long u) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.unit0[mid] <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Sum of a double over the block in a fixed order (shuffles within each
// warp, then the warps' totals in order); every thread gets the total.
__device__ inline double block_total(double v, double* warp_totals) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_totals[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < warps; ++w) s += warp_totals[w];
  __syncthreads();  // warp_totals is reused by the next call
  return s;
}

// The update of one element, in the plain version's order.
__device__ inline void update_one(float g, float& nu, float& w, float& mom,
                                  float scale, bool rescale, float lr,
                                  const Hyper& h) {
  if (rescale) g = __fmul_rn(g, scale);
  nu = __fadd_rn(__fmul_rn(h.alpha, nu),
                 __fmul_rn(__fmul_rn(h.one_minus_alpha, g), g));
  float upd = __fdiv_rn(g, __fadd_rn(__fsqrt_rn(nu), h.eps));
  if (h.has_mom) {
    upd = __fadd_rn(__fmul_rn(h.momentum, mom), upd);
    mom = upd;
  }
  w = __fsub_rn(w, __fmul_rn(lr, upd));
}

// Visit this thread's units: f(leaf, first element, elements in the unit
// (1..4), whether the unit takes one 4-wide access).
template <typename Table, typename F>
__device__ inline void for_each_unit(const Table& t, F f) {
  const long long units = t.unit0[t.n];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= units) return;
  int leaf = find_leaf(t, u);
  for (; u < units; u += stride) {
    while (u >= t.unit0[leaf + 1]) ++leaf;
    const long long e = 4 * (u - t.unit0[leaf]);
    const int n = static_cast<int>(min(4LL, t.numel[leaf] - e));
    f(leaf, e, n, n == 4 && ((t.vec[leaf >> 6] >> (leaf & 63)) & 1ULL));
  }
}

template <typename PT, typename NT>
__global__ void __launch_bounds__(kTailThreads, kTailBlocksPerSm)
    rmsprop_tail_kernel(const LeafTable<PT, NT> t,
                        double* __restrict__ partials,
                        float* __restrict__ sumsq_out, const Hyper h) {
  // bf16 params keep their f32 master in its own column.
  constexpr bool kMaster = LeafTable<PT, NT>::kMaster;
  __shared__ double warp_totals[kTailThreads / 32];
  // Pass 1: this block's share of sum(g^2), in f64.
  double s = 0.0;
  for_each_unit(t, [&](int leaf, long long e, int n, bool vec) {
    const PT* g = t.grad[leaf] + e;
    if (vec) {
      float v[4];
      tbt::load4(g, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) s += static_cast<double>(v[k]) * v[k];
    } else {
      for (int k = 0; k < n; ++k) {
        const float v = tbt::to_float(g[k]);
        s += static_cast<double>(v) * v;
      }
    }
  });
  s = block_total(s, warp_totals);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
  cg::this_grid().sync();

  // Every block sums the partials in the same order.
  double tot = 0.0;
  for (int k = threadIdx.x; k < gridDim.x; k += blockDim.x)
    tot += __ldcg(partials + k);
  const float sumsq = static_cast<float>(block_total(tot, warp_totals));
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

  // Pass 2: the update.
  const float lr = __ldg(h.lr);
  for_each_unit(t, [&](int leaf, long long e, int n, bool vec) {
    const PT* g = t.grad[leaf] + e;
    NT* nu = t.nu[leaf] + e;
    PT* p = t.param[leaf] + e;
    float* mst = nullptr;
    if constexpr (kMaster) mst = t.master[leaf] + e;
    float* mom = h.has_mom ? t.mom[leaf] + e : nullptr;
    if (vec) {
      float gv[4], nv[4], wv[4], mv[4] = {0.f, 0.f, 0.f, 0.f};
      tbt::load4(g, gv);
      tbt::load4(nu, nv);
      if constexpr (kMaster) tbt::load4(mst, wv); else tbt::load4(p, wv);
      if (mom) tbt::load4(mom, mv);
      // Four calls, not a loop over k: nvcc unswitches such a loop on
      // `rescale` and then computes the four square roots one after the
      // other (1.5% slower on an H100).
      update_one(gv[0], nv[0], wv[0], mv[0], scale, rescale, lr, h);
      update_one(gv[1], nv[1], wv[1], mv[1], scale, rescale, lr, h);
      update_one(gv[2], nv[2], wv[2], mv[2], scale, rescale, lr, h);
      update_one(gv[3], nv[3], wv[3], mv[3], scale, rescale, lr, h);
      tbt::store4(nu, nv);
      tbt::store4(p, wv);
      if constexpr (kMaster) tbt::store4(mst, wv);
      if (mom) tbt::store4(mom, mv);
    } else {
      for (int k = 0; k < n; ++k) {
        float nk = tbt::to_float(nu[k]);
        float wk = kMaster ? mst[k] : tbt::to_float(p[k]);
        float mk = mom ? mom[k] : 0.f;
        update_one(tbt::to_float(g[k]), nk, wk, mk, scale, rescale, lr,
                   h);
        nu[k] = tbt::from_float<NT>(nk);
        p[k] = tbt::from_float<PT>(wk);
        if (kMaster) mst[k] = wk;
        if (mom) mom[k] = mk;
      }
    }
  });
}

template <typename PT, typename NT>
int launch(void* const* params, void* const* grads, void* const* nus,
           void* const* moms, void* const* masters, const long long* numels,
           int n_leaves, double* partials, int n_partials, float* sumsq,
           const Hyper& h, cudaStream_t stream) {
  constexpr bool kMaster = LeafTable<PT, NT>::kMaster;
  static_assert(sizeof(LeafTable<PT, NT>) + sizeof(double*) +
                        sizeof(float*) + sizeof(Hyper) <= 32764,
                "the launch's parameters exceed CUDA's 32,764 bytes");
  // A unit's access: 4 elements of each role at once.
  constexpr int kP = 4 * sizeof(PT), kN = 4 * sizeof(NT), kF = 16;
  LeafTable<PT, NT> t;
  t.n = n_leaves;
  t.unit0[0] = 0;
  for (int w = 0; w < kMaxLeaves / 64; ++w) t.vec[w] = 0;
  for (int l = 0; l < n_leaves; ++l) {
    t.param[l] = static_cast<PT*>(params[l]);
    t.grad[l] = static_cast<const PT*>(grads[l]);
    t.nu[l] = static_cast<NT*>(nus[l]);
    t.mom[l] = h.has_mom ? static_cast<float*>(moms[l]) : nullptr;
    if constexpr (kMaster) t.master[l] = static_cast<float*>(masters[l]);
    t.numel[l] = numels[l];
    t.unit0[l + 1] = t.unit0[l] + (numels[l] + 3) / 4;
    const bool aligned = tbt::aligned(t.param[l], kP) &&
                         tbt::aligned(t.grad[l], kP) &&
                         tbt::aligned(t.nu[l], kN) &&
                         (!h.has_mom || tbt::aligned(t.mom[l], kF)) &&
                         (!kMaster || tbt::aligned(masters[l], kF));
    if (aligned) t.vec[l >> 6] |= 1ULL << (l & 63);
  }
  // The grid: no more blocks than the card holds at once (the grid-wide
  // barrier needs them all resident), than the partials, or than the work.
  auto kernel = rmsprop_tail_kernel<PT, NT>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTailThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = static_cast<long long>(sms) *
                     (per_sm < kTailBlocksPerSm ? per_sm : kTailBlocksPerSm);
  if (blocks > n_partials) blocks = n_partials;
  const long long need = (t.unit0[n_leaves] + kTailThreads - 1) / kTailThreads;
  if (blocks > need) blocks = need > 0 ? need : 1;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // Stream capture records this launch as a cooperative kernel node (CUDA
  // 12.8), so the learner's CUDA graph replays it as it is.
  void* args[] = {&t, &partials, &sumsq, const_cast<Hyper*>(&h)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kTailThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partials: n_partials doubles of scratch; the grid takes at most that
// many blocks (the wrapper gives kTailBlocksPerSm per SM). param_bf16: the
// params and gradients are bf16 and `masters` holds each leaf's f32 master
// (ignored otherwise); nu_bf16: nu is bf16. Three instances: f32 params
// with f32 nu (the f32 and bf16_compute policies) or bf16 nu (the
// reference's opt_state_dtype alone), and bf16 params with bf16 nu
// (bf16_train); bf16 params with f32 nu, which no policy makes, are
// refused.
TBT_API int tbt_rmsprop_tail(void* const* params, void* const* grads,
                             void* const* nus, void* const* moms,
                             void* const* masters, const long long* numels,
                             int n_leaves, double* partials, int n_partials,
                             float* sumsq, const float* lr, float alpha,
                             float one_minus_alpha, float eps,
                             float momentum, float max_norm, int clip,
                             int has_mom, int param_bf16, int nu_bf16,
                             void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_partials < 1 ||
      (param_bf16 && !nu_bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{lr, alpha, one_minus_alpha, eps, momentum, max_norm, clip,
                has_mom};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using tbt::bf16;
  if (param_bf16)
    return launch<bf16, bf16>(params, grads, nus, moms, masters, numels,
                              n_leaves, partials, n_partials, sumsq, h, s);
  if (nu_bf16)
    return launch<float, bf16>(params, grads, nus, moms, masters, numels,
                               n_leaves, partials, n_partials, sumsq, h, s);
  return launch<float, float>(params, grads, nus, moms, masters, numels,
                              n_leaves, partials, n_partials, sumsq, h, s);
}
