// One LSTM layer's recurrence: one launch a step forward, one a step back.
//
// Replaces no TPU kernel. The reference's core is flax's OptimizedLSTMCell
// under lax.scan (torchbeast_tpu/models/cores.py), which it leaves to XLA.
// This kernel was added because the port's core, about a dozen separate
// operations a layer-step forward and twice that back, took 80% of the
// shallow network's update in launch chains of small SIMT products and
// gate arithmetic (PERF.md section 5).
//
// Per step t of a layer (gates in torch's i, f, g, o order, H units):
//
//   pre_t = x_proj_t + nd_t * (h_{t-1} @ W_hh^T)   (x_proj_t carries the bias)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of pre_t's four quarters
//   c_t = f * (c_{t-1} * nd_t) + i * g,   h_t = o * tanh(c_t)
//
// nd_t is 0 where an episode ended before step t: the carried state is
// reset. Backward, from the last step down, with dc carrying
// dc_t * f_t * nd_t to step t - 1:
//
//   dh_t = dy_t + nd_{t+1} * (dgates_{t+1} @ W_hh)
//   dc_t = dc + dh_t * o * (1 - tanh(c_t)^2)
//   dgates_t = (dc_t g i(1-i), dc_t c_{t-1} nd_t f(1-f), dc_t i (1-g^2),
//               dh_t tanh(c_t) o(1-o))
//
// Everything that is not on the recurrence runs outside, once for all
// steps (ops/lstm.py): the input products, the weight gradient, d h0.
//
// Bound on the H100, a step at B=32, H=519: one [32 x 519] x [519 x 2076]
// product, 69 MFLOP, about 1.0 us at 67 TFLOP/s in f32; and W_hh read
// once, 4.3 MB, about 1.3 us at 3.35 TB/s (it stays in the 50 MB L2 from
// step to step). A launch a step adds its own cost: in a CUDA graph an
// empty kernel takes about 1 us a launch, and every block reads the whole
// of h_{t-1} forward (8.6 MB a step from L2 over 130 blocks) and its
// batch rows of dgates_{t+1} back (17 MB), which L2 serves at some 5 TB/s.
//
// Design: about one block a SM. Forward a block owns J hidden units, so
// 4J rows of W_hh, and 32 batch rows: J = 4 (130 blocks at H = 519), J = 2
// (128 at H = 256). Back it owns 2J units, so 2J columns of W_hh, and 16
// batch rows: every block reads all 4H columns of its rows of dgates, so
// half as many unit groups read a third less in all. A block streams its
// operands through two slots of shared memory in chunks of 64 columns
// forward and 128 back (whose reduction runs over 4H), loaded into
// registers three chunks ahead with plain coalesced loads: 4 bytes
// forward (H is odd in the shallow network: rows are not 16-byte
// aligned), 16 back (rows of dgates are 4H wide). Each of 8 warps reduces
// its own columns of every chunk in full-f32 FFMA (no TF32: the
// configurations hold products to full f32), a lane 4 batch rows against
// 4 rows of W forward, 2 batch rows and 4 columns against its block's
// units back, read 16 bytes at a time from shared memory. The warps'
// partial sums meet in shared memory, and the epilogue of the same launch
// applies the cell: forward it writes h_t, c_t and, when a gradient is
// wanted, the activated gates; back it writes the 4 gate columns of each
// of its units in dgates_t and its slice of the dc carry, which no other
// block touches, so the carry needs no atomics. Launches go on the
// caller's stream and allocate nothing, so a CUDA graph captures them.
//
// At H = 519 a step takes about 10 us forward and 12 back in a graph; the
// loads from L2 take about 3 and 6 of that, the epilogue about 2.5. The
// first version (4-byte cp.async copies, a lane one batch row against
// every row of W, 32 batch rows back) took 15 and 25 (PERF.md).
#include "common.cuh"

namespace {

constexpr int kBT = 32;  // batch rows a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Reduction columns a chunk: the backward's reduction runs over 4H.
constexpr int kFwdKC = 64;
constexpr int kBwdKC = 128;
// Chunks whose loads are in flight at once.
constexpr int kDepth = 3;

__device__ inline float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ inline float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// A row of J floats read from shared memory in one access (two at J = 8).
template <int J>
struct alignas(4 * J) Row {
  float v[J];
};

// The reduction over `chunks` chunks: load(c, d) reads chunk c from
// device memory into register set d (kDepth sets, so kDepth chunks are in
// flight), store(d, slot) writes a set to one of two slots of shared
// memory, compute(slot) reduces a slot. A slot is refilled only after
// every warp has passed the barrier that follows its last reduction: one
// barrier a chunk.
template <typename Load, typename Store, typename Compute>
__device__ inline void ring(int chunks, Load load, Store store,
                            Compute compute) {
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    if (d < chunks) load(d, d);
  for (int c0 = 0; c0 < chunks; c0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int c = c0 + d;
      if (c < chunks) {
        store(d, c & 1);
        __syncthreads();
        if (c + kDepth < chunks) load(c + kDepth, d);
        compute(c & 1);
      }
    }
  }
  __syncthreads();
}

// grid (ceil(H / J), ceil(B / kBT)); one step forward. gates, h_last and
// c_last may be null.
template <int J>
__global__ void __launch_bounds__(kThreads)
    lstm_step_fwd_kernel(const float* __restrict__ x_proj,
                         const float* __restrict__ nd,
                         const float* __restrict__ h_prev,
                         const float* __restrict__ c_prev,
                         const float* __restrict__ w,
                         float* __restrict__ h_out, float* __restrict__ c_out,
                         float* __restrict__ gates,
                         float* __restrict__ h_last,
                         float* __restrict__ c_last, int B, int H) {
  constexpr int R = 4 * J;  // the block's rows of W_hh: gate-major
  constexpr int U = R / 4;  // rows of W a lane reduces
  constexpr int kLD = kFwdKC + 4;  // padded: conflict-free 16-byte reads
  constexpr int kHs = kBT * kLD, kWs = R * kLD;
  constexpr int kGroups = kThreads / kFwdKC;  // rows a pass of the block
  constexpr int kHr = kBT / kGroups, kWr = R / kGroups;
  static_assert(R % kGroups == 0, "rows of W_hh a thread stages");
  // The two slots; after the reduction, the warps' partial sums.
  __shared__ __align__(16) float smem[2 * (kHs + kWs)];
  static_assert(kWarps * R * kBT <= 2 * (kHs + kWs), "red");
  float* hs = smem;
  float* ws = smem + 2 * kHs;
  float* red = smem;  // [kWarps][R][kBT]
  const int j0 = blockIdx.x * J, b0 = blockIdx.y * kBT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Staging: column k of a chunk, rows r0, r0 + kGroups, ...
  const int k = threadIdx.x % kFwdKC, r0 = threadIdx.x / kFwdKC;
  float hv[kDepth][kHr], wv[kDepth][kWr];
  // Reduction: the lane's batch rows bq + 8i, W rows rq + 4u.
  const int bq = lane % 8, rq = lane / 8;
  float acc[4][U];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < U; ++u) acc[i][u] = 0.f;
  ring(
      (H + kFwdKC - 1) / kFwdKC,
      [&](int c, int d) {
        const int kk = c * kFwdKC + k;
#pragma unroll
        for (int i = 0; i < kHr; ++i) {
          const long long bb = b0 + r0 + kGroups * i;
          hv[d][i] = bb < B && kk < H ? __ldg(h_prev + bb * H + kk) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < kWr; ++i) {
          const int q = r0 + kGroups * i, jw = j0 + q % J;
          const long long row = static_cast<long long>(q / J) * H + jw;
          wv[d][i] = jw < H && kk < H ? __ldg(w + row * H + kk) : 0.f;
        }
      },
      [&](int d, int slot) {
#pragma unroll
        for (int i = 0; i < kHr; ++i)
          hs[slot * kHs + (r0 + kGroups * i) * kLD + k] = hv[d][i];
#pragma unroll
        for (int i = 0; i < kWr; ++i)
          ws[slot * kWs + (r0 + kGroups * i) * kLD + k] = wv[d][i];
      },
      [&](int slot) {
        const float* hsl = hs + slot * kHs;
        const float* wsl = ws + slot * kWs;
#pragma unroll
        for (int s = 0; s < kFwdKC / kWarps; s += 4) {
          const int kc = warp * (kFwdKC / kWarps) + s;
          float4 h[4], v[U];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            h[i] = *reinterpret_cast<const float4*>(
                hsl + (bq + 8 * i) * kLD + kc);
#pragma unroll
          for (int u = 0; u < U; ++u)
            v[u] = *reinterpret_cast<const float4*>(
                wsl + (rq + 4 * u) * kLD + kc);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int u = 0; u < U; ++u) acc[i][u] = dot4(h[i], v[u], acc[i][u]);
        }
      });
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < U; ++u)
      red[(warp * R + rq + 4 * u) * kBT + bq + 8 * i] = acc[i][u];
  __syncthreads();

  if (threadIdx.x >= J * kBT) return;
  const int bl = threadIdx.x % kBT, jj = threadIdx.x / kBT;
  const int b = b0 + bl, j = j0 + jj;
  if (b >= B || j >= H) return;
  const float keep = nd[b];
  const long long bh = static_cast<long long>(b) * H + j;
  const long long b4 = static_cast<long long>(b) * 4 * H + j;
  float pre[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red[(v * R + g * J + jj) * kBT + bl];
    pre[g] = x_proj[b4 + g * H] + keep * s;
  }
  const float ig = sigmoid(pre[0]), fg = sigmoid(pre[1]);
  const float gg = tanhf(pre[2]), og = sigmoid(pre[3]);
  const float c = fg * (c_prev[bh] * keep) + ig * gg;
  const float h = og * tanhf(c);
  h_out[bh] = h;
  c_out[bh] = c;
  if (gates != nullptr) {
    gates[b4] = ig;
    gates[b4 + H] = fg;
    gates[b4 + 2 * H] = gg;
    gates[b4 + 3 * H] = og;
  }
  if (h_last != nullptr) {
    h_last[bh] = h;
    c_last[bh] = c;
  }
}

// grid (ceil(H / J), ceil(B / BT)); one step back. dg_next and nd_next
// are null at the last step, dy and dh_last may be null. dg_next's rows
// (4H floats) are read 16 bytes at a time: it must be 16-byte aligned.
template <int J, int BT>
__global__ void __launch_bounds__(kThreads)
    lstm_step_bwd_kernel(const float* __restrict__ dg_next,
                         const float* __restrict__ nd_next,
                         const float* __restrict__ w,
                         const float* __restrict__ dy,
                         const float* __restrict__ dh_last,
                         const float* __restrict__ gates,
                         const float* __restrict__ c_t,
                         const float* __restrict__ c_prev,
                         const float* __restrict__ nd,
                         float* __restrict__ dc, float* __restrict__ dg,
                         int B, int H) {
  constexpr int kLD = kBwdKC + 4;  // padded: conflict-free 16-byte reads
  constexpr int kGs = BT * kLD, kWs = kBwdKC * J;
  constexpr int kRow4 = kBwdKC / 4;          // float4 a chunk row
  constexpr int kGroups = kThreads / kRow4;  // rows a pass
  constexpr int kGr = BT / kGroups;          // float4 a thread
  constexpr int kWr = (kWs + kThreads - 1) / kThreads;
  constexpr int kCols = kBwdKC / kWarps;     // a warp's columns
  constexpr int I = BT / 8;                  // batch rows a lane
  static_assert(kCols == 16, "a lane reduces 4 of its warp's 16 columns");
  static_assert(BT % kGroups == 0 && J * BT <= kThreads, "block shape");
  __shared__ __align__(32) float smem[2 * (kGs + kWs)];
  static_assert(kWarps * J * BT <= 2 * (kGs + kWs), "red");
  float* gs = smem;
  float* ws = smem + 2 * kGs;  // W_hh[q, j0:j0+J], row-major
  float* red = smem;           // [kWarps][J][BT]
  const int j0 = blockIdx.x * J, b0 = blockIdx.y * BT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = 4 * H;

  if (dg_next != nullptr) {
    // Staging: float4 column c4 of a chunk, rows r0, r0 + kGroups, ...;
    // elements e, e + kThreads, ... of W's slice.
    const int c4 = threadIdx.x % kRow4, r0 = threadIdx.x / kRow4;
    float4 gv[kDepth][kGr];
    float wv[kDepth][kWr];
    // Reduction: the lane's batch rows bq + 8i, columns 4 qs .. 4 qs + 3
    // of its warp's.
    const int bq = lane % 8, qs = lane / 8;
    float acc[I][J];
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int jw = 0; jw < J; ++jw) acc[i][jw] = 0.f;
    ring(
        (K + kBwdKC - 1) / kBwdKC,
        [&](int c, int d) {
          const int q = c * kBwdKC + 4 * c4;
#pragma unroll
          for (int i = 0; i < kGr; ++i) {
            const int bb = b0 + r0 + kGroups * i;
            gv[d][i] = bb < B && q < K
                           ? __ldg(reinterpret_cast<const float4*>(
                                 dg_next + static_cast<long long>(bb) * K + q))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int i = 0; i < kWr; ++i) {
            const int e = threadIdx.x + kThreads * i;
            const int qq = c * kBwdKC + e / J, jw = j0 + e % J;
            wv[d][i] = e < kWs && qq < K && jw < H
                           ? __ldg(w + static_cast<long long>(qq) * H + jw)
                           : 0.f;
          }
        },
        [&](int d, int slot) {
#pragma unroll
          for (int i = 0; i < kGr; ++i)
            *reinterpret_cast<float4*>(gs + slot * kGs +
                                       (r0 + kGroups * i) * kLD + 4 * c4) =
                gv[d][i];
#pragma unroll
          for (int i = 0; i < kWr; ++i) {
            const int e = threadIdx.x + kThreads * i;
            if (e < kWs) ws[slot * kWs + e] = wv[d][i];
          }
        },
        [&](int slot) {
          const int q = warp * kCols + 4 * qs;
          float4 g4[I];
#pragma unroll
          for (int i = 0; i < I; ++i)
            g4[i] = *reinterpret_cast<const float4*>(
                gs + slot * kGs + (bq + 8 * i) * kLD + q);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const Row<J> r = *reinterpret_cast<const Row<J>*>(
                ws + slot * kWs + (q + u) * J);
#pragma unroll
            for (int i = 0; i < I; ++i) {
              const float gq = u == 0 ? g4[i].x
                               : u == 1 ? g4[i].y
                               : u == 2 ? g4[i].z
                                        : g4[i].w;
#pragma unroll
              for (int jw = 0; jw < J; ++jw)
                acc[i][jw] = fmaf(gq, r.v[jw], acc[i][jw]);
            }
          }
        });
    // The lanes of one batch row hold 4 partial sums: add them, then the
    // warps' in shared memory.
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int jw = 0; jw < J; ++jw) {
        float v = acc[i][jw];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (qs == 0) red[(warp * J + jw) * BT + bq + 8 * i] = v;
      }
    __syncthreads();
  }

  if (threadIdx.x >= J * BT) return;
  const int bl = threadIdx.x % BT, jj = threadIdx.x / BT;
  const int b = b0 + bl, j = j0 + jj;
  if (b >= B || j >= H) return;
  const long long bh = static_cast<long long>(b) * H + j;
  const long long b4 = static_cast<long long>(b) * 4 * H + j;
  float dh = 0.f;
  if (dy != nullptr) dh += dy[bh];
  if (dh_last != nullptr) dh += dh_last[bh];
  if (dg_next != nullptr) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += red[(v * J + jj) * BT + bl];
    dh += nd_next[b] * s;
  }
  const float ig = gates[b4], fg = gates[b4 + H];
  const float gg = gates[b4 + 2 * H], og = gates[b4 + 3 * H];
  const float tc = tanhf(c_t[bh]);
  const float keep = nd[b];
  const float dct = dc[bh] + dh * og * (1.f - tc * tc);
  dg[b4] = dct * gg * ig * (1.f - ig);
  dg[b4 + H] = dct * (c_prev[bh] * keep) * fg * (1.f - fg);
  dg[b4 + 2 * H] = dct * ig * (1.f - gg * gg);
  dg[b4 + 3 * H] = dh * tc * og * (1.f - og);
  dc[bh] = dct * fg * keep;
}

// Units a block: about one block a SM at the networks' widths. The
// backward's blocks take half the batch rows and twice the units: every
// block reads all of dgates_{t+1}, so fewer unit groups read less of it.
int units_per_block(int H) { return H <= 160 ? 1 : (H <= 320 ? 2 : 4); }
constexpr int kBwdBT = 16;

template <int J>
int fwd_steps(const float* x_proj, const float* nd, const float* h0,
              const float* c0, const float* w, float* h_seq, float* c_seq,
              float* gates, float* h_last, float* c_last, int T, int B,
              int H, cudaStream_t stream) {
  const dim3 grid((H + J - 1) / J, (B + kBT - 1) / kBT);
  const long long bh = static_cast<long long>(B) * H;
  for (int t = 0; t < T; ++t) {
    const bool last = t == T - 1;
    lstm_step_fwd_kernel<J><<<grid, kThreads, 0, stream>>>(
        x_proj + t * 4 * bh, nd + static_cast<long long>(t) * B,
        t == 0 ? h0 : h_seq + (t - 1) * bh, t == 0 ? c0 : c_seq + (t - 1) * bh,
        w, h_seq + t * bh, c_seq + t * bh,
        gates == nullptr ? nullptr : gates + t * 4 * bh,
        last ? h_last : nullptr, last ? c_last : nullptr, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int J, int BT>
int bwd_steps(const float* nd, const float* w, const float* gates,
              const float* c_seq, const float* c0, const float* dy,
              const float* dh_last, float* dc, float* dgates, int T, int B,
              int H, cudaStream_t stream) {
  const dim3 grid((H + J - 1) / J, (B + BT - 1) / BT);
  const long long bh = static_cast<long long>(B) * H;
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t == T - 1;
    lstm_step_bwd_kernel<J, BT><<<grid, kThreads, 0, stream>>>(
        last ? nullptr : dgates + (t + 1) * 4 * bh,
        last ? nullptr : nd + static_cast<long long>(t + 1) * B, w,
        dy == nullptr ? nullptr : dy + t * bh, last ? dh_last : nullptr,
        gates + t * 4 * bh, c_seq + t * bh,
        t == 0 ? c0 : c_seq + (t - 1) * bh, nd + static_cast<long long>(t) * B,
        dc, dgates + t * 4 * bh, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// The forward of one layer over T steps: T launches. All f32, contiguous:
// x_proj [T, B, 4H], notdone [T, B], h0, c0 [B, H], w [4H, H]; out h_seq,
// c_seq [T, B, H], gates [T, B, 4H] (null: not kept), h_last, c_last
// [B, H] (step T - 1's h and c).
TBT_API int tbt_lstm_fwd(const void* x_proj, const void* notdone,
                         const void* h0, const void* c0, const void* w,
                         void* h_seq, void* c_seq, void* gates, void* h_last,
                         void* c_last, int T, int B, int H, void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (units_per_block(H)) {
    case 1:
      return fwd_steps<1>(f(x_proj), f(notdone), f(h0), f(c0), f(w),
                          m(h_seq), m(c_seq), m(gates), m(h_last),
                          m(c_last), T, B, H, s);
    case 2:
      return fwd_steps<2>(f(x_proj), f(notdone), f(h0), f(c0), f(w),
                          m(h_seq), m(c_seq), m(gates), m(h_last),
                          m(c_last), T, B, H, s);
    default:
      return fwd_steps<4>(f(x_proj), f(notdone), f(h0), f(c0), f(w),
                          m(h_seq), m(c_seq), m(gates), m(h_last),
                          m(c_last), T, B, H, s);
  }
}

// The backward of one layer over T steps, from the last: T launches.
// dy [T, B, H] and dh_last [B, H] may be null (no gradient). dc [B, H]
// holds dc_T on entry (zeros for none) and d c0 on return; dgates
// [T, B, 4H], 16-byte aligned, is written whole.
TBT_API int tbt_lstm_bwd(const void* notdone, const void* w,
                         const void* gates, const void* c_seq,
                         const void* c0, const void* dy, const void* dh_last,
                         void* dc, void* dgates, int T, int B, int H,
                         void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  if (!tbt::aligned16(dgates))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (units_per_block(H)) {
    case 1:
      return bwd_steps<2, kBwdBT>(f(notdone), f(w), f(gates), f(c_seq),
                                  f(c0), f(dy), f(dh_last), m(dc),
                                  m(dgates), T, B, H, s);
    case 2:
      return bwd_steps<4, kBwdBT>(f(notdone), f(w), f(gates), f(c_seq),
                                  f(c0), f(dy), f(dh_last), m(dc),
                                  m(dgates), T, B, H, s);
    default:
      return bwd_steps<8, kBwdBT>(f(notdone), f(w), f(gates), f(c_seq),
                                  f(c0), f(dy), f(dh_last), m(dc),
                                  m(dgates), T, B, H, s);
  }
}
