// Fused attention of the transformer policy: forward, and the backward
// that recomputes the probabilities.
//
// Replaces the TPU kernel torchbeast_tpu/ops/pallas_attention.py::_kernel
// (launched by _pallas_forward through transformer_attention). The TPU
// kernel has no backward of its own: its custom VJP recomputes through the
// jnp reference (_bwd). Here the backward is hand-written too.
//
// Per (b, h), query t attends to keys j of the combined [cache; unroll]
// axis (K = M + T keys, key j at time j - M) inside the band j in
// [t, t + M], i.e. at relative offset o = t - j + M in [0, M]:
//
//   s_tj = (q_t . k_j) / sqrt(D) + rel_bias[h, o]     if visible(t, j)
//   visible: cache key (j < M):  cache_valid[b, j] != 0 and no_done[b, t]
//            unroll key (j >= M): seg[b, t] == seg[b, j - M]
//   out_t = sum_j softmax_j(s_tj) v_j                 (masked: weight 0)
//
// Every row sees at least its own key (offset 0, its own segment), so no
// row is empty, and a masked key gets weight exactly 0, as the reference's
// -1e30 score does.
//
// Storage: q, k, v, out, dO and dq, dk, dv are f32, or bf16 under the bf16
// precision policies; rel_bias and its gradient f32 or bf16 on their own;
// lse f32. bf16 rows are widened to f32 as they are staged into shared
// memory (so every loop below reads f32 and its shared-memory tiles are
// the f32 ones), all arithmetic is f32, as the reference's kernel widens
// q, k and v, and outputs are narrowed on their one write, rounding to
// nearest even. The backward's dK and dV, where they gather across row
// tiles, gather in an f32 scratch and are narrowed once at the end.
//
// Layouts are the model's [B, T, H, D] and [B, K, H, D]: no transposes,
// and the mask and the bias index are computed in the kernels from seg,
// cache_valid and no_done (the TPU kernel had the bias expanded to
// [H, T, K] in HBM for Mosaic's sake). Arithmetic is f32 on the CUDA
// cores: the forward is 0.09 GFLOP at the learner shape, about 1.3 us at
// the card's f32 rate, and TF32 tensor cores would not hold the stated
// tolerance.
//
// Forward. A block owns one (b, h) and a tile of TQ query rows. It copies
// the tile's q rows and its whole band of keys, [t0, t_last + M], of K and
// V into shared memory once, with 16-byte cp.async (each key row is D
// contiguous floats at a stride of H * D), and while those fly it puts
// each key's mask tag (a cache slot's validity, an unroll key's segment)
// and the bias of the tile's offsets there too, so nothing after the one
// barrier reads global memory; a band beyond the shared-memory budget
// (kSmemBudget) is taken in chunks. Each warp owns RW rows and takes the
// keys their bands need in slots of 32, one key a lane, kSlots slots a
// pass: the lane forms the RW scores of its key as outer products over D
// (one K float4 against RW broadcast q float4s), the warp reduces each
// row's max and sum once a pass (the RW shuffle chains side by side;
// online softmax across passes, so no [T, K] tile is stored), puts the
// probabilities in shared memory and sums P . V with lanes over the head
// dims, one broadcast read of the RW probabilities per key. It writes each
// row's log-sum-exp, from which the backward recomputes P. Two launch
// geometries share the kernel:
// - learner (T > kActingMaxT): RW = 4 rows a warp and up to kMaxRowGroups
//   warps, so at T = 81 one block of 21 warps holds all rows of a (b, h)
//   and HBM sees each key once; at M = 64 a warp's band is 68 keys, one
//   pass;
// - acting (T <= kActingMaxT, T = 1 when acting), in the spirit of flash
//   decoding: one row a block, its M + 1 keys split across S warps (up
//   to kMaxSplits) slot by slot, the warps' partial max, sum and
//   accumulator merged in shared memory at the end, so no warp idles for
//   want of a row.
//
// Backward, with Delta_t = rowsum(dO_t * O_t) and P from the lse:
//   dS = P * (dO V^T - Delta),  dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
//   dV = P^T dO,  d rel_bias[h, o] = sum over b, t of dS[t, t + M - o].
// One launch, one block per (b, h) (128 blocks at the learner shape, one
// an SM). The block copies its q, dO and O rows and the K and V rows of
// their band into shared memory once, with 16-byte cp.async as the
// forward does. Pass 1, warps over rows (4 rows a warp, lanes over keys,
// as in the forward's score loop), forms q . k and dO . v once per band
// pair and writes P and dS into [key][row] tiles in shared memory, then
// sums dQ with lanes over D. After one barrier, pass 2, warps over keys
// (8 at a time, lanes over D), sums dK and dV from the tiles: no pair is
// computed twice and nothing is staged twice. The block sums the dS tile
// along each band offset in order of t into one [M + 1] partial per
// (b, h); the last block of each head to finish (a ticket counter that it
// resets) adds the B partials in order of b into d rel_bias. No atomic
// decides an order: every output element has one writer and a fixed order
// of summation, so two calls give identical bits. Where a (b, h)'s rows
// and band exceed the shared-memory budget (kBwdSmemBudget), the same
// block walks row tiles and key chunks, and gathers dK and dV in global
// memory (it is their only writer).
//
// Bounds on the H100 (3.35 TB/s, 67 TFLOP/s f32), counting only the band's
// pairs (M + 1 keys a row): at the learner shape (B=32, T=81, H=4, D=32,
// M=64) the forward moves about 7.4 MB (q, k, v, out) for 0.09 GFLOP, so
// bytes bound it at about 2.2 us; at the acting shape (T=1) it moves about
// 2.2 MB, about 0.65 us; the backward moves about 15 MB for 0.21 GFLOP
// (10 D flops a pair), about 4.4 us. None of these kernels reaches its
// bound: the forward's time is one burst round trip to HBM for the
// staging plus the shared-memory traffic of the score and P . V loops (by
// their count about 290 wavefronts a warp at the learner shape), not its
// flops; the backward's measured times are in PERF.md.
#include <math.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

using tbt::bf16;

constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int B, T, H, D, M, K;
};

// Offset of element (b, n, h, 0) of a [B, N, H, D] tensor.
__device__ inline long long row_of(int b, int n, int h, int N, int H, int D) {
  return ((static_cast<long long>(b) * N + n) * H + h) * D;
}

// ------------------------------------------------------------- forward

constexpr int kSlots = 3;                // slots of 32 keys a warp pass
constexpr int kPassKeys = 32 * kSlots;
constexpr int kLearnerRows = 4;          // learner geometry: RW rows a warp,
constexpr int kMaxRowGroups = 24;        // at most this many warps a block
constexpr int kActingMaxT = 4;           // up to this T, one row a block
constexpr int kMaxSplits = 4;            // acting: warps sharing a row
constexpr int kMaxThreads = 32 * kMaxRowGroups;
constexpr size_t kSmemBudget = 160 * 1024;  // shared memory a block takes

// The launch geometry: TQ query rows a block, in G groups of RW rows (one
// warp each) times S warps that split each group's keys; KC keys a chunk;
// shared-memory rows of LD floats; vec: 16-byte copies.
struct FwdShape {
  int TQ, G, S, KC, LD;
  bool vec;
};

__device__ inline void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy n rows of D elements, `stride` elements apart in global memory,
// into shared-memory rows of LD floats; all threads of the block take part.
// The 4-wide path (D % 4 == 0, aligned) of f32 is a 16-byte cp.async that
// completes at cp_async_wait_all(); of bf16, an 8-byte load widened into
// one float4 store. The scalar path also zeroes the columns D ..
// round_up(D, 4) that the float4 dot products read.
template <typename T>
__device__ inline void stage_rows_async(float* dst, int LD, const T* src,
                                        long long stride, int n, int D,
                                        bool vec) {
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int cols = vec ? D / 4 : (D + 3) & ~3;
  auto copy = [&](int r, int c) {
    if (vec) {
      if constexpr (std::is_same<T, float>::value) {
        cp_async16(dst + r * LD + 4 * c, src + r * stride + 4 * c);
      } else {
        float v[4];
        tbt::load4(src + r * stride + 4 * c, v);
        tbt::store4(dst + r * LD + 4 * c, v);
      }
    } else {
      dst[r * LD + c] = c < D ? tbt::to_float(src[r * stride + c]) : 0.f;
    }
  };
  if (nthreads >= cols) {
    const int per = nthreads / cols;  // rows copied per pass
    if (tid >= per * cols) return;
    const int c = tid % cols;
    for (int r = tid / cols; r < n; r += per) copy(r, c);
  } else {
    for (int r = 0; r < n; ++r)
      for (int c = tid; c < cols; c += nthreads) copy(r, c);
  }
}

// RW probabilities of one key to and from shared memory, as float4s
// where RW is a multiple of 4.
template <int RW>
__device__ inline void load_p(const float* p, float (&pr)[RW]) {
  if constexpr (RW % 4 == 0) {
#pragma unroll
    for (int r = 0; r < RW; r += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + r);
      pr[r] = t.x; pr[r + 1] = t.y; pr[r + 2] = t.z; pr[r + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RW; ++r) pr[r] = p[r];
  }
}

template <int RW>
__device__ inline void store_p(float* p, const float (&pr)[RW]) {
  if constexpr (RW % 4 == 0) {
#pragma unroll
    for (int r = 0; r < RW; r += 4)
      *reinterpret_cast<float4*>(p + r) =
          make_float4(pr[r], pr[r + 1], pr[r + 2], pr[r + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < RW; ++r) p[r] = pr[r];
  }
}

// Maxima and sums over the warp of R independent values at once, so the
// R shuffle chains overlap.
template <int R>
__device__ inline void warp_max_n(float (&v)[R]) {
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = fmaxf(v[r], __shfl_xor_sync(kFull, v[r], o));
  }
}

template <int R>
__device__ inline void warp_sum_n(float (&v)[R]) {
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] += __shfl_xor_sync(kFull, v[r], o);
  }
}

// grid (B*H, ceil(T / TQ)), G * S warps. Warp w owns rows
// t0 + (w % G) * RW .. + RW - 1; of each chunk's keys that their bands
// need, in slots of 32 (one key a lane), it takes slots w / G, w / G + S,
// ... DPL = ceil(D / 32) head dims per lane.
template <typename T, typename BT, int RW, int DPL>
__global__ void __launch_bounds__(kMaxThreads)
    attention_fwd_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ seg,
                         const float* __restrict__ valid,
                         const unsigned char* __restrict__ nodone,
                         const BT* __restrict__ bias,
                         T* __restrict__ out, float* __restrict__ lse,
                         Geometry g, FwdShape f, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warps = f.G * f.S;
  float* ks = smem;                       // [KC][LD]
  float* vs = ks + f.KC * f.LD;           // [KC][LD]
  float* qs = vs + f.KC * f.LD;           // [TQ][LD]
  float* pw = qs + f.TQ * f.LD;           // [warps][kSlots * 32][RW]
  float* bw = pw + warps * kPassKeys * RW;  // [KC + TQ] the chunk's bias
  int* ktag = reinterpret_cast<int*>(bw + f.KC + f.TQ);  // [KC]
  float* mg = reinterpret_cast<float*>(ktag + f.KC);     // [S][TQ] (S > 1)
  float* lg = mg + f.S * f.TQ;            // [S][TQ]
  float* ag = lg + f.S * f.TQ;            // [S][TQ][32 * DPL]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gi = warp % f.G, si = warp / f.G;
  const int b = blockIdx.x / g.H, h = blockIdx.x - b * g.H;
  const int t0 = blockIdx.y * f.TQ;
  const int t_last = min(t0 + f.TQ, g.T) - 1;
  const int ta = t0 + gi * RW;                // the warp's first row
  const int ta_last = min(ta + RW, g.T) - 1;  // < ta: the warp has no row
  const int D = g.D, D4 = (D + 3) / 4;
  const long long stride = static_cast<long long>(g.H) * D;  // row to row
  const T* kb = k + row_of(b, 0, h, g.K, g.H, D);
  const T* vb = v + row_of(b, 0, h, g.K, g.H, D);
  const int* seg_b = seg + static_cast<long long>(b) * g.T;
  const float* valid_b = valid + static_cast<long long>(b) * g.M;
  const unsigned char* nodone_b = nodone + static_cast<long long>(b) * g.T;
  const BT* bias_h = bias + static_cast<long long>(h) * (g.M + 1);
  float* pw_w = pw + warp * kPassKeys * RW;

  bool row_ok[RW], row_nodone[RW];
  int row_seg[RW];
  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int t = ta + r;
    row_ok[r] = t <= ta_last;
    row_seg[r] = row_ok[r] ? seg_b[t] : 0;
    row_nodone[r] = row_ok[r] && nodone_b[t] != 0;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  const int j_end = t_last + g.M;  // keys [t0, t_last + M] cover the band
  for (int c0 = t0; c0 <= j_end; c0 += f.KC) {
    const int n = min(f.KC, j_end - c0 + 1);
    // Offset o = t - j + M of row t and key j is bias window entry
    // o - o_base, in [0, n + t_last - t0).
    const int o_base = t0 - (c0 + n - 1) + g.M;
    __syncthreads();  // the previous chunk is consumed
    stage_rows_async(ks, f.LD, kb + c0 * stride, stride, n, D, f.vec);
    stage_rows_async(vs, f.LD, vb + c0 * stride, stride, n, D, f.vec);
    if (c0 == t0)
      stage_rows_async(qs, f.LD, q + row_of(b, t0, h, g.T, g.H, D), stride,
                       t_last - t0 + 1, D, f.vec);
    // While the copies fly: each key's tag (a cache key's validity, an
    // unroll key's segment) and the bias over the chunk's offsets.
    for (int i = tid; i < n; i += nthreads) {
      const int j = c0 + i;
      ktag[i] = j < g.M ? static_cast<int>(valid_b[j] != 0.f) : seg_b[j - g.M];
    }
    for (int i = tid; i < n + t_last - t0; i += nthreads) {
      const int o = o_base + i;
      bw[i] = o >= 0 && o <= g.M ? tbt::to_float(bias_h[o]) : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (ta > ta_last) continue;
    // The warp's keys in this chunk: its rows' bands, [ta, ta_last + M],
    // in slots of 32; the warps of a row group take every S-th slot, in
    // passes of kSlots slots.
    const int kbeg = max(ta, c0), kend = min(ta_last + g.M, c0 + n - 1);
    for (int u0 = si; kbeg + 32 * u0 <= kend; u0 += kSlots * f.S) {
      int j0[kSlots];
      bool live[kSlots];  // warp-uniform
      float s[kSlots][RW];
#pragma unroll
      for (int st = 0; st < kSlots; ++st) {
        j0[st] = kbeg + 32 * (u0 + st * f.S);
        live[st] = j0[st] <= kend;
#pragma unroll
        for (int r = 0; r < RW; ++r) s[st][r] = 0.f;
      }
      // Scores: each lane's key against the RW rows, outer products over D.
      for (int d4 = 0; d4 < D4; ++d4) {
        float4 qv[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r)
          qv[r] = *reinterpret_cast<const float4*>(qs + (ta - t0 + r) * f.LD +
                                                   4 * d4);
#pragma unroll
        for (int st = 0; st < kSlots; ++st) {
          if (!live[st]) continue;
          const int j = min(j0[st] + lane, kend);  // a staged key either way
          const float4 kv =
              *reinterpret_cast<const float4*>(ks + (j - c0) * f.LD + 4 * d4);
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            s[st][r] = fmaf(qv[r].x, kv.x, s[st][r]);
            s[st][r] = fmaf(qv[r].y, kv.y, s[st][r]);
            s[st][r] = fmaf(qv[r].z, kv.z, s[st][r]);
            s[st][r] = fmaf(qv[r].w, kv.w, s[st][r]);
          }
        }
      }
      // Mask and bias: a cache key by its slot's validity and the row's
      // no-done gate, an unroll key by the segment; band offsets only.
      float mx[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) mx[r] = -INFINITY;
#pragma unroll
      for (int st = 0; st < kSlots; ++st) {
        const int j = j0[st] + lane;
        const bool key_in = live[st] && j <= kend;
        const int tag = key_in ? ktag[j - c0] : 0;
        const bool is_cache = j < g.M;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int o = ta + r - j + g.M;
          const bool vis = key_in && row_ok[r] && o >= 0 && o <= g.M &&
                           (is_cache ? tag != 0 && row_nodone[r]
                                     : row_seg[r] == tag);
          s[st][r] = vis ? s[st][r] * scale + bw[o - o_base] : -INFINITY;
          mx[r] = fmaxf(mx[r], s[st][r]);
        }
      }
      warp_max_n<RW>(mx);
      // Online softmax across passes: rescale what earlier ones summed.
      float sum[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        sum[r] = 0.f;
        if (mx[r] == -INFINITY) {  // nothing visible to row r in this pass
          mx[r] = 0.f;             // any finite max: its p are exp(-inf) = 0
          continue;
        }
        const float m_new = fmaxf(m[r], mx[r]);
        const float corr = expf(m[r] - m_new);  // 0 on the first visible pass
        l[r] *= corr;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= corr;
        m[r] = mx[r] = m_new;
      }
#pragma unroll
      for (int st = 0; st < kSlots; ++st) {
        if (!live[st]) continue;
        float p[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          p[r] = expf(s[st][r] - mx[r]);  // 0 where s is -inf
          sum[r] += p[r];
        }
        store_p<RW>(pw_w + (st * 32 + lane) * RW, p);
      }
      warp_sum_n<RW>(sum);
#pragma unroll
      for (int r = 0; r < RW; ++r) l[r] += sum[r];
      __syncwarp();
      // P . V: lanes over the head dims, one broadcast read of the RW
      // probabilities of each key.
#pragma unroll
      for (int st = 0; st < kSlots; ++st) {
        if (!live[st]) continue;
        const int nk = min(32, kend - j0[st] + 1);
        const float* vrow = vs + (j0[st] - c0) * f.LD;
        const float* prow = pw_w + st * 32 * RW;
        for (int kk = 0; kk < nk; ++kk, vrow += f.LD, prow += RW) {
          float pr[RW];
          load_p<RW>(prow, pr);
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) {
              const float vv = vrow[d];
#pragma unroll
              for (int r = 0; r < RW; ++r)
                acc[r][i] = fmaf(pr[r], vv, acc[r][i]);
            }
          }
        }
      }
      __syncwarp();  // pw_w is rewritten by the next pass
    }
  }

  if (f.S > 1) {
    // Merge the S warps of each row group: max, rescaled sums.
    if (ta <= ta_last) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (!row_ok[r]) continue;
        const int slot = si * f.TQ + ta - t0 + r;
        if (lane == 0) {
          mg[slot] = m[r];
          lg[slot] = l[r];
        }
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          ag[slot * 32 * DPL + lane + 32 * i] = acc[r][i];
      }
    }
    __syncthreads();
    if (si != 0 || ta > ta_last) return;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (!row_ok[r]) continue;
      const int row = ta - t0 + r;
      float m_tot = -INFINITY;
      for (int s = 0; s < f.S; ++s) m_tot = fmaxf(m_tot, mg[s * f.TQ + row]);
      float l_tot = 0.f, a[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) a[i] = 0.f;
      for (int s = 0; s < f.S; ++s) {
        const int slot = s * f.TQ + row;
        const float w = expf(mg[slot] - m_tot);  // 0 for a split with no key
        l_tot = fmaf(lg[slot], w, l_tot);
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          a[i] = fmaf(ag[slot * 32 * DPL + lane + 32 * i], w, a[i]);
      }
      m[r] = m_tot;
      l[r] = l_tot;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = a[i];
    }
  }
  if (ta > ta_last) return;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (!row_ok[r]) continue;
    const int t = ta + r;
    const long long o_row = row_of(b, t, h, g.T, g.H, D);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[o_row + d] = tbt::from_float<T>(acc[r][i] / l[r]);
    }
    if (lane == 0)
      lse[(static_cast<long long>(b) * g.H + h) * g.T + t] = m[r] + logf(l[r]);
  }
}

// ------------------------------------------------------------ backward

constexpr int kBwdRows = 4;       // pass 1: rows a warp
constexpr int kBwdMinWarps = 4;   // a block has at least this many warps
constexpr size_t kBwdSmemBudget = 200 * 1024;

// Most warps a block, so that the accumulators stay in registers: 21 row
// groups (84 rows, the learner's T = 81 in one tile) with up to 32 head
// dims, 16 up to 64, 8 above.
template <int DPL>
__host__ __device__ constexpr int bwd_max_warps() {
  return DPL == 1 ? 21 : DPL == 2 ? 16 : 8;
}

// Pass 2: keys a warp sums at once (its accumulators, 2 * KW * DPL).
template <int DPL>
__host__ __device__ constexpr int bwd_keys_per_warp() {
  return DPL <= 2 ? 8 : 4;
}

// The launch geometry: row tiles of TR rows (TR / 4 warps hold them in
// pass 1; NW warps a block); key chunks of KC keys, KCP of them in the
// tiles (a multiple of 8); shared-memory rows of LD floats; vec: 16-byte
// copies; accumulate: more than one row tile, so dK and dV gather in
// global memory.
struct BwdShape {
  int TR, NW, KC, KCP, LD;
  bool vec, accumulate;
};

// grid (B*H): block (b, h) owns every row and key of its (b, h). For each
// row tile [t0, t_last] and chunk of the keys its band needs:
// - pass 1: warp w owns rows ta = t0 + 4 w .. ta + 3 and takes the keys
//   of their bands in slots of 32 (one key a lane, kSlots slots a pass):
//   q . k and dO . v as outer products over D, P = exp(s - lse) and
//   dS = P (dO . v - Delta), written into the [key][row] tiles pt and dt;
//   then dQ += dS K with lanes over D from the warp's own dS entries;
// - pass 2 (after one barrier): warps take the chunk's keys KW at a time,
//   lanes over D, and sum dK = dS^T q and dV = P^T dO over the rows;
// - the bias partial: thread o sums the dS tile along offset o in order
//   of t into partials[b, h, o].
// The last block of head h to finish (a ticket counter, reset by that
// block) sums the B partials of h in order of b into dbias[h]. Every
// output element has one writer and a fixed order of summation. With more
// than one row tile, dK and dV gather in f32: in dk and dv themselves for
// f32, in `work` ([2][B][K][H][D] f32) for bf16, narrowed into dk and dv
// at the end.
template <typename T, typename BT, int DPL, int KW>
__global__ void __launch_bounds__(32 * bwd_max_warps<DPL>())
    attention_bwd_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ seg,
                         const float* __restrict__ valid,
                         const unsigned char* __restrict__ nodone,
                         const BT* __restrict__ bias,
                         const T* __restrict__ out,
                         const float* __restrict__ lse,
                         const T* __restrict__ dout,
                         T* __restrict__ dq, T* __restrict__ dk,
                         T* __restrict__ dv, BT* __restrict__ dbias,
                         double* __restrict__ partials,
                         int* __restrict__ tickets,
                         float* __restrict__ work, Geometry g, BwdShape f,
                         float scale) {
  constexpr int RW = kBwdRows;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last_block;
  float* qs = smem;                    // [TR][LD]
  float* dos = qs + f.TR * f.LD;       // [TR][LD]
  float* os = dos + f.TR * f.LD;       // [TR][LD] the forward's out
  float* ks = os + f.TR * f.LD;        // [KCP][LD]
  float* vs = ks + f.KCP * f.LD;       // [KCP][LD]
  float* pt = vs + f.KCP * f.LD;       // [KCP][TR] P
  float* dt = pt + f.KCP * f.TR;       // [KCP][TR] dS
  float* bw = dt + f.KCP * f.TR;       // [KCP + TR] the chunk's bias
  int* ktag = reinterpret_cast<int*>(bw + f.KCP + f.TR);  // [KCP]
  // Per row of the tile: its lse, Delta, segment and no-done gate (kept
  // here, not in registers, which pass 1 needs for its accumulators).
  float* rlse = reinterpret_cast<float*>(ktag + f.KCP);  // [TR]
  float* rdelta = rlse + f.TR;                            // [TR]
  int* rseg = reinterpret_cast<int*>(rdelta + f.TR);      // [TR]
  int* rgate = rseg + f.TR;                               // [TR]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / g.H, h = blockIdx.x - b * g.H;
  const int D = g.D, D4 = (D + 3) / 4, W = g.M + 1;
  const long long stride = static_cast<long long>(g.H) * D;  // row to row
  const T* kb = k + row_of(b, 0, h, g.K, g.H, D);
  const T* vb = v + row_of(b, 0, h, g.K, g.H, D);
  const int* seg_b = seg + static_cast<long long>(b) * g.T;
  const float* valid_b = valid + static_cast<long long>(b) * g.M;
  const unsigned char* nodone_b = nodone + static_cast<long long>(b) * g.T;
  const BT* bias_h = bias + static_cast<long long>(h) * W;
  const float* lse_bh = lse + (static_cast<long long>(b) * g.H + h) * g.T;
  double* part = partials + (static_cast<long long>(b) * g.H + h) * W;
  // bf16: where dK and dV gather across row tiles, in f32.
  float* const wk = work;
  float* const wv =
      kF32 ? nullptr : work + static_cast<long long>(g.B) * g.K * g.H * D;

  // Zero what the block gathers into: its bias partial and, with more
  // than one row tile, its dK and dV rows. The first chunk's barrier
  // orders these stores before any reader.
  for (int o = tid; o < W; o += nthreads) part[o] = 0.0;
  if (f.accumulate) {
    for (int i = tid; i < g.K * D; i += nthreads) {
      const int j = i / D, d = i - j * D;
      const long long r = row_of(b, j, h, g.K, g.H, D) + d;
      if constexpr (kF32) {
        dk[r] = 0.f;
        dv[r] = 0.f;
      } else {
        wk[r] = 0.f;
        wv[r] = 0.f;
      }
    }
  }

  for (int t0 = 0; t0 < g.T; t0 += f.TR) {
    const int t_last = min(t0 + f.TR, g.T) - 1;
    const int rows = t_last - t0 + 1;
    const int ta = t0 + RW * warp;  // the warp's first row in pass 1
    const bool has_rows = RW * warp < f.TR && ta <= t_last;  // warp-uniform
    const int ta_last = min(ta + RW, g.T) - 1;
    const int rel = ta - t0;  // the warp's first tile row (column in pt, dt)
    float acc_q[RW][DPL];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc_q[r][i] = 0.f;

    const int j_end = t_last + g.M;  // keys [t0, t_last + M] cover the band
    for (int c0 = t0; c0 <= j_end; c0 += f.KC) {
      const int n = min(f.KC, j_end - c0 + 1);
      // Offset o = t - j + M of row t and key j is bias window entry
      // o - o_base, in [0, n + rows - 1).
      const int o_base = t0 - (c0 + n - 1) + g.M;
      __syncthreads();  // the previous chunk (or row tile) is consumed
      stage_rows_async(ks, f.LD, kb + c0 * stride, stride, n, D, f.vec);
      stage_rows_async(vs, f.LD, vb + c0 * stride, stride, n, D, f.vec);
      if (c0 == t0) {
        const long long r0 = row_of(b, t0, h, g.T, g.H, D);
        stage_rows_async(qs, f.LD, q + r0, stride, rows, D, f.vec);
        stage_rows_async(dos, f.LD, dout + r0, stride, rows, D, f.vec);
        stage_rows_async(os, f.LD, out + r0, stride, rows, D, f.vec);
        // Rows past T read as zeros in pass 2.
        for (int i = tid; i < (f.TR - rows) * f.LD; i += nthreads)
          qs[rows * f.LD + i] = dos[rows * f.LD + i] = 0.f;
        for (int i = tid; i < f.TR; i += nthreads) {
          const bool ok = i < rows;
          rlse[i] = ok ? lse_bh[t0 + i] : 0.f;
          rseg[i] = ok ? seg_b[t0 + i] : 0;
          rgate[i] = ok && nodone_b[t0 + i] != 0;
        }
      }
      // While the copies fly: the key tags, the bias window, and zeros in
      // the tiles (pass 1 writes only the pairs its warps visit).
      for (int i = tid; i < n; i += nthreads) {
        const int j = c0 + i;
        ktag[i] = j < g.M ? static_cast<int>(valid_b[j] != 0.f) : seg_b[j - g.M];
      }
      for (int i = tid; i < n + rows - 1; i += nthreads) {
        const int o = o_base + i;
        bw[i] = o >= 0 && o <= g.M ? tbt::to_float(bias_h[o]) : 0.f;
      }
      float4* tiles4 = reinterpret_cast<float4*>(pt);
      for (int i = tid; i < f.KCP * f.TR / 2; i += nthreads)
        tiles4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      cp_async_wait_all();
      __syncthreads();

      // Delta_t = rowsum(dO_t * O_t), summed in the order in which pass 1
      // sums dO . v, so that a row whose only visible key is its own
      // (P = 1, O = v) gets dS exactly 0, as the plain version does.
      if (c0 == t0 && has_rows) {
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float dl = 0.f;
          for (int d4 = 0; d4 < D4; ++d4) {
            const float4 a = *reinterpret_cast<const float4*>(
                dos + (rel + r) * f.LD + 4 * d4);
            const float4 o = *reinterpret_cast<const float4*>(
                os + (rel + r) * f.LD + 4 * d4);
            dl = fmaf(a.x, o.x, dl);
            dl = fmaf(a.y, o.y, dl);
            dl = fmaf(a.z, o.z, dl);
            dl = fmaf(a.w, o.w, dl);
          }
          // O past T is not staged.
          if (lane == 0) rdelta[rel + r] = ta + r <= ta_last ? dl : 0.f;
        }
        __syncwarp();
      }

      // Pass 1: warps over rows.
      if (has_rows) {
        const int kbeg = max(ta, c0), kend = min(ta_last + g.M, c0 + n - 1);
        for (int u0 = 0; kbeg + 32 * u0 <= kend; u0 += kSlots) {
          int j0[kSlots];
          bool live[kSlots];  // warp-uniform
          float s[kSlots][RW], dp[kSlots][RW];
#pragma unroll
          for (int st = 0; st < kSlots; ++st) {
            j0[st] = kbeg + 32 * (u0 + st);
            live[st] = j0[st] <= kend;
#pragma unroll
            for (int r = 0; r < RW; ++r) s[st][r] = dp[st][r] = 0.f;
          }
          // q . k, then dO . v: each lane's key against the RW rows.
          for (int d4 = 0; d4 < D4; ++d4) {
            float4 qv[RW];
#pragma unroll
            for (int r = 0; r < RW; ++r)
              qv[r] = *reinterpret_cast<const float4*>(qs + (rel + r) * f.LD +
                                                       4 * d4);
#pragma unroll
            for (int st = 0; st < kSlots; ++st) {
              if (!live[st]) continue;
              const int j = min(j0[st] + lane, kend);  // a staged key
              const float4 kv = *reinterpret_cast<const float4*>(
                  ks + (j - c0) * f.LD + 4 * d4);
#pragma unroll
              for (int r = 0; r < RW; ++r) {
                s[st][r] = fmaf(qv[r].x, kv.x, s[st][r]);
                s[st][r] = fmaf(qv[r].y, kv.y, s[st][r]);
                s[st][r] = fmaf(qv[r].z, kv.z, s[st][r]);
                s[st][r] = fmaf(qv[r].w, kv.w, s[st][r]);
              }
            }
          }
          for (int d4 = 0; d4 < D4; ++d4) {
            float4 ov[RW];
#pragma unroll
            for (int r = 0; r < RW; ++r)
              ov[r] = *reinterpret_cast<const float4*>(dos + (rel + r) * f.LD +
                                                       4 * d4);
#pragma unroll
            for (int st = 0; st < kSlots; ++st) {
              if (!live[st]) continue;
              const int j = min(j0[st] + lane, kend);
              const float4 vv = *reinterpret_cast<const float4*>(
                  vs + (j - c0) * f.LD + 4 * d4);
#pragma unroll
              for (int r = 0; r < RW; ++r) {
                dp[st][r] = fmaf(ov[r].x, vv.x, dp[st][r]);
                dp[st][r] = fmaf(ov[r].y, vv.y, dp[st][r]);
                dp[st][r] = fmaf(ov[r].z, vv.z, dp[st][r]);
                dp[st][r] = fmaf(ov[r].w, vv.w, dp[st][r]);
              }
            }
          }
          // P and dS of each visible pair (0 elsewhere), into the tiles.
#pragma unroll
          for (int st = 0; st < kSlots; ++st) {
            const int j = j0[st] + lane;
            if (!live[st] || j > kend) continue;
            const int tag = ktag[j - c0];
            const bool is_cache = j < g.M;
            float p[RW], ds[RW];
#pragma unroll
            for (int r = 0; r < RW; ++r) {
              const int o = ta + r - j + g.M;
              const bool vis = ta + r <= ta_last && o >= 0 && o <= g.M &&
                               (is_cache ? tag != 0 && rgate[rel + r] != 0
                                         : rseg[rel + r] == tag);
              p[r] = vis ? expf(s[st][r] * scale + bw[o - o_base] -
                                rlse[rel + r])
                         : 0.f;
              ds[r] = vis ? p[r] * (dp[st][r] - rdelta[rel + r]) : 0.f;
            }
            store_p<RW>(pt + (j - c0) * f.TR + rel, p);
            store_p<RW>(dt + (j - c0) * f.TR + rel, ds);
          }
          __syncwarp();
          // dQ += dS K: lanes over the head dims, one broadcast read of
          // the RW dS entries of each key.
#pragma unroll
          for (int st = 0; st < kSlots; ++st) {
            if (!live[st]) continue;
            const int nk = min(32, kend - j0[st] + 1);
            const float* krow = ks + (j0[st] - c0) * f.LD;
            const float* drow = dt + (j0[st] - c0) * f.TR + rel;
            for (int kk = 0; kk < nk; ++kk, krow += f.LD, drow += f.TR) {
              float dsr[RW];
              load_p<RW>(drow, dsr);
#pragma unroll
              for (int i = 0; i < DPL; ++i) {
                const int d = lane + 32 * i;
                if (d < D) {
                  const float kv = krow[d];
#pragma unroll
                  for (int r = 0; r < RW; ++r)
                    acc_q[r][i] = fmaf(dsr[r], kv, acc_q[r][i]);
                }
              }
            }
          }
        }
      }
      __syncthreads();

      // Pass 2: warps over keys, KW at a time, lanes over the head dims.
      const int groups = (n + KW - 1) / KW;
      for (int grp = warp; grp < groups; grp += f.NW) {
        const int jg = c0 + grp * KW;  // the group's first key
        const int r_lo = (max(t0, jg - g.M) - t0) & ~3;
        const int r_hi = min(t_last, jg + KW - 1) - t0;
        float acc_k[KW][DPL], acc_v[KW][DPL];
#pragma unroll
        for (int kk = 0; kk < KW; ++kk)
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc_k[kk][i] = acc_v[kk][i] = 0.f;
        for (int r4 = r_lo; r4 <= r_hi; r4 += 4) {
          float qv[4][DPL], ov[4][DPL];
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
              const int d = lane + 32 * i;
              qv[x][i] = d < D ? qs[(r4 + x) * f.LD + d] : 0.f;
              ov[x][i] = d < D ? dos[(r4 + x) * f.LD + d] : 0.f;
            }
#pragma unroll
          for (int kk = 0; kk < KW; ++kk) {
            const int cell = (jg - c0 + kk) * f.TR + r4;
            const float4 p4 = *reinterpret_cast<const float4*>(pt + cell);
            const float4 d4 = *reinterpret_cast<const float4*>(dt + cell);
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
              acc_v[kk][i] = fmaf(p4.x, ov[0][i], acc_v[kk][i]);
              acc_v[kk][i] = fmaf(p4.y, ov[1][i], acc_v[kk][i]);
              acc_v[kk][i] = fmaf(p4.z, ov[2][i], acc_v[kk][i]);
              acc_v[kk][i] = fmaf(p4.w, ov[3][i], acc_v[kk][i]);
              acc_k[kk][i] = fmaf(d4.x, qv[0][i], acc_k[kk][i]);
              acc_k[kk][i] = fmaf(d4.y, qv[1][i], acc_k[kk][i]);
              acc_k[kk][i] = fmaf(d4.z, qv[2][i], acc_k[kk][i]);
              acc_k[kk][i] = fmaf(d4.w, qv[3][i], acc_k[kk][i]);
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < KW; ++kk) {
          const int j = jg + kk;
          if (j >= c0 + n) break;
          const long long r = row_of(b, j, h, g.K, g.H, D);
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d >= D) continue;
            if (f.accumulate) {
              if constexpr (kF32) {
                dk[r + d] += acc_k[kk][i] * scale;
                dv[r + d] += acc_v[kk][i];
              } else {
                wk[r + d] += acc_k[kk][i] * scale;
                wv[r + d] += acc_v[kk][i];
              }
            } else {
              dk[r + d] = tbt::from_float<T>(acc_k[kk][i] * scale);
              dv[r + d] = tbt::from_float<T>(acc_v[kk][i]);
            }
          }
        }
      }

      // The bias partial: the offsets this chunk and row tile touch, each
      // summed along its diagonal of the dS tile in order of t.
      const int o_lo = max(0, o_base), o_hi = min(g.M, t_last - c0 + g.M);
      for (int o = o_lo + tid; o <= o_hi; o += nthreads) {
        const int tb = max(t0, c0 - g.M + o);
        const int te = min(t_last, c0 + n - 1 - g.M + o);
        double acc = 0.0;
        for (int t = tb; t <= te; ++t)
          acc += dt[(t + g.M - o - c0) * f.TR + (t - t0)];
        part[o] += acc;
      }
    }

    if (has_rows) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (ta + r > ta_last) continue;
        const long long o_row = row_of(b, ta + r, h, g.T, g.H, D);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) dq[o_row + d] = tbt::from_float<T>(acc_q[r][i] * scale);
        }
      }
    }
  }

  if constexpr (!kF32) {
    // bf16: narrow the gathered dK and dV once (this block wrote them).
    if (f.accumulate) {
      __syncthreads();
      for (int i = tid; i < g.K * D; i += nthreads) {
        const int j = i / D, d = i - j * D;
        const long long r = row_of(b, j, h, g.K, g.H, D) + d;
        dk[r] = tbt::from_float<T>(wk[r]);
        dv[r] = tbt::from_float<T>(wv[r]);
      }
    }
  }

  // d rel_bias: the last block of head h sums the B partials in order of
  // b. Each thread's partial stores are fenced before the ticket is taken.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(tickets + h, 1) == g.B - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int o = tid; o < W; o += nthreads) {
    double acc = 0.0;
#pragma unroll 8
    for (int bb = 0; bb < g.B; ++bb)
      acc += __ldcg(partials + (static_cast<long long>(bb) * g.H + h) * W + o);
    dbias[static_cast<long long>(h) * W + o] =
        tbt::from_float<BT>(static_cast<float>(acc));
  }
  if (tid == 0) tickets[h] = 0;  // ready for the next call
}

// Pointers of one call, typed by the wrapper's dtypes.
struct Args {
  const void *q, *k, *v;
  const int* seg;
  const float* valid;
  const unsigned char* nodone;
  const void* bias;
  const void* out;
  const float* lse;
  const void* dout;
  void *dq, *dk, *dv, *dbias;
  double* partials;
  int* tickets;
  float* work;
  float* lse_out;
};

// Whether rows of D elements of T can be moved 4 at a time (D % 4 == 0 and
// every pointer aligned for a 4-element access).
template <typename T>
bool vec_rows(int D, std::initializer_list<const void*> ptrs) {
  if (D % 4 != 0) return false;
  for (const void* p : ptrs)
    if (!tbt::aligned(p, 4 * sizeof(T))) return false;
  return true;
}

template <typename T, typename BT, int RW, int DPL>
int launch_fwd(const Args& a, Geometry g, float scale, cudaStream_t stream) {
  FwdShape f;
  if (RW == 1) {  // acting: one row a block, its keys split across warps
    f.G = 1;
    f.S = std::min(kMaxSplits, std::max(1, (g.M + 1 + 31) / 32));
  } else {  // learner: up to kMaxRowGroups warps of RW rows, one tile if T fits
    f.G = std::min(kMaxRowGroups, (g.T + RW - 1) / RW);
    f.S = 1;
  }
  f.TQ = RW * f.G;
  f.LD = 32 * DPL + 4;  // LD % 32 == 4: a warp's float4 rows miss no bank
  f.vec = vec_rows<T>(g.D, {a.q, a.k, a.v});
  const int warps = f.G * f.S;
  // Shared memory in floats: q, the warps' probabilities, the bias window's
  // TQ extra entries and the merge, then per key of a chunk its K and V
  // rows, a bias entry and a tag. The whole band [t0, t_last + M] is one
  // chunk when it fits the budget.
  size_t fixed = static_cast<size_t>(f.TQ) * f.LD +
                 static_cast<size_t>(warps) * kPassKeys * RW + f.TQ;
  if (f.S > 1) fixed += static_cast<size_t>(f.S) * f.TQ * (2 + 32 * DPL);
  const size_t per_key = 2 * f.LD + 2;
  const size_t budget = kSmemBudget / sizeof(float);
  if (fixed + per_key > budget) return static_cast<int>(cudaErrorInvalidValue);
  f.KC = static_cast<int>(
      std::min<size_t>(f.TQ + g.M, (budget - fixed) / per_key));
  const size_t smem = sizeof(float) * (fixed + per_key * f.KC);
  auto kernel = attention_fwd_kernel<T, BT, RW, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(g.B * g.H, (g.T + f.TQ - 1) / f.TQ);
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg, a.valid, a.nodone,
      static_cast<const BT*>(a.bias),
      static_cast<T*>(const_cast<void*>(a.out)), a.lse_out, g, f, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename BT, int DPL>
int launch_fwd_for(const Args& a, Geometry g, float scale,
                   cudaStream_t stream) {
  return g.T <= kActingMaxT
             ? launch_fwd<T, BT, 1, DPL>(a, g, scale, stream)
             : launch_fwd<T, BT, kLearnerRows, DPL>(a, g, scale, stream);
}

template <typename T, typename BT, int DPL>
int launch_bwd(const Args& a, Geometry g, float scale, cudaStream_t stream) {
  constexpr int KW = bwd_keys_per_warp<DPL>();
  BwdShape f;
  const int row_groups =
      std::min(bwd_max_warps<DPL>(), (g.T + kBwdRows - 1) / kBwdRows);
  f.TR = kBwdRows * row_groups;
  f.NW = std::max(row_groups, kBwdMinWarps);
  f.LD = 32 * DPL + 4;  // LD % 32 == 4: a warp's float4 rows miss no bank
  f.vec = vec_rows<T>(g.D, {a.q, a.k, a.v, a.dout, a.out});
  f.accumulate = g.T > f.TR;
  if (f.accumulate && !std::is_same<T, float>::value && a.work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // Shared memory in floats (bf16 rows are staged widened, so the tiles
  // are the same for both types): q, dO and O of a row tile, the bias
  // window's TR extra entries and four values a row, then per key of a
  // chunk its K and V rows, its column of the P and dS tiles, a bias entry
  // and a tag; 8 keys of slack round the chunk's tiles up to whole key
  // groups. The whole band
  // [t0, t_last + M] is one chunk when it fits the budget.
  const size_t fixed = 3 * static_cast<size_t>(f.TR) * f.LD + 5 * f.TR;
  const size_t per_key = 2 * static_cast<size_t>(f.LD) + 2 * f.TR + 2;
  const size_t budget = kBwdSmemBudget / sizeof(float);
  if (fixed + 9 * per_key > budget)
    return static_cast<int>(cudaErrorInvalidValue);
  f.KC = static_cast<int>(std::min<size_t>(f.TR + g.M,
                                           (budget - fixed) / per_key - 8));
  f.KCP = (f.KC + 7) & ~7;
  const size_t smem = sizeof(float) * (fixed + per_key * f.KCP);
  auto kernel = attention_bwd_kernel<T, BT, DPL, KW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<g.B * g.H, 32 * f.NW, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.seg, a.valid, a.nodone,
      static_cast<const BT*>(a.bias), static_cast<const T*>(a.out), a.lse,
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<BT*>(a.dbias), a.partials, a.tickets, a.work, g, f,
      scale);
  return static_cast<int>(cudaGetLastError());
}

Geometry geometry(int B, int T, int H, int D, int M) {
  return Geometry{B, T, H, D, M, M + T};
}

// DPL = ceil(D / 32) head dims per lane, 1 to 4, as a template argument.
template <typename T, typename BT, template <typename, typename, int> class L>
int by_dpl(const Args& a, Geometry g, cudaStream_t s) {
  const float scale = 1.f / sqrtf(static_cast<float>(g.D));
  switch ((g.D + 31) / 32) {
    case 1: return L<T, BT, 1>::run(a, g, scale, s);
    case 2: return L<T, BT, 2>::run(a, g, scale, s);
    case 3: return L<T, BT, 3>::run(a, g, scale, s);
    case 4: return L<T, BT, 4>::run(a, g, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The storage types a call may take: q's (f32 or bf16), and rel_bias's
// (f32, or bf16 with bf16 q).
template <template <typename, typename, int> class L>
int by_types(const Args& a, Geometry g, int is_bf16, int bias_bf16,
             cudaStream_t s) {
  if (!is_bf16 && !bias_bf16) return by_dpl<float, float, L>(a, g, s);
  if (is_bf16 && bias_bf16) return by_dpl<bf16, bf16, L>(a, g, s);
  if (is_bf16) return by_dpl<bf16, float, L>(a, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename BT, int DPL>
struct Fwd {
  static int run(const Args& a, Geometry g, float scale, cudaStream_t s) {
    return launch_fwd_for<T, BT, DPL>(a, g, scale, s);
  }
};

template <typename T, typename BT, int DPL>
struct Bwd {
  static int run(const Args& a, Geometry g, float scale, cudaStream_t s) {
    return launch_bwd<T, BT, DPL>(a, g, scale, s);
  }
};

}  // namespace

// D <= 128 (ceil(D / 32) <= 4 dims per lane). Both kernels opt in to more
// than 48 KB of shared memory where their chunks need it. is_bf16: q, k, v
// and out are bf16 (else f32); bias_bf16: rel_bias is bf16 (else f32).
TBT_API int tbt_attention_fwd(const void* q, const void* k, const void* v,
                              const int* seg, const float* valid,
                              const unsigned char* nodone, const void* bias,
                              void* out, float* lse, int B, int T, int H,
                              int D, int M, int is_bf16, int bias_bf16,
                              void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.seg = seg; a.valid = valid;
  a.nodone = nodone; a.bias = bias; a.out = out; a.lse_out = lse;
  return by_types<Fwd>(a, geometry(B, T, H, D, M), is_bf16, bias_bf16,
                       static_cast<cudaStream_t>(stream));
}

// One launch. partials: [B, H, M + 1] f64 scratch; tickets: [H] ints,
// zero before the first call and left zero by every call (calls that
// share them must not overlap); work: [2, B, M + T, H, D] f32 scratch, for
// bf16 only (dK and dV gather there across row tiles; unused, and may be
// null, for f32). is_bf16: q, k, v, out, dout, dq, dk and dv are bf16 (else
// f32); bias_bf16: rel_bias and dbias are bf16 (else f32).
TBT_API int tbt_attention_bwd(const void* q, const void* k, const void* v,
                              const int* seg, const float* valid,
                              const unsigned char* nodone, const void* bias,
                              const void* out, const float* lse,
                              const void* dout, void* dq, void* dk,
                              void* dv, void* dbias, double* partials,
                              int* tickets, float* work, int B, int T,
                              int H, int D, int M, int is_bf16,
                              int bias_bf16, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.seg = seg; a.valid = valid;
  a.nodone = nodone; a.bias = bias; a.out = out; a.lse = lse;
  a.dout = dout; a.dq = dq; a.dk = dk; a.dv = dv; a.dbias = dbias;
  a.partials = partials; a.tickets = tickets; a.work = work;
  return by_types<Bwd>(a, geometry(B, T, H, D, M), is_bf16, bias_bf16,
                       static_cast<cudaStream_t>(stream));
}
