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
// Each warp owns one item (a query row in the dq pass, a key in the dk/dv
// pass); a block of kWarps warps owns kWarps consecutive items of one
// (b, h) and streams the partners its items need (rows [j0 - M, j_last]
// or keys [t0, t_last + M]) through shared memory in chunks of 32, one
// partner per lane. Launch 1 (one warp per row) writes dQ, Delta and dS on
// each row's M + 1 band offsets; launch 2 (one warp per key) writes dK and
// dV; launch 3 sums the per-row offsets over b and t in a fixed order. No
// atomics: every output element has one writer, so the result is
// deterministic.
//
// Bounds on the H100 (3.35 TB/s, 67 TFLOP/s f32), counting only the band's
// pairs (M + 1 keys a row): at the learner shape (B=32, T=81, H=4, D=32,
// M=64) the forward moves about 7.4 MB (q, k, v, out) for 0.09 GFLOP, so
// bytes bound it at about 2.2 us; at the acting shape (T=1) it moves about
// 2.2 MB, about 0.65 us; the backward moves about 15 MB for 2.5x the
// flops, about 4.4 us. None of these kernels reaches its bound. The
// forward's time is one burst round trip to HBM for the staging plus the
// shared-memory traffic of the score and P . V loops (by their count about
// 290 wavefronts a warp at the learner shape), not its flops (PERF.md).
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

// Backward: items per block, and partners per shared-memory chunk (one a
// lane).
constexpr int kWarps = 8;
constexpr int kChunk = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int B, T, H, D, M, K;
};

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Offset of element (b, n, h, 0) of a [B, N, H, D] tensor.
__device__ inline long long row_of(int b, int n, int h, int N, int H, int D) {
  return ((static_cast<long long>(b) * N + n) * H + h) * D;
}

// Whether query t of batch row b sees key j, inside the band or not.
__device__ inline bool visible(int t, int j, const Geometry& g,
                               const int* seg_b, const float* valid_b,
                               const unsigned char* nodone_b) {
  const int o = t - j + g.M;
  if (o < 0 || o > g.M) return false;
  if (j < g.M) return valid_b[j] != 0.f && nodone_b[t] != 0;
  return seg_b[t] == seg_b[j - g.M];
}

// dot(a, b) over D floats in shared memory, in order.
__device__ inline float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Copy rows [n0, n0 + n) of (b, h) of a [B, N, H, D] tensor into shared
// memory with row stride ld; all threads of the block take part.
__device__ inline void stage_rows(float* dst, int ld, const float* src, int b,
                                  int n0, int n, int h, int N, int H, int D) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = src[row_of(b, n0 + r, h, N, H, D) + d];
  }
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

// Copy n rows of D floats, `stride` floats apart in global memory, into
// shared-memory rows of LD floats; all threads of the block take part. The
// 16-byte path (D % 4 == 0, aligned) is asynchronous and completes at
// cp_async_wait_all(); the scalar path also zeroes the columns D ..
// round_up(D, 4) that the float4 dot products read.
__device__ inline void stage_rows_async(float* dst, int LD, const float* src,
                                        long long stride, int n, int D,
                                        bool vec) {
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int cols = vec ? D / 4 : (D + 3) & ~3;
  auto copy = [&](int r, int c) {
    if (vec) {
      cp_async16(dst + r * LD + 4 * c, src + r * stride + 4 * c);
    } else {
      dst[r * LD + c] = c < D ? src[r * stride + c] : 0.f;
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
template <int RW, int DPL>
__global__ void __launch_bounds__(kMaxThreads)
    attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ seg,
                         const float* __restrict__ valid,
                         const unsigned char* __restrict__ nodone,
                         const float* __restrict__ bias,
                         float* __restrict__ out, float* __restrict__ lse,
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
  const float* kb = k + row_of(b, 0, h, g.K, g.H, D);
  const float* vb = v + row_of(b, 0, h, g.K, g.H, D);
  const int* seg_b = seg + static_cast<long long>(b) * g.T;
  const float* valid_b = valid + static_cast<long long>(b) * g.M;
  const unsigned char* nodone_b = nodone + static_cast<long long>(b) * g.T;
  const float* bias_h = bias + static_cast<long long>(h) * (g.M + 1);
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
      bw[i] = o >= 0 && o <= g.M ? bias_h[o] : 0.f;
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
      if (d < D) out[o_row + d] = acc[r][i] / l[r];
    }
    if (lane == 0)
      lse[(static_cast<long long>(b) * g.H + h) * g.T + t] = m[r] + logf(l[r]);
  }
}

// ------------------------------------------------------------ backward

// Launch 1. grid (B*H, ceil(T / kWarps)); warp w owns query row t. Writes
// dq[t], delta[b, h, t] and ds_diag[b, h, t, o] for o in [0, M] (0 where
// masked), each exactly once.
template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_dq_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ seg,
                            const float* __restrict__ valid,
                            const unsigned char* __restrict__ nodone,
                            const float* __restrict__ bias,
                            const float* __restrict__ out,
                            const float* __restrict__ lse,
                            const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ delta,
                            float* __restrict__ ds_diag, Geometry g,
                            float scale) {
  extern __shared__ float smem[];
  const int D = g.D, ld = D + 1;
  float* ks = smem;               // [kChunk][ld]
  float* vs = ks + kChunk * ld;   // [kChunk][ld]
  float* qs = vs + kChunk * ld;   // [kWarps][D]
  float* dos = qs + kWarps * D;   // [kWarps][D]
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = blockIdx.y * kWarps;
  const int t = t0 + warp;
  const bool active = t < g.T;
  const int t_last = min(t0 + kWarps, g.T) - 1;
  const int* seg_b = seg + static_cast<long long>(b) * g.T;
  const float* valid_b = valid + static_cast<long long>(b) * g.M;
  const unsigned char* nodone_b = nodone + static_cast<long long>(b) * g.T;
  const float* bias_h = bias + static_cast<long long>(h) * (g.M + 1);
  const long long bht = (static_cast<long long>(b) * g.H + h) * g.T + t;
  float* q_w = qs + warp * D;
  float* do_w = dos + warp * D;
  float delta_t = 0.f, lse_t = 0.f;
  if (active) {
    const long long r = row_of(b, t, h, g.T, g.H, D);
    float part = 0.f;
    for (int d = lane; d < D; d += 32) {
      q_w[d] = q[r + d];
      do_w[d] = dout[r + d];
      part = fmaf(dout[r + d], out[r + d], part);
    }
    delta_t = warp_sum(part);
    lse_t = lse[bht];
    if (lane == 0) delta[bht] = delta_t;
  }

  float acc[DPL];
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  const int j_end = t_last + g.M;
  for (int c0 = t0; c0 <= j_end; c0 += kChunk) {
    const int n = min(kChunk, j_end - c0 + 1);
    __syncthreads();
    stage_rows(ks, ld, k, b, c0, n, h, g.K, g.H, D);
    stage_rows(vs, ld, v, b, c0, n, h, g.K, g.H, D);
    __syncthreads();
    if (!active) continue;
    const int j = c0 + lane;
    const int o = t - j + g.M;
    float ds = 0.f;
    if (lane < n && o >= 0 && o <= g.M) {
      if (visible(t, j, g, seg_b, valid_b, nodone_b)) {
        const float s =
            dot(q_w, ks + lane * ld, D) * scale + bias_h[o];
        const float p = expf(s - lse_t);
        ds = p * (dot(do_w, vs + lane * ld, D) - delta_t);
      }
      ds_diag[bht * (g.M + 1) + o] = ds;
    }
    for (int jj = 0; jj < n; ++jj) {
      const float dsj = __shfl_sync(kFull, ds, jj);
      if (dsj == 0.f) continue;  // warp-uniform
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(dsj, ks[jj * ld + d], acc[i]);
      }
    }
  }
  if (!active) return;
  const long long r = row_of(b, t, h, g.T, g.H, D);
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) dq[r + d] = acc[i] * scale;
  }
}

// Launch 2. grid (B*H, ceil(K / kWarps)); warp w owns key j and sums over
// the rows t in [j - M, j] that see it. Writes dk[j] and dv[j].
template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    attention_bwd_dkdv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int* __restrict__ seg,
                              const float* __restrict__ valid,
                              const unsigned char* __restrict__ nodone,
                              const float* __restrict__ bias,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const float* __restrict__ dout,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Geometry g, float scale) {
  extern __shared__ float smem[];
  const int D = g.D, ld = D + 1;
  float* qs = smem;               // [kChunk][ld]
  float* dos = qs + kChunk * ld;  // [kChunk][ld]
  float* ks = dos + kChunk * ld;  // [kWarps][D]
  float* vs = ks + kWarps * D;    // [kWarps][D]
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = blockIdx.y * kWarps;
  const int j = j0 + warp;
  const bool active = j < g.K;
  const int j_last = min(j0 + kWarps, g.K) - 1;
  const int* seg_b = seg + static_cast<long long>(b) * g.T;
  const float* valid_b = valid + static_cast<long long>(b) * g.M;
  const unsigned char* nodone_b = nodone + static_cast<long long>(b) * g.T;
  const float* bias_h = bias + static_cast<long long>(h) * (g.M + 1);
  const long long bh_t = (static_cast<long long>(b) * g.H + h) * g.T;
  float* k_w = ks + warp * D;
  float* v_w = vs + warp * D;
  if (active) {
    const long long r = row_of(b, j, h, g.K, g.H, D);
    for (int d = lane; d < D; d += 32) {
      k_w[d] = k[r + d];
      v_w[d] = v[r + d];
    }
  }

  float acc_k[DPL], acc_v[DPL];
  for (int i = 0; i < DPL; ++i) acc_k[i] = acc_v[i] = 0.f;
  const int t_begin = max(0, j0 - g.M), t_end = min(g.T - 1, j_last);
  for (int c0 = t_begin; c0 <= t_end; c0 += kChunk) {
    const int n = min(kChunk, t_end - c0 + 1);
    __syncthreads();
    stage_rows(qs, ld, q, b, c0, n, h, g.T, g.H, D);
    stage_rows(dos, ld, dout, b, c0, n, h, g.T, g.H, D);
    __syncthreads();
    if (!active) continue;
    const int t = c0 + lane;
    float p = 0.f, ds = 0.f;
    if (lane < n && visible(t, j, g, seg_b, valid_b, nodone_b)) {
      const float s =
          dot(qs + lane * ld, k_w, D) * scale + bias_h[t - j + g.M];
      p = expf(s - lse[bh_t + t]);
      ds = p * (dot(dos + lane * ld, v_w, D) - delta[bh_t + t]);
    }
    for (int tt = 0; tt < n; ++tt) {
      const float pt = __shfl_sync(kFull, p, tt);
      const float dst = __shfl_sync(kFull, ds, tt);
      if (pt == 0.f) continue;  // warp-uniform; ds is 0 where p is
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          acc_v[i] = fmaf(pt, dos[tt * ld + d], acc_v[i]);
          acc_k[i] = fmaf(dst, qs[tt * ld + d], acc_k[i]);
        }
      }
    }
  }
  if (!active) return;
  const long long r = row_of(b, j, h, g.K, g.H, D);
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) {
      dk[r + d] = acc_k[i] * scale;
      dv[r + d] = acc_v[i];
    }
  }
}

// Launch 3. grid (ceil((M + 1) / 32), H), block (32, 32): x over offsets,
// y strides over the B*T rows; partial sums in f64, combined over y in
// order.
__global__ void attention_dbias_kernel(const float* __restrict__ ds_diag,
                                       float* __restrict__ dbias,
                                       Geometry g) {
  __shared__ double part[32][33];
  const int o = blockIdx.x * 32 + threadIdx.x, h = blockIdx.y;
  const int W = g.M + 1;
  double s = 0.0;
  if (o < W) {
    for (int r = threadIdx.y; r < g.B * g.T; r += 32) {
      const int b = r / g.T, t = r - b * g.T;
      s += ds_diag[((static_cast<long long>(b) * g.H + h) * g.T + t) * W + o];
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && o < W) {
    double tot = 0.0;
    for (int y = 0; y < 32; ++y) tot += part[y][threadIdx.x];
    dbias[h * W + o] = static_cast<float>(tot);
  }
}

size_t bwd_smem(int D) {
  return sizeof(float) * (2 * kChunk * (D + 1) + 2 * kWarps * D);
}

template <int RW, int DPL>
int launch_fwd(const float* q, const float* k, const float* v,
               const int* seg, const float* valid,
               const unsigned char* nodone, const float* bias, float* out,
               float* lse, Geometry g, float scale, cudaStream_t stream) {
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
  f.vec = g.D % 4 == 0 && tbt::aligned16(q) &&
          tbt::aligned16(k) && tbt::aligned16(v);
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
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<RW, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(g.B * g.H, (g.T + f.TQ - 1) / f.TQ);
  attention_fwd_kernel<RW, DPL><<<grid, 32 * warps, smem, stream>>>(
      q, k, v, seg, valid, nodone, bias, out, lse, g, f, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DPL>
int launch_fwd_for(const float* q, const float* k, const float* v,
                   const int* seg, const float* valid,
                   const unsigned char* nodone, const float* bias, float* out,
                   float* lse, Geometry g, float scale, cudaStream_t stream) {
  return g.T <= kActingMaxT
             ? launch_fwd<1, DPL>(q, k, v, seg, valid, nodone, bias, out, lse,
                                  g, scale, stream)
             : launch_fwd<kLearnerRows, DPL>(q, k, v, seg, valid, nodone,
                                             bias, out, lse, g, scale, stream);
}

template <int DPL>
void launch_bwd(const float* q, const float* k, const float* v,
                const int* seg, const float* valid,
                const unsigned char* nodone, const float* bias,
                const float* out, const float* lse, const float* dout,
                float* dq, float* dk, float* dv, float* delta,
                float* ds_diag, Geometry g, float scale,
                cudaStream_t stream) {
  const dim3 rows(g.B * g.H, (g.T + kWarps - 1) / kWarps);
  attention_bwd_dq_kernel<DPL><<<rows, kWarps * 32, bwd_smem(g.D), stream>>>(
      q, k, v, seg, valid, nodone, bias, out, lse, dout, dq, delta, ds_diag,
      g, scale);
  const dim3 keys(g.B * g.H, (g.K + kWarps - 1) / kWarps);
  attention_bwd_dkdv_kernel<DPL>
      <<<keys, kWarps * 32, bwd_smem(g.D), stream>>>(
          q, k, v, seg, valid, nodone, bias, lse, delta, dout, dk, dv, g,
          scale);
}

Geometry geometry(int B, int T, int H, int D, int M) {
  return Geometry{B, T, H, D, M, M + T};
}

}  // namespace

// D <= 128 (ceil(D / 32) <= 4 dims per lane). The forward opts in to
// more than 48 KB of shared memory where its chunks need it (D > 32); the
// backward stays within 48 KB.
TBT_API int tbt_attention_fwd(const float* q, const float* k, const float* v,
                              const int* seg, const float* valid,
                              const unsigned char* nodone, const float* bias,
                              float* out, float* lse, int B, int T, int H,
                              int D, int M, void* stream) {
  const Geometry g = geometry(B, T, H, D, M);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return launch_fwd_for<1>(q, k, v, seg, valid, nodone, bias, out, lse, g, scale, s);
    case 2: return launch_fwd_for<2>(q, k, v, seg, valid, nodone, bias, out, lse, g, scale, s);
    case 3: return launch_fwd_for<3>(q, k, v, seg, valid, nodone, bias, out, lse, g, scale, s);
    case 4: return launch_fwd_for<4>(q, k, v, seg, valid, nodone, bias, out, lse, g, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

TBT_API int tbt_attention_bwd(const float* q, const float* k, const float* v,
                              const int* seg, const float* valid,
                              const unsigned char* nodone, const float* bias,
                              const float* out, const float* lse,
                              const float* dout, float* dq, float* dk,
                              float* dv, float* dbias, float* delta,
                              float* ds_diag, int B, int T, int H, int D,
                              int M, void* stream) {
  const Geometry g = geometry(B, T, H, D, M);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: launch_bwd<1>(q, k, v, seg, valid, nodone, bias, out, lse, dout, dq, dk, dv, delta, ds_diag, g, scale, s); break;
    case 2: launch_bwd<2>(q, k, v, seg, valid, nodone, bias, out, lse, dout, dq, dk, dv, delta, ds_diag, g, scale, s); break;
    case 3: launch_bwd<3>(q, k, v, seg, valid, nodone, bias, out, lse, dout, dq, dk, dv, delta, ds_diag, g, scale, s); break;
    case 4: launch_bwd<4>(q, k, v, seg, valid, nodone, bias, out, lse, dout, dq, dk, dv, delta, ds_diag, g, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + 1 + 31) / 32, H);
  attention_dbias_kernel<<<grid, dim3(32, 32), 0, s>>>(ds_diag, dbias, g);
  return static_cast<int>(cudaGetLastError());
}
