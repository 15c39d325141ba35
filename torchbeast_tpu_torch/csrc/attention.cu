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
// Design. Each warp owns one item (a query row in the forward and the dq
// pass, a key in the dk/dv pass); a block of kWarps warps owns kWarps
// consecutive items of one (b, h). The block streams the partners its
// items need (only the band: keys [t0, t_last + M], or rows
// [j0 - M, j_last]) through shared memory in chunks of 32, one partner per
// lane: the lane computes its partner's dot products over D, and the
// warp's sums over partners (p . V, dS . K, ...) broadcast each lane's
// value with a shuffle while lanes hold the head dims. The forward keeps a
// running max and sum (online softmax) so no [T, K] tile is ever stored;
// it writes each row's log-sum-exp, from which the backward recomputes P.
// Layouts are the model's [B, T, H, D] and [B, K, H, D]: no transposes,
// and the mask and the bias index are computed in the kernel from seg,
// cache_valid and no_done (the TPU kernel had the bias expanded to
// [H, T, K] in HBM for Mosaic's sake).
//
// Backward, with Delta_t = rowsum(dO_t * O_t) and P from the lse:
//   dS = P * (dO V^T - Delta),  dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D),
//   dV = P^T dO,  d rel_bias[h, o] = sum over b, t of dS[t, t + M - o].
// Launch 1 (one warp per row) writes dQ, Delta and dS on each row's M + 1
// band offsets; launch 2 (one warp per key) writes dK and dV; launch 3
// sums the per-row offsets over b and t in a fixed order. No atomics:
// every output element has one writer, so the result is deterministic.
//
// Bound on the H100 at the learner shape (B=32, T=81, H=4, D=32, M=64):
// the forward moves about 7.4 MB (q, k, v, out) and does 4 D flops per
// band pair (2.7 M pairs, 0.09 GFLOP), so bytes bound it at about 2.2 us;
// the backward moves about 15 MB for 2.5x the flops. The simple design
// here uses no tensor cores (wgmma) and reads each key chunk once per
// block of 8 rows, so latency and the f32 FMA pipe, not HBM, set its time.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;   // items per block
constexpr int kChunk = 32;  // partners per shared-memory chunk (one a lane)
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int B, T, H, D, M, K;
};

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
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

// grid (B*H, ceil(T / kWarps)), kWarps warps; warp w owns query row
// t = blockIdx.y * kWarps + w. DPL = ceil(D / 32) head dims per lane.
template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ seg,
                         const float* __restrict__ valid,
                         const unsigned char* __restrict__ nodone,
                         const float* __restrict__ bias,
                         float* __restrict__ out, float* __restrict__ lse,
                         Geometry g, float scale) {
  extern __shared__ float smem[];
  const int D = g.D, ld = D + 1;  // padded rows: lanes read distinct banks
  float* ks = smem;               // [kChunk][ld]
  float* vs = ks + kChunk * ld;   // [kChunk][ld]
  float* qs = vs + kChunk * ld;   // [kWarps][D]
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
  float* q_w = qs + warp * D;
  if (active) {
    for (int d = lane; d < D; d += 32) q_w[d] = q[row_of(b, t, h, g.T, g.H, D) + d];
  }

  float m = -INFINITY, l = 0.f, acc[DPL];
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  const int j_end = t_last + g.M;  // keys [t0, t_last + M] cover the band
  for (int c0 = t0; c0 <= j_end; c0 += kChunk) {
    const int n = min(kChunk, j_end - c0 + 1);
    __syncthreads();  // the previous chunk is consumed (and q_w staged)
    stage_rows(ks, ld, k, b, c0, n, h, g.K, g.H, D);
    stage_rows(vs, ld, v, b, c0, n, h, g.K, g.H, D);
    __syncthreads();
    if (!active) continue;
    const int j = c0 + lane;
    const bool vis =
        lane < n && visible(t, j, g, seg_b, valid_b, nodone_b);
    float s = -INFINITY;
    if (vis) s = dot(q_w, ks + lane * ld, D) * scale + bias_h[t - j + g.M];
    const float cmax = warp_max(s);
    if (cmax == -INFINITY) continue;  // nothing visible in this chunk
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);  // 0 on the first visible chunk
    const float p = vis ? expf(s - m_new) : 0.f;
    l = l * corr + warp_sum(p);
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
    for (int jj = 0; jj < n; ++jj) {
      const float pj = __shfl_sync(kFull, p, jj);
      if (pj == 0.f) continue;  // warp-uniform
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pj, vs[jj * ld + d], acc[i]);
      }
    }
    m = m_new;
  }
  if (!active) return;
  const long long o_row = row_of(b, t, h, g.T, g.H, D);
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[o_row + d] = acc[i] / l;
  }
  if (lane == 0) lse[(static_cast<long long>(b) * g.H + h) * g.T + t] = m + logf(l);
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

size_t fwd_smem(int D) {
  return sizeof(float) * (2 * kChunk * (D + 1) + kWarps * D);
}

size_t bwd_smem(int D) {
  return sizeof(float) * (2 * kChunk * (D + 1) + 2 * kWarps * D);
}

template <int DPL>
void launch_fwd(const float* q, const float* k, const float* v,
                const int* seg, const float* valid,
                const unsigned char* nodone, const float* bias, float* out,
                float* lse, Geometry g, float scale, cudaStream_t stream) {
  const dim3 grid(g.B * g.H, (g.T + kWarps - 1) / kWarps);
  attention_fwd_kernel<DPL><<<grid, kWarps * 32, fwd_smem(g.D), stream>>>(
      q, k, v, seg, valid, nodone, bias, out, lse, g, scale);
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

// D <= 128 (ceil(D / 32) <= 4 dims per lane); the shared memory then
// stays within the 48 KB a launch may take without opting in.
TBT_API int tbt_attention_fwd(const float* q, const float* k, const float* v,
                              const int* seg, const float* valid,
                              const unsigned char* nodone, const float* bias,
                              float* out, float* lse, int B, int T, int H,
                              int D, int M, void* stream) {
  const Geometry g = geometry(B, T, H, D, M);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: launch_fwd<1>(q, k, v, seg, valid, nodone, bias, out, lse, g, scale, s); break;
    case 2: launch_fwd<2>(q, k, v, seg, valid, nodone, bias, out, lse, g, scale, s); break;
    case 3: launch_fwd<3>(q, k, v, seg, valid, nodone, bias, out, lse, g, scale, s); break;
    case 4: launch_fwd<4>(q, k, v, seg, valid, nodone, bias, out, lse, g, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
