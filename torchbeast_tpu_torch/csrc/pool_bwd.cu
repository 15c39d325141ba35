// Gradient of the 3x3, stride-2, pad-1 max-pool with respect to its input,
// crediting EVERY input position that ties at its window's max.
//
// Replaces the TPU kernel torchbeast_tpu/ops/pallas_pool.py::_kernel
// (launched by pool_bwd; helpers _doubled_grid and _auto_block_n):
//
//   gx[n, h, w, c] = sum over output windows (oh, ow) that cover (h, w) of
//                    g[n, oh, ow, c] * (x[n, h, w, c] == y[n, oh, ow, c])
//
// Design: gather form, no atomics. Window oh covers input rows 2*oh - 1 ..
// 2*oh + 1, so the 2x2 input patch (rows 2*oh, 2*oh + 1; columns 2*ow,
// 2*ow + 1) of output position (oh, ow) is covered by windows (oh..oh+1,
// ow..ow+1) and by no other: the even row and column by one window, the
// odd ones by two. A thread owns one output column ow and a group of V
// channels (V = 4: one 16-byte float4; V = 1: one float) and walks a
// strip of output rows downwards, writing each row's 2x2 input patch. y
// and g of the row below are loaded once and carried in registers to the
// next row, so each thread reads every x element of its strip once and
// each y and g element at most twice (its own column and, for the
// neighbouring thread, as column ow + 1, which the L1 serves). Blocks are
// (channel groups, output columns) over a grid of (image, strip of rows),
// so no thread divides a 64-bit index: offsets are products of the
// coordinates and the tensors' strides.
//
// Storage: f32, or bf16 under the bf16 precision policies (the reference's
// kernel runs in x.dtype). The 16-byte path carries V = 4 f32 or V = 8
// bf16 channels a thread; it needs C % V == 0, channels contiguous (stride
// 1), every other stride a multiple of V elements and 16-byte aligned
// pointers; the deep trunk's channels_last activations (C = 16 or 32) take
// it. Any other shape or layout (odd C, a view into its storage, NCHW
// strides) takes the scalar path of the same kernel; odd H and W only mask
// the last row and column. The TPU kernel's doubled grid (a 2x upsampled,
// padded copy of y and of g, built for the TPU's lane layout) is not built.
//
// Windows are added from the highest (oh, ow) down, the order in which the
// plain tap-sum (ops/pool.py::pool_bwd_plain, and the reference's
// ops/pool.py::_bwd and pallas_pool.py::_kernel) adds its taps, so the two
// agree bit for bit. In bf16 the sum is kept in f32 registers but rounded
// to bf16 after every add, as the reference's bf16 accumulator is: the
// comparisons are exact (y is a max of x) and each sum of two bf16 values
// rounds once.
//
// Bound on the H100 (3.35 TB/s): bytes. x and gx are input-sized, y and g
// output-sized, f32: at the deep trunk's stage 1 (N=2592, 84x84x16 ->
// 42x42x16) that is 2.93 GB, about 0.87 ms; the three stages together
// 1.42 ms, half of that in bf16. With 16-byte accesses and no index
// division the kernel is a stream: in f32 it moves those bytes at about
// three quarters of the peak rate (PERF.md).
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

using tbt::bf16;

// Rows of output per thread strip (the launch balances the strips).
constexpr int kMaxStripRows = 8;

// Element strides of a 4-D tensor indexed (n, c, h, w).
struct Layout {
  long long n, c, h, w;
};

template <int V>
struct Pack {
  float v[V];
};

// V consecutive channels, widened to f32: one 16-byte access for V = 4
// f32 or V = 8 bf16, one element for V = 1.
template <int V>
__device__ inline Pack<V> load(const float* p) {
  Pack<V> r;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int V>
__device__ inline Pack<V> load(const bf16* p) {
  Pack<V> r;
  if constexpr (V == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      r.v[2 * i] = f.x;
      r.v[2 * i + 1] = f.y;
    }
  } else {
    r.v[0] = __bfloat162float(__ldg(p));
  }
  return r;
}

template <int V>
__device__ inline void store(float* p, const Pack<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

template <int V>
__device__ inline void store(bf16* p, const Pack<V>& r) {
  if constexpr (V == 8) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b =
          __floats2bfloat162_rn(r.v[2 * i], r.v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *p = __float2bfloat16_rn(r.v[0]);
  }
}

// acc += g where x == y, channel by channel; T = bf16 rounds each sum to
// bf16 (the values stay exact bf16 values in f32 registers).
template <typename T, int V>
__device__ inline void credit(Pack<V>& acc, const Pack<V>& x,
                              const Pack<V>& y, const Pack<V>& g) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (x.v[i] == y.v[i]) {
      if constexpr (std::is_same<T, bf16>::value) {
        acc.v[i] = __bfloat162float(__float2bfloat16_rn(acc.v[i] + g.v[i]));
      } else {
        acc.v[i] += g.v[i];
      }
    }
  }
}

template <int V>
__device__ inline Pack<V> zeros() {
  Pack<V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = 0.f;
  return r;
}

// grid (N * strips, ceil(Wo / blockDim.y), ceil(C / V / blockDim.x)),
// block (channel groups, output columns).
template <typename T, int V>
__global__ void __launch_bounds__(tbt::kThreads)
    pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ g, T* __restrict__ gx,
                    Layout lx, Layout ly, Layout lg, Layout lgx, int H, int W,
                    int C, int Ho, int Wo, int strips, int strip_rows) {
  const int c = (blockIdx.z * blockDim.x + threadIdx.x) * V;
  const int ow = blockIdx.y * blockDim.y + threadIdx.y;
  if (c >= C || ow >= Wo) return;
  const int n = blockIdx.x / strips;
  const int oh0 = (blockIdx.x - n * strips) * strip_rows;
  const int oh_end = min(oh0 + strip_rows, Ho);
  if (oh0 >= oh_end) return;

  const T* xb = x + n * lx.n + c * lx.c;
  const T* yb = y + n * ly.n + c * ly.c;
  const T* gb = g + n * lg.n + c * lg.c;
  T* gxb = gx + n * lgx.n + c * lgx.c;
  const int w0 = 2 * ow, w1 = 2 * ow + 1;
  const bool has_w1 = w1 < W;        // W odd: the last column has no w1
  const bool has_ow1 = ow + 1 < Wo;  // window ow + 1 covers column w1
  const long long yw0 = ow * ly.w, yw1 = (ow + 1) * ly.w;
  const long long gw0 = ow * lg.w, gw1 = (ow + 1) * lg.w;

  // y and g of windows (oh, ow) and (oh, ow + 1); the row below is loaded
  // each step and carried to the next.
  Pack<V> y00 = load<V>(yb + oh0 * ly.h + yw0);
  Pack<V> g00 = load<V>(gb + oh0 * lg.h + gw0);
  Pack<V> y01 = y00, g01 = zeros<V>();
  if (has_ow1) {
    y01 = load<V>(yb + oh0 * ly.h + yw1);
    g01 = load<V>(gb + oh0 * lg.h + gw1);
  }
  for (int oh = oh0; oh < oh_end; ++oh) {
    const bool has_oh1 = oh + 1 < Ho;  // window oh + 1 covers row h1
    Pack<V> y10 = y00, g10 = zeros<V>(), y11 = y00, g11 = zeros<V>();
    if (has_oh1) {
      y10 = load<V>(yb + (oh + 1) * ly.h + yw0);
      g10 = load<V>(gb + (oh + 1) * lg.h + gw0);
      if (has_ow1) {
        y11 = load<V>(yb + (oh + 1) * ly.h + yw1);
        g11 = load<V>(gb + (oh + 1) * lg.h + gw1);
      }
    }
    const int h0 = 2 * oh, h1 = 2 * oh + 1;
    const bool has_h1 = h1 < H;  // H odd: the last strip row has no h1
    {
      // Row h0 is covered by window row oh only.
      const T* xr = xb + h0 * lx.h;
      T* gr = gxb + h0 * lgx.h;
      const Pack<V> x00 = load<V>(xr + w0 * lx.w);
      Pack<V> a = zeros<V>();
      credit<T>(a, x00, y00, g00);
      store<V>(gr + w0 * lgx.w, a);
      if (has_w1) {
        const Pack<V> x01 = load<V>(xr + w1 * lx.w);
        a = zeros<V>();
        if (has_ow1) credit<T>(a, x01, y01, g01);
        credit<T>(a, x01, y00, g00);
        store<V>(gr + w1 * lgx.w, a);
      }
    }
    if (has_h1) {
      // Row h1 is covered by window rows oh + 1 (if any), then oh.
      const T* xr = xb + h1 * lx.h;
      T* gr = gxb + h1 * lgx.h;
      const Pack<V> x10 = load<V>(xr + w0 * lx.w);
      Pack<V> a = zeros<V>();
      if (has_oh1) credit<T>(a, x10, y10, g10);
      credit<T>(a, x10, y00, g00);
      store<V>(gr + w0 * lgx.w, a);
      if (has_w1) {
        const Pack<V> x11 = load<V>(xr + w1 * lx.w);
        a = zeros<V>();
        if (has_oh1) {
          if (has_ow1) credit<T>(a, x11, y11, g11);
          credit<T>(a, x11, y10, g10);
        }
        if (has_ow1) credit<T>(a, x11, y01, g01);
        credit<T>(a, x11, y00, g00);
        store<V>(gr + w1 * lgx.w, a);
      }
    }
    y00 = y10; g00 = g10; y01 = y11; g01 = g11;
  }
}

// Whether a tensor can be read V channels at a time with 16-byte accesses.
bool vector_layout(const void* p, const Layout& l, int V) {
  return tbt::aligned16(p) && l.c == 1 && l.n % V == 0 && l.h % V == 0 &&
         l.w % V == 0;
}

template <typename T, int V>
int launch(const void* x, const void* y, const void* g, void* gx,
           const Layout* l, int N, int H, int W, int C, int Ho, int Wo,
           cudaStream_t stream) {
  const int groups = (C + V - 1) / V;
  const int bx = std::min(groups, 32);
  const int by = std::max(1, std::min(Wo, tbt::kThreads / bx));
  // Balanced strips of at most kMaxStripRows output rows.
  const int strips = (Ho + kMaxStripRows - 1) / kMaxStripRows;
  const int strip_rows = (Ho + strips - 1) / strips;
  const long long blocks_x = static_cast<long long>(N) * strips;
  if (blocks_x > 0x7fffffffLL || (Wo + by - 1) / by > 65535 ||
      (groups + bx - 1) / bx > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks_x), (Wo + by - 1) / by,
                  (groups + bx - 1) / bx);
  pool_bwd_kernel<T, V><<<grid, dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(g), static_cast<T*>(gx), l[0], l[1], l[2], l[3],
      H, W, C, Ho, Wo, strips, strip_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 16 element strides, (n, c, h, w) of x, y, g and gx in turn.
// is_bf16: all four tensors are bf16 (else f32). *vectorized is set to 1
// when the 16-byte path ran, 0 for the scalar one.
TBT_API int tbt_pool_bwd(const void* x, const void* y, const void* g,
                         void* gx, const long long* strides, int N, int H,
                         int W, int C, int Ho, int Wo, int is_bf16,
                         int* vectorized, void* stream) {
  Layout l[4];
  for (int i = 0; i < 4; ++i)
    l[i] = Layout{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                  strides[4 * i + 3]};
  const int V = is_bf16 ? 8 : 4;  // channels in 16 bytes
  const bool vec = C % V == 0 && vector_layout(x, l[0], V) &&
                   vector_layout(y, l[1], V) && vector_layout(g, l[2], V) &&
                   vector_layout(gx, l[3], V);
  *vectorized = vec ? 1 : 0;
  if (N == 0 || H == 0 || W == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? launch<bf16, 8>(x, y, g, gx, l, N, H, W, C, Ho, Wo, s)
               : launch<bf16, 1>(x, y, g, gx, l, N, H, W, C, Ho, Wo, s);
  return vec ? launch<float, 4>(x, y, g, gx, l, N, H, W, C, Ho, Wo, s)
             : launch<float, 1>(x, y, g, gx, l, N, H, W, C, Ho, Wo, s);
}
