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
// Bound on the H100: 6 [T, B] reads, 2 [T, B] writes and a [B] read of f32
// (at T=80, B=32 about 82 KB, under 0.03 us at 3.35 TB/s). What a kernel
// can be held to is the launch plus the T-step dependent chain of acc (a
// multiply and an add a step), provided no step waits on device memory.
//
// Design: stage the inputs in shared memory, run the chain there, and
// keep everything off the chain that need not be on it. A block owns
// kCols = 32 columns (B=32 is one block, B=128 four) and walks the unroll
// from its end in chunks of kRows rows through a ring of kStages slots:
//
// - warp 1 (producer) fills slot s with chunk k's six [kRows, 32] tiles.
//   When B % 4 == 0 and every tensor is 16-byte aligned (the main path)
//   that is six 2-D TMA copies (cp.async.bulk.tensor; rows before 0 and
//   columns past B arrive as zeros), completed on the slot's `full`
//   mbarrier; else 4-byte cp.async copies, a row of 32 columns a warp
//   instruction, handed to the same mbarrier (B=7, B=33, offset views).
//   At T=80 all five chunks are in flight at once, at T=4000 eight, so any
//   T fits. A TMA copy moves a whole tile for one instruction; 16-byte
//   cp.async copies of the same bytes were several times slower to land,
//   each warp keeping only so many requests in flight;
// - warp 0 (chain), a lane a column, keeps (acc, vs_{t+1}) in registers
//   across the whole unroll. For a chunk it loads its rows of a, delta
//   and V into registers first, then runs the chain on them, a multiply
//   and two adds a row, then stores the chunk's vs to the slot's vs tile,
//   and arrives on the slot's `chained` mbarrier;
// - warps 2 and 3 (epilogue) compute pgadv from the slot and its vs tile
//   (whose row kRows holds vs at the chunk's top, the chain's carry) and
//   write vs and pgadv to device memory, 16 bytes a thread on the main
//   path, while the chain runs the next chunk; then they arrive on
//   `empty`, and the producer refills the slot. Two warps keep up with the
//   chain; four slowed it, competing for shared memory. The vs tiles lie
//   outside the slots, so a TMA copy never overwrites what a thread wrote.
//
// The TPU kernel's VMEM scratch carry becomes the two registers; its
// BlockSpec tiles become the ring.
//
// Arithmetic uses the round-to-nearest intrinsics so no multiply-add is
// contracted: the kernel repeats the plain PyTorch recursion
// (ops/vtrace.py::vtrace_targets_plain) operation for operation, bit for
// bit.
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

namespace {

// Tiles in a slot: a, deltas, pgrho, rewards, discounts, values.
constexpr int kInputs = 6;
constexpr int kA = 0, kDelta = 1, kPgRho = 2, kReward = 3, kDisc = 4,
              kValue = 5;
constexpr int kCols = 32;      // columns a block: one warp runs the chain
constexpr int kRows = 16;      // rows a chunk
constexpr int kStages = 8;     // chunks in the ring
constexpr int kEpilogueWarps = 2;
constexpr int kEpilogueThreads = 32 * kEpilogueWarps;
constexpr int kThreads = 32 * (2 + kEpilogueWarps);
constexpr int kTileFloats = kRows * kCols;            // 2 KB
constexpr int kSlotFloats = kInputs * kTileFloats;    // 12 KB
constexpr int kSlotBytes = 4 * kSlotFloats;
constexpr int kVsFloats = (kRows + 1) * kCols;        // a slot's vs tile
// Dynamic shared memory only (so the ring starts at the window's base,
// aligned for TMA): the ring, the vs tiles, then the mbarriers.
constexpr int kSmemBytes =
    kStages * (kSlotBytes + 4 * kVsFloats) + 3 * kStages * 8;

struct Inputs {
  const float* p[kInputs];
};

struct TensorMaps {
  CUtensorMap m[kInputs];
};

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for.
__device__ inline void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Arrives on `bar` once every cp.async this thread issued so far has
// landed (noinc: the arrival is one of the count given at init).
__device__ inline void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The [kRows, kCols] box of `map` at (row, col) into dst; rows outside
// [0, T) and columns outside [0, B) land as zeros and count as bytes.
__device__ inline void tma_load(float* dst, const CUtensorMap* map, int col,
                                int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

__device__ inline void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// TMA: the inputs come through `maps`, else through `in` by cp.async.
// Chunk k covers rows [hi - kRows, hi), hi = T - k kRows; row r of a tile
// is row hi - kRows + r of the input (rows below 0 are not used).
template <bool TMA>
__global__ void __launch_bounds__(kThreads)
    vtrace_targets_kernel(const __grid_constant__ TensorMaps maps, Inputs in,
                          const float* __restrict__ boot,
                          float* __restrict__ vs, float* __restrict__ pg,
                          int T, int B) {
  extern __shared__ __align__(128) float ring[];
  float* vs_tiles = ring + kStages * kSlotFloats;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs_tiles + kStages * kVsFloats);
  uint64_t* chained = full + kStages;
  uint64_t* empty = chained + kStages;
  const int col0 = blockIdx.x * kCols;
  const int ncols = min(kCols, B - col0);
  const int nchunks = (T + kRows - 1) / kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);
      mbar_init(&chained[s], 32);
      mbar_init(&empty[s], kEpilogueThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {
    // Producer.
    for (int k = 0; k < nchunks; ++k) {
      const int s = k % kStages;
      if (k >= kStages) mbar_wait(&empty[s], ((k / kStages) - 1) & 1);
      const int row0 = T - (k + 1) * kRows;
      float* slot = ring + s * kSlotFloats;
      if constexpr (TMA) {
        if (lane == 0) {
          mbar_arrive_expect(&full[s], kSlotBytes);
          for (int x = 0; x < kInputs; ++x) {
            tma_load(slot + x * kTileFloats, &maps.m[x], col0, row0,
                     &full[s]);
          }
        }
      } else {
        // A warp copies a row of the tile a pass, a lane a column.
#pragma unroll
        for (int x = 0; x < kInputs; ++x) {
          const float* src = in.p[x] + col0 + lane;
          for (int r = max(0, -row0); r < kRows && lane < ncols; ++r) {
            cp_async4(slot + x * kTileFloats + r * kCols + lane,
                      src + static_cast<long long>(row0 + r) * B);
          }
        }
        mbar_arrive_on_copies(&full[s]);
      }
    }
    if constexpr (!TMA) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  if (warp == 0) {
    // The chain: lane = column.
    const bool active = lane < ncols;
    float acc = 0.f;
    float vs_next = active ? boot[col0 + lane] : 0.f;
    for (int k = 0; k < nchunks; ++k) {
      const int s = k % kStages;
      const float* tile = ring + s * kSlotFloats + lane;
      float* vs_tile = vs_tiles + s * kVsFloats + lane;
      mbar_wait(&full[s], (k / kStages) & 1);
      vs_tile[kRows * kCols] = vs_next;
      // Every load first, into registers, so none waits inside the chain
      // (the vs stores could alias them: the compiler keeps a load written
      // after a store after it). Rows below 0 (the last chunk of a T that
      // is not a multiple of kRows) come last and are never stored.
      float a[kRows], delta[kRows], v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a[r] = tile[kA * kTileFloats + r * kCols];
        delta[r] = tile[kDelta * kTileFloats + r * kCols];
        v[r] = tile[kValue * kTileFloats + r * kCols];
      }
#pragma unroll
      for (int r = kRows - 1; r >= 0; --r) {
        acc = __fadd_rn(delta[r], __fmul_rn(a[r], acc));
        vs_next = __fadd_rn(acc, v[r]);
        v[r] = vs_next;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) vs_tile[r * kCols] = v[r];
      mbar_arrive(&chained[s]);
    }
    return;
  }

  // Epilogue: pgadv_t = pgrho_t * ((r_t + disc_t * vs_{t+1}) - V_t), then
  // vs and pgadv out. A thread keeps kVec consecutive columns of a row
  // (TMA: B % 4 == 0, so four, as one 16-byte access each); all its loads
  // come first, then the stores (which could alias them).
  constexpr int kVec = TMA ? 4 : 1;
  constexpr int kPer = kTileFloats / kVec / kEpilogueThreads;
  static_assert(kEpilogueThreads * kVec % kCols == 0 &&
                    kTileFloats % (kVec * kEpilogueThreads) == 0,
                "an epilogue thread keeps the same columns in every row");
  using Vec = typename std::conditional<TMA, float4, float>::type;
  const int tid = threadIdx.x - 64;
  const int c = tid * kVec % kCols;
  for (int k = 0; k < nchunks; ++k) {
    const int s = k % kStages;
    const float* tile = ring + s * kSlotFloats;
    const float* vs_tile = vs_tiles + s * kVsFloats;
    const int row0 = T - (k + 1) * kRows;
    mbar_wait(&chained[s], (k / kStages) & 1);
    Vec pg_out[kPer], vs_out[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = (tid + j * kEpilogueThreads) * kVec;
      auto at = [&](const float* p) {
        return *reinterpret_cast<const Vec*>(p + i);
      };
      const Vec pgrho = at(tile + kPgRho * kTileFloats);
      const Vec reward = at(tile + kReward * kTileFloats);
      const Vec disc = at(tile + kDisc * kTileFloats);
      const Vec v = at(tile + kValue * kTileFloats);
      const Vec vs_up = at(vs_tile + kCols);
      vs_out[j] = at(vs_tile);
      const float* pr = reinterpret_cast<const float*>(&pgrho);
      const float* rw = reinterpret_cast<const float*>(&reward);
      const float* di = reinterpret_cast<const float*>(&disc);
      const float* vv = reinterpret_cast<const float*>(&v);
      const float* up = reinterpret_cast<const float*>(&vs_up);
      float* out = reinterpret_cast<float*>(&pg_out[j]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float target = __fadd_rn(rw[e], __fmul_rn(di[e], up[e]));
        out[e] = __fmul_rn(pr[e], __fsub_rn(target, vv[e]));
      }
    }
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = (tid + j * kEpilogueThreads) * kVec / kCols;
      if (c < ncols && row0 + r >= 0) {
        const long long g = static_cast<long long>(row0 + r) * B + col0 + c;
        *reinterpret_cast<Vec*>(pg + g) = pg_out[j];
        *reinterpret_cast<Vec*>(vs + g) = vs_out[j];
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (the library links
// no driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  static cudaError_t status = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    if (err == cudaSuccess && found != cudaDriverEntryPointSuccess) {
      err = cudaErrorSymbolNotFound;
    }
    cached = reinterpret_cast<EncodeTiled>(p);
    return err;
  }();
  *fn = cached;
  return status;
}

// A [T, B] f32 tensor read in [kRows, kCols] boxes.
cudaError_t encode_map(EncodeTiled encode, CUtensorMap* map, const float* p,
                       int T, int B) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(B),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(B) * 4};
  const cuuint32_t box[2] = {kCols, kRows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

TBT_API int tbt_vtrace_targets(const float* a, const float* deltas,
                               const float* pgrho, const float* rewards,
                               const float* discounts, const float* values,
                               const float* boot, float* vs, float* pg, int T,
                               int B, void* stream) {
  const Inputs in{{a, deltas, pgrho, rewards, discounts, values}};
  TensorMaps maps{};
  bool tma = B % 4 == 0;
  for (const float* p : in.p) tma = tma && tbt::aligned16(p);
  tma = tma && tbt::aligned16(vs) && tbt::aligned16(pg);
  if (tma) {
    EncodeTiled encode;
    cudaError_t err = encoder(&encode);
    for (int x = 0; x < kInputs && err == cudaSuccess; ++x) {
      err = encode_map(encode, &maps.m[x], in.p[x], T, B);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = tma ? vtrace_targets_kernel<true>
                    : vtrace_targets_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kCols - 1) / kCols;
  kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps, in, boot, vs, pg, T, B);
  return static_cast<int>(cudaGetLastError());
}

TBT_API const char* tbt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
