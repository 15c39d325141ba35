// Device marks: the boundaries of a learner update, stamped on the card
// inside its CUDA graph (torchbeast_tpu_torch/marks.py).
//
// tbt_mark<I> reads the global nanosecond timer (%globaltimer) and writes
// it to slot I of a small device buffer. Each boundary has its own kernel
// name, so every mark shows by name in a torch.profiler device trace.
//
// - Mark 0 (the update's start) writes slot 0 and clears the other
//   boundary slots. Every other mark writes its slot only while it is
//   clear, so a mark that runs again (a recomputed region) keeps the first
//   stamp.
// - The update's last mark also folds: each region's duration (from one
//   slot to another), the whole update's span and, on a dispatch's first
//   update, the gap since the previous dispatch's last mark, each into
//   one row of a device accumulator: a histogram with the telemetry
//   registry's bucket geometry plus the exact count, sum, min, max (ns)
//   and sum of squares (s^2, a double). A bucket comes from the host's
//   table of thresholds, so it is the bucket the registry's own
//   bucket_index gives the same duration.
//
// Summed regions repeat within an update (a model's layers, forward and
// back): tbt_region<R, 1> stamps slot kRegionBase + 2R on entry and
// tbt_region<R, 0> adds the time since to slot kRegionBase + 2R + 1. A
// fold row whose `from` is -2 reads its `to` slot as it stands: a
// region's sum, or a value the learner wrote there with torch ops (an
// integer of billionths); a slot still 0 (nothing ran) folds nothing.
// Mark 0 clears these slots too.
//
// One thread stamps; a fold runs one thread a row, each row its own.
#include "common.cuh"

namespace {

// The buffer's layout; marks.py keeps the same numbers.
constexpr int kBoundaries = 8;   // slots 0..7: the update's boundaries
constexpr int kPrevEnd = 15;     // slot 15: the previous update's end
constexpr int kRegionBase = 16;  // slots 16..23: summed regions; 24..: values
constexpr int kSlots = 32;
constexpr int kRegions = 4;
constexpr int kFromSlot = -2;    // a fold row that reads its `to` slot
constexpr int kBuckets = 192;    // histogram buckets a row
constexpr int kCount = kBuckets;        // then the row's count,
constexpr int kSum = kBuckets + 1;      // sum of durations (ns),
constexpr int kMin = kBuckets + 2;      // min (ns),
constexpr int kMax = kBuckets + 3;      // max (ns),
constexpr int kSumSq = kBuckets + 4;    // sum of squares (s^2, double)
constexpr int kRow = kBuckets + 5;
constexpr int kMaxRows = 16;

// What the last mark folds: row r takes slots[to[r]] - slots[from[r]]
// into accumulator row series[r]. A `from` of -1 reads the previous
// update's end (the gap). n == 0 for every other mark.
struct Fold {
  int n;
  int from[kMaxRows];
  int to[kMaxRows];
  int series[kMaxRows];
};

__device__ __forceinline__ long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// The largest i with thr[i] <= v (thr ascending, thr[0] = 0): a first
// guess from the log, then a step or two along the table.
__device__ int bucket_of(long long v, const long long* thr) {
  if (v <= 0) return 0;
  // Bucket i >= 1 holds (G^(i-1), G^i] ns, G = 2^0.25.
  int b = 1 + static_cast<int>(log2(static_cast<double>(v)) * 4.0);
  b = min(max(b, 0), kBuckets - 1);
  while (b + 1 < kBuckets && thr[b + 1] <= v) ++b;
  while (b > 0 && thr[b] > v) --b;
  return b;
}

__device__ void observe(long long* row, long long d, const long long* thr) {
  row[bucket_of(d, thr)] += 1;
  row[kCount] += 1;
  row[kSum] += d;
  if (d < row[kMin]) row[kMin] = d;
  if (d > row[kMax]) row[kMax] = d;
  const double s = static_cast<double>(d) * 1e-9;
  reinterpret_cast<double*>(row)[kSumSq] += s * s;
}

}  // namespace

template <int I>
__global__ void tbt_mark(long long* slots, long long* acc,
                         const long long* thr, Fold fold) {
  __shared__ long long now;
  if (threadIdx.x == 0) {
    const long long t = global_timer();
    if (I == 0) {
      slots[0] = t;
      for (int i = 1; i < kBoundaries; ++i) slots[i] = 0;
      for (int i = kRegionBase; i < kSlots; ++i) slots[i] = 0;
    } else if (slots[I] == 0) {
      slots[I] = t;
    }
    now = slots[I];
  }
  if (fold.n == 0) return;
  __syncthreads();
  const int r = threadIdx.x;
  if (r < fold.n && fold.from[r] == kFromSlot) {
    const long long v = slots[fold.to[r]];
    if (v > 0) observe(acc + static_cast<long long>(fold.series[r]) * kRow,
                       v, thr);
  } else if (r < fold.n) {
    const long long end = slots[fold.to[r]];
    const long long start =
        fold.from[r] < 0 ? slots[kPrevEnd] : slots[fold.from[r]];
    // A gap needs a previous update; a clock never runs backwards, but a
    // negative difference would wrap the sums.
    if (start != 0 && end != 0) {
      observe(acc + static_cast<long long>(fold.series[r]) * kRow,
              end > start ? end - start : 0, thr);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) slots[kPrevEnd] = now;
}

// Enter (E = 1) or leave (E = 0) summed region R.
template <int R, int E>
__global__ void tbt_region(long long* slots) {
  const long long t = global_timer();
  long long* entered = slots + kRegionBase + 2 * R;
  if (E) {
    *entered = t;
  } else if (*entered != 0) {
    entered[1] += t > *entered ? t - *entered : 0;
  }
}

namespace {

template <int I>
cudaError_t launch(long long* slots, long long* acc, const long long* thr,
                   const Fold& fold, cudaStream_t stream) {
  // One warp covers every row of a fold; a plain mark is one thread.
  tbt_mark<I><<<1, fold.n > 0 ? 32 : 1, 0, stream>>>(slots, acc, thr, fold);
  return cudaGetLastError();
}

}  // namespace

// index: the boundary (0..7); fold: a host array of 1 + 3 x n ints (n,
// then from, to and series of each row), or NULL for a plain mark.
TBT_API int tbt_mark_launch(int index, long long* slots, long long* acc,
                            const long long* thr, const int* fold,
                            void* stream) {
  Fold f{};
  if (fold != nullptr) {
    f.n = fold[0];
    if (f.n < 0 || f.n > kMaxRows) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int r = 0; r < f.n; ++r) {
      f.from[r] = fold[1 + r];
      f.to[r] = fold[1 + f.n + r];
      f.series[r] = fold[1 + 2 * f.n + r];
    }
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (index) {
    case 0: return static_cast<int>(launch<0>(slots, acc, thr, f, s));
    case 1: return static_cast<int>(launch<1>(slots, acc, thr, f, s));
    case 2: return static_cast<int>(launch<2>(slots, acc, thr, f, s));
    case 3: return static_cast<int>(launch<3>(slots, acc, thr, f, s));
    case 4: return static_cast<int>(launch<4>(slots, acc, thr, f, s));
    case 5: return static_cast<int>(launch<5>(slots, acc, thr, f, s));
    case 6: return static_cast<int>(launch<6>(slots, acc, thr, f, s));
    case 7: return static_cast<int>(launch<7>(slots, acc, thr, f, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// region: the summed region (0..3); enter: 1 on entry, 0 on exit.
TBT_API int tbt_region_launch(int region, int enter, long long* slots,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (region < 0 || region >= kRegions) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (region * 2 + (enter ? 1 : 0)) {
    case 0: tbt_region<0, 0><<<1, 1, 0, s>>>(slots); break;
    case 1: tbt_region<0, 1><<<1, 1, 0, s>>>(slots); break;
    case 2: tbt_region<1, 0><<<1, 1, 0, s>>>(slots); break;
    case 3: tbt_region<1, 1><<<1, 1, 0, s>>>(slots); break;
    case 4: tbt_region<2, 0><<<1, 1, 0, s>>>(slots); break;
    case 5: tbt_region<2, 1><<<1, 1, 0, s>>>(slots); break;
    case 6: tbt_region<3, 0><<<1, 1, 0, s>>>(slots); break;
    default: tbt_region<3, 1><<<1, 1, 0, s>>>(slots); break;
  }
  return static_cast<int>(cudaGetLastError());
}
