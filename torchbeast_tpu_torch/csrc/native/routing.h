// Native serving-plane routing (ISSUE 16): the slot-hash slice router
// and the replica/central fallback router, ported from the Python
// request path (torchbeast_tpu/parallel/sebulba.py SliceRouter,
// torchbeast_tpu/serving/replica.py ReplicaRouter) so the C++ actor
// pool's compute() path never touches Python to pick a batcher.
//
// The routing hash is the splitmix64 finalizer from
// torchbeast_tpu/runtime/placement.py _mix64 — the STATIC actor->slice
// assignment that keeps each actor's device-resident state-table slot
// on one inference slice for the life of the run. The constants below
// are literal-pinned cross-language by beastlint ROUTE-PARITY
// (analysis/parity.py): a drift on either side would silently re-shard
// every deployed slot table, so the lint gate fails before the drift
// can ship.
//
// Thread-safety: routers are constructed on the driver thread before
// actor loops start and are immutable afterwards except for the atomic
// counters and the replica health flag; every method here is called
// concurrently from N actor threads with no lock.

#pragma once

#include <atomic>
#include <cstdint>
#include <memory>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "array.h"
#include "nest.h"
#include "queues.h"

namespace tbt {

// splitmix64 finalizer constants (runtime/placement.py _mix64; pinned
// by beastlint ROUTE-PARITY — edit BOTH sides and the lint spec
// together or deployed slot tables re-shard).
constexpr uint64_t kSplitMix64Gamma = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kSplitMix64Mul1 = 0xBF58476D1CE4E5B9ULL;
constexpr uint64_t kSplitMix64Mul2 = 0x94D049BB133111EBULL;
constexpr int kSplitMix64Shift1 = 30;
constexpr int kSplitMix64Shift2 = 27;
constexpr int kSplitMix64Shift3 = 31;

// Per-slice telemetry series prefix — the native fold
// (runtime/native.py NativeTelemetryFolder) publishes this router's
// counters as "<prefix><i>.requests", matching the Python
// SliceRouter's registry series exactly (pinned by ROUTE-PARITY).
constexpr const char kSliceSeriesPrefix[] = "inference.slice.";

inline uint64_t splitmix64(uint64_t x) {
  x += kSplitMix64Gamma;
  x = (x ^ (x >> kSplitMix64Shift1)) * kSplitMix64Mul1;
  x = (x ^ (x >> kSplitMix64Shift2)) * kSplitMix64Mul2;
  return x ^ (x >> kSplitMix64Shift3);
}

// slot -> slice, bit-identical to DeviceSplit.slice_for_slot: the
// uint64 cast wraps negative ids exactly like Python's `& (2**64-1)`.
inline int64_t slice_for_slot(int64_t slot, int64_t n_slices) {
  if (n_slices < 1) throw std::invalid_argument("n_slices must be >= 1");
  return static_cast<int64_t>(splitmix64(static_cast<uint64_t>(slot)) %
                              static_cast<uint64_t>(n_slices));
}

namespace detail {
// The slot leaf is a [1, 1] integer array (actor_pool.h slot framing).
inline int64_t read_slot_scalar(const Array& a) {
  switch (a.dtype()) {
    case DType::kI32:
      return *reinterpret_cast<const int32_t*>(a.data());
    case DType::kI64:
      return *reinterpret_cast<const int64_t*>(a.data());
    default:
      throw std::invalid_argument("slot leaf must be integer typed");
  }
}
}  // namespace detail

// Fans actor requests into N per-slice DynamicBatchers by the static
// slot hash; slot-less requests (legacy framing) round-robin so every
// slice still earns traffic. Semantics mirror the Python SliceRouter
// (parallel/sebulba.py) minus its advisory serving_ok() poke — on the
// native path per-slice health rides the replica routers/hooks, not
// the fan-out.
class SliceRouter : public InferenceClient {
 public:
  explicit SliceRouter(std::vector<std::shared_ptr<InferenceClient>> slices)
      : slices_(std::move(slices)), requests_(slices_.size()) {
    if (slices_.empty())
      throw std::invalid_argument("SliceRouter needs >= 1 slice");
  }

  int64_t n_slices() const { return static_cast<int64_t>(slices_.size()); }

  const std::shared_ptr<InferenceClient>& slice(int64_t i) const {
    return slices_.at(static_cast<size_t>(i));
  }

  // Cumulative per-slice routed-request counts (folded by the driver
  // into the "inference.slice.<i>.requests" series).
  std::vector<int64_t> request_counts() const {
    std::vector<int64_t> out;
    out.reserve(requests_.size());
    for (const auto& c : requests_) out.push_back(c.load());
    return out;
  }

  ArrayNest compute(ArrayNest inputs, int64_t timeout_s = 600) override {
    size_t idx = route(inputs);
    // Counted at routing time like the Python router: the series
    // answers "where is traffic going", sheds included.
    requests_[idx].fetch_add(1);
    return slices_[idx]->compute(std::move(inputs), timeout_s);
  }

  int64_t size() const override {
    int64_t total = 0;
    for (const auto& s : slices_) total += s->size();
    return total;
  }

  // One close() closes every slice, so the pool's shutting_down() poll
  // (which only sees this router) observes the whole plane; the Python
  // router's is_closed checks slice 0 for the same reason.
  bool is_closed() const override { return slices_.front()->is_closed(); }

  void close() override {
    for (const auto& s : slices_) {
      try {
        s->close();
      } catch (const std::runtime_error&) {
        // already closed (driver shutdown closes slices individually
        // too) — same swallow as the Python close_all.
      }
    }
  }

 private:
  size_t route(const ArrayNest& inputs) {
    if (inputs.is_dict()) {
      const auto& d = inputs.dict();
      auto it = d.find("slot");
      if (it != d.end() && it->second.is_leaf()) {
        int64_t slot = detail::read_slot_scalar(it->second.leaf());
        return static_cast<size_t>(
            slice_for_slot(slot, static_cast<int64_t>(slices_.size())));
      }
    }
    // Legacy (slot-less) framing: round-robin keeps the slices evenly
    // loaded; the atomic tick makes concurrent producers collision-free.
    return static_cast<size_t>(rr_.fetch_add(1)) % slices_.size();
  }

  const std::vector<std::shared_ptr<InferenceClient>> slices_;
  std::vector<std::atomic<int64_t>> requests_;  // per-slice routed count
  std::atomic<uint64_t> rr_{0};  // slot-less round-robin cursor
};

// Replica-first routing with central fallback — the native twin of
// serving/replica.py ReplicaRouter. The lag/health gate is a plain
// atomic flag flipped from the Python side (the replica serving loop's
// hooks own the PolicySnapshotStore and the health machine; they call
// set_serving() on every begin_batch and monitor tick), so the actor
// threads' routing decision costs one relaxed load instead of a GIL
// round-trip per request.
class ReplicaRouter : public InferenceClient {
 public:
  ReplicaRouter(std::shared_ptr<InferenceClient> central,
                std::shared_ptr<InferenceClient> replica)
      : central_(std::move(central)), replica_(std::move(replica)) {
    if (!central_ || !replica_)
      throw std::invalid_argument("ReplicaRouter needs central and replica");
  }

  void set_serving(bool ok) { serving_ok_.store(ok); }
  bool serving() const { return serving_ok_.load(); }

  int64_t replica_requests() const { return replica_requests_.load(); }
  int64_t central_requests() const { return central_requests_.load(); }

  ArrayNest compute(ArrayNest inputs, int64_t timeout_s = 600) override {
    if (serving_ok_.load() && !replica_->is_closed()) {
      try {
        // `inputs` stays intact for the fallback leg: nest copies are
        // shallow (leaves share buffers), so this costs pointers.
        ArrayNest out = replica_->compute(inputs, timeout_s);
        // Counted on SUCCESS only: a fallen-back request must land in
        // exactly one routing series, or the two sum past the total —
        // the Python router's accounting contract.
        replica_requests_.fetch_add(1);
        return out;
      } catch (const ShedError&) {
        throw;  // sheds keep their actor-side retry contract
      } catch (const ClosedBatchingQueue&) {
        // dying/closing replica path: fall through to central
      } catch (const AsyncError&) {
        // replica-side serving failure: fall through to central
      }
    }
    central_requests_.fetch_add(1);
    return central_->compute(std::move(inputs), timeout_s);
  }

  int64_t size() const override {
    return central_->size() + replica_->size();
  }

  bool is_closed() const override { return central_->is_closed(); }

  void close() override {
    // Central first: the pool's shutting_down() keys off it, so actor
    // threads stop producing before the replica drains.
    for (const auto& c : {central_, replica_}) {
      try {
        c->close();
      } catch (const std::runtime_error&) {
        // already closed by the driver's own closer list
      }
    }
  }

 private:
  const std::shared_ptr<InferenceClient> central_;
  const std::shared_ptr<InferenceClient> replica_;
  std::atomic<bool> serving_ok_{false};  // flipped by the Python hooks
  std::atomic<int64_t> replica_requests_{0};
  std::atomic<int64_t> central_requests_{0};
};

}  // namespace tbt
