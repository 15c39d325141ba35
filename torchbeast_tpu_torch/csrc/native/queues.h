// BatchingQueue + DynamicBatcher: the native learner-queue and inference
// batcher (reference components N3/N4, /root/reference/src/cc/actorpool.cc
// 57-340 — re-designed torch-free over tbt::Array nests; semantics match
// the Python implementations in torchbeast_tpu/runtime/queues.py, which
// carry the test surface).

#pragma once

#include <array>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <deque>
#include <functional>
#include <future>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
#include <stdexcept>
#include <vector>

#include "array.h"
#include "nest.h"

namespace tbt {

using ArrayNest = Nest<Array>;

// ------------------------------------------------------------ telemetry
// Log-bucket histogram accumulator with the SAME bucket geometry as
// torchbeast_tpu/telemetry/metrics.py (LO=1e-9, growth 2^0.25), so the
// Python driver can fold native snapshots straight into registry
// histograms bucket-for-bucket. Mutex-guarded: observations here happen
// at batch cadence (or per request on ms-scale operations), so a ~100ns
// lock is noise — and snapshot(reset=true) hands the driver exact
// interval aggregates without a torn read.
inline int telemetry_bucket_index(double value) {
  constexpr double kLo = 1e-9;
  static const double kLogGrowth = std::log(std::pow(2.0, 0.25));
  if (value <= kLo) return 0;
  return 1 + static_cast<int>(std::log(value / kLo) / kLogGrowth);
}

struct HistSnapshot {
  int64_t count = 0;
  double total = 0.0;
  double total_sq = 0.0;
  double min = 0.0;
  double max = 0.0;
  std::map<int, int64_t> buckets;
};

class HistAccum {
 public:
  void observe(double value) {
    std::lock_guard<std::mutex> lock(mu_);
    ++count_;
    total_ += value;
    total_sq_ += value * value;
    if (count_ == 1 || value < min_) min_ = value;
    if (count_ == 1 || value > max_) max_ = value;
    ++buckets_[telemetry_bucket_index(value)];
  }

  // Interval aggregate; reset=true starts a fresh interval (the
  // driver's monitor-tick fold — the registry owns the cumulative view).
  HistSnapshot snapshot(bool reset = false) {
    std::lock_guard<std::mutex> lock(mu_);
    HistSnapshot out{count_, total_, total_sq_, min_, max_, buckets_};
    if (reset) {
      count_ = 0;
      total_ = total_sq_ = min_ = max_ = 0.0;
      buckets_.clear();
    }
    return out;
  }

 private:
  mutable std::mutex mu_;
  int64_t count_ = 0;
  double total_ = 0.0, total_sq_ = 0.0, min_ = 0.0, max_ = 0.0;
  std::map<int, int64_t> buckets_;
};

// Sampled request->trace cadence, matching the Python pool's
// actor_pool.py _TRACE_EVERY so native and Python runs trace at the
// same density; the span buffer is bounded so an idle driver (nobody
// draining trace_spans) never grows memory.
constexpr int64_t kTraceEvery = 256;
constexpr size_t kTraceSpanCap = 1024;

// Per-request pipeline stamps (ISSUE 2 parity): enqueue -> batch ->
// reply. Shared by the batcher and its in-flight Batches.
struct BatcherTelemetry {
  std::atomic<int64_t> batches{0};
  std::atomic<int64_t> rows{0};
  HistAccum batch_size;
  HistAccum request_wait_s;  // enqueue -> picked into a batch
  HistAccum request_rtt_s;   // enqueue -> outputs distributed
  // Admission-gate accounting (ISSUE 14): same semantics as the Python
  // serving/admission.py series the driver folds these into —
  // admitted (accepted at enqueue), shed (rejected at the depth
  // bound), expired (deadline passed in-queue, failed at dequeue),
  // slo_breaches (served RTT above the SLO target).
  std::atomic<int64_t> admitted{0};
  std::atomic<int64_t> shed{0};
  std::atomic<int64_t> expired{0};
  std::atomic<int64_t> slo_breaches{0};
  // Continuous-batching accounting (ISSUE 16): requests rolled into an
  // already-forming dispatch window by the top-up pass. Pure
  // observability — rolled requests are ordinary admitted requests and
  // take no part in the shed/expired audit.
  std::atomic<int64_t> rolled{0};
  HistAccum queue_delay_s;  // enqueue -> dequeue, served AND expired
  // Sampled per-request spans (ISSUE 12): 1-in-kTraceEvery computes
  // records its (enqueued, batched, replied) steady-clock stamps here;
  // the driver drains them each monitor tick and folds them into
  // tracer StageTraces under the same actor.request.* names the
  // Python pool emits (runtime/native.py NativeTelemetryFolder).
  std::atomic<int64_t> trace_tick{0};
  std::mutex trace_mu;
  std::vector<std::array<double, 3>> trace_spans;  // guarded-by: trace_mu
};

class ClosedBatchingQueue : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};
class QueueStopped : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};
class AsyncError : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};
// The typed shed reply (ISSUE 14; Python twin:
// torchbeast_tpu/runtime/errors.ShedError). Derives from AsyncError so
// a catch site that only knows the base still treats a shed as an
// inference-side condition, but the actor pool catches EXACTLY this
// type and re-submits the same env step after backoff — a shed is flow
// control, never a retired actor or a lost rollout.
class ShedError : public AsyncError {
 public:
  using AsyncError::AsyncError;
};

// Concatenate structurally-equal nests leaf-wise along batch_dim.
inline ArrayNest batch_nests(const std::vector<ArrayNest>& nests,
                             int64_t batch_dim) {
  return Nest<Array>::zip(nests).map(
      [batch_dim](const std::vector<Array>& leaves) {
        return concatenate(leaves, batch_dim);
      });
}

// What the actor pool's request path sees (ISSUE 16): a DynamicBatcher,
// or a routing facade over several (csrc/routing.h SliceRouter /
// ReplicaRouter). The pool only ever computes, polls closure, and
// closes — keeping the seam this narrow is what lets the routers drop
// in without the pool knowing the serving topology.
class InferenceClient {
 public:
  virtual ~InferenceClient() = default;
  virtual ArrayNest compute(ArrayNest inputs, int64_t timeout_s = 600) = 0;
  virtual int64_t size() const = 0;
  virtual bool is_closed() const = 0;
  virtual void close() = 0;
};

template <typename Payload>
class BatchingQueue {
 public:
  struct Item {
    ArrayNest inputs;
    Payload payload;
    int64_t rows;
  };

  BatchingQueue(int64_t batch_dim, int64_t min_batch_size,
                int64_t max_batch_size, std::optional<int64_t> timeout_ms,
                std::optional<int64_t> max_queue_size, bool check_inputs)
      : batch_dim_(batch_dim),
        min_(min_batch_size),
        max_(max_batch_size),
        timeout_ms_(timeout_ms),
        max_queue_(max_queue_size),
        check_inputs_(check_inputs) {
    if (min_ < 1) throw std::invalid_argument("Min batch size must be >= 1");
    if (max_ < min_)
      throw std::invalid_argument("Max batch size must be >= min batch size");
    if (max_queue_ && *max_queue_ < 1)
      throw std::invalid_argument("Max queue size must be >= 1");
  }

  int64_t size() const {
    std::unique_lock<std::mutex> lock(mu_);
    return static_cast<int64_t>(deque_.size());
  }

  bool is_closed() const {
    std::unique_lock<std::mutex> lock(mu_);
    return closed_;
  }

  void enqueue(ArrayNest inputs, Payload payload) {
    int64_t rows = 1;
    if (check_inputs_) {
      bool any = false;
      inputs.for_each([&](const Array& a) {
        if (a.ndim() <= batch_dim_)
          throw std::invalid_argument(
              "Enqueued array has too few dims for batch_dim");
        any = true;
      });
      if (!any)
        throw std::invalid_argument("Cannot enqueue empty vector of arrays");
    }
    if (!inputs.empty()) rows = inputs.front().dim(batch_dim_);

    std::unique_lock<std::mutex> lock(mu_);
    if (closed_) throw ClosedBatchingQueue("Enqueue to closed batching queue");
    while (max_queue_ && static_cast<int64_t>(deque_.size()) >= *max_queue_) {
      can_enqueue_.wait(lock);
      if (closed_)
        throw ClosedBatchingQueue("Enqueue to closed batching queue");
    }
    deque_.push_back(Item{std::move(inputs), std::move(payload), rows});
    ++num_enqueued_;
    can_dequeue_.notify_one();
  }

  // Blocks for >= min rows (or any after timeout). Throws QueueStopped when
  // closed and drained.
  std::pair<ArrayNest, std::vector<Payload>> dequeue_many() {
    auto t0 = std::chrono::steady_clock::now();
    std::vector<Item> items;
    {
      std::unique_lock<std::mutex> lock(mu_);
      // The timeout bounds the wait for a FULL minimum batch; an empty
      // queue always blocks untimed for the first item — wait_for in a
      // loop with an expired (e.g. zero) timeout would busy-spin.
      std::optional<std::chrono::steady_clock::time_point> deadline;
      if (timeout_ms_)
        deadline = std::chrono::steady_clock::now() +
                   std::chrono::milliseconds(*timeout_ms_);
      while (true) {
        int64_t rows = 0;
        for (const Item& it : deque_) rows += it.rows;
        if (rows >= min_) break;
        if (closed_) throw QueueStopped("queue closed");
        if (deadline && std::chrono::steady_clock::now() >= *deadline) {
          if (!deque_.empty()) break;
          can_dequeue_.wait(lock);
        } else if (deadline) {
#if defined(__SANITIZE_THREAD__)
          // TSan builds only: a steady_clock wait_until lowers to
          // pthread_cond_clockwait (glibc >= 2.30), which GCC 10's
          // libtsan does not intercept — TSan then never sees the mutex
          // released inside the wait and reports bogus double-locks/
          // races on every subsequent queue op (observed: ~90 reports
          // on the dynamic-batcher suite). Wait against a system-clock
          // deadline there (pthread_cond_timedwait, which TSan models);
          // the steady deadline above stays authoritative, and the
          // wall-clock jump sensitivity this introduces is acceptable
          // in a sanitizer lane.
          can_dequeue_.wait_until(
              lock, std::chrono::system_clock::now() +
                        (*deadline - std::chrono::steady_clock::now()));
#else
          can_dequeue_.wait_until(lock, *deadline);
#endif
        } else {
          can_dequeue_.wait(lock);
        }
      }
      items.push_back(std::move(deque_.front()));
      deque_.pop_front();
      int64_t rows = items.front().rows;
      while (!deque_.empty() && rows + deque_.front().rows <= max_) {
        rows += deque_.front().rows;
        items.push_back(std::move(deque_.front()));
        deque_.pop_front();
      }
      can_enqueue_.notify_all();
    }
    dequeue_wait_s_.observe(
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
            .count());
    std::vector<ArrayNest> inputs;
    std::vector<Payload> payloads;
    inputs.reserve(items.size());
    payloads.reserve(items.size());
    int64_t total_rows = 0;
    for (Item& it : items) {
      total_rows += it.rows;
      inputs.push_back(std::move(it.inputs));
      payloads.push_back(std::move(it.payload));
    }
    batch_size_.observe(static_cast<double>(total_rows));
    return {batch_nests(inputs, batch_dim_), std::move(payloads)};
  }

  // One raw (inputs, rows) item in FIFO order, blocking until an item
  // arrives; QueueStopped once the queue is closed and drained. The
  // BatchArena's intake (runtime/queues.py dequeue_item): assembly
  // happens by write-through column copy straight into the host arena,
  // so this path skips dequeue_many's min-batch wait and batch forming.
  std::pair<ArrayNest, int64_t> dequeue_item() {
    auto t0 = std::chrono::steady_clock::now();
    std::unique_lock<std::mutex> lock(mu_);
    while (deque_.empty()) {
      if (closed_) throw QueueStopped("queue closed");
      can_dequeue_.wait(lock);
    }
    Item item = std::move(deque_.front());
    deque_.pop_front();
    can_enqueue_.notify_all();
    lock.unlock();
    dequeue_wait_s_.observe(
        std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
            .count());
    return {std::move(item.inputs), item.rows};
  }

  // Non-blocking drain of whole items that fit under `max_rows` — the
  // continuous-batching top-up (ISSUE 16): a forming dispatch window
  // rolls in requests that arrived after dequeue_many released the
  // lock. Returns possibly-empty; never waits.
  std::vector<Item> try_dequeue_upto(int64_t max_rows) {
    std::vector<Item> items;
    std::unique_lock<std::mutex> lock(mu_);
    int64_t rows = 0;
    while (!deque_.empty() && rows + deque_.front().rows <= max_rows) {
      rows += deque_.front().rows;
      items.push_back(std::move(deque_.front()));
      deque_.pop_front();
    }
    if (!items.empty()) can_enqueue_.notify_all();
    return items;
  }

  int64_t num_enqueued() const {
    std::unique_lock<std::mutex> lock(mu_);
    return num_enqueued_;
  }

  // Interval telemetry for the Python driver's native fold.
  HistSnapshot dequeue_wait_snapshot(bool reset) {
    return dequeue_wait_s_.snapshot(reset);
  }
  HistSnapshot batch_size_snapshot(bool reset) {
    return batch_size_.snapshot(reset);
  }

  // Returns leftover items; their payloads, so callers can fail promises.
  std::vector<Payload> close() {
    std::unique_lock<std::mutex> lock(mu_);
    if (closed_) throw std::runtime_error("Queue was closed already");
    closed_ = true;
    std::vector<Payload> leftover;
    for (Item& it : deque_) leftover.push_back(std::move(it.payload));
    deque_.clear();
    can_dequeue_.notify_all();
    can_enqueue_.notify_all();
    return leftover;
  }

  int64_t batch_dim() const { return batch_dim_; }
  int64_t max_batch_size() const { return max_; }

 private:
  const int64_t batch_dim_, min_, max_;
  const std::optional<int64_t> timeout_ms_, max_queue_;
  const bool check_inputs_;

  mutable std::mutex mu_;
  std::condition_variable can_dequeue_, can_enqueue_;
  std::deque<Item> deque_;
  bool closed_ = false;
  int64_t num_enqueued_ = 0;
  HistAccum dequeue_wait_s_;
  HistAccum batch_size_;
};

class DynamicBatcher : public InferenceClient {
 public:
  struct Request {
    std::shared_ptr<std::promise<ArrayNest>> promise;
    int64_t rows;
    // Stage stamps (enqueue -> batch -> reply): set at compute(), read
    // when the batch forms and when outputs are distributed.
    std::chrono::steady_clock::time_point enqueued_at;
    // Trace sampling (ISSUE 12): this request records a full span.
    bool traced = false;
    std::chrono::steady_clock::time_point batched_at;
    // Deadline gate (ISSUE 14): absolute expiry; unset when admission
    // control is disarmed.
    std::optional<std::chrono::steady_clock::time_point> deadline;
  };

  class Batch {
   public:
    Batch(int64_t batch_dim, ArrayNest inputs, std::vector<Request> requests,
          std::shared_ptr<BatcherTelemetry> telemetry = nullptr)
        : batch_dim_(batch_dim),
          inputs_(std::move(inputs)),
          requests_(std::move(requests)),
          telemetry_(std::move(telemetry)) {}

    ~Batch() {
      if (!outputs_set_) {
        for (Request& r : requests_) {
          r.promise->set_exception(std::make_exception_ptr(
              AsyncError("Batch died before outputs were set")));
        }
      }
    }

    int64_t size() const {
      int64_t n = 0;
      for (const Request& r : requests_) n += r.rows;
      return n;
    }

    const ArrayNest& inputs() const { return inputs_; }

    void set_slo_target(std::optional<double> target_s) {
      slo_target_s_ = target_s;
    }

    void set_outputs(const ArrayNest& outputs) {
      if (outputs_set_) throw std::runtime_error("set_outputs called twice");
      int64_t expected = size();
      bool any = false;
      outputs.for_each([&](const Array& a) {
        if (a.ndim() <= batch_dim_)
          throw std::invalid_argument("output has too few dims");
        if (a.dim(batch_dim_) != expected)
          throw std::invalid_argument("output batch size mismatch");
        any = true;
      });
      if (!any) throw std::invalid_argument("empty output");
      outputs_set_ = true;
      auto now = std::chrono::steady_clock::now();
      int64_t offset = 0;
      for (Request& r : requests_) {
        int64_t start = offset, count = r.rows;
        ArrayNest mine = outputs.map([&](const Array& a) {
          return slice(a, batch_dim_, start, count);
        });
        if (telemetry_) {
          double rtt =
              std::chrono::duration<double>(now - r.enqueued_at).count();
          telemetry_->request_rtt_s.observe(rtt);
          // SLO breach accounting (ISSUE 14): the C++ pool has no
          // Python-side request path, so served-RTT-over-target is
          // counted here and folded into slo.rtt_breaches.
          if (slo_target_s_ && rtt > *slo_target_s_)
            telemetry_->slo_breaches.fetch_add(1);
          if (r.traced) {
            auto to_s = [](std::chrono::steady_clock::time_point tp) {
              return std::chrono::duration<double>(tp.time_since_epoch())
                  .count();
            };
            std::lock_guard<std::mutex> lock(telemetry_->trace_mu);
            if (telemetry_->trace_spans.size() < kTraceSpanCap)
              telemetry_->trace_spans.push_back(
                  {to_s(r.enqueued_at), to_s(r.batched_at), to_s(now)});
          }
        }
        r.promise->set_value(std::move(mine));
        offset += count;
      }
    }

    void fail(const std::string& message) {
      if (outputs_set_) return;
      outputs_set_ = true;
      for (Request& r : requests_) {
        r.promise->set_exception(
            std::make_exception_ptr(AsyncError(message)));
      }
    }

   private:
    int64_t batch_dim_;
    ArrayNest inputs_;
    std::vector<Request> requests_;
    std::shared_ptr<BatcherTelemetry> telemetry_;
    std::optional<double> slo_target_s_;
    bool outputs_set_ = false;
  };

  // Admission control (ISSUE 14): `shed_max_queue_depth` bounds the
  // queued-request count at enqueue (over it -> ShedError at the
  // caller), `deadline_ms` arms the dequeue-side expiry, and
  // `slo_target_ms` arms served-RTT breach counting. All optional —
  // disarmed, the batcher behaves exactly as before.
  //
  // `continuous` (ISSUE 16) switches the overload posture from
  // depth-gating to continuous batching: the caller passes the FALLBACK
  // hard bound as shed_max_queue_depth (a multiple of the old
  // depth-factor gate — polybeast keeps --admission_depth_factor as
  // that bound) and get_batch() rolls requests that arrive while a
  // dispatch window is forming into that window (try_dequeue_upto)
  // instead of leaving them for the next batch. Latency stays guarded
  // by the dequeue-side deadline expiry, which runs AFTER the top-up
  // merge so rolled requests face exactly the same gate — the
  // resubmitted == shed + expired audit is unchanged.
  DynamicBatcher(int64_t batch_dim, int64_t min_batch_size,
                 int64_t max_batch_size, std::optional<int64_t> timeout_ms,
                 std::optional<int64_t> shed_max_queue_depth = std::nullopt,
                 std::optional<double> deadline_ms = std::nullopt,
                 std::optional<double> slo_target_ms = std::nullopt,
                 bool continuous = false)
      : batch_dim_(batch_dim),
        queue_(batch_dim, min_batch_size, max_batch_size, timeout_ms,
               std::nullopt, /*check_inputs=*/true),
        telemetry_(std::make_shared<BatcherTelemetry>()),
        shed_max_queue_depth_(shed_max_queue_depth),
        deadline_ms_(deadline_ms),
        slo_target_ms_(slo_target_ms),
        continuous_(continuous) {
    if (shed_max_queue_depth_ && *shed_max_queue_depth_ < 1)
      throw std::invalid_argument("shed_max_queue_depth must be >= 1");
  }

  int64_t size() const override { return queue_.size(); }
  bool is_closed() const override { return queue_.is_closed(); }

  // Interval snapshot for the Python driver's native-telemetry fold.
  std::shared_ptr<BatcherTelemetry> telemetry() { return telemetry_; }

  ArrayNest compute(ArrayNest inputs,
                    int64_t timeout_s = 600 /* reference: 10 min */) override {
    int64_t rows = inputs.front().dim(batch_dim_);
    if (rows > queue_.max_batch_size())
      throw std::invalid_argument("compute() exceeds maximum_batch_size");
    // Enqueue-side admission gate (ISSUE 14): shed while the queue is
    // at the depth bound — the caller's retry path re-submits after
    // backoff. Racy-by-design against concurrent producers (the bound
    // is flow control, not an invariant); counted BEFORE the throw so
    // shed accounting is exact.
    if (shed_max_queue_depth_ && queue_.size() >= *shed_max_queue_depth_) {
      telemetry_->shed.fetch_add(1);
      throw ShedError(
          "admission gate: inference queue at its depth bound; "
          "re-submit after backoff");
    }
    // admitted counts only under an armed gate, mirroring the Python
    // AdmissionController (disarmed runs report no serving.* series).
    if (shed_max_queue_depth_ || deadline_ms_)
      telemetry_->admitted.fetch_add(1);
    Request req{std::make_shared<std::promise<ArrayNest>>(), rows,
                std::chrono::steady_clock::now()};
    if (deadline_ms_)
      req.deadline = req.enqueued_at +
                     std::chrono::microseconds(
                         static_cast<int64_t>(*deadline_ms_ * 1000.0));
    // Sampled tracing (1-in-kTraceEvery, like the Python pool): N
    // racing actors may interleave ticks, which only shifts WHICH
    // request gets traced.
    req.traced =
        (telemetry_->trace_tick.fetch_add(1) + 1) % kTraceEvery == 0;
    auto future = req.promise->get_future();
    queue_.enqueue(std::move(inputs), std::move(req));
    if (future.wait_for(std::chrono::seconds(timeout_s)) ==
        std::future_status::timeout) {
      throw std::runtime_error("Compute response not ready after timeout");
    }
    return future.get();
  }

  // Blocks; throws QueueStopped when closed.
  std::unique_ptr<Batch> get_batch() {
    while (true) {
      auto [inputs, requests] = queue_.dequeue_many();
      // Continuous batching (ISSUE 16): roll requests that landed
      // between dequeue_many's drain and now into THIS dispatch window
      // (up to max batch size) instead of parking them for the next
      // one. The merge happens BEFORE the deadline pass below, so a
      // rolled request meets the exact same expiry gate as any other.
      if (continuous_) {
        int64_t have = 0;
        for (const Request& r : requests) have += r.rows;
        int64_t room = queue_.max_batch_size() - have;
        if (room > 0) {
          auto extra = queue_.try_dequeue_upto(room);
          if (!extra.empty()) {
            std::vector<ArrayNest> pieces;
            pieces.reserve(extra.size() + 1);
            pieces.push_back(std::move(inputs));
            for (auto& it : extra) {
              pieces.push_back(std::move(it.inputs));
              requests.push_back(std::move(it.payload));
            }
            inputs = batch_nests(pieces, batch_dim_);
            telemetry_->rolled.fetch_add(
                static_cast<int64_t>(extra.size()));
          }
        }
      }
      auto now = std::chrono::steady_clock::now();
      if (deadline_ms_) {
        // Dequeue-side deadline gate (ISSUE 14): fail requests that
        // sat in the queue past their deadline with the typed
        // ShedError and cut their rows out of the batch (the queue
        // concatenated them already — re-slice the survivors). A
        // fully-expired batch loops back for the next one. First pass
        // marks expired requests (promise reset() after the exception
        // = the expiry mark); the rebuild pass only runs — and only
        // moves survivors out — when something actually expired.
        int64_t n_expired = 0;
        for (Request& r : requests) {
          telemetry_->queue_delay_s.observe(
              std::chrono::duration<double>(now - r.enqueued_at).count());
          if (r.deadline && now > *r.deadline) {
            ++n_expired;
            if (r.traced) {
              // A sampled request shed here must still land in the
              // trace export (the Python twin stamps "shed" and
              // finishes): record (enqueued, shed, shed) — the batch
              // stage shows the queue wait that killed it, the reply
              // stage is zero-length. Dropping it would blind trace
              // analysis to exactly the overload traffic the gate
              // exists to observe.
              auto to_s = [](std::chrono::steady_clock::time_point tp) {
                return std::chrono::duration<double>(tp.time_since_epoch())
                    .count();
              };
              std::lock_guard<std::mutex> lock(telemetry_->trace_mu);
              if (telemetry_->trace_spans.size() < kTraceSpanCap)
                telemetry_->trace_spans.push_back(
                    {to_s(r.enqueued_at), to_s(now), to_s(now)});
            }
            r.promise->set_exception(std::make_exception_ptr(ShedError(
                "deadline expired in queue: the reply would land past "
                "the request's deadline budget; re-submit after "
                "backoff")));
            r.promise.reset();
          }
        }
        if (n_expired > 0) {
          telemetry_->expired.fetch_add(n_expired);
          std::vector<Request> live;
          std::vector<std::pair<int64_t, int64_t>> live_spans;  // start,count
          int64_t offset = 0;
          for (Request& r : requests) {
            int64_t start = offset;
            offset += r.rows;
            if (!r.promise) continue;  // expired above
            live_spans.emplace_back(start, r.rows);
            live.push_back(std::move(r));
          }
          if (live.empty()) continue;
          inputs = inputs.map([&](const Array& a) {
            std::vector<Array> pieces;
            pieces.reserve(live_spans.size());
            for (const auto& [start, count] : live_spans)
              pieces.push_back(slice(a, batch_dim_, start, count));
            return concatenate(pieces, batch_dim_);
          });
          requests = std::move(live);
        }
      }
      // (Disarmed, queue delay == request_wait_s below; the serving.*
      // delay series only exists under an armed gate, like Python.)
      int64_t rows = 0;
      for (Request& r : requests) {
        rows += r.rows;
        r.batched_at = now;
        telemetry_->request_wait_s.observe(
            std::chrono::duration<double>(now - r.enqueued_at).count());
      }
      telemetry_->batches.fetch_add(1);
      telemetry_->rows.fetch_add(rows);
      telemetry_->batch_size.observe(static_cast<double>(rows));
      auto batch = std::make_unique<Batch>(batch_dim_, std::move(inputs),
                                           std::move(requests), telemetry_);
      if (slo_target_ms_) batch->set_slo_target(*slo_target_ms_ / 1000.0);
      return batch;
    }
  }

  void close() override {
    std::vector<Request> pending = queue_.close();
    for (Request& r : pending) {
      r.promise->set_exception(std::make_exception_ptr(
          AsyncError("Batcher closed with pending requests")));
    }
  }

 private:
  int64_t batch_dim_;
  BatchingQueue<Request> queue_;
  std::shared_ptr<BatcherTelemetry> telemetry_;
  const std::optional<int64_t> shed_max_queue_depth_;
  const std::optional<double> deadline_ms_;
  const std::optional<double> slo_target_ms_;
  const bool continuous_;
};

}  // namespace tbt
