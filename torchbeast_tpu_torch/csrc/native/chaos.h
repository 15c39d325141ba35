// FaultHooks: the C++ side of resilience/chaos.py (ISSUE 12). The
// Python ChaosController cannot wrap the native pool's transports (they
// live in C++ actor threads), so the pool owns ONE FaultHooks instance
// the controller reaches through pymodule entry points
// (chaos_sever/chaos_window/chaos_corrupt_ring on the pool object):
//
//   - transport_sever      -> shutdown(SHUT_RDWR) on the actor's live
//                             transport: a parked recv wakes with the
//                             same EOF a real cable cut produces.
//   - transport_delay /    -> a per-actor perturbation window consulted
//     transport_blackhole     by the actor loop before every send/recv
//                             (ChaosTransport wrapper), sleeping the op
//                             exactly like the Python FaultingTransport.
//   - shm_corrupt_*        -> ShmRing::corrupt_tail_frame through the
//                             transport (poke parity with the Python
//                             ShmRing.poke path, tail-stability checked
//                             so "injected" means OBSERVABLE).
//
// Entry points run on the Python chaos thread (GIL released by
// pymodule's call_nogil); registration/perturbation run on actor
// threads. The hooks mutex serializes injector calls against transport
// teardown: an actor unregisters (under mu_) before destroying its
// transport, so an injector holding mu_ can never touch a freed one.
// Pools without --chaos_plan never construct the wrapper: the hot path
// pays nothing when chaos is unarmed.

#pragma once

#include <chrono>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>

#include "client.h"

namespace tbt {

class FaultHooks {
 public:
  // -- actor-thread side ------------------------------------------------
  void register_transport(int64_t index, Transport* t) {
    std::lock_guard<std::mutex> lock(mu_);
    transports_[index] = t;
  }

  void unregister_transport(int64_t index, Transport* t) {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = transports_.find(index);
    if (it != transports_.end() && it->second == t) transports_.erase(it);
  }

  // Called before every send/recv on a wrapped transport. The window
  // state is copied out under the lock and slept OUTSIDE it (a blackhole
  // must stall the actor, not the injector thread).
  void perturb(int64_t index) {
    bool is_delay = false;
    double delay_s = 0.0;
    std::chrono::steady_clock::time_point until{};
    {
      std::lock_guard<std::mutex> lock(mu_);
      auto it = windows_.find(index);
      if (it == windows_.end()) return;
      is_delay = it->second.is_delay;
      delay_s = it->second.delay_s;
      until = it->second.until;
    }
    auto now = std::chrono::steady_clock::now();
    if (now >= until) {
      std::lock_guard<std::mutex> lock(mu_);
      auto it = windows_.find(index);
      if (it != windows_.end() && it->second.until == until)
        windows_.erase(it);
      return;
    }
    if (is_delay) {
      std::this_thread::sleep_for(std::chrono::duration<double>(delay_s));
    } else {  // blackhole: hold the op until the window heals
      std::this_thread::sleep_until(until);
    }
  }

  // -- injector side (Python chaos thread via pymodule) -----------------
  // False = no live transport for that actor right now (between
  // connections): the controller retries on a later tick, so injected
  // counts stay exact.
  bool sever(int64_t index) {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = transports_.find(index);
    if (it == transports_.end()) return false;
    it->second->shutdown_stream();
    return true;
  }

  bool arm_window(int64_t index, bool is_delay, double duration_s,
                  double delay_s) {
    std::lock_guard<std::mutex> lock(mu_);
    if (transports_.find(index) == transports_.end()) return false;
    windows_[index] = Window{
        is_delay,
        std::chrono::steady_clock::now() +
            std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                std::chrono::duration<double>(duration_s)),
        delay_s};
    return true;
  }

  // True when the stomp observably landed in an unconsumed frame
  // (ShmRing::corrupt_tail_frame's tail-stability check); False when
  // the actor has no shm transport or the ring is momentarily empty —
  // the controller retries next tick, same contract as _corrupt_ring.
  bool corrupt_recv_ring(int64_t index, bool header) {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = transports_.find(index);
    if (it == transports_.end()) return false;
    return it->second->corrupt_recv_ring(header) == 1;
  }

 private:
  struct Window {
    bool is_delay;  // false = blackhole
    std::chrono::steady_clock::time_point until;
    double delay_s;
  };

  std::mutex mu_;
  std::map<int64_t, Transport*> transports_;  // guarded-by: mu_
  std::map<int64_t, Window> windows_;         // guarded-by: mu_
};

// Per-op fault interposition for one actor loop: forwards everything to
// the wrapped transport, consulting the hooks' perturbation window first
// — the C++ twin of chaos.py's FaultingTransport. Registers the INNER
// transport so injectors act on the real stream.
class ChaosTransport : public Transport {
 public:
  ChaosTransport(std::unique_ptr<Transport> inner, int64_t index,
                 FaultHooks* hooks)
      : inner_(std::move(inner)), index_(index), hooks_(hooks) {
    hooks_->register_transport(index_, inner_.get());
  }

  ~ChaosTransport() override {
    // Unregister BEFORE the member destructor frees inner_: an injector
    // holding the hooks mutex must never race transport teardown.
    hooks_->unregister_transport(index_, inner_.get());
  }

  size_t send(const wire::ValueNest& value) override {
    hooks_->perturb(index_);
    return inner_->send(value);
  }

  std::pair<wire::ValueNest, size_t> recv_sized() override {
    hooks_->perturb(index_);
    return inner_->recv_sized();
  }

  void unlink_segments() override { inner_->unlink_segments(); }
  void shutdown_stream() override { inner_->shutdown_stream(); }
  int corrupt_recv_ring(bool header) override {
    return inner_->corrupt_recv_ring(header);
  }
  void close() override { inner_->close(); }

 private:
  std::unique_ptr<Transport> inner_;
  const int64_t index_;
  FaultHooks* const hooks_;
};

}  // namespace tbt
