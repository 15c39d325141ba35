// Decorrelated-jitter exponential backoff — the C++ port of
// torchbeast_tpu/resilience/backoff.py's Backoff, for the native actor
// pool's reconnect loop (ISSUE 12): a dead env-server address must not
// be re-dialed in a tight loop, and a mass server restart must not
// thundering-herd the fresh listener. Same schedule as the Python
// class: next delay = uniform(base_s, min(cap_s, prev * 3)), reset on
// proven recovery.

#pragma once

#include <algorithm>
#include <chrono>
#include <functional>
#include <random>
#include <thread>

namespace tbt {

class Backoff {
 public:
  explicit Backoff(double base_s = 0.1, double cap_s = 2.0,
                   unsigned seed = std::random_device{}())
      : base_s_(base_s), cap_s_(cap_s), rng_(seed) {}

  // The next jittered delay (advances the schedule, no sleeping).
  double next_delay() {
    double hi = std::max(base_s_, std::min(cap_s_, prev_ * 3.0));
    std::uniform_real_distribution<double> dist(base_s_, hi);
    double delay = dist(rng_);
    prev_ = delay;
    return delay;
  }

  // Sleep the next jittered delay in short slices so `abort` (pipeline
  // shutdown) cuts the wait short — the C++ twin of
  // Backoff.sleep(wake=Event). Returns the delay drawn.
  double sleep(const std::function<bool()>& abort = nullptr) {
    double delay = next_delay();
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::duration_cast<
                        std::chrono::steady_clock::duration>(
                        std::chrono::duration<double>(delay));
    while (std::chrono::steady_clock::now() < deadline) {
      if (abort && abort()) break;
      std::this_thread::sleep_for(std::chrono::milliseconds(10));
    }
    return delay;
  }

  // Re-arm after proven recovery: the next delay starts from base_s.
  void reset() { prev_ = 0.0; }

 private:
  const double base_s_;
  const double cap_s_;
  double prev_ = 0.0;
  std::mt19937 rng_;
};

}  // namespace tbt
