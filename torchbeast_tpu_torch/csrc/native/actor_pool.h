// ActorPool: pure-C++ actor loops — the reference's hottest native
// component (N5, /root/reference/src/cc/actorpool.cc:342-564), re-designed
// for the framed transports (tcp/unix sockets and shm rings, client.h /
// shm.h).
//
// Each loop: connect to an env server, read the initial Step, then repeat
// {inference via DynamicBatcher::compute -> send Action -> recv Step},
// assembling unroll_length+1-step rollouts with the on-policy invariants
// (overlap-by-one, agent-output pairing, agent-state carry; see
// torchbeast_tpu/rollout.py for the invariant spec shared with the Python
// implementation). No Python in the loop: the GIL is only touched by the
// inference/learner threads that drain the queues from the Python side —
// plus, in slot mode, the once-per-unroll slot hooks (pymodule.cc), which
// drive the SAME device-resident state table the Python pool uses.
//
// Two framings (runtime/actor_pool.py wire contract):
// - legacy: requests carry {"env", "agent_state"}; replies carry
//   {"outputs", "agent_state"} and the boundary state rides every reply.
// - slot (use_slots): requests carry {"env", "slot", "advance"} ([1,1]
//   leaves, batchable like any other); replies carry {"outputs"} only.
//   Recurrent state lives in the Python DeviceStateTable; the hooks
//   reset a slot at (re)connect and read it once per unroll boundary.

#pragma once

#include <atomic>
#include <chrono>
#include <cstring>
#include <exception>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "backoff.h"
#include "chaos.h"
#include "client.h"
#include "queues.h"
#include "shm.h"
#include "wire.h"

namespace tbt {

// A slot-hook failure that is the DeviceStateTable's poison window, not
// an actor bug (runtime/errors.StateTablePoisonedError crossing the GIL
// boundary, pymodule.cc throw_py_error_typed). Derives from AsyncError
// so ONE catch handler covers both inference-side failure classes —
// the same shape as the Python pool's single
// `except (AsyncError, StateTablePoisonedError)` clause: both ride the
// budgeted retry path instead of retiring the actor while the
// supervisor rebuilds the table concurrently (ISSUE 6 contract).
class StateTableError : public AsyncError {
 public:
  using AsyncError::AsyncError;
};

inline const std::vector<std::string>& env_keys() {
  static const std::vector<std::string> keys = {
      "frame",        "reward",       "done",
      "episode_step", "episode_return", "last_action"};
  return keys;
}

class ActorPool {
 public:
  using LearnerQueue = BatchingQueue<int>;  // payload unused
  // Slot hooks (slot mode only; pymodule.cc binds them to the Python
  // DeviceStateTable under the GIL): reset(slot) -> initial state host
  // copy, read(slot) -> the slot's current state host copy.
  using SlotHook = std::function<ArrayNest(int64_t)>;

  struct Telemetry {
    int64_t env_steps = 0;
    int64_t connects = 0;
    int64_t reconnects = 0;
    int64_t batch_retries = 0;
    // Sheds absorbed by the in-place retry (ISSUE 14): one per
    // ShedError received, so the Python fold's serving.resubmitted ==
    // serving.shed + serving.expired audit is exact on this runtime
    // too.
    int64_t shed_resubmits = 0;
    int64_t bytes_up = 0;    // env server -> this process
    int64_t bytes_down = 0;  // actions back out
    // shm doorbell-wait counters (process-wide, csrc/shm.h
    // ring_wait_counters — cumulative like the fields above).
    int64_t ring_doorbell_waits = 0;
    int64_t ring_recheck_wakeups = 0;
  };

  // `inference_batcher` is any InferenceClient: a plain DynamicBatcher
  // (central serving) or a routing facade (csrc/routing.h SliceRouter /
  // ReplicaRouter — ISSUE 16); the pool is topology-blind either way.
  // `record_policy_lag` normalizes replies missing a policy_lag leaf to
  // zeros — the Python pool's _normalize_lag contract, needed when the
  // serving plane mixes replica replies (stamped) with central ones
  // (unstamped) so rollout nests stay structurally uniform.
  ActorPool(int64_t unroll_length, std::shared_ptr<LearnerQueue> learner_queue,
            std::shared_ptr<InferenceClient> inference_batcher,
            std::vector<std::string> addresses, ArrayNest initial_agent_state,
            double connect_timeout_s = 600, int64_t max_reconnects = 0,
            bool use_slots = false, SlotHook slot_reset = nullptr,
            SlotHook slot_read = nullptr,
            size_t max_frame_bytes = wire::kMaxFrameBytes,
            bool enable_fault_hooks = false, bool record_policy_lag = false)
      : unroll_length_(unroll_length),
        learner_queue_(std::move(learner_queue)),
        inference_batcher_(std::move(inference_batcher)),
        addresses_(std::move(addresses)),
        initial_agent_state_(std::move(initial_agent_state)),
        connect_timeout_s_(connect_timeout_s),
        max_reconnects_(max_reconnects),
        use_slots_(use_slots),
        slot_reset_(std::move(slot_reset)),
        slot_read_(std::move(slot_read)),
        max_frame_bytes_(max_frame_bytes),
        record_policy_lag_(record_policy_lag) {
    if (use_slots_ && (!slot_reset_ || !slot_read_))
      throw std::invalid_argument(
          "slot framing needs slot_reset and slot_read hooks");
    // Chaos interposition (csrc/chaos.h): constructed only when armed —
    // unarmed pools never wrap a transport, so the hot path pays zero.
    if (enable_fault_hooks) fault_hooks_ = std::make_unique<FaultHooks>();
  }

  int64_t count() const { return count_.load(); }
  // COMPLETED recoveries (the stream re-established AND delivering
  // again), not granted retry attempts — the Python pool's contract,
  // which is what lets chaos_run assert reconnects == injected faults
  // exactly on both runtimes (ISSUE 12 satellite).
  int64_t reconnect_count() const { return reconnect_count_.load(); }

  // Actor loops still running; the driver's health machine runs
  // DEGRADED while this stays >= --min_live_actors and halts (clean
  // checkpoint-and-exit) below it — same contract as the Python pool.
  int64_t live_actors() const {
    return static_cast<int64_t>(addresses_.size()) - dead_.load();
  }

  std::vector<std::string> error_messages() const {
    std::lock_guard<std::mutex> lock(error_mu_);
    return error_messages_;
  }

  // The chaos entry points' target (null when not armed).
  FaultHooks* fault_hooks() { return fault_hooks_.get(); }

  Telemetry telemetry() const {
    Telemetry t;
    t.env_steps = count_.load();
    t.connects = connects_.load();
    t.reconnects = reconnect_count_.load();
    t.batch_retries = batch_retries_.load();
    t.shed_resubmits = shed_resubmits_.load();
    t.bytes_up = bytes_up_.load();
    t.bytes_down = bytes_down_.load();
    t.ring_doorbell_waits =
        shm::ring_wait_counters().doorbell_waits.load();
    t.ring_recheck_wakeups =
        shm::ring_wait_counters().recheck_wakeups.load();
    return t;
  }

  // Blocks until every loop exits; rethrows the first error.
  void run() {
    std::vector<std::thread> threads;
    threads.reserve(addresses_.size());
    for (size_t i = 0; i < addresses_.size(); ++i) {
      const std::string& address = addresses_[i];
      int64_t index = static_cast<int64_t>(i);
      threads.emplace_back(
          [this, index, address] { guarded_loop(index, address); });
    }
    for (auto& t : threads) t.join();
    std::lock_guard<std::mutex> lock(error_mu_);
    if (first_error_) std::rethrow_exception(first_error_);
  }

  std::string first_error_message() const {
    std::lock_guard<std::mutex> lock(error_mu_);
    if (!first_error_) return "";
    try {
      std::rethrow_exception(first_error_);
    } catch (const std::exception& e) {
      return e.what();
    } catch (...) {
      return "unknown error";
    }
  }

 private:
  // Record inside a catch block (std::current_exception must be live).
  void record_error(const std::string& message) {
    std::lock_guard<std::mutex> lock(error_mu_);
    error_messages_.push_back(message);
    if (!first_error_) first_error_ = std::current_exception();
  }

  bool shutting_down() const {
    return inference_batcher_->is_closed() || learner_queue_->is_closed();
  }

  void guarded_loop(int64_t index, const std::string& address) {
    // ANY exit — clean shutdown or a burned budget — retires this
    // actor; live_actors() feeds the driver's health machine (the
    // Python pool's _guarded_loop finally-block contract).
    struct Retire {
      ActorPool* pool;
      ~Retire() { pool->dead_.fetch_add(1); }
    } retire{this};
    // One budget for BOTH failure classes (transport failures and
    // failed inference batches), refilled by a full recovered unroll —
    // mirroring the Python pool's _recovering_loop. Retries ride the
    // decorrelated-jitter Backoff (csrc/backoff.h) so a dead address
    // is never re-dialed in a tight loop and a mass server restart
    // never thundering-herds the fresh listener.
    int64_t failures = 0;
    int64_t progress = 0;  // this actor's env steps across reconnects
    bool reconnect_pending = false;
    Backoff backoff(0.1, 2.0);
    auto abort_sleep = [this] { return shutting_down(); };
    while (true) {
      int64_t steps_at_connect = progress;
      // Grant a budgeted retry (false during shutdown or once the
      // budget is burned). Sleeps the jittered backoff before the
      // caller retries the stream; a shutdown landing MID-SLEEP also
      // denies the grant — the retry would otherwise re-dial a reaped
      // env server for up to connect_timeout_s.
      auto grant_retry = [&]() -> bool {
        if (shutting_down()) return false;
        if (progress - steps_at_connect >= unroll_length_) {
          failures = 0;
          backoff.reset();
        }
        if (failures >= max_reconnects_) return false;
        ++failures;
        backoff.sleep(abort_sleep);
        return !shutting_down();
      };
      try {
        loop(index, address, &progress, &reconnect_pending);
        return;
      } catch (const ClosedBatchingQueue&) {
        return;  // clean shutdown
      } catch (const QueueStopped&) {
        return;  // clean shutdown
      } catch (const AsyncError& e) {
        // A broken inference promise mid-training — or, via the
        // StateTableError subclass, a DIRECT slot-hook call
        // (connect-time reset, unroll-boundary read) landing inside
        // the poison-to-rebuild window. Either may come from a
        // RECOVERING serving thread (state-table rebuild) — discard
        // the partial rollout and retry the stream under the same
        // budget/backoff as a reconnect (the PR 6 Python contract),
        // instead of retiring the actor for good.
        if (grant_retry()) {
          batch_retries_.fetch_add(1);
          continue;
        }
        // Re-checked AFTER the failed grant: shutdown landing during
        // the backoff sleep must exit cleanly, not record an error.
        if (shutting_down()) return;
        record_error(e.what());
        return;
      } catch (const SocketError& e) {
        // Transport failure (env-server death / stream cut): reconnect
        // with a fresh env + reset agent state. The reconnect is
        // COUNTED only once the new stream delivers (loop() clears
        // reconnect_pending after the initial step) — attempts that
        // fail before streaming are budget, not recoveries.
        if (grant_retry()) {
          reconnect_pending = true;
          continue;
        }
        if (shutting_down()) return;
        record_error(e.what());
        return;
      } catch (const wire::WireError& e) {
        // A corrupt frame (bit-flipped tcp stream, stomped shm ring) is
        // a per-connection failure, not a pool failure — same
        // reconnect contract as the Python pool.
        if (grant_retry()) {
          reconnect_pending = true;
          continue;
        }
        if (shutting_down()) return;
        record_error(e.what());
        return;
      } catch (const std::exception& e) {
        record_error(e.what());
        return;
      } catch (...) {
        record_error("unknown error");
        return;
      }
    }
  }

  // Step message -> env-output nest with [T=1, B=1] leading dims.
  static ArrayNest env_outputs_from(const wire::ValueNest& msg) {
    if (!msg.is_dict()) throw SocketError("expected dict Step message");
    const auto& dict = msg.dict();
    auto type_it = dict.find("type");
    if (type_it != dict.end() && type_it->second.is_leaf() &&
        type_it->second.leaf().kind == wire::Value::Kind::kString &&
        type_it->second.leaf().s == "error") {
      auto m = dict.find("message");
      throw std::runtime_error(
          "Env server error: " +
          (m != dict.end() && m->second.is_leaf() ? m->second.leaf().s : ""));
    }
    ArrayNest::Dict out;
    for (const std::string& key : env_keys()) {
      auto it = dict.find(key);
      if (it == dict.end() || !it->second.is_leaf() ||
          it->second.leaf().kind != wire::Value::Kind::kArray)
        throw SocketError("Step message missing array field: " + key);
      const Array& a = it->second.leaf().array;
      std::vector<int64_t> shape = {1, 1};
      shape.insert(shape.end(), a.shape().begin(), a.shape().end());
      // Clone: the wire buffer is reused per message (RecvBuffer / shm
      // ring slot); rollout storage must own its bytes.
      Array expanded(a.dtype(), shape);
      std::memcpy(expanded.mutable_data(), a.data(), a.nbytes());
      out.emplace(key, ArrayNest(std::move(expanded)));
    }
    return ArrayNest(std::move(out));
  }

  struct StepPair {
    ArrayNest env;
    ArrayNest agent;
  };

  template <typename T>
  static Array scalar_array(DType dtype, T value) {
    Array a(dtype, {1, 1});
    std::memcpy(a.mutable_data(), &value, sizeof(T));
    return a;
  }

  ArrayNest recv_step(Transport* t) {
    auto [msg, nbytes] = t->recv_sized();
    bytes_up_.fetch_add(static_cast<int64_t>(nbytes));
    return env_outputs_from(msg);
  }

  void loop(int64_t index, const std::string& address, int64_t* progress,
            bool* reconnect_pending) {
    std::unique_ptr<Transport> sock =
        shm::connect_transport(address, connect_timeout_s_, max_frame_bytes_);
    if (fault_hooks_) {
      // Chaos interposition: every (re)connection gets wrapped, so
      // injected faults see post-reconnect streams too (the Python
      // pool's transport_wrap contract).
      sock = std::make_unique<ChaosTransport>(std::move(sock), index,
                                              fault_hooks_.get());
    }
    connects_.fetch_add(1);
    // shm connections: sweep the ring segments on EVERY teardown — a
    // SIGKILL'd env server can't clean up its own, and for a live
    // server this only pre-empts its own unlink (segments are
    // per-connection, never re-attached).
    struct Sweep {
      Transport* t;
      ~Sweep() { t->unlink_segments(); }
    } sweep{sock.get()};

    // Fresh stream => fresh recurrent state. In slot mode this resets
    // the actor's table slot (covers reconnects: the partial rollout
    // was discarded, so the slot must restart from the initial state)
    // and fetches the host copy for the rollout boundary.
    ArrayNest initial_agent_state =
        use_slots_ ? slot_reset_(index) : initial_agent_state_;

    ArrayNest env_outputs = recv_step(sock.get());
    // The stream is re-established AND delivering: a granted reconnect
    // retry counts as a completed recovery now — not at grant time, so
    // attempts that die before streaming (a stale socket file, a
    // mid-respawn handshake) never inflate the count past the faults.
    if (*reconnect_pending) {
      *reconnect_pending = false;
      reconnect_count_.fetch_add(1);
    }
    ArrayNest agent_state = initial_agent_state;

    // Shed contract (ISSUE 14): a ShedError from compute() is FLOW
    // CONTROL — re-submit the SAME request after a jittered backoff,
    // outside the reconnect budget, so a shed can never retire this
    // actor or lose the rollout. The backoff starts smaller than the
    // reconnect one (overload drains in batches, not server-restart
    // time) and resets after every served request. Counted at catch
    // time, making the resubmitted == shed + expired audit exact.
    Backoff shed_backoff(0.05, 1.0);
    auto abort_shed = [this] { return shutting_down(); };
    auto shed_compute = [&](ArrayNest inputs) {
      while (true) {
        try {
          ArrayNest result = inference_batcher_->compute(inputs);
          shed_backoff.reset();
          return result;
        } catch (const ShedError&) {
          shed_resubmits_.fetch_add(1);
          if (shutting_down())
            throw QueueStopped("shutdown during shed retry");
          shed_backoff.sleep(abort_shed);
        }
      }
    };

    auto compute = [this, index, &shed_compute](
                       const ArrayNest& env, ArrayNest* state,
                       bool advance) {
      ArrayNest::Dict inputs;
      inputs.emplace("env", env);
      if (use_slots_) {
        inputs.emplace("slot", ArrayNest(scalar_array<int32_t>(
                                   DType::kI32, static_cast<int32_t>(index))));
        inputs.emplace("advance", ArrayNest(scalar_array<uint8_t>(
                                      DType::kBool, advance ? 1 : 0)));
        ArrayNest result = shed_compute(ArrayNest(inputs));
        return normalize_lag(result.dict().at("outputs"));
      }
      inputs.emplace("agent_state", *state);
      ArrayNest result = shed_compute(ArrayNest(inputs));
      const auto& d = result.dict();
      if (advance) *state = d.at("agent_state");
      return normalize_lag(d.at("outputs"));
    };

    // Prime the boundary agent output (state advance discarded — the
    // first in-rollout compute re-consumes this env output for real).
    ArrayNest agent_outputs = compute(env_outputs, &agent_state,
                                      /*advance=*/false);

    std::vector<StepPair> rollout;
    rollout.push_back({env_outputs, agent_outputs});
    ArrayNest rollout_initial_state = initial_agent_state;

    while (true) {
      agent_outputs = compute(env_outputs, &agent_state, /*advance=*/true);

      // Extract the scalar action from outputs["action"] ([1,1]).
      const Array& action_arr =
          agent_outputs.dict().at("action").front();
      int64_t action = read_scalar_i64(action_arr);

      wire::ValueNest::Dict action_msg;
      action_msg.emplace("type",
                         wire::ValueNest(wire::Value::of_string("action")));
      action_msg.emplace("action",
                         wire::ValueNest(wire::Value::of_int(action)));
      bytes_down_.fetch_add(
          static_cast<int64_t>(sock->send(wire::ValueNest(std::move(action_msg)))));

      env_outputs = recv_step(sock.get());
      ++(*progress);
      count_.fetch_add(1);
      rollout.push_back({env_outputs, agent_outputs});

      if (static_cast<int64_t>(rollout.size()) == unroll_length_ + 1) {
        enqueue_rollout(rollout, rollout_initial_state);
        rollout.erase(rollout.begin(), rollout.end() - 1);  // overlap-by-one
        // Boundary state for the NEXT rollout: slot mode fetches it
        // from the device table once per unroll (the only time agent
        // state crosses the host boundary); legacy mode carries it
        // from the last reply.
        rollout_initial_state = use_slots_ ? slot_read_(index) : agent_state;
      }
    }
  }

  // The Python pool's _normalize_lag (runtime/actor_pool.py): central
  // replies carry no policy_lag leaf (their params rebind every update
  // — lag is definitionally 0); replica replies stamp the real lag.
  // Rollout stacking needs one structure, so the missing leaf becomes
  // explicit zeros. Off (the default) this is a single branch.
  ArrayNest normalize_lag(ArrayNest outputs) const {
    if (!record_policy_lag_ || !outputs.is_dict()) return outputs;
    ArrayNest::Dict d = outputs.dict();
    if (d.find("policy_lag") != d.end()) return outputs;
    d.emplace("policy_lag",
              ArrayNest(scalar_array<int32_t>(DType::kI32, 0)));
    return ArrayNest(std::move(d));
  }

  static int64_t read_scalar_i64(const Array& a) {
    switch (a.dtype()) {
      case DType::kI32:
        return *reinterpret_cast<const int32_t*>(a.data());
      case DType::kI64:
        return *reinterpret_cast<const int64_t*>(a.data());
      case DType::kU8:
        return *a.data();
      default:
        throw std::invalid_argument("action must be integer typed");
    }
  }

  void enqueue_rollout(const std::vector<StepPair>& rollout,
                       const ArrayNest& initial_state) {
    std::vector<ArrayNest> envs, agents;
    envs.reserve(rollout.size());
    agents.reserve(rollout.size());
    for (const StepPair& p : rollout) {
      envs.push_back(p.env);
      agents.push_back(p.agent);
    }
    // Stack along time dim 0 -> [T+1, 1, ...].
    ArrayNest env_stack = batch_nests(envs, 0);
    ArrayNest agent_stack = batch_nests(agents, 0);

    ArrayNest::Dict batch = env_stack.dict();
    for (const auto& [k, v] : agent_stack.dict()) batch.emplace(k, v);

    ArrayNest::Dict item;
    item.emplace("batch", ArrayNest(std::move(batch)));
    item.emplace("initial_agent_state", initial_state);
    learner_queue_->enqueue(ArrayNest(std::move(item)), 0);
  }

  const int64_t unroll_length_;
  std::shared_ptr<LearnerQueue> learner_queue_;
  std::shared_ptr<InferenceClient> inference_batcher_;
  const std::vector<std::string> addresses_;
  const ArrayNest initial_agent_state_;
  const double connect_timeout_s_;
  const int64_t max_reconnects_;
  const bool use_slots_;
  const SlotHook slot_reset_;
  const SlotHook slot_read_;
  const size_t max_frame_bytes_;
  const bool record_policy_lag_;

  std::atomic<int64_t> count_{0};
  std::atomic<int64_t> reconnect_count_{0};
  std::atomic<int64_t> batch_retries_{0};
  std::atomic<int64_t> shed_resubmits_{0};
  std::atomic<int64_t> connects_{0};
  std::atomic<int64_t> dead_{0};  // retired actor loops (live_actors())
  std::atomic<int64_t> bytes_up_{0};
  std::atomic<int64_t> bytes_down_{0};
  std::unique_ptr<FaultHooks> fault_hooks_;  // non-null only when armed
  mutable std::mutex error_mu_;
  std::exception_ptr first_error_;  // guarded-by: error_mu_
  std::vector<std::string> error_messages_;  // guarded-by: error_mu_
};

}  // namespace tbt
