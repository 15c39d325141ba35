// Shared-memory SPSC ring transport — the C++ side of runtime/transport.py's
// shm data plane. Byte-level layout parity with the Python ShmRing is a
// hard contract (beastlint WIRE-PARITY pins it): a Python env server and a
// C++ actor loop attach the SAME segments, so every constant below must
// match transport.py exactly.
//
// Ring layout (u64 little-endian words at the segment head):
//   [0:8)  head      (monotonic byte counter, producer-owned)
//   [8:16) tail      (monotonic byte counter, consumer-owned)
//   [16:24) capacity
//   [24:32) waiting  (consumer's blocked flag, the coalesced-doorbell latch)
//   data at [kRingHeaderBytes, kRingHeaderBytes + capacity)
//
// Frames are contiguous [u32 length][bytes]; a u32 wrap marker (or < 4
// bytes of tail room) skips the remainder at the segment end; an inline
// marker reserves a message's ORDER SLOT while its bytes ride the doorbell
// socket (too big for the ring). Only frames <= capacity/2 - 4 ever enter
// the ring (bigger ones can be position-dependently unplaceable forever).
//
// The doorbell socket is the blocking primitive and the crash detector:
// the sender rings the 1-byte bell only when the reader's waiting flag is
// set (futex-style coalescing); peer death closes the socket, which
// surfaces as SocketError — the same teardown contract as tcp.

#pragma once

#include <fcntl.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstring>
#include <functional>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include "client.h"
#include "wire.h"

namespace tbt {
namespace shm {

// --- Layout constants (WIRE-PARITY pins these against transport.py) ---
constexpr size_t kRingHeaderBytes = 64;
// u64-word indices into the header (transport.py _HEAD/_TAIL/_CAP/_WAITING).
constexpr size_t kRingHeadWord = 0;
constexpr size_t kRingTailWord = 1;
constexpr size_t kRingCapacityWord = 2;
constexpr size_t kRingWaitingWord = 3;
// In-ring u32 markers (transport.py _WRAP/_INLINE).
constexpr uint32_t kRingWrapMarker = 0xFFFFFFFF;
constexpr uint32_t kRingInlineMarker = 0xFFFFFFFE;
// Doorbell control bytes (transport.py _DOORBELL_WAKE/_DOORBELL_INLINE).
constexpr uint8_t kDoorbellWake = 0x01;
constexpr uint8_t kDoorbellInline = 0x02;
// Default per-direction capacities (transport.py DEFAULT_*_RING_BYTES).
constexpr size_t kDefaultObsRingBytes = 4 * 1024 * 1024;
constexpr size_t kDefaultActRingBytes = 256 * 1024;

// Reader-side wait tuning (matches transport.py's rationale; the exact
// values are latency knobs, not wire format).
// The INITIAL bound on the (fence-less) lost-wakeup stall. 20ms like
// transport.py's _WAKE_RECHECK_S: under scheduler pressure a doorbell
// hop can be late or lost, and a tight recheck caps that stall at one
// scheduling quantum; an idle connection pays only 50 wakeups/s for it.
constexpr int kWakeRecheckMs = 20;
// Adaptive recheck policy (ISSUE 12): per-connection, the bound walks
// within [kRecheckMinMs, kRecheckMaxMs] driven by the
// ring.doorbell_waits / ring.recheck_wakeups counters' local window —
// a recheck-heavy window (>= kRecheckTighten of kRecheckWindow waits
// ended by the timeout: doorbells are being lost/late, the ROADMAP
// metastability signature) HALVES the bound so each stall costs less;
// a quiescent window (<= kRecheckRelax) DOUBLES it back toward idle
// cheapness. All five constants are pinned cross-language against
// analysis/protocol.py (ATOMIC-ORDER _check_recheck); the model
// checker's timeout transition covers any bound in the range (it only
// needs the recheck to stay FINITE — kRecheckMinMs > 0).
constexpr int kRecheckMinMs = 5;
constexpr int kRecheckMaxMs = 100;
constexpr int kRecheckWindow = 32;
constexpr int kRecheckTighten = 16;
constexpr int kRecheckRelax = 4;
constexpr double kEmptySpinS = 100e-6;  // rate-matched pairs stay syscall-free

// Per-connection adaptive recheck state (single-threaded like the
// transport that owns it). record(true) = a wait ended by the bounded
// poll timeout instead of a doorbell byte.
class AdaptiveRecheck {
 public:
  int bound_ms() const { return bound_ms_; }

  void record(bool recheck) {
    ++waits_;
    if (recheck) ++rechecks_;
    if (waits_ < kRecheckWindow) return;
    if (rechecks_ >= kRecheckTighten) {
      bound_ms_ = bound_ms_ / 2 < kRecheckMinMs ? kRecheckMinMs
                                                : bound_ms_ / 2;
    } else if (rechecks_ <= kRecheckRelax) {
      bound_ms_ = bound_ms_ * 2 > kRecheckMaxMs ? kRecheckMaxMs
                                                : bound_ms_ * 2;
    }
    waits_ = rechecks_ = 0;
  }

 private:
  int bound_ms_ = kWakeRecheckMs;
  int waits_ = 0;
  int rechecks_ = 0;
};

inline uint32_t load_u32le(const uint8_t* p) {
  uint32_t x = 0;
  std::memcpy(&x, p, 4);  // little-endian hosts only, like the codec
  return x;
}

// Doorbell-wait observability (mirrors transport.py's
// ring.doorbell_waits / ring.recheck_wakeups counters; the Python
// driver folds these into the telemetry registry via
// NativeTelemetryFolder). Process-wide because transports are
// per-connection and may die before a telemetry tick — cumulative
// counters survive the connection. doorbell_waits counts every
// armed+blocked wait; recheck_wakeups the subset ended by the bounded
// kWakeRecheckMs poll timeout instead of a doorbell byte. A growing
// recheck share is the ROADMAP metastability signature.
struct RingWaitCounters {
  std::atomic<int64_t> doorbell_waits{0};
  std::atomic<int64_t> recheck_wakeups{0};
};

inline RingWaitCounters& ring_wait_counters() {
  static RingWaitCounters counters;
  return counters;
}

// One mapped SPSC ring. Move-only; the mapping is shared with the peer
// process, so head/tail/waiting go through atomics (the Python side's
// plain u64 stores are single aligned stores; release/acquire here gives
// the C++ threads the same data-then-head publish ordering x86 gives
// Python for free, and keeps TSan clean).
class ShmRing {
 public:
  ShmRing() = default;
  ShmRing(const ShmRing&) = delete;
  ShmRing& operator=(const ShmRing&) = delete;
  ShmRing(ShmRing&& other) noexcept { *this = std::move(other); }
  ShmRing& operator=(ShmRing&& other) noexcept {
    close();
    base_ = other.base_;
    map_bytes_ = other.map_bytes_;
    capacity_ = other.capacity_;
    publish_head_ = other.publish_head_;
    owner_ = other.owner_;
    name_ = std::move(other.name_);
    other.base_ = nullptr;
    other.map_bytes_ = 0;
    return *this;
  }
  ~ShmRing() { close(); }

  static ShmRing create(size_t capacity) {
    static std::atomic<uint64_t> counter{0};
    std::string name;
    int fd = -1;
    for (int attempt = 0; attempt < 64; ++attempt) {
      name = "tbtring_" + std::to_string(::getpid()) + "_" +
             std::to_string(counter.fetch_add(1)) + "_" +
             std::to_string(std::chrono::steady_clock::now()
                                .time_since_epoch()
                                .count() &
                            0xffff);
      fd = ::shm_open(("/" + name).c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
      if (fd >= 0) break;
      if (errno != EEXIST) break;  // only name collisions are retryable
    }
    if (fd < 0)
      throw SocketError(std::string("shm_open(create) failed: ") +
                        ::strerror(errno));
    ShmRing ring;
    ring.name_ = name;
    ring.owner_ = true;
    ring.map_bytes_ = kRingHeaderBytes + capacity;
    if (::ftruncate(fd, static_cast<off_t>(ring.map_bytes_)) != 0) {
      ::close(fd);
      ::shm_unlink(("/" + name).c_str());
      throw SocketError("ftruncate failed for shm ring");
    }
    ring.base_ = static_cast<uint8_t*>(::mmap(
        nullptr, ring.map_bytes_, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
    ::close(fd);
    if (ring.base_ == MAP_FAILED) {
      ring.base_ = nullptr;
      ::shm_unlink(("/" + name).c_str());
      throw SocketError("mmap failed for shm ring");
    }
    ring.capacity_ = capacity;
    ring.word(kRingHeadWord)->store(0, std::memory_order_relaxed);
    ring.word(kRingTailWord)->store(0, std::memory_order_relaxed);
    ring.word(kRingCapacityWord)->store(capacity, std::memory_order_relaxed);
    ring.word(kRingWaitingWord)->store(0, std::memory_order_release);
    return ring;
  }

  // Attach a segment the peer created. Python's SharedMemory names come
  // over the handshake without the leading "/" shm_open requires.
  static ShmRing attach(const std::string& name) {
    std::string path = name.empty() || name[0] == '/' ? name : "/" + name;
    int fd = ::shm_open(path.c_str(), O_RDWR, 0);
    if (fd < 0) throw SocketError("shm_open(attach) failed for " + name);
    struct stat st{};
    if (::fstat(fd, &st) != 0) {
      ::close(fd);
      throw SocketError("fstat failed for shm ring " + name);
    }
    ShmRing ring;
    ring.name_ = name;
    ring.owner_ = false;
    ring.map_bytes_ = static_cast<size_t>(st.st_size);
    ring.base_ = static_cast<uint8_t*>(::mmap(
        nullptr, ring.map_bytes_, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
    ::close(fd);
    if (ring.base_ == MAP_FAILED) {
      ring.base_ = nullptr;
      throw SocketError("mmap failed for shm ring " + name);
    }
    uint64_t capacity =
        ring.word(kRingCapacityWord)->load(std::memory_order_acquire);
    if (capacity == 0 || kRingHeaderBytes + capacity > ring.map_bytes_) {
      ring.close();
      throw wire::WireError("shm ring " + name + ": bad capacity " +
                            std::to_string(capacity));
    }
    ring.capacity_ = static_cast<size_t>(capacity);
    return ring;
  }

  const std::string& name() const { return name_; }
  size_t capacity() const { return capacity_; }
  bool valid() const { return base_ != nullptr; }

  // Largest frame routed through the ring; bigger frames ride the inline
  // socket path (same capacity/2 - 4 bound as transport.py — a frame
  // needing a wrap skip can demand skip + frame > capacity free bytes,
  // position-dependently unsatisfiable forever).
  size_t max_frame_bytes() const { return capacity_ / 2 - 4; }

  // -- producer --------------------------------------------------------
  void write_frame(const uint8_t* frame, size_t n,
                   const std::function<void()>& peer_check) {
    size_t need = 4 + n;
    if (need > capacity_)
      throw wire::WireError("Frame of " + std::to_string(n) +
                            " bytes exceeds ring capacity " +
                            std::to_string(capacity_));
    size_t pos = reserve(need, peer_check);
    uint32_t len = static_cast<uint32_t>(n);
    std::memcpy(data() + pos, &len, 4);
    std::memcpy(data() + pos + 4, frame, n);
    word(kRingHeadWord)->store(publish_head_, std::memory_order_release);
  }

  void write_inline_marker(const std::function<void()>& peer_check) {
    size_t pos = reserve(4, peer_check);
    uint32_t marker = kRingInlineMarker;
    std::memcpy(data() + pos, &marker, 4);
    word(kRingHeadWord)->store(publish_head_, std::memory_order_release);
  }

  bool reader_waiting() const {
    return word(kRingWaitingWord)->load(std::memory_order_acquire) != 0;
  }

  // -- consumer --------------------------------------------------------
  bool has_frame() const {
    return word(kRingHeadWord)->load(std::memory_order_acquire) !=
           word(kRingTailWord)->load(std::memory_order_relaxed);
  }

  void set_waiting(bool value) {
    word(kRingWaitingWord)
        ->store(value ? 1 : 0, std::memory_order_seq_cst);
  }

  struct Frame {
    const uint8_t* data;  // nullptr for an inline marker
    size_t size;
    size_t advance;
    bool is_inline;
  };

  Frame read_frame() {
    uint64_t tail = word(kRingTailWord)->load(std::memory_order_relaxed);
    uint64_t head = word(kRingHeadWord)->load(std::memory_order_acquire);
    if (head - tail < 4) throw wire::WireError("shm ring: read without a frame");
    size_t pos = tail % capacity_;
    size_t skipped = 0;
    size_t tail_room = capacity_ - pos;
    uint32_t length = 0;
    if (tail_room < 4) {
      skipped = tail_room;
      pos = 0;
    } else {
      length = load_u32le(data() + pos);
      if (length == kRingWrapMarker) {
        skipped = tail_room;
        pos = 0;
      }
    }
    if (skipped) length = load_u32le(data() + pos);
    if (length == kRingInlineMarker) return {nullptr, 0, skipped + 4, true};
    if (length > capacity_ - 4 || skipped + 4 + length > head - tail)
      throw wire::WireError("shm ring: bad frame length " +
                            std::to_string(length) + " at " +
                            std::to_string(pos));
    return {data() + pos + 4, length, skipped + 4 + length, false};
  }

  void release(size_t advance) {
    uint64_t tail = word(kRingTailWord)->load(std::memory_order_relaxed);
    word(kRingTailWord)->store(tail + advance, std::memory_order_release);
  }

  // -- chaos hook -------------------------------------------------------
  // Stomp the frame queued at tail — poke parity with the Python
  // ShmRing.poke path in resilience/chaos._corrupt_ring, byte for byte:
  // header mode writes an impossible length (0xDEADBEEF) the reader's
  // next read_frame deterministically rejects as WireError; payload
  // mode flips <= 4 bytes clamped to the payload AND the data region.
  // Returns 1 when the stomp observably landed (tail stable: the frame
  // was not consumed mid-stomp), 0 when the ring is momentarily empty /
  // the frame is a marker / the reader raced us — the injector retries.
  // Never called on a healthy path.
  int corrupt_tail_frame(bool header) {
    uint64_t tail = word(kRingTailWord)->load(std::memory_order_acquire);
    uint64_t head = word(kRingHeadWord)->load(std::memory_order_acquire);
    if (head - tail < 8) return 0;  // need a real frame, not just a marker
    size_t pos = tail % capacity_;
    if (capacity_ - pos < 4) pos = 0;  // implicit wrap: frame starts at base
    if (header) {
      // Not WRAP/INLINE, way past any sane length. (Stomping a WRAP
      // marker is equally observable: the reader decodes the bogus
      // length and rejects it.)
      uint32_t poison = 0xDEADBEEF;
      std::memcpy(data() + pos, &poison, 4);
    } else {
      uint32_t length = load_u32le(data() + pos);
      if (length >= kRingInlineMarker) return 0;  // marker: no payload here
      size_t n = 4;
      if (static_cast<size_t>(length) < n) n = length;
      if (capacity_ - pos - 4 < n) n = capacity_ - pos - 4;
      if (n == 0) return 0;
      static const uint8_t pat[4] = {0xa5, 0x5a, 0xa5, 0x5a};
      std::memcpy(data() + pos + 4, pat, n);
    }
    // If the reader consumed the frame while we were stomping, the
    // bytes landed in free space the producer will overwrite — the
    // fault did NOT observably fire; report failure so the caller
    // retries (same tail-stability contract as the Python injector).
    return word(kRingTailWord)->load(std::memory_order_seq_cst) == tail
               ? 1
               : 0;
  }

  // -- teardown --------------------------------------------------------
  // Best-effort unlink regardless of ownership — the crash sweep for a
  // dead owner (mirrors ShmRing.unlink in transport.py; existing
  // mappings stay valid until unmapped).
  void unlink() {
    if (name_.empty()) return;
    std::string path = name_[0] == '/' ? name_ : "/" + name_;
    ::shm_unlink(path.c_str());
  }

  void close() {
    if (base_ != nullptr) {
      ::munmap(base_, map_bytes_);
      base_ = nullptr;
      if (owner_) unlink();
    }
  }

 private:
  std::atomic<uint64_t>* word(size_t i) const {
    return reinterpret_cast<std::atomic<uint64_t>*>(base_ + 8 * i);
  }
  uint8_t* data() const { return base_ + kRingHeaderBytes; }

  size_t reserve(size_t need, const std::function<void()>& peer_check) {
    uint64_t head = word(kRingHeadWord)->load(std::memory_order_relaxed);
    size_t pos = head % capacity_;
    size_t tail_room = capacity_ - pos;
    if (need > tail_room) {
      wait_free(head, tail_room + need, peer_check);
      if (tail_room >= 4) {
        uint32_t marker = kRingWrapMarker;
        std::memcpy(data() + pos, &marker, 4);
      }
      head += tail_room;
      pos = 0;
    } else {
      wait_free(head, need, peer_check);
    }
    publish_head_ = head + need;
    return pos;
  }

  void wait_free(uint64_t head, size_t need,
                 const std::function<void()>& peer_check) {
    auto deadline = std::chrono::steady_clock::time_point::min();
    int64_t ticks = 0;
    while (capacity_ -
               (head - word(kRingTailWord)->load(std::memory_order_acquire)) <
           need) {
      if (deadline == std::chrono::steady_clock::time_point::min()) {
        deadline = std::chrono::steady_clock::now() +
                   std::chrono::seconds(120);
      } else if (std::chrono::steady_clock::now() > deadline) {
        throw wire::WireError("shm ring full for 120s (reader stalled?)");
      }
      ++ticks;
      if (peer_check && ticks % 200 == 0) peer_check();  // ~every 20ms
      std::this_thread::sleep_for(std::chrono::microseconds(100));
    }
  }

  uint8_t* base_ = nullptr;
  size_t map_bytes_ = 0;
  size_t capacity_ = 0;
  uint64_t publish_head_ = 0;
  bool owner_ = false;
  std::string name_;
};

// Framed messages over a ring pair + doorbell socket; same contract as
// transport.py's ShmTransport: the rings are the data plane AND the
// ordering authority, the socket is the blocking primitive, the crash
// detector, and the inline carrier for oversized frames. Single-threaded
// per connection (one actor loop), like every transport here.
class ShmTransport : public Transport {
 public:
  ShmTransport(int fd, ShmRing send_ring, ShmRing recv_ring,
               size_t max_frame_bytes = wire::kMaxFrameBytes)
      : fd_(fd),
        send_ring_(std::move(send_ring)),
        recv_ring_(std::move(recv_ring)),
        max_frame_bytes_(max_frame_bytes) {}

  ~ShmTransport() override { close(); }

  size_t send(const wire::ValueNest& value) override {
    std::vector<uint8_t> framed = wire::encode(value);
    auto peer_check = [this] { check_peer_alive(); };
    if (framed.size() <= send_ring_.max_frame_bytes()) {
      send_ring_.write_frame(framed.data(), framed.size(), peer_check);
      if (send_ring_.reader_waiting()) send_doorbell(kDoorbellWake);
    } else {
      send_ring_.write_inline_marker(peer_check);
      if (send_ring_.reader_waiting()) send_doorbell(kDoorbellWake);
      send_doorbell(kDoorbellInline);
      send_all(framed.data(), framed.size());
    }
    return framed.size();
  }

  std::pair<wire::ValueNest, size_t> recv_sized() override {
    if (pending_release_) {
      recv_ring_.release(pending_release_);
      pending_release_ = 0;
    }
    if (!wait_for_frame())
      throw SocketError("connection closed by peer");
    ShmRing::Frame f = recv_ring_.read_frame();
    pending_release_ = f.advance;
    if (f.is_inline) return recv_inline_frame();
    if (f.size < 4) throw wire::WireError("shm ring: truncated frame header");
    uint32_t payload_len = load_u32le(f.data);
    if (payload_len != f.size - 4)
      throw wire::WireError("shm ring: header says " +
                            std::to_string(payload_len) + ", frame has " +
                            std::to_string(f.size - 4));
    if (payload_len > max_frame_bytes_)
      throw wire::WireError("Frame length " + std::to_string(payload_len) +
                            " exceeds max_frame_bytes");
    // Zero-copy decode out of the mapped ring; the slot is released at
    // the NEXT recv (same buffer-reuse lifetime rule as the Python
    // transport — the actor pool clones env fields per step anyway).
    return {wire::decode(f.data + 4, payload_len, nullptr),
            f.size};
  }

  // Crash sweep: unlink both segments regardless of ownership (a
  // SIGKILL'd owner can't; for a live one this only pre-empts its own
  // unlink — rings are per-connection and never re-attached).
  void unlink_segments() override {
    send_ring_.unlink();
    recv_ring_.unlink();
  }

  // Chaos hooks (csrc/chaos.h): sever the doorbell — peer-death
  // semantics for both sides (a blocked reader's poll wakes to EOF, a
  // blocked writer's peer probe fails) — and the ring-poke injector.
  void shutdown_stream() override {
    if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
  }

  int corrupt_recv_ring(bool header) override {
    return recv_ring_.corrupt_tail_frame(header);
  }

  void close() override {
    if (fd_ >= 0) {
      ::close(fd_);
      fd_ = -1;
    }
    send_ring_.close();
    recv_ring_.close();
  }

 private:
  void send_doorbell(uint8_t byte) { send_all(&byte, 1); }

  void send_all(const uint8_t* p, size_t n) {
    size_t sent = 0;
    while (sent < n) {
      ssize_t r = ::send(fd_, p + sent, n - sent, 0);
      if (r <= 0) throw SocketError("shm doorbell send failed");
      sent += static_cast<size_t>(r);
    }
  }

  // Probe the doorbell while a send is blocked on ring space: a DEAD
  // peer must fail the send promptly. Queued stale WAKE bytes are
  // consumed so they can't mask the EOF behind them (wakeups are only
  // needed while this end is blocked in wait_for_frame; the transport
  // is single-threaded per connection, so any 0x01 queued during a send
  // is stale by definition). An inline 0x02 is left for recv_sized.
  void check_peer_alive() {
    // A consumed 0x02 whose frame bytes are still queued proves the
    // peer alive AND makes the socket head payload, not doorbell —
    // probing now could eat a payload byte that happens to be 0x01.
    if (inline_consumed_) return;
    while (true) {
      uint8_t b = 0;
      ssize_t r = ::recv(fd_, &b, 1, MSG_PEEK | MSG_DONTWAIT);
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
          return;  // alive; nothing queued
        throw SocketError("shm peer connection lost during ring wait");
      }
      if (r == 0) throw SocketError("shm peer closed during ring wait");
      if (b == kDoorbellWake) {
        ::recv(fd_, &b, 1, MSG_DONTWAIT);
        continue;  // re-probe: EOF may hide behind stale wakeups
      }
      return;  // inline traffic queued: peer alive, leave it alone
    }
  }

  // Block until the recv ring has a frame; false on clean EOF with a
  // drained ring. The waiting-flag dance keeps a busy pair syscall-free;
  // the bounded poll re-checks the ring against the fence-less
  // lost-wakeup window (same recovery as transport.py).
  bool wait_for_frame() {
    while (true) {
      if (recv_ring_.has_frame()) return true;
      auto spin_until = std::chrono::steady_clock::now() +
                        std::chrono::duration_cast<
                            std::chrono::steady_clock::duration>(
                            std::chrono::duration<double>(kEmptySpinS));
      while (std::chrono::steady_clock::now() < spin_until) {
        if (recv_ring_.has_frame()) return true;
      }
      recv_ring_.set_waiting(true);
      if (recv_ring_.has_frame()) {
        recv_ring_.set_waiting(false);
        continue;
      }
      ring_wait_counters().doorbell_waits.fetch_add(
          1, std::memory_order_relaxed);
      struct pollfd p {fd_, POLLIN, 0};
      // Adaptive bound (ISSUE 12): recheck-heavy windows tighten it,
      // quiescent ones relax it — see AdaptiveRecheck above.
      int pr = ::poll(&p, 1, recheck_.bound_ms());
      if (pr == 0) {
        recv_ring_.set_waiting(false);
        ring_wait_counters().recheck_wakeups.fetch_add(
            1, std::memory_order_relaxed);
        recheck_.record(true);
        continue;  // re-check the ring (lost-wakeup guard)
      }
      if (pr < 0) {
        recv_ring_.set_waiting(false);
        if (errno == EINTR) continue;
        throw SocketError("shm doorbell poll failed");
      }
      uint8_t b = 0;
      ssize_t r = ::recv(fd_, &b, 1, 0);
      recv_ring_.set_waiting(false);
      if (r > 0) recheck_.record(false);  // a byte ended this wait
      if (r == 0) {
        // Peer closed. Frames already in the ring stay deliverable;
        // EOF surfaces once it drains.
        return recv_ring_.has_frame();
      }
      if (r < 0) {
        if (errno == EINTR) continue;
        throw SocketError("shm doorbell recv failed");
      }
      if (b == kDoorbellInline) {
        // The fence-less waiting-flag race can land the inline byte on
        // a blocked reader before the WAKE was seen; the send syscall
        // fences the sender's marker publish, so the marker must be in
        // the ring by now.
        if (!recv_ring_.has_frame())
          throw wire::WireError("shm: inline byte with an empty ring");
        inline_consumed_ = true;
        return true;
      }
      if (b != kDoorbellWake)
        throw wire::WireError("Bad doorbell byte " + std::to_string(b));
      // Stale wakeup: loop and re-check the ring.
    }
  }

  // The ring said this message rides the socket: skip stale wakeups up
  // to the 0x02 byte (unless wait_for_frame already consumed it), then
  // read one framed message off the socket.
  std::pair<wire::ValueNest, size_t> recv_inline_frame() {
    while (!inline_consumed_) {
      uint8_t b = 0;
      ssize_t r = ::recv(fd_, &b, 1, 0);
      if (r == 0)
        throw wire::WireError("Connection closed before inline frame");
      if (r < 0) {
        if (errno == EINTR) continue;
        throw SocketError("shm doorbell recv failed");
      }
      if (b == kDoorbellInline) break;
      if (b != kDoorbellWake)
        throw wire::WireError("Bad doorbell byte " + std::to_string(b));
    }
    inline_consumed_ = false;
    uint8_t header[4];
    recv_exact(header, 4);
    uint32_t length = load_u32le(header);
    if (length > max_frame_bytes_)
      throw wire::WireError("wire: frame length " + std::to_string(length) +
                            " exceeds max_frame_bytes");
    auto payload = std::make_shared<std::vector<uint8_t>>(length);
    recv_exact(payload->data(), length);
    return {wire::decode(payload->data(), length, payload),
            4 + static_cast<size_t>(length)};
  }

  void recv_exact(uint8_t* out, size_t n) {
    size_t got = 0;
    while (got < n) {
      ssize_t r = ::recv(fd_, out + got, n - got, 0);
      if (r == 0) throw SocketError("connection closed by peer");
      if (r < 0) {
        if (errno == EINTR) continue;
        throw SocketError("recv failed");
      }
      got += static_cast<size_t>(r);
    }
  }

  int fd_ = -1;
  ShmRing send_ring_;
  ShmRing recv_ring_;
  size_t max_frame_bytes_;
  size_t pending_release_ = 0;
  bool inline_consumed_ = false;
  AdaptiveRecheck recheck_;
};

// -- handshake (both roles) -------------------------------------------
// Same protocol as transport.py: the server creates the per-connection
// rings and sends {"type": "shm_handshake", "version": 1, "s2c": name,
// "c2s": name}; the client attaches and acks {"type": "shm_ok"}.

inline std::string handshake_string(const wire::ValueNest& msg,
                                    const std::string& key) {
  if (!msg.is_dict()) throw wire::WireError("Bad shm handshake message");
  const auto& dict = msg.dict();
  auto it = dict.find(key);
  if (it == dict.end() || !it->second.is_leaf() ||
      it->second.leaf().kind != wire::Value::Kind::kString)
    throw wire::WireError("shm handshake missing " + key);
  return it->second.leaf().s;
}

// Client role: the doorbell socket is already connected; complete the
// handshake and return the transport (send ring = c2s, recv = s2c).
inline std::unique_ptr<Transport> shm_client_transport(
    FramedSocket&& sock, size_t max_frame_bytes = wire::kMaxFrameBytes) {
  wire::ValueNest hs = sock.recv();
  if (handshake_string(hs, "type") != "shm_handshake")
    throw wire::WireError("Expected shm handshake");
  ShmRing s2c = ShmRing::attach(handshake_string(hs, "s2c"));
  ShmRing c2s = ShmRing::attach(handshake_string(hs, "c2s"));
  wire::ValueNest::Dict ack;
  ack.emplace("type", wire::ValueNest(wire::Value::of_string("shm_ok")));
  sock.send(wire::ValueNest(std::move(ack)));
  int fd = sock.release();
  return std::make_unique<ShmTransport>(fd, std::move(c2s), std::move(s2c),
                                        max_frame_bytes);
}

// Server role: create the rings, send the handshake, wait for the ack
// (send ring = s2c, recv = c2s). The created rings are owner-unlinked at
// transport close, so a clean stream end leaves /dev/shm empty.
inline std::unique_ptr<Transport> shm_server_transport(
    FramedSocket&& sock, size_t obs_ring_bytes = kDefaultObsRingBytes,
    size_t act_ring_bytes = kDefaultActRingBytes,
    size_t max_frame_bytes = wire::kMaxFrameBytes) {
  ShmRing s2c = ShmRing::create(obs_ring_bytes);
  ShmRing c2s = ShmRing::create(act_ring_bytes);
  wire::ValueNest::Dict hs;
  hs.emplace("type",
             wire::ValueNest(wire::Value::of_string("shm_handshake")));
  hs.emplace("version", wire::ValueNest(wire::Value::of_int(1)));
  hs.emplace("s2c", wire::ValueNest(wire::Value::of_string(s2c.name())));
  hs.emplace("c2s", wire::ValueNest(wire::Value::of_string(c2s.name())));
  sock.send(wire::ValueNest(std::move(hs)));
  // Bounded ack wait, matching transport.py's handshake_timeout_s: a
  // peer that connects but never acks (crashed mid-handshake, stray
  // prober) must not pin the serve thread. The timeout makes recv
  // throw, and stack unwind owner-unlinks both just-created rings.
  struct timeval tv = {};
  tv.tv_sec = 30;
  ::setsockopt(sock.fd(), SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  wire::ValueNest ack = sock.recv();
  tv.tv_sec = 0;  // back to blocking before the fd becomes the doorbell
  ::setsockopt(sock.fd(), SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  if (handshake_string(ack, "type") != "shm_ok")
    throw wire::WireError("Bad shm handshake ack");
  int fd = sock.release();
  return std::make_unique<ShmTransport>(fd, std::move(s2c), std::move(c2s),
                                        max_frame_bytes);
}

// Address helpers (transport.py shm_socket_path): "shm:/p" and
// "shm:///p" -> "/p", the unix doorbell socket path.
inline bool is_shm_address(const std::string& address) {
  return address.rfind("shm:", 0) == 0;
}

inline std::string shm_socket_path(const std::string& address) {
  std::string path = address.substr(4);
  if (path.rfind("//", 0) == 0) path = path.substr(2);
  if (path.empty()) throw SocketError("Empty shm address: " + address);
  return path;
}

// The client-side factory the actor pool uses: SocketTransport semantics
// for unix:/host:port, handshaken ShmTransport for shm: addresses.
inline std::unique_ptr<Transport> connect_transport(
    const std::string& address, double deadline_s,
    size_t max_frame_bytes = wire::kMaxFrameBytes) {
  FramedSocket sock;
  if (is_shm_address(address)) {
    sock.connect("unix:" + shm_socket_path(address), deadline_s);
    return shm_client_transport(std::move(sock), max_frame_bytes);
  }
  sock.connect(address, deadline_s);
  sock.set_max_frame_bytes(max_frame_bytes);
  return std::make_unique<FramedSocket>(std::move(sock));
}

}  // namespace shm
}  // namespace tbt
