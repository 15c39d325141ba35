// Framed-socket client: connect (with retry-to-deadline), send/recv wire
// messages. The C++ side of the env-stream transport (reference: gRPC
// channel + WaitForConnected, actorpool.cc:354-381).

#pragma once

#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <arpa/inet.h>
#include <netdb.h>

#include <chrono>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "wire.h"

namespace tbt {

class SocketError : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};

// One framed-message stream, whatever the data plane: the plain socket
// (FramedSocket) or the shared-memory rings (shm.h ShmTransport). The
// actor pool and env server speak only this interface, so both sides
// accept every address scheme the Python runtime does.
class Transport {
 public:
  virtual ~Transport() = default;
  // Returns the framed byte count (header included) for wire telemetry.
  virtual size_t send(const wire::ValueNest& value) = 0;
  // (value, framed byte count); throws SocketError on EOF — the env
  // stream should outlive the actor loop.
  virtual std::pair<wire::ValueNest, size_t> recv_sized() = 0;
  wire::ValueNest recv() { return recv_sized().first; }
  // shm crash sweep; no-op for socket transports.
  virtual void unlink_segments() {}
  // Chaos hooks (csrc/chaos.h / ISSUE 12): sever the stream from
  // another thread — shutdown(SHUT_RDWR) so a parked recv wakes with
  // the same EOF a real cable cut produces; corrupt the shm recv ring's
  // queued frame (1 = observably landed, 0 = momentarily empty, retry;
  // -1 = not an shm transport). No-ops on transports without the
  // underlying surface; the FaultingTransport parity contract lives in
  // resilience/chaos.py.
  virtual void shutdown_stream() {}
  virtual int corrupt_recv_ring(bool /*header*/) { return -1; }
  virtual void close() = 0;
};

class FramedSocket : public Transport {
 public:
  FramedSocket() = default;
  ~FramedSocket() override { close(); }

  FramedSocket(const FramedSocket&) = delete;
  FramedSocket& operator=(const FramedSocket&) = delete;
  FramedSocket(FramedSocket&& other) noexcept
      : fd_(other.fd_), max_frame_bytes_(other.max_frame_bytes_) {
    other.fd_ = -1;
  }

  // Wrap an already-connected fd (server-accepted stream); takes
  // ownership (closes it in the destructor).
  static FramedSocket adopt(int fd) {
    FramedSocket s;
    s.fd_ = fd;
    return s;
  }

  // Borrow the fd (e.g. for setsockopt) without giving up ownership.
  int fd() const { return fd_; }

  // Hand the fd off (e.g. to a ShmTransport after the handshake); the
  // destructor then leaves it alone.
  int release() {
    int fd = fd_;
    fd_ = -1;
    return fd;
  }

  // Per-connection frame bound (--max_frame_bytes); defaults to the
  // codec-wide kMaxFrameBytes.
  void set_max_frame_bytes(size_t n) { max_frame_bytes_ = n; }

  // "unix:/path" or "host:port", retrying until deadline_s.
  void connect(const std::string& address, double deadline_s) {
    auto deadline =
        std::chrono::steady_clock::now() +
        std::chrono::duration_cast<std::chrono::steady_clock::duration>(
            std::chrono::duration<double>(deadline_s));
    std::string last_error = "unknown";
    while (std::chrono::steady_clock::now() < deadline) {
      if (try_connect(address, &last_error)) return;
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
    }
    throw SocketError("WaitForConnected() timed out for " + address + ": " +
                      last_error);
  }

  void close() override {
    if (fd_ >= 0) {
      ::close(fd_);
      fd_ = -1;
    }
  }

  // Chaos sever: called from the injector thread while the owning actor
  // may be blocked in recv — shutdown (not close) keeps the fd valid
  // until the owner tears down, so there is no fd-reuse race.
  void shutdown_stream() override {
    if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
  }

  size_t send(const wire::ValueNest& value) override {
    std::vector<uint8_t> framed = wire::encode(value);
    size_t sent = 0;
    while (sent < framed.size()) {
      ssize_t n = ::send(fd_, framed.data() + sent, framed.size() - sent, 0);
      if (n <= 0) throw SocketError("send failed");
      sent += static_cast<size_t>(n);
    }
    return framed.size();
  }

  // Throws SocketError on EOF (the stream should outlive the actor loop).
  std::pair<wire::ValueNest, size_t> recv_sized() override {
    uint8_t header[4];
    recv_exact(header, 4);
    uint32_t length = 0;
    for (int i = 0; i < 4; ++i)
      length |= static_cast<uint32_t>(header[i]) << (8 * i);
    if (length > max_frame_bytes_)
      throw wire::WireError("wire: frame length " + std::to_string(length) +
                            " exceeds max_frame_bytes " +
                            std::to_string(max_frame_bytes_));
    auto payload = std::make_shared<std::vector<uint8_t>>(length);
    recv_exact(payload->data(), length);
    return {wire::decode(payload->data(), length, payload),
            4 + static_cast<size_t>(length)};
  }

 private:
  bool try_connect(const std::string& address, std::string* error) {
    int fd = -1;
    if (address.rfind("unix:", 0) == 0) {
      fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
      if (fd < 0) {
        *error = std::strerror(errno);
        return false;
      }
      sockaddr_un addr{};
      addr.sun_family = AF_UNIX;
      std::string path = address.substr(5);
      if (path.size() >= sizeof(addr.sun_path)) {
        ::close(fd);
        *error = "unix path too long";
        return false;
      }
      std::strncpy(addr.sun_path, path.c_str(), sizeof(addr.sun_path) - 1);
      if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
          0) {
        *error = std::strerror(errno);
        ::close(fd);
        return false;
      }
    } else {
      auto colon = address.rfind(':');
      if (colon == std::string::npos) {
        *error = "bad address";
        return false;
      }
      std::string host = address.substr(0, colon);
      if (host.empty()) host = "127.0.0.1";
      std::string port = address.substr(colon + 1);
      addrinfo hints{};
      hints.ai_family = AF_UNSPEC;
      hints.ai_socktype = SOCK_STREAM;
      addrinfo* res = nullptr;
      if (::getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0) {
        *error = "getaddrinfo failed";
        return false;
      }
      for (addrinfo* rp = res; rp; rp = rp->ai_next) {
        fd = ::socket(rp->ai_family, rp->ai_socktype, rp->ai_protocol);
        if (fd < 0) continue;
        if (::connect(fd, rp->ai_addr, rp->ai_addrlen) == 0) break;
        *error = std::strerror(errno);
        ::close(fd);
        fd = -1;
      }
      ::freeaddrinfo(res);
      if (fd < 0) return false;
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    }
    fd_ = fd;
    return true;
  }

  void recv_exact(uint8_t* out, size_t n) {
    size_t got = 0;
    while (got < n) {
      ssize_t r = ::recv(fd_, out + got, n - got, 0);
      if (r == 0) throw SocketError("connection closed by peer");
      if (r < 0) throw SocketError(std::string("recv failed: ") +
                                   std::strerror(errno));
      got += static_cast<size_t>(r);
    }
  }

  int fd_ = -1;
  size_t max_frame_bytes_ = wire::kMaxFrameBytes;
};

}  // namespace tbt
