// EnvServer: hosts environment streams behind the framed-socket wire
// protocol, mechanics in C++ (the reference embeds Python envs in a C++
// gRPC server the same way, rpcenv.cc:36-156).
//
// The header is Python-free: per-stream behavior is injected as hooks
// (initial / step / close). The Python binding (pymodule.cc) supplies
// hooks that take the GIL only around the env calls, so all socket I/O
// and wire codec work runs GIL-free — the reason to host the server in
// C++ at all (reference: gil_scoped_acquire only around Python calls,
// rpcenv.cc:47,95).

#pragma once

#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <atomic>
#include <cstring>
#include <functional>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "client.h"
#include "shm.h"
#include "wire.h"

namespace tbt {

// Per-stream behavior. Hooks may throw; the server reports the error to
// the client as an error frame and drops the stream. close() always runs.
struct StreamHooks {
  std::function<wire::ValueNest()> initial;
  std::function<wire::ValueNest(const wire::ValueNest&)> step;
  std::function<void()> close;
};

class EnvServer {
 public:
  EnvServer(std::string address, std::function<StreamHooks()> hook_factory)
      : address_(std::move(address)),
        hook_factory_(std::move(hook_factory)) {}

  ~EnvServer() {
    stop();
    join_all();
  }

  EnvServer(const EnvServer&) = delete;
  EnvServer& operator=(const EnvServer&) = delete;

  // Bind + accept loop; blocks until stop() (reference Server::run,
  // rpcenv.cc:142-156). Each accepted connection gets its own thread and
  // a fresh hook set (fresh env per stream, rpcenv.cc:72).
  void run() {
    bind_and_listen();
    running_.store(true);
    while (running_.load()) {
      int listen_fd = listen_fd_.load();
      if (listen_fd < 0) break;
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (!running_.load()) break;
        continue;  // transient accept failure (EINTR etc.)
      }
      std::lock_guard<std::mutex> lock(mu_);
      if (!running_.load()) {
        ::close(fd);
        break;
      }
      conn_fds_.push_back(fd);
      reap_finished_locked();
      threads_.emplace_back([this, fd] {
        serve_stream(fd);
        std::lock_guard<std::mutex> l(mu_);
        finished_.push_back(std::this_thread::get_id());
      });
    }
  }

  // Close the listen socket and sever live streams. Idempotent; safe to
  // call concurrently with run() (the fd hand-off is an atomic exchange).
  void stop() {
    running_.store(false);
    int fd = listen_fd_.exchange(-1);
    if (fd >= 0) {
      ::shutdown(fd, SHUT_RDWR);
      ::close(fd);
      if (!unix_path_.empty()) ::unlink(unix_path_.c_str());
    }
    std::lock_guard<std::mutex> lock(mu_);
    for (int conn : conn_fds_) ::shutdown(conn, SHUT_RDWR);
  }

  void join_all() {
    std::vector<std::thread> threads;
    {
      std::lock_guard<std::mutex> lock(mu_);
      threads.swap(threads_);
    }
    for (auto& t : threads)
      if (t.joinable()) t.join();
  }

 private:
  void bind_and_listen() {
    int fd = -1;
    if (address_.rfind("unix:", 0) == 0 || shm::is_shm_address(address_)) {
      // shm addresses resolve to their unix doorbell socket; the
      // per-connection rings are created at accept time
      // (shm_server_transport), names exchanged in the handshake —
      // same protocol as runtime/transport.py server_transport.
      // beastlint: disable=CXX-LOCK-DISCIPLINE  write-before-spawn: stream threads that read shm_ are created after bind_and_listen returns, by the same thread
      shm_ = shm::is_shm_address(address_);
      // beastlint: disable=CXX-LOCK-DISCIPLINE  atomic handoff: stop() reads unix_path_ only after listen_fd_.exchange() observed the fd stored after this write
      unix_path_ = shm_ ? shm::shm_socket_path(address_)
                        : address_.substr(5);
      ::unlink(unix_path_.c_str());
      fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
      if (fd < 0) throw SocketError("socket() failed");
      sockaddr_un addr{};
      addr.sun_family = AF_UNIX;
      if (unix_path_.size() >= sizeof(addr.sun_path))
        throw SocketError("unix path too long: " + unix_path_);
      std::strncpy(addr.sun_path, unix_path_.c_str(),
                   sizeof(addr.sun_path) - 1);
      if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
        throw SocketError("bind failed for " + address_);
    } else {
      auto colon = address_.rfind(':');
      if (colon == std::string::npos)
        throw SocketError("address must be unix:/path or host:port");
      std::string host = address_.substr(0, colon);
      int port = std::stoi(address_.substr(colon + 1));
      if (host.empty()) host = "127.0.0.1";
      fd = ::socket(AF_INET, SOCK_STREAM, 0);
      if (fd < 0) throw SocketError("socket() failed");
      int one = 1;
      ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_port = htons(static_cast<uint16_t>(port));
      if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1)
        throw SocketError("bad host " + host);
      if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
        throw SocketError("bind failed for " + address_);
    }
    if (::listen(fd, 16) != 0)
      throw SocketError("listen failed for " + address_);
    listen_fd_.store(fd);
  }

  void serve_stream(int fd) {
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::unique_ptr<Transport> sock;
    StreamHooks hooks;
    bool have_hooks = false;
    try {
      if (shm_) {
        // Rings + handshake BEFORE the env hooks run, so a client that
        // never acks can't leak an env instance (matches the Python
        // server's ordering). Ring teardown: the transport owns its
        // created segments and unlinks them at close.
        sock = shm::shm_server_transport(FramedSocket::adopt(fd));
      } else {
        sock = std::make_unique<FramedSocket>(FramedSocket::adopt(fd));
      }
      hooks = hook_factory_();
      have_hooks = true;
      sock->send(hooks.initial());
      while (true) {
        wire::ValueNest action = sock->recv();
        sock->send(hooks.step(action));
      }
    } catch (const SocketError&) {
      // client hung up / stop(): normal end of stream
    } catch (const std::exception& e) {
      // env/hook raised: report to the client, then drop the stream
      // (reference: grpc INTERNAL status, rpcenv.cc:76-81)
      try {
        wire::ValueNest::Dict err;
        err.emplace("type",
                    wire::ValueNest(wire::Value::of_string("error")));
        err.emplace("message",
                    wire::ValueNest(wire::Value::of_string(e.what())));
        if (sock) sock->send(wire::ValueNest(std::move(err)));
      } catch (const SocketError&) {
      } catch (const wire::WireError&) {
      }
    }
    if (have_hooks && hooks.close) hooks.close();
    std::lock_guard<std::mutex> lock(mu_);
    for (auto it = conn_fds_.begin(); it != conn_fds_.end(); ++it) {
      if (*it == fd) {
        conn_fds_.erase(it);
        break;
      }
    }
  }

  // Join threads whose streams already ended so the vector stays
  // bounded under reconnect-heavy workloads (the Python server prunes
  // the same way). A finished id's thread is at worst a few
  // instructions from returning, so these joins are effectively
  // instant and never wait on a live stream.
  // beastlint: holds mu_
  void reap_finished_locked() {
    for (std::thread::id id : finished_) {
      for (auto it = threads_.begin(); it != threads_.end(); ++it) {
        if (it->get_id() == id) {
          it->join();
          threads_.erase(it);
          break;
        }
      }
    }
    finished_.clear();
  }

  std::string address_;
  std::function<StreamHooks()> hook_factory_;
  // unix_path_ / shm_ are written once by bind_and_listen (run()'s
  // thread) and then only read: stream threads spawn strictly after
  // bind_and_listen returns (write-before-spawn), and stop() touches
  // unix_path_ only after listen_fd_.exchange() returned a valid fd —
  // a seq_cst handoff that happens-after the store publishing the path.
  std::string unix_path_;
  bool shm_ = false;
  std::atomic<int> listen_fd_{-1};
  std::atomic<bool> running_{false};
  std::mutex mu_;
  std::vector<int> conn_fds_;     // guarded-by: mu_
  std::vector<std::thread> threads_;  // guarded-by: mu_
  std::vector<std::thread::id> finished_;  // guarded-by: mu_
};

}  // namespace tbt
