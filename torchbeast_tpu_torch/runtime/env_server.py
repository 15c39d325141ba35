"""Environment server: hosts environments behind a streaming socket.

The reference's gRPC `EnvServer` (torchbeast's src/cc/rpcenv.cc:36-211,
driven by polybeast_env.py:61-77) re-designed over the framed-socket wire
protocol: each incoming connection gets a FRESH environment instance
(reference rpcenv.cc:72), the server sends the initial Step, then loops
recv(Action) -> env.step -> send(Step). Episode accounting and auto-reset
live in the Environment adapter (envs/environment.py), matching the
reference's server-side bookkeeping (rpcenv.cc:106-119).

Env exceptions are reported to the client as an error message frame (the
reference surfaces them as grpc INTERNAL status, rpcenv.cc:76-81).

Addresses: "unix:/path", "host:port" (same convention as the reference's
pipes_basename, polybeast_learner.py:40-42), or "shm:/path" — shared-
memory rings with a unix doorbell socket at /path, for env servers
co-located with the learner process (runtime/transport.py): obs/action
frames skip the socket data plane entirely.

The port's copy of torchbeast_tpu/runtime/env_server.py.
"""

import logging
import os
import socket
import threading
import time
from typing import Callable, Optional

import numpy as np

from torchbeast_tpu_torch import telemetry
from torchbeast_tpu_torch.envs.environment import Environment
from torchbeast_tpu_torch.runtime import transport as transport_lib
from torchbeast_tpu_torch.runtime import wire

# Re-exported: parse_address lived here before the transport module
# existed and tests/drivers import it from this path.
from torchbeast_tpu_torch.runtime.transport import parse_address  # noqa: F401

log = logging.getLogger(__name__)


def _step_to_message(step) -> dict:
    # 0-d arrays (not python scalars) so dtypes survive the wire exactly:
    # reward stays float32, done bool, counters int32.
    return {"type": "step", **{k: np.asarray(v) for k, v in step.items()}}


class EnvServer:
    """Serve env streams; one thread per connection."""

    def __init__(self, env_init: Callable, address: str,
                 max_frame_bytes: Optional[int] = None,
                 obs_ring_bytes: int = transport_lib.DEFAULT_OBS_RING_BYTES,
                 act_ring_bytes: int = transport_lib.DEFAULT_ACT_RING_BYTES):
        self._env_init = env_init
        self._address = address
        self._shm = transport_lib.is_shm_address(address)
        self._max_frame_bytes = max_frame_bytes
        self._obs_ring_bytes = obs_ring_bytes
        self._act_ring_bytes = act_ring_bytes
        self._family, self._target = parse_address(address)
        # Control fields shared between run() (its own thread under
        # start()), the per-stream threads, and stop() (caller thread):
        # all guarded by the conns lock (RACE burn-down).
        self._sock = None  # guarded-by: self._conns_lock
        self._threads = []  # guarded-by: self._conns_lock
        # Permanent stop latch: a stop() that wins the race against a
        # just-starting run() (before the listener is published) must
        # still stop it — run() re-checks this at publish time.
        self._stopped = False  # guarded-by: self._conns_lock
        self._conns = []
        # conn -> (shm segment names) for live shm streams: stop()'s
        # owner-side sweep unlinks whatever a stream thread didn't get
        # to (SIGKILL chaos must not grow /dev/shm).
        self._ring_names = {}  # guarded-by: self._conns_lock
        self._conns_lock = threading.Lock()
        self._running = False  # guarded-by: self._conns_lock
        # NB: env servers usually run as separate processes, so these
        # land in each server's OWN process registry (the learner-side
        # mirror lives in ActorPool's wire.bytes_* counters).
        reg = telemetry.get_registry()
        self._tm_conns = reg.gauge("env_server.connections")
        self._tm_bytes_in = reg.counter("env_server.bytes_in")
        self._tm_bytes_out = reg.counter("env_server.bytes_out")
        self._tm_step_s = reg.histogram("env_server.env_step_s")

    def run(self):
        """Bind and serve until stop() (reference Server.run blocks too,
        rpcenv.cc:142-156)."""
        sock = socket.socket(self._family, socket.SOCK_STREAM)
        if self._family == socket.AF_UNIX:
            try:
                os.unlink(self._target)
            except FileNotFoundError:
                pass
        else:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(self._target)
        sock.listen(16)
        # Publish the listener + running flag under the lock: a stop()
        # racing a just-starting run() either already latched _stopped
        # (we tear down here and never serve) or sees the published
        # socket and closes it.
        with self._conns_lock:
            if self._stopped:
                sock.close()
                if self._family == socket.AF_UNIX:
                    try:
                        os.unlink(self._target)
                    except FileNotFoundError:
                        pass
                return
            self._sock = sock
            self._running = True
        log.info("EnvServer listening on %s", self._address)
        while True:
            with self._conns_lock:
                if not self._running:
                    break
            try:
                conn, _ = sock.accept()
            except OSError:
                break  # socket closed by stop()
            # Register the conn BEFORE spawning its thread so a concurrent
            # stop() can never miss a just-accepted stream.
            with self._conns_lock:
                if not self._running:
                    conn.close()
                    break
                self._conns.append(conn)
            t = threading.Thread(
                target=self._serve_stream, args=(conn,), daemon=True
            )
            t.start()
            # Prune finished stream threads so reconnect-heavy workloads
            # don't grow this list unboundedly.
            with self._conns_lock:
                self._threads = [
                    x for x in self._threads if x.is_alive()
                ] + [t]

    def start(self):
        """Non-blocking run() in a daemon thread."""
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        with self._conns_lock:
            self._threads.append(t)

    def stop(self):
        with self._conns_lock:
            self._stopped = True
            self._running = False
            sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        # Sever live streams too — stop() means stop, and clients with
        # reconnect enabled treat the cut as a transport failure.
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        # Owner-side shm sweep: give the stream threads a moment to
        # close their rings (which unlinks them), then unlink whatever
        # is left. A thread wedged past the join window must not strand
        # segments in /dev/shm — unlink is safe under live mappings.
        # (Joins happen OUTSIDE the conns lock: a stream thread's
        # teardown takes it to deregister.)
        with self._conns_lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2)
        with self._conns_lock:
            leftovers = [
                name
                for names in self._ring_names.values()
                for name in names
            ]
            self._ring_names.clear()
        for name in leftovers:
            if transport_lib.unlink_segment(name):
                log.warning(
                    "EnvServer stop(): swept leaked shm segment %s", name
                )
        if self._family == socket.AF_UNIX:
            try:
                os.unlink(self._target)
            except FileNotFoundError:
                pass

    def _serve_stream(self, conn: socket.socket):
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # unix sockets
        stream = None
        env = None
        msg = None
        try:
            # For shm addresses this creates the per-connection rings and
            # completes the handshake BEFORE the env is built, so a
            # client that never acks can't leak an env instance.
            stream = transport_lib.server_transport(
                conn, shm=self._shm,
                obs_ring_bytes=self._obs_ring_bytes,
                act_ring_bytes=self._act_ring_bytes,
                max_frame_bytes=self._max_frame_bytes,
            )
            if self._shm:
                with self._conns_lock:
                    self._ring_names[conn] = stream.segment_names
            raw_env = self._env_init()
            env = Environment(raw_env)
            # The initial Step doubles as the env spec: remote learners
            # probe num_actions/frame shape from it instead of having to
            # build the env locally (split deployments may not have the
            # env deps on the learner host).
            from torchbeast_tpu_torch.envs import num_actions_of

            initial = _step_to_message(env.initial())
            initial["num_actions"] = num_actions_of(raw_env)
            with self._conns_lock:
                self._tm_conns.set(len(self._conns))
            self._tm_bytes_out.inc(stream.send(initial))
            while True:
                msg, nbytes = stream.recv_sized()
                if msg is None:
                    break  # client hung up
                self._tm_bytes_in.inc(nbytes)
                if msg.get("type") != "action":
                    raise wire.WireError(f"Expected action, got {msg!r}")
                t0 = time.perf_counter()
                step = env.step(int(msg["action"]))
                self._tm_step_s.observe(time.perf_counter() - t0)
                self._tm_bytes_out.inc(stream.send(_step_to_message(step)))
        except (wire.WireError, ConnectionError, BrokenPipeError,
                TimeoutError) as e:
            log.debug("Stream ended: %s", e)
        except Exception as e:  # env raised: report to client, drop stream
            log.exception("Environment raised")
            try:
                if stream is not None:
                    stream.send({
                        "type": "error",
                        "message": f"{type(e).__name__}: {e}",
                    })
            except (OSError, wire.WireError):
                pass
        finally:
            msg = None  # drop transport-buffer views before close
            if env is not None:
                env.close()
            if stream is not None:
                stream.close()  # closes conn and, for shm, the rings
            else:
                conn.close()
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                # stream.close() unlinked the rings; drop them from the
                # stop() sweep's ledger.
                self._ring_names.pop(conn, None)
                self._tm_conns.set(len(self._conns))


def serve_once(env_init: Callable, address: str):
    """Convenience: construct and run (blocking)."""
    EnvServer(env_init, address).run()
