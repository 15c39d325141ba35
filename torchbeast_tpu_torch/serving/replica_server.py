"""Remote replica serving: the replica tier pushed to separate hosts (the
port of torchbeast_tpu/serving/replica_server.py).

Replica routing answers acting requests from versioned policy snapshots.
In-process that is a DynamicBatcher + serving thread next to the
learner; this module makes the same tier PHYSICALLY pushable to the
env-server hosts over the port's wire/shm transport stack
(runtime/transport.py, runtime/wire.py, the reference's formats): the
learner keeps publishing snapshots, the acting requests never touch the
learner's devices, and the policy-lag contract (per-request stamps,
budget-gated degradation) is identical to the in-process path because
it runs through the SAME `ReplicaServingHooks`/`PolicySnapshotStore`
machinery, on the other side of a socket.

Three pieces:

- `ReplicaServer`: binds a transport address (unix:/shm:, the addresses
  env servers use), keeps a local `PolicySnapshotStore`, and serves two
  kinds of streams over it: snapshot publishes from the learner and
  acting requests from actor pools. Requests from ALL connections funnel
  through one local `DynamicBatcher` (continuous batching across links)
  drained by a serving thread that stamps `policy_lag` via
  `ReplicaServingHooks.begin_batch()`. Params arrive as numpy nests; a
  publish puts them on the server's `device` as tensors, and the hooks
  place each version there once (`latest_on`), so `act_fn` reads params
  already on the device and its outputs come back to the host in one
  copy (runtime/inference.to_host).
- `RemoteSnapshotPublisher`: the learner-side publish client. Mirrors
  the `PolicySnapshotStore` publish surface (`publish`/`note_update`)
  so a trainer's refresh tick can fan out to remote replicas with the
  code it already has. Tensors are sent as numpy (one copy to the host
  per publish).
- `RemoteReplicaBatcher`: the actor-side client, shaped like a
  DynamicBatcher (compute/size/is_closed/close) so it drops in as the
  replica leg of `serving.ReplicaRouter` unchanged. One transport stream
  per CALLING thread (actor threads already parallelize the pool), so
  the server's batcher sees concurrent rows to coalesce.

The protocol is the reference's (hello, publish, head, request, reply,
shed, error; PROTOCOL_VERSION 1), so either package's clients talk to
either package's server. The remote leg plugs into the PYTHON
ReplicaRouter (any compute-shaped object routes). The core's
ReplicaRouter routes between in-process native batchers; pointing it at
a remote tier means draining a native batcher into a
RemoteReplicaBatcher from a Python proxy thread, which `proxy_loop`
below does, so a native pool can still degrade onto a remote replica
host. Sheds propagate as typed `ShedError` replies either way. No driver
wires this tier, as in the reference.
"""

import logging
import socket
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from torchbeast_tpu_torch import nest
from torchbeast_tpu_torch.runtime import transport as transport_lib
from torchbeast_tpu_torch.runtime import wire
from torchbeast_tpu_torch.runtime.inference import to_host
from torchbeast_tpu_torch.runtime.errors import ShedError
from torchbeast_tpu_torch.runtime.transport import parse_address

log = logging.getLogger(__name__)

PROTOCOL_VERSION = 1


class ReplicaServer:
    """Serve acting requests from published snapshots over a transport
    address. `act_fn(params, inputs)` -> outputs nest (batched along
    `batch_dim`; tensors or numpy): `params` is the published nest as
    tensors on `device` (the bf16 publication round trip, restored to the
    published dtypes), `inputs` the batch's numpy nest; the server adds
    the policy_lag stamp. `device` None is the current CUDA device (the
    server runs on the card unless it is given the CPU)."""

    def __init__(self, act_fn: Callable[[Any, Any], Any], address: str,
                 *,
                 max_policy_lag: int = 20,
                 refresh_updates: int = 1,
                 batch_dim: int = 1,
                 max_batch_size: int = 64,
                 timeout_ms: float = 10.0,
                 shed_max_queue_depth: Optional[int] = None,
                 rng_seed: int = 0,
                 registry=None,
                 max_frame_bytes: Optional[int] = None,
                 device=None):
        from torchbeast_tpu_torch import telemetry
        from torchbeast_tpu_torch.runtime.queues import DynamicBatcher
        from torchbeast_tpu_torch.serving.admission import (
            AdmissionController,
        )
        from torchbeast_tpu_torch.serving.replica import ReplicaServingHooks
        from torchbeast_tpu_torch.serving.snapshot import (
            PolicySnapshotStore,
        )

        self._act_fn = act_fn
        self._device = (
            torch.device("cuda", torch.cuda.current_device())
            if device is None else torch.device(device)
        )
        self._address = address
        self._shm = transport_lib.is_shm_address(address)
        self._family, self._target = parse_address(address)
        self._max_frame_bytes = max_frame_bytes
        reg = registry if registry is not None else telemetry.get_registry()
        self.store = PolicySnapshotStore(
            refresh_updates=refresh_updates, registry=reg
        )
        self.hooks = ReplicaServingHooks(
            self.store,
            max_policy_lag=max_policy_lag,
            rng_seed=rng_seed,
            batch_dim=batch_dim,
            registry=reg,
            device=self._device,
        )
        admission = None
        if shed_max_queue_depth is not None:
            admission = AdmissionController(
                max_queue_depth=shed_max_queue_depth, registry=reg
            )
        self._batcher = DynamicBatcher(
            batch_dim=batch_dim,
            minimum_batch_size=1,
            maximum_batch_size=max_batch_size,
            timeout_ms=timeout_ms,
            telemetry_name="replica_server",
            admission=admission,
        )
        self._batch_dim = batch_dim
        self._sock = None  # guarded-by: self._lock
        self._conns = []  # guarded-by: self._lock
        self._threads = []  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._running = False  # guarded-by: self._lock
        self._stopped = False  # guarded-by: self._lock
        # conn -> shm segment names for live streams: stop()'s sweep
        # unlinks whatever a wedged stream thread didn't get to.
        self._ring_names = {}  # guarded-by: self._lock
        self._c_requests = reg.counter("replica_server.requests")
        self._c_publishes = reg.counter("replica_server.publishes")
        self._g_conns = reg.gauge("replica_server.connections")

    # -- serving ---------------------------------------------------------

    def _serving_loop(self):
        """Drain the shared batcher: one ctx+stamp per dispatched batch,
        identical to the in-process replica inference loop."""
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        it = iter(self._batcher)
        while True:
            try:
                batch = next(it)
            except StopIteration:
                return
            try:
                ctx, annotate = self.hooks.begin_batch()
                _version, params = ctx
                with torch.no_grad():
                    outputs = dict(to_host(
                        self._act_fn(params, batch.get_inputs())))
                annotate(outputs, len(batch))
                batch.set_outputs(outputs)
            except Exception as e:  # noqa: BLE001 — reply, don't die
                batch.fail(e)

    def _serve_stream(self, conn):
        stream = None
        msg = None
        try:
            stream = transport_lib.server_transport(
                conn, shm=self._shm,
                max_frame_bytes=self._max_frame_bytes,
            )
            if self._shm:
                with self._lock:
                    self._ring_names[conn] = stream.segment_names
            stream.send({"type": "hello", "version": PROTOCOL_VERSION})
            while True:
                msg, _ = stream.recv_sized()
                if msg is None:
                    break  # peer hung up
                kind = msg.get("type")
                if kind == "publish":
                    self.store.publish(int(msg["version"]),
                                       self._place(msg["params"]))
                    self._c_publishes.inc()
                    stream.send({"type": "ok", "version": msg["version"]})
                elif kind == "head":
                    self.store.note_update(int(msg["version"]))
                    stream.send({"type": "ok", "version": msg["version"]})
                elif kind == "request":
                    self._c_requests.inc()
                    try:
                        outputs = self._batcher.compute(msg["inputs"])
                    except ShedError as e:
                        stream.send({"type": "shed", "message": str(e)})
                        continue
                    stream.send({"type": "reply", "outputs": outputs})
                else:
                    raise wire.WireError(
                        f"replica server: unexpected message {kind!r}"
                    )
        except (wire.WireError, ConnectionError, BrokenPipeError,
                TimeoutError, OSError) as e:
            log.debug("Replica stream ended: %s", e)
        except Exception as e:  # noqa: BLE001 — report to peer, drop stream
            log.exception("Replica serving raised")
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
            if stream is not None:
                stream.close()
            else:
                conn.close()
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                self._ring_names.pop(conn, None)
                self._g_conns.set(len(self._conns))

    def _place(self, params):
        """A published numpy nest as tensors on the server's device (the
        store's bf16 cast runs there). Copies: the arrays are views of
        the transport's receive buffer."""
        return nest.map(
            lambda a: torch.from_numpy(np.array(a)).to(self._device),
            params)

    # -- lifecycle -------------------------------------------------------

    def run(self):
        sock = socket.socket(self._family, socket.SOCK_STREAM)
        if self._family == socket.AF_UNIX:
            import os

            try:
                os.unlink(self._target)
            except FileNotFoundError:
                pass
        else:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(self._target)
        sock.listen(16)
        with self._lock:
            if self._stopped:
                sock.close()
                return
            self._sock = sock
            self._running = True
        serving = threading.Thread(target=self._serving_loop, daemon=True)
        serving.start()
        with self._lock:
            self._threads.append(serving)
        log.info("ReplicaServer listening on %s", self._address)
        while True:
            with self._lock:
                if not self._running:
                    break
            try:
                conn, _ = sock.accept()
            except OSError:
                break  # closed by stop()
            with self._lock:
                if not self._running:
                    conn.close()
                    break
                self._conns.append(conn)
                self._g_conns.set(len(self._conns))
            t = threading.Thread(
                target=self._serve_stream, args=(conn,), daemon=True
            )
            t.start()
            with self._lock:
                self._threads = [
                    x for x in self._threads if x.is_alive()
                ] + [t]

    def start(self):
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        with self._lock:
            self._threads.append(t)

    def stop(self):
        with self._lock:
            self._stopped = True
            self._running = False
            sock = self._sock
        try:
            self._batcher.close()
        except RuntimeError:
            pass  # already closed
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            sock.close()
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2)
        with self._lock:
            leftovers = [
                name
                for names in self._ring_names.values()
                for name in names
            ]
            self._ring_names.clear()
        for name in leftovers:
            if transport_lib.unlink_segment(name):
                log.warning(
                    "ReplicaServer stop(): swept leaked shm segment %s",
                    name,
                )
        if self._family == socket.AF_UNIX:
            import os

            try:
                os.unlink(self._target)
            except FileNotFoundError:
                pass


class _StreamClient:
    """One lazily-connected request/reply stream with a send lock."""

    def __init__(self, address: str, timeout_s: float,
                 max_frame_bytes: Optional[int]):
        self._address = address
        self._timeout_s = timeout_s
        self._max_frame_bytes = max_frame_bytes
        self._stream = None
        self._lock = threading.Lock()

    def _connect(self):
        stream = transport_lib.connect_transport(
            self._address, timeout_s=self._timeout_s,
            max_frame_bytes=self._max_frame_bytes,
        )
        hello = stream.recv()
        if not isinstance(hello, dict) or hello.get("type") != "hello":
            stream.close()
            raise wire.WireError(
                f"replica server handshake: expected hello, got {hello!r}"
            )
        return stream

    def call(self, message: dict) -> dict:
        with self._lock:
            if self._stream is None:
                self._stream = self._connect()
            self._stream.send(message)
            reply = self._stream.recv()
        if reply is None:
            raise ConnectionError("replica server hung up")
        if reply.get("type") == "shed":
            raise ShedError(reply.get("message", "shed by replica server"))
        if reply.get("type") == "error":
            raise RuntimeError(
                f"replica server error: {reply.get('message')}"
            )
        return reply

    def close(self):
        with self._lock:
            if self._stream is not None:
                self._stream.close()
                self._stream = None


class RemoteSnapshotPublisher:
    """Learner-side publish client mirroring PolicySnapshotStore's
    publish surface, so a trainer's refresh tick can feed a remote
    replica host with the code it already has."""

    def __init__(self, address: str, timeout_s: float = 600,
                 max_frame_bytes: Optional[int] = None):
        self._client = _StreamClient(address, timeout_s, max_frame_bytes)

    def publish(self, version: int, params: Any) -> bool:
        """Send `params` (a nest of tensors or numpy arrays) as snapshot
        `version`: tensors go as numpy, one copy to the host."""
        self._client.call({
            "type": "publish", "version": int(version),
            "params": to_host(params),
        })
        return True

    def note_update(self, version: int) -> bool:
        self._client.call({"type": "head", "version": int(version)})
        return False  # refresh cadence is the local store's concern

    def close(self):
        self._client.close()


class RemoteReplicaBatcher:
    """Actor-side client, DynamicBatcher-shaped: drops in as the
    replica leg of serving.ReplicaRouter. One stream per calling
    thread — concurrent actor threads become concurrent rows in the
    server's batcher."""

    def __init__(self, address: str, timeout_s: float = 600,
                 max_frame_bytes: Optional[int] = None):
        self._address = address
        self._timeout_s = timeout_s
        self._max_frame_bytes = max_frame_bytes
        self._local = threading.local()
        self._clients = []  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: self._lock

    def _client(self) -> _StreamClient:
        client = getattr(self._local, "client", None)
        if client is None:
            client = _StreamClient(
                self._address, self._timeout_s, self._max_frame_bytes
            )
            self._local.client = client
            with self._lock:
                if self._closed:
                    raise RuntimeError("RemoteReplicaBatcher is closed")
                self._clients.append(client)
        return client

    def compute(self, inputs: Any, trace=None) -> Any:
        reply = self._client().call({"type": "request", "inputs": inputs})
        if reply.get("type") != "reply":
            raise wire.WireError(
                f"replica server: expected reply, got {reply.get('type')!r}"
            )
        return reply["outputs"]

    def size(self) -> int:
        return 0  # depth lives server-side; the router only logs this

    def is_closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            clients = list(self._clients)
        for client in clients:
            client.close()


def proxy_loop(native_batcher, remote: RemoteReplicaBatcher,
               concurrency: int = 4):
    """Drain a NATIVE replica batcher into a remote replica host: the
    bridge that lets the C++ ReplicaRouter's replica leg live on
    another machine. Each dispatched batch is forwarded whole (the
    native batcher already coalesced it); `concurrency` forwarding
    threads keep the link full. Returns when the batcher closes."""

    def forward():
        it = iter(native_batcher)
        while True:
            try:
                batch = it.__next__()
            except StopIteration:
                return
            try:
                batch.set_outputs(remote.compute(batch.get_inputs()))
            except Exception as e:  # noqa: BLE001 — reply, don't die
                batch.fail(e)

    threads = [
        threading.Thread(target=forward, daemon=True)
        for _ in range(max(1, concurrency))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
