"""The port's remote replica tier (torchbeast_tpu_torch/serving/
replica_server.py) against the reference's (torchbeast_tpu/serving/
replica_server.py), on the CPU:

- the reference's TestReplicaServer cases (tests/test_serving.py) on the
  port's classes, over a unix socket and an shm ring: publish then serve
  with the true policy_lag stamp, the remote leg inside the port's
  ReplicaRouter, a request before any publish failing loud, sheds
  arriving as typed ShedErrors;
- proxy_loop draining the port's C++ core's replica batcher into a
  remote replica host (tests/test_native_routing.py's case);
- wire interop: the reference's RemoteSnapshotPublisher and
  RemoteReplicaBatcher against the port's ReplicaServer, and the port's
  clients against the reference's ReplicaServer, over both transports,
  with the same replies as the same-package pairs.

Every blocking wait is bounded.
"""

import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from torchbeast_tpu.serving import replica_server as ref_rs
from torchbeast_tpu.telemetry.metrics import MetricsRegistry as RefRegistry
from torchbeast_tpu_torch.runtime.errors import ShedError
from torchbeast_tpu_torch.runtime.queues import DynamicBatcher
from torchbeast_tpu_torch.serving import (
    PolicySnapshotStore,
    ReplicaRouter,
    ReplicaServingHooks,
)
from torchbeast_tpu_torch.serving import replica_server as port_rs
from torchbeast_tpu_torch.telemetry.metrics import MetricsRegistry

WAIT_S = 10


def _act_fn(params, inputs):
    """Toy policy: action = int(w) per row; the logits carry w, so a
    reply shows WHICH snapshot served it (params are tensors on the
    port's server, jax arrays on the reference's)."""
    n = np.asarray(inputs["env"]).shape[1]
    w = float(np.asarray(params["w"]).reshape(-1)[0])
    return {
        "action": np.full((1, n), int(w), np.int32),
        "policy_logits": np.full((1, n, 2), w, np.float32),
    }


def _server(package, address, **kwargs):
    if package == "port":
        server = port_rs.ReplicaServer(
            _act_fn, address, max_policy_lag=5, batch_dim=1, timeout_ms=5,
            registry=MetricsRegistry(), device="cpu", **kwargs)
    else:
        server = ref_rs.ReplicaServer(
            _act_fn, address, max_policy_lag=5, batch_dim=1, timeout_ms=5,
            registry=RefRegistry(), **kwargs)
    server.start()
    return server


def _clients(package, address):
    mod = port_rs if package == "port" else ref_rs
    return (mod.RemoteSnapshotPublisher(address, timeout_s=WAIT_S),
            mod.RemoteReplicaBatcher(address, timeout_s=WAIT_S))


def _request(i=0):
    return {"env": np.full((1, 1, 3), i, np.float32)}


def _address(transport, tag):
    return f"{transport}:{os.path.join(tempfile.mkdtemp(), tag)}"


def _exchange(server_pkg, client_pkg, transport):
    """Publish w=7.5, run the head 3 past it, serve one request; publish
    w=9, serve again. The four replies' leaves."""
    address = _address(transport, f"rs_{server_pkg}_{client_pkg}")
    server = _server(server_pkg, address)
    publisher, client = _clients(client_pkg, address)
    try:
        publisher.publish(0, {"w": np.full((1,), 7.5, np.float32)})
        for v in (1, 2, 3):
            publisher.note_update(v)
        # Copies: a reply's arrays view the transport's receive buffer.
        first = {k: np.array(v) for k, v in
                 client.compute(_request()).items()}
        publisher.publish(3, {"w": np.full((1,), 9.0, np.float32)})
        second = {k: np.array(v) for k, v in
                  client.compute(_request(1)).items()}
    finally:
        client.close()
        publisher.close()
        server.stop()
    return [first, second]


@pytest.mark.parametrize("transport", ["unix", "shm"])
def test_publish_then_serve_stamps_lag(transport):
    """The port's server and clients over a real transport: the reply
    carries the serving snapshot's outputs and the true policy_lag stamp
    from the server-side store; a fresh publish drops it to zero."""
    first, second = _exchange("port", "port", transport)
    assert int(first["action"].reshape(-1)[0]) == 7
    assert first["policy_lag"].dtype == np.int32
    assert int(first["policy_lag"].reshape(-1)[0]) == 3
    assert int(second["action"].reshape(-1)[0]) == 9
    assert int(second["policy_lag"].reshape(-1)[0]) == 0


@pytest.mark.parametrize("transport", ["unix", "shm"])
@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "reference"), ("reference", "port")])
def test_wire_interop_with_the_reference(transport, server_pkg, client_pkg):
    """One package's clients against the other's server: the same
    replies, bit for bit, as the reference's clients against the
    reference's server (7.5 survives the bf16 publication exactly)."""
    got = _exchange(server_pkg, client_pkg, transport)
    want = _exchange("reference", "reference", transport)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert float(got[0]["policy_logits"].reshape(-1)[0]) == 7.5


def test_remote_leg_in_replica_router():
    """The remote batcher drops into the port's ReplicaRouter as the
    replica leg: healthy -> served remotely with stamps; the local
    hooks' lag budget still gates the route to central."""
    address = _address("unix", "rs_router")
    server = _server("port", address)
    registry = MetricsRegistry()
    store = PolicySnapshotStore(refresh_updates=1, registry=registry)
    hooks = ReplicaServingHooks(store, max_policy_lag=2, batch_dim=1,
                                registry=registry)
    publisher, remote = _clients("port", address)
    central = DynamicBatcher(batch_dim=1, timeout_ms=5)

    def serve_central():
        for batch in iter(central):
            batch.set_outputs({
                "action": np.full((1, len(batch)), -1, np.int32)})

    central_thread = threading.Thread(target=serve_central, daemon=True)
    central_thread.start()
    router = ReplicaRouter(central, remote, hooks, registry=registry)
    try:
        store.publish(0, {"w": torch.full((1,), 4.0)})
        publisher.publish(0, {"w": torch.full((1,), 4.0)})
        out = router.compute(_request())
        assert int(np.asarray(out["action"]).reshape(-1)[0]) == 4
        assert registry.counter("serving.replica_requests").value() == 1
        for v in range(1, 5):  # blow the local lag budget
            store.note_update(v)
        out = router.compute(_request())
        assert int(np.asarray(out["action"]).reshape(-1)[0]) == -1
        assert registry.counter("serving.central_requests").value() == 1
    finally:
        remote.close()
        publisher.close()
        central.close()
        central_thread.join(WAIT_S)
        server.stop()
    assert not central_thread.is_alive()


def test_unpublished_store_fails_loud_not_silent():
    """A request before the first publish is an error reply, raised on
    the client: never a hang or an unstamped reply."""
    address = _address("unix", "rs_empty")
    server = _server("port", address)
    client = port_rs.RemoteReplicaBatcher(address, timeout_s=WAIT_S)
    try:
        with pytest.raises((RuntimeError, ConnectionError)):
            client.compute(_request())
    finally:
        client.close()
        server.stop()


def test_shed_propagates_as_typed_error():
    """An admission-gated server sheds overload as a typed ShedError on
    the CLIENT side, keeping the pool's shed/retry contract across the
    wire."""
    address = _address("unix", "rs_shed")
    server = _server("port", address, shed_max_queue_depth=1,
                     max_batch_size=1)
    publisher, client = _clients("port", address)
    outcomes = {"served": 0, "shed": 0}
    lock = threading.Lock()

    def one(i):
        try:
            client.compute(_request(i))
            with lock:
                outcomes["served"] += 1
        except ShedError:
            with lock:
                outcomes["shed"] += 1

    try:
        publisher.publish(0, {"w": np.full((1,), 1.0, np.float32)})
        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert not any(t.is_alive() for t in threads)
        assert outcomes["served"] + outcomes["shed"] == 16
        assert outcomes["served"] > 0
    finally:
        client.close()
        publisher.close()
        server.stop()


def test_server_params_are_tensors_on_its_device():
    """A publish lands on the server's device once per version: act_fn
    reads tensors there, restored to the published dtype from bf16."""
    seen = []

    def act_fn(params, inputs):
        seen.append(params["w"])
        n = np.asarray(inputs["env"]).shape[1]
        return {"action": torch.zeros((1, n), dtype=torch.int32)}

    address = _address("unix", "rs_device")
    server = port_rs.ReplicaServer(act_fn, address, batch_dim=1,
                                   timeout_ms=5, registry=MetricsRegistry(),
                                   device="cpu")
    server.start()
    publisher, client = _clients("port", address)
    try:
        w = np.array([0.1, 3.0], np.float32)
        publisher.publish(0, {"w": w})
        out = client.compute(_request())
        client.compute(_request())
    finally:
        client.close()
        publisher.close()
        server.stop()
    assert np.asarray(out["action"]).dtype == np.int32
    assert all(torch.is_tensor(t) and t.device.type == "cpu" for t in seen)
    assert seen[0] is seen[1]  # one placement per version
    np.testing.assert_array_equal(
        seen[0].numpy(), torch.from_numpy(w).to(torch.bfloat16).float())


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_server_without_a_device_asks_for_the_card():
    """With no `device` the server takes the current CUDA device: where
    torch has no card it raises instead of serving from the CPU."""
    with pytest.raises((AssertionError, RuntimeError)):
        port_rs.ReplicaServer(_act_fn, _address("unix", "rs_card"),
                              registry=MetricsRegistry())


def _toolchain_gap():
    from torchbeast_tpu_torch.runtime import native_build

    try:
        native_build.check_toolchain()
    except native_build.NativeBuildError as e:
        return str(e)
    return None


def test_proxy_loop_bridges_native_batcher_to_remote():
    """proxy_loop drains the port's core's replica batcher (behind the
    core's ReplicaRouter) into a remote replica host."""
    gap = _toolchain_gap()
    if gap is not None:
        pytest.skip(gap)
    from torchbeast_tpu_torch.runtime import native_build

    core = native_build.load()
    address = _address("unix", "rs_native")
    server = _server("port", address)
    publisher, remote = _clients("port", address)
    central = core.DynamicBatcher(batch_dim=1)
    replica = core.DynamicBatcher(batch_dim=1)
    router = core.ReplicaRouter(central=central, replica=replica)
    proxy = threading.Thread(target=port_rs.proxy_loop,
                             args=(replica, remote), daemon=True)
    proxy.start()
    try:
        publisher.publish(0, {"w": np.full((1,), 6.0, np.float32)})
        router.set_serving(True)
        out = router.compute({"env": np.zeros((1, 1, 3), np.float32)})
        assert int(np.asarray(out["action"]).reshape(-1)[0]) == 6
        stamp = np.asarray(out["policy_lag"])
        assert stamp.dtype == np.int32 and int(stamp.reshape(-1)[0]) == 0
        tm = router.telemetry()
        assert tm["replica_requests"] == 1 and tm["central_requests"] == 0
    finally:
        central.close()
        replica.close()
        proxy.join(WAIT_S)
        remote.close()
        publisher.close()
        server.stop()
    assert not proxy.is_alive()


def test_stop_unlinks_the_unix_socket():
    address = _address("unix", "rs_stop")
    server = _server("port", address)
    path = address.split(":", 1)[1]
    deadline = time.monotonic() + WAIT_S
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert os.path.exists(path)
    server.stop()
    assert not os.path.exists(path)
