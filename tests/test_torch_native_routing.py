"""The port's C++ core's split routing (`_tbt_core_torch.SliceRouter`,
`slice_for_slot`, `splitmix64`; csrc/native/routing.h) against the
port's Python SliceRouter (parallel/sebulba.py) and the reference's
placement hash, on the CPU (tests/test_native_routing.py's families):

- the core's slot -> slice hash equal to the port's and the reference's
  for slots 0-4095 and negative slots;
- the core's SliceRouter sends every slot's request to that slice, and
  round-robins slot-less requests;
- routing bit-identity over a unix socket and an shm ring: one actor in
  slot mode through two slice batchers behind the core's router (the
  core's pool) and behind the Python router (the port's Python pool),
  with tests/test_torch_native.py's Counting server and slot-table
  serving: bit-identical learner batches, every request on the hashed
  slice;
- the per-slice telemetry fold (runtime/native.NativeTelemetryFolder)
  onto the Python serving plane's `inference.slice.<i>.*` series.

The module builds the core once (skipping only without a C++ compiler or
Python.h). Every blocking wait is bounded.
"""

import os
import tempfile
import threading

import numpy as np
import pytest
import torch

from torchbeast_tpu.runtime import placement as ref_placement
from torchbeast_tpu_torch import nest, parallel, telemetry
from torchbeast_tpu_torch.runtime import native_build, placement
from tests.test_torch_native import (
    _HostSlotTable,
    _serve_slots,
    _start_server,
)

T = 4
WAIT_S = 30


def _toolchain_gap():
    try:
        native_build.check_toolchain()
    except native_build.NativeBuildError as e:
        return str(e)
    return None


_GAP = _toolchain_gap()
pytestmark = pytest.mark.skipif(_GAP is not None, reason=str(_GAP))


@pytest.fixture(scope="module")
def core():
    return native_build.load()


SLOTS = list(range(4096)) + [-1, -2, -4096, 2 ** 40, -(2 ** 40)]


@pytest.mark.parametrize("n_slices", [1, 2, 3, 8])
def test_core_hash_matches_both_packages(core, n_slices):
    ours = placement.DeviceSplit("t", (torch.device("cpu"),) * n_slices,
                                 (torch.device("cpu"),))
    got = [core.slice_for_slot(s, n_slices) for s in SLOTS]
    assert got == [ours.slice_for_slot(s) for s in SLOTS]
    assert got == [ref_placement._mix64(s) % n_slices for s in SLOTS]
    for s in SLOTS[:64]:
        assert core.splitmix64(s & 0xFFFFFFFFFFFFFFFF) == placement._mix64(s)


def _serve(batcher, tag, seen):
    """Reply to every batch with the slice's tag; record the slots."""
    it = iter(batcher)
    while True:
        try:
            batch = next(it)
        except StopIteration:
            return
        inputs = batch.get_inputs()
        if "slot" in inputs:
            seen.extend(np.asarray(inputs["slot"]).reshape(-1).tolist())
        batch.set_outputs({"slice": np.full((1, len(batch)), tag,
                                            np.int32)})


def test_core_slice_router_routes_every_slot_to_its_slice(core):
    n = 3
    batchers = [core.DynamicBatcher(batch_dim=1, timeout_ms=5)
                for _ in range(n)]
    seen = [[] for _ in range(n)]
    servers = [threading.Thread(target=_serve, args=(b, i, seen[i]),
                                daemon=True)
               for i, b in enumerate(batchers)]
    for t in servers:
        t.start()
    router = core.SliceRouter(slices=batchers)
    split = placement.DeviceSplit("t", (torch.device("cpu"),) * n,
                                  (torch.device("cpu"),))
    try:
        assert router.n_slices() == n
        for slot in range(64):
            out = router.compute({"slot": np.full((1, 1), slot, np.int32),
                                  "env": np.zeros((1, 1, 2), np.float32)})
            assert int(np.asarray(out["slice"]).reshape(-1)[0]) == (
                split.slice_for_slot(slot))
        counts = list(router.telemetry()["requests"])
        assert counts == [sum(split.slice_for_slot(s) == i
                              for s in range(64)) for i in range(n)]
        for _ in range(6):  # slot-less: round-robin
            router.compute({"env": np.zeros((1, 1, 2), np.float32)})
        assert list(router.telemetry()["requests"]) == [
            c + 2 for c in counts]
    finally:
        router.close()
        for t in servers:
            t.join(WAIT_S)
    assert router.is_closed()
    assert not any(t.is_alive() for t in servers)
    with pytest.raises(ValueError):
        core.SliceRouter(slices=[])


def _collect(core, kind, address, n_items):
    """One actor in slot mode through two slice batchers behind the
    router of `kind`; (items, per-slice request counts)."""
    from torchbeast_tpu_torch.runtime.actor_pool import ActorPool
    from torchbeast_tpu_torch.runtime.queues import (
        BatchingQueue,
        DynamicBatcher,
    )

    table = _HostSlotTable(num_slots=1)
    if kind == "native":
        queue = core.BatchingQueue(batch_dim=1, minimum_batch_size=1,
                                   maximum_batch_size=1)
        batchers = [core.DynamicBatcher(batch_dim=1, timeout_ms=20)
                    for _ in range(2)]
        router = core.SliceRouter(slices=batchers)
        pool_cls = core.ActorPool
        counts = lambda: list(router.telemetry()["requests"])  # noqa: E731
    else:
        registry = telemetry.MetricsRegistry()
        queue = BatchingQueue(batch_dim=1, minimum_batch_size=1,
                              maximum_batch_size=1)
        batchers = [DynamicBatcher(batch_dim=1, timeout_ms=20)
                    for _ in range(2)]
        stacks = [parallel.SliceStack(i, None, b, None, None, None)
                  for i, b in enumerate(batchers)]
        split = placement.DeviceSplit(
            "t", (torch.device("cpu"),) * 2, (torch.device("cpu"),))
        router = parallel.SliceRouter(split, stacks, registry=registry)
        pool_cls = ActorPool
        counts = lambda: [  # noqa: E731
            registry.counter(f"inference.slice.{i}.requests").value()
            for i in range(2)]
    pool = pool_cls(unroll_length=T, learner_queue=queue,
                    inference_batcher=router, env_server_addresses=[address],
                    initial_agent_state=table.initial_state_host,
                    state_table=table)
    servers = [threading.Thread(target=_serve_slots, args=(b, table),
                                daemon=True) for b in batchers]
    for s in servers:
        s.start()
    pool_thread = threading.Thread(target=pool.run, daemon=True)
    pool_thread.start()
    items, done = [], threading.Event()

    def take():
        it = iter(queue)
        try:
            while len(items) < n_items:
                item = next(it)
                items.append(item[0] if isinstance(item, tuple) else item)
        except StopIteration:
            pass
        done.set()

    threading.Thread(target=take, daemon=True).start()
    finished = done.wait(WAIT_S)
    for b in batchers:
        b.close()
    queue.close()
    pool_thread.join(10)
    for s in servers:
        s.join(10)
    assert finished and len(items) == n_items, f"{len(items)} items"
    flat = [[np.asarray(leaf) for leaf in nest.flatten(item)]
            for item in items]
    return flat, counts()


@pytest.mark.parametrize("transport", ["unix", "shm"])
def test_native_routing_bit_identical(core, transport):
    """Same slot -> same slice -> same reply, either language, over a
    real transport: bit-identical learner batches and every request on
    the hash-designated slice."""
    expected = placement._mix64(0) % 2  # the one actor serves slot 0
    results = {}
    for kind in ("native", "python"):
        address = (f"{transport}:"
                   f"{os.path.join(tempfile.mkdtemp(), f'route_{kind}')}")
        server = _start_server(core, address)
        try:
            results[kind] = _collect(core, kind, address, 5)
        finally:
            server.stop()
    (native_items, native_counts), (python_items, python_counts) = (
        results["native"], results["python"])
    for counts in (native_counts, python_counts):
        assert counts[1 - expected] == 0 and counts[expected] > 0
    assert len(native_items) == len(python_items) == 5
    for a, b in zip(native_items, python_items):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_native_per_slice_telemetry_fold(core):
    """NativeTelemetryFolder folds the core's router and slice batchers
    into the Python serving plane's series: per-slice requests counters
    (deltas), depth gauges."""
    from torchbeast_tpu_torch.runtime.native import NativeTelemetryFolder

    batchers = [core.DynamicBatcher(batch_dim=1, timeout_ms=5)
                for _ in range(2)]
    router = core.SliceRouter(slices=batchers)
    seen = []
    server = threading.Thread(target=_serve, args=(batchers[1], 1, seen),
                              daemon=True)
    server.start()
    # Slot 0 hashes to slice 1 (splitmix64(0) is odd).
    router.compute({"slot": np.zeros((1, 1), np.int32),
                    "env": np.zeros((1, 1, 2), np.float32)})
    registry = telemetry.MetricsRegistry()
    folder = NativeTelemetryFolder(registry, slice_batchers=batchers,
                                   slice_router=router)
    folder.tick()
    assert registry.counter("inference.slice.1.requests").value() == 1
    assert registry.counter("inference.slice.0.requests").value() == 0
    assert registry.gauge("inference.slice.0.depth").value() == 0
    assert registry.gauge("inference.slice.1.depth").value() == 0
    folder.tick()  # deltas: nothing new
    assert registry.counter("inference.slice.1.requests").value() == 1
    router.close()
    server.join(WAIT_S)
    assert not server.is_alive() and seen == [0]
