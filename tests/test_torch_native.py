"""The port's C++ runtime core (`_tbt_core_torch`, built from
torchbeast_tpu_torch/csrc/native/ by runtime/native_build.py) on the CPU:

- the runtime cases of tests/test_native.py, driven through the port's
  core and the port's Python modules: queue and batcher semantics and
  errors, the reference-leak check, the pool end to end against a
  Counting env server, the wire codec against the port's wire.py and the
  JAX package's, the arena intake, shm end to end with a crash, a
  reconnect and the /dev/shm sweep, the telemetry fold (counters,
  histograms and sampled request spans), the adaptive doorbell recheck
  and the reconnect counts;
- the port's native ActorPool against the JAX package's Python ActorPool
  (the reference semantics) on the same deterministic Counting servers,
  one actor, one deterministic inference function: bit-identical
  learner batches, with agent state on the wire and through a slot
  table;
- the C++ env server against the port's Python pool;
- import purity: building and loading the core loads neither jax nor
  the JAX package.

The module builds the core once (skipping only where no C++ compiler or
no Python.h is found). Every blocking wait is bounded, and each test runs
under a watchdog that dumps the stacks and ends the process if it hangs.
"""

import faulthandler
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from torchbeast_tpu_torch import nest
from torchbeast_tpu_torch.runtime import native, native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODE_LEN = 5
T = 3
TEST_TIMEOUT_S = 240  # the first test of a worker may wait for the build
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


@pytest.fixture(autouse=True)
def _per_test_timeout():
    """A hung test dumps every thread's stack and ends its process."""
    faulthandler.dump_traceback_later(TEST_TIMEOUT_S, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _take(queue, n, closers=(), timeout_s=WAIT_S):
    """The first `n` items `queue` yields; fails after `timeout_s`,
    closing `closers` first so no thread of the test stays blocked."""
    out, done = [], threading.Event()

    def run():
        try:
            it = iter(queue)
            while len(out) < n:
                out.append(next(it))
        except StopIteration:
            pass
        finally:
            done.set()

    threading.Thread(target=run, daemon=True).start()
    if not done.wait(timeout_s):
        for closer in closers:
            closer.close()
        pytest.fail(f"{len(out)} of {n} items within {timeout_s} s")
    assert len(out) == n, f"the queue closed after {len(out)} of {n} items"
    return out


def _run_thread(target, *args):
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    return t


# ------------------------------------------------------------------ build


def test_build_is_cached_and_named(core):
    path = native_build.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "torch_native")
    assert os.path.basename(path).startswith("_tbt_core_torch_")
    assert core.__name__ == "_tbt_core_torch"
    assert native_build.load() is core
    assert native_build.build() == path  # on disk: no second compile
    assert native.gap_reason(core) is None
    assert core.API_VERSION >= native.REQUIRED_API_VERSION
    assert core.BatchingQueue.__module__ == "_tbt_core_torch"
    from torchbeast_tpu_torch.runtime.errors import ShedError

    assert issubclass(core.ShedError, ShedError)
    assert issubclass(core.ShedError, core.AsyncError)


def test_kernel_hash_does_not_see_the_core():
    from torchbeast_tpu_torch.ops import _build

    assert not any(os.sep + "native" + os.sep in s for s in _build.sources())
    assert all(s.endswith((".cu", ".cuh")) for s in _build.sources())


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SOURCE_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "out"))
    (tmp_path / "pymodule.cc").write_text('#include "bad.cc"\n')
    with pytest.raises(native_build.NativeBuildError,
                       match="build failed") as info:
        native_build.build()
    assert "bad.cc" in str(info.value)


def test_missing_compiler_and_header_raise(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    with pytest.raises(native_build.NativeBuildError, match="compiler"):
        native_build.check_toolchain()
    monkeypatch.undo()
    monkeypatch.setattr(native_build, "_include_dirs",
                        lambda: (str(tmp_path), str(tmp_path)))
    with pytest.raises(native_build.NativeBuildError, match="Python.h"):
        native_build.check_toolchain()


def test_loading_the_core_imports_no_jax():
    code = (
        "import sys\n"
        "from torchbeast_tpu_torch.runtime import native\n"
        "core = native.import_native()\n"
        "assert core is not None, native.gap_reason()\n"
        "q = core.BatchingQueue()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'torchbeast_tpu', "
        "'_tbt_core', 'torch'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------- queue and batcher


class TestNativeBatchingQueue:
    def test_construction_errors(self, core):
        with pytest.raises(ValueError):
            core.BatchingQueue(minimum_batch_size=0)
        with pytest.raises(ValueError):
            core.BatchingQueue(minimum_batch_size=4, maximum_batch_size=2)

    def test_enqueue_dequeue_roundtrip(self, core):
        queue = core.BatchingQueue(batch_dim=0, minimum_batch_size=2)
        queue.enqueue({"x": np.full((1, 3), 1.5, np.float32)})
        queue.enqueue({"x": np.full((1, 3), 2.5, np.float32)})
        batch, count = queue.dequeue_many()
        assert count == 2
        assert batch["x"].shape == (2, 3)
        np.testing.assert_array_equal(batch["x"][:, 0], [1.5, 2.5])

    def test_close_semantics(self, core):
        queue = core.BatchingQueue()
        queue.close()
        with pytest.raises(core.ClosedBatchingQueue):
            queue.enqueue(np.zeros((1, 1)))
        with pytest.raises(RuntimeError):
            queue.close()
        with pytest.raises(StopIteration):
            next(iter(queue))

    def test_validation(self, core):
        queue = core.BatchingQueue(batch_dim=1)
        with pytest.raises(ValueError):
            queue.enqueue(np.zeros(3))  # too few dims

    def test_iteration_blocks_until_item(self, core):
        queue = core.BatchingQueue(batch_dim=0, minimum_batch_size=1)
        _run_thread(lambda: (time.sleep(0.05), queue.enqueue(
            [np.full((1, 2), 7, np.int64)])))
        (batch,) = _take(queue, 1, closers=[queue])
        np.testing.assert_array_equal(batch[0], [[7, 7]])

    def test_stress(self, core):
        queue = core.BatchingQueue(
            batch_dim=0, minimum_batch_size=1, maximum_batch_size=16
        )
        n_producers, items = 8, 100
        got = []
        lock = threading.Lock()

        def producer(p):
            for i in range(items):
                queue.enqueue(np.full((1,), p * items + i, np.int64))

        def consumer():
            while True:
                try:
                    batch, _ = queue.dequeue_many()
                except StopIteration:
                    return
                with lock:
                    got.extend(batch.tolist())

        consumers = [_run_thread(consumer) for _ in range(4)]
        producers = [_run_thread(producer, p) for p in range(n_producers)]
        for t in producers:
            t.join(WAIT_S)
        deadline = time.monotonic() + WAIT_S
        while queue.size() and time.monotonic() < deadline:
            time.sleep(0.01)
        queue.close()
        for t in consumers:
            t.join(10)
        assert sorted(got) == list(range(n_producers * items))


class TestNativeDynamicBatcher:
    def test_request_response(self, core):
        batcher = core.DynamicBatcher(batch_dim=0)
        result = {}

        def producer():
            result["out"] = batcher.compute(
                {"x": np.arange(4, dtype=np.float32).reshape(1, 4)}
            )

        t = _run_thread(producer)
        (batch,) = _take(batcher, 1, closers=[batcher])
        inputs = batch.get_inputs()
        assert len(batch) == 1
        batch.set_outputs({"y": inputs["x"] * 10})
        t.join(WAIT_S)
        np.testing.assert_array_equal(result["out"]["y"], [[0, 10, 20, 30]])

    def test_batched_rows_sliced_back(self, core):
        batcher = core.DynamicBatcher(batch_dim=0, minimum_batch_size=3)
        outs = {}

        def producer(i):
            outs[i] = batcher.compute(np.full((1, 2), i, np.int64))

        threads = [_run_thread(producer, i) for i in range(3)]
        (batch,) = _take(batcher, 1, closers=[batcher])
        inputs = batch.get_inputs()
        assert inputs.shape == (3, 2)
        batch.set_outputs(inputs + 100)
        for t in threads:
            t.join(WAIT_S)
        for i in range(3):
            np.testing.assert_array_equal(outs[i], [[i + 100, i + 100]])

    def test_dropped_batch_breaks_promise(self, core):
        batcher = core.DynamicBatcher(batch_dim=0)
        caught = {}

        def producer():
            try:
                batcher.compute(np.zeros((1, 1)))
            except core.AsyncError as e:
                caught["err"] = e

        t = _run_thread(producer)
        batches = _take(batcher, 1, closers=[batcher])
        del batches
        t.join(WAIT_S)
        assert "err" in caught

    def test_close_wakes_producers(self, core):
        batcher = core.DynamicBatcher(batch_dim=0)
        caught = {}

        def producer():
            try:
                batcher.compute(np.zeros((1, 1)))
            except core.AsyncError as e:
                caught["err"] = e

        t = _run_thread(producer)
        time.sleep(0.1)
        batcher.close()
        t.join(WAIT_S)
        assert "err" in caught

    def test_set_outputs_twice_raises(self, core):
        batcher = core.DynamicBatcher(batch_dim=0)
        t = _run_thread(lambda: batcher.compute(np.zeros((1, 1))))
        (batch,) = _take(batcher, 1, closers=[batcher])
        batch.set_outputs(np.zeros((1, 1)))
        with pytest.raises(RuntimeError):
            batch.set_outputs(np.zeros((1, 1)))
        t.join(WAIT_S)

    def test_inputs_are_writable_views_torch_can_wrap(self, core):
        """The inference loop hands the batch's inputs to
        torch.from_numpy (runtime/inference.to_device): they must be
        writable (no warning) and valid while the batch lives."""
        import warnings

        import torch

        batcher = core.DynamicBatcher(batch_dim=1)
        t = _run_thread(lambda: batcher.compute(
            {"frame": np.full((1, 1, 4), 3, np.uint8)}))
        (batch,) = _take(batcher, 1, closers=[batcher])
        frame = batch.get_inputs()["frame"]
        assert frame.flags.writeable
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            wrapped = torch.from_numpy(np.ascontiguousarray(frame))
        assert wrapped.tolist() == [[[3, 3, 3, 3]]]
        batch.set_outputs({"y": np.zeros((1, 1), np.float32)})
        t.join(WAIT_S)


def test_conversion_does_not_leak_references(core):
    """enqueue/dequeue round trips leak no reference to the inputs, and
    dequeued outputs keep their own buffer alive."""
    import gc

    arr = np.arange(6, dtype=np.float32).reshape(1, 6)
    baseline_rc = sys.getrefcount(arr)
    queue = core.BatchingQueue(batch_dim=0, minimum_batch_size=1)
    for _ in range(10):
        queue.enqueue({"x": arr})
        out, _ = queue.dequeue_many()
        del out
    queue.close()
    del queue
    gc.collect()
    assert sys.getrefcount(arr) == baseline_rc

    queue = core.BatchingQueue(batch_dim=0, minimum_batch_size=1)
    src = np.full((1, 4), 7.0)
    queue.enqueue(src)
    out, _ = queue.dequeue_many()
    del src
    gc.collect()
    np.testing.assert_array_equal(out, [[7.0, 7.0, 7.0, 7.0]])
    queue.close()


# ------------------------------------------------------------ env servers


def _counting():
    from torchbeast_tpu_torch.envs import CountingEnv

    return CountingEnv(episode_length=EPISODE_LEN)


def _wait_bound(path, proc=None, timeout_s=WAIT_S):
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            if proc is not None:
                proc.kill()
            raise TimeoutError(f"no server bound {path}")
        time.sleep(0.01)


class _NativeServer:
    """start()/stop() around the C++ env server, whose run() blocks."""

    def __init__(self, core, env_init, address):
        self._server = core.EnvServer(env_init, address)
        self._thread = None

    def start(self):
        self._thread = _run_thread(self._server.run)

    def stop(self):
        self._server.stop()
        self._thread.join(5)


def _start_server(core, address, impl="python"):
    """A Counting env server on `address` (unix: or shm:), bound."""
    from torchbeast_tpu_torch.runtime.env_server import EnvServer

    if impl == "native":
        server = _NativeServer(core, _counting, address)
    else:
        server = EnvServer(_counting, address)
    server.start()
    _wait_bound(address.split(":", 1)[1])
    return server


# ------------------------------------------------------------ actor pools


def _serve_state(batcher):
    """Inference thread body: CountingEnv dynamics with the agent state
    on the wire (state = where(done, 0, prev) + 1)."""
    it = iter(batcher)
    while True:
        try:
            batch = next(it)
        except StopIteration:
            return
        inputs = batch.get_inputs()
        done = np.asarray(inputs["env"]["done"])
        state = np.where(done, 0, inputs["agent_state"]) + 1
        batch.set_outputs({
            "outputs": {
                "action": (state % 2).astype(np.int32),
                "policy_logits": state[..., None].astype(np.float32),
                "baseline": state.astype(np.float32),
            },
            "agent_state": state.astype(np.int64),
        })


class _HostSlotTable:
    """A host stand-in for runtime.state_table.DeviceStateTable: the
    reset / read_slot / initial_state_host / trash_slot surface both
    pools use, its state advanced by the serving thread."""

    def __init__(self, num_slots):
        self.num_slots = num_slots
        self.initial_state_host = {"s": np.zeros((1, 1), np.int64)}
        self._values = {}

    @property
    def trash_slot(self):
        return self.num_slots

    def get(self, slot):
        return self._values.get(int(slot), 0)

    def set(self, slot, value):
        self._values[int(slot)] = int(value)

    def reset(self, slots):
        for s in slots:
            self._values[int(s)] = 0

    def read_slot(self, slot):
        return {"s": np.full((1, 1), self.get(slot), np.int64)}


def _serve_slots(batcher, table):
    """Inference thread body over the slot table: replies carry the
    outputs only."""
    it = iter(batcher)
    while True:
        try:
            batch = next(it)
        except StopIteration:
            return
        inputs = batch.get_inputs()
        slots = np.asarray(inputs["slot"]).reshape(-1)
        advance = np.asarray(inputs["advance"]).reshape(-1)
        done = np.asarray(inputs["env"]["done"])[0].astype(bool)
        prev = np.array([table.get(s) for s in slots], np.int64)
        new = np.where(done, 0, prev) + 1
        for j, slot in enumerate(slots):
            if advance[j]:
                table.set(slot, new[j])
        batch.set_outputs({"outputs": {
            "action": (new[None] % 2).astype(np.int32),
            "policy_logits": new[None, :, None].astype(np.float32),
            "baseline": new[None].astype(np.float32),
        }})


_KINDS = {
    # kind -> (queue and batcher module, pool class), imported lazily
    "native": None,
    "reference": ("torchbeast_tpu.runtime.queues",
                  "torchbeast_tpu.runtime.actor_pool"),
    "port": ("torchbeast_tpu_torch.runtime.queues",
             "torchbeast_tpu_torch.runtime.actor_pool"),
}


class _Pool:
    """One actor through the native, the reference's or the port's
    Python pool, with an inference thread serving its batcher.
    `queue_size` bounds the learner queue (unbounded by default): a test
    that takes rollouts after a fault bounds it to 1, so that at most two
    rollouts of before the fault (one queued, one blocked on the full
    queue) can stand ahead of those of the recovered stream, however far
    the actor ran ahead of a test thread slowed by a loaded host."""

    def __init__(self, core, kind, address, slots=False, max_reconnects=0,
                 queue_size=None, **pool_kwargs):
        import importlib

        if kind == "native":
            queues, pool_cls = core, core.ActorPool
        else:
            queues_name, pool_name = _KINDS[kind]
            queues = importlib.import_module(queues_name)
            pool_cls = importlib.import_module(pool_name).ActorPool
        self.kind = kind
        self.learner_queue = queues.BatchingQueue(
            batch_dim=1, minimum_batch_size=1, maximum_batch_size=1,
            maximum_queue_size=queue_size)
        self.batcher = queues.DynamicBatcher(batch_dim=1, timeout_ms=20)
        if slots:
            table = _HostSlotTable(num_slots=1)
            initial = table.initial_state_host
            pool_kwargs["state_table"] = table
            serve = (_serve_slots, self.batcher, table)
        else:
            initial = np.zeros((1, 1), np.int64)
            serve = (_serve_state, self.batcher)
        self.serve_thread = _run_thread(*serve)
        self.pool = pool_cls(
            unroll_length=T, learner_queue=self.learner_queue,
            inference_batcher=self.batcher,
            env_server_addresses=[address], initial_agent_state=initial,
            max_reconnects=max_reconnects, **pool_kwargs)
        self.pool_thread = _run_thread(self.pool.run)

    def take(self, n):
        items = _take(self.learner_queue, n,
                      closers=[self.batcher, self.learner_queue])
        # The Python queue yields the batch alone, the core's the item.
        return [item[0] if isinstance(item, tuple) else item
                for item in items]

    def close(self):
        self.batcher.close()
        self.learner_queue.close()
        self.pool_thread.join(10)
        self.serve_thread.join(10)


def _flat(items):
    return [[np.asarray(leaf) for leaf in nest.flatten(item)]
            for item in items]


@pytest.mark.parametrize("slots", [False, True], ids=["state", "slots"])
def test_native_pool_matches_the_reference_pool(core, slots):
    """The same Counting env stream and the same inference function
    through the port's C++ pool and the JAX package's Python pool (the
    reference semantics): bit-identical learner batches."""
    flat = {}
    for kind in ("native", "reference"):
        path = os.path.join(tempfile.mkdtemp(), f"parity_{kind}")
        server = _start_server(core, f"unix:{path}")
        pool = _Pool(core, kind, f"unix:{path}", slots=slots)
        try:
            flat[kind] = _flat(pool.take(6))
        finally:
            pool.close()
            server.stop()
    assert len(flat["native"]) == len(flat["reference"]) == 6
    for native_item, ref_item in zip(flat["native"], flat["reference"]):
        assert len(native_item) == len(ref_item)
        for native_leaf, ref_leaf in zip(native_item, ref_item):
            assert native_leaf.dtype == ref_leaf.dtype
            assert native_leaf.shape == ref_leaf.shape
            assert native_leaf.tobytes() == ref_leaf.tobytes()


@pytest.mark.parametrize("server_impl", ["python", "native"])
def test_native_actor_pool_end_to_end(core, server_impl):
    """C++ actor loops against a Counting env server (the port's Python
    one and the core's), the inference thread serving the core's batcher,
    rollouts into the core's learner queue: the on-policy invariants
    hold."""
    path = os.path.join(tempfile.mkdtemp(), "native_env")
    server = _start_server(core, f"unix:{path}", server_impl)
    pool = _Pool(core, "native", f"unix:{path}")
    try:
        items = pool.take(6)
    finally:
        pool.close()
        server.stop()
    assert pool.pool.count() >= 6 * T
    _check_rollouts(items)


def _check_rollouts(items):
    prev = None
    for item in items:
        batch = item["batch"]
        initial_state = item["initial_agent_state"]
        assert batch["frame"].shape[:2] == (T + 1, 1)
        if prev is not None:
            for key in batch:
                np.testing.assert_array_equal(batch[key][0], prev[key][-1],
                                              err_msg=key)
        done0 = batch["done"][0]
        expected = np.where(done0, 0, initial_state[0]) + 1
        np.testing.assert_array_equal(batch["baseline"][1], expected)
        assert (batch["frame"][batch["done"].astype(bool)] == 0).all()
        np.testing.assert_array_equal(batch["action"][1:],
                                      batch["last_action"][1:])
        prev = batch


def test_native_env_server_serves_the_port_python_pool(core):
    """The core's env server speaks the port's Python pool's protocol:
    the same batches as the port's Python server gives that pool."""
    flat = {}
    for impl in ("python", "native"):
        path = os.path.join(tempfile.mkdtemp(), f"server_{impl}")
        server = _start_server(core, f"unix:{path}", impl)
        pool = _Pool(core, "port", f"unix:{path}")
        try:
            flat[impl] = _flat(pool.take(4))
        finally:
            pool.close()
            server.stop()
    for a, b in zip(flat["python"], flat["native"]):
        assert [x.tobytes() for x in a] == [x.tobytes() for x in b]


# ------------------------------------------------------------ wire codec


def _norm(v):
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in sorted(v.items())}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.shape, v.tobytes())
    return v


def _sorted_keys(v):
    if isinstance(v, dict):
        return {k: _sorted_keys(x) for k, x in sorted(v.items())}
    return v


def _codec_messages():
    rng = np.random.default_rng(7)
    yield {"type": "step", "frame": rng.integers(0, 255, (4, 3), np.uint8),
           "reward": np.asarray(np.float32(0.5)), "done": np.asarray(False),
           "n": 7, "f": 1.5, "s": "hello", "none": None,
           "lst": [1, 2.0, "x", None, True]}
    yield {"scalars": [np.int32(3), np.float64(2.5), np.bool_(True)],
           "empty": np.zeros((0, 5), np.float32),
           "zerod": np.asarray(np.int64(-9))}
    yield {"dtypes": [np.zeros(3, dt) for dt in (
        np.uint8, np.int8, np.int32, np.int64, np.float32, np.float64,
        np.bool_, np.uint16, np.int16, np.uint32, np.uint64, np.float16)]}


@pytest.mark.parametrize("package", ["torchbeast_tpu_torch",
                                     "torchbeast_tpu"])
def test_wire_codec_cross_language(core, package):
    """The core's codec against the port's wire.py and the JAX
    package's: equal bytes for sorted-key dicts, and each decodes the
    other's frames."""
    import importlib

    wire = importlib.import_module(f"{package}.runtime.wire")
    for msg in _codec_messages():
        smsg = _sorted_keys(msg)
        assert core.wire_encode(smsg) == wire.encode(smsg)
        assert _norm(core.wire_decode(wire.encode(msg))) == _norm(msg)
        assert _norm(wire.decode(core.wire_encode(msg)[4:])) == _norm(msg)


def test_wire_codec_bf16_roundtrip(core):
    """bf16 (wire code 12) where ml_dtypes is installed: the core's bytes
    equal the port's wire.py's both ways (the port's f32 path sends
    none)."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    from torchbeast_tpu_torch.runtime import wire

    bf = np.arange(-6, 6, dtype=ml_dtypes.bfloat16).reshape(3, 4)
    assert core.wire_encode({"x": bf}) == wire.encode({"x": bf})
    for decoded in (core.wire_decode(wire.encode({"x": bf}))["x"],
                    wire.decode(core.wire_encode({"x": bf})[4:])["x"]):
        assert decoded.dtype == np.dtype(ml_dtypes.bfloat16)
        assert decoded.tobytes() == bf.tobytes()


# ------------------------------------------------------------ arena intake


def _rollout_item(seed):
    rng = np.random.default_rng(seed)
    return {
        "batch": {
            "frame": rng.integers(0, 255, (6, 1, 4, 4), np.uint8),
            "reward": rng.normal(size=(6, 1)).astype(np.float32),
        },
        "initial_agent_state": rng.normal(size=(1, 1, 3)).astype(np.float32),
    }


def test_native_arena_intake_bit_identical(core):
    """dequeue_item drains the core's queue through the port's
    BatchArena (--superstep_k) bit-identically to the Python queue."""
    from torchbeast_tpu_torch.runtime.queues import BatchArena, BatchingQueue

    items = [_rollout_item(s) for s in range(4)]
    native_q = core.BatchingQueue(batch_dim=1, minimum_batch_size=2,
                                  maximum_batch_size=2)
    python_q = BatchingQueue(batch_dim=1, minimum_batch_size=2,
                             maximum_batch_size=2)
    for item in items:
        native_q.enqueue(item)
        python_q.enqueue(item)
    stacks = []
    for queue in (native_q, python_q):
        arena = BatchArena(k=2, rows=2, batch_dim=1)
        stacked, release = arena.assemble_from(queue)
        stacks.append([np.asarray(a).copy() for a in nest.flatten(stacked)])
        release()
    assert len(stacks[0]) == len(stacks[1])
    for native_leaf, python_leaf in zip(*stacks):
        assert native_leaf.dtype == python_leaf.dtype
        np.testing.assert_array_equal(native_leaf, python_leaf)
    native_q.close()
    with pytest.raises(StopIteration):
        BatchArena(k=2, rows=2, batch_dim=1).assemble_from(native_q)


# ---------------------------------------------------------- shm transport


def test_native_pool_shm_end_to_end(core):
    """C++ actor loops over shm rings created by the port's Python env
    server: real rollouts with the on-policy invariants held."""
    path = os.path.join(tempfile.mkdtemp(), "native_shm")
    server = _start_server(core, f"shm:{path}")
    pool = _Pool(core, "native", f"shm:{path}")
    try:
        items = pool.take(5)
    finally:
        pool.close()
        server.stop()
    assert pool.pool.count() >= 5 * T
    _check_rollouts(items)
    tele = pool.pool.telemetry()
    assert tele["env_steps"] == pool.pool.count()
    assert tele["bytes_up"] > 0 and tele["bytes_down"] > 0
    assert tele["connects"] == 1
    assert 0 <= tele["ring_recheck_wakeups"] <= tele["ring_doorbell_waits"]


def _shm_segments(pids=None):
    """The ring segments in /dev/shm created by the processes `pids`, or
    by any process (None); the port's and the core's ring names carry
    their creator's pid. Other processes on the machine, such as other
    test workers, create and remove segments meanwhile."""
    from torchbeast_tpu_torch.runtime.transport import segment_owner_pid

    if not os.path.isdir("/dev/shm"):
        return set()
    owners = {n: segment_owner_pid(n) for n in os.listdir("/dev/shm")}
    return {n for n, pid in owners.items()
            if pid is not None and (pids is None or pid in pids)}


def _serve_counting_shm_child(path):
    from torchbeast_tpu_torch.envs import CountingEnv
    from torchbeast_tpu_torch.runtime.env_server import EnvServer

    EnvServer(lambda: CountingEnv(episode_length=EPISODE_LEN),
              f"shm:{path}").run()


def _spawn_counting_server_proc(path):
    proc = mp.get_context("spawn").Process(
        target=_serve_counting_shm_child, args=(path,), daemon=True)
    proc.start()
    _wait_bound(path, proc)
    return proc


def test_native_shm_crash_reconnect_and_sweep(core):
    """SIGKILL the env server mid-ring: the C++ actor revives its
    connection against the restarted server, and the teardown sweep
    leaves none of the test's own segments in /dev/shm (the dead owner
    never unlinks): those of the two servers, which create the rings,
    and of this process."""
    pids = {os.getpid()}
    # Every named segment now: a server's pid may be a dead process's
    # whose segment is still there.
    before = _shm_segments()
    path = os.path.join(tempfile.mkdtemp(), "native_shm_crash")
    proc = _spawn_counting_server_proc(path)
    pids.add(proc.pid)
    pool = _Pool(core, "native", f"shm:{path}", max_reconnects=3,
                 queue_size=1)
    try:
        pool.take(1)  # a rollout through the first connection
        # The first connection's rings are the server's, by name.
        assert _shm_segments({proc.pid})
        proc.kill()
        proc.join(10)
        os.unlink(path)  # the dead server's socket file lingers
        proc = _spawn_counting_server_proc(path)
        pids.add(proc.pid)
        pool.take(3)  # at least one through the revived connection
        assert pool.pool.first_error_message() is None
        assert pool.pool.reconnect_count() >= 1
    finally:
        pool.close()
        proc.kill()
        proc.join(10)
    leaked = _shm_segments(pids) - before
    assert leaked == set(), f"leaked /dev/shm segments: {leaked}"


# ---------------------------------------------------------- telemetry fold


def test_native_telemetry_fold(core):
    """The core's counters and histograms land in the port's registry
    under the Python runtime's series, credited per interval."""
    from torchbeast_tpu_torch.telemetry.metrics import MetricsRegistry

    queue = core.BatchingQueue(batch_dim=0, minimum_batch_size=1)
    batcher = core.DynamicBatcher(batch_dim=0)
    t = _run_thread(lambda: batcher.compute(np.zeros((1, 2), np.float32)))
    (batch,) = _take(batcher, 1, closers=[batcher])
    batch.set_outputs(batch.get_inputs())
    t.join(WAIT_S)
    queue.enqueue(np.zeros((1, 2), np.float32))
    queue.dequeue_many()

    class FakePool:
        def __init__(self):
            self.waits, self.rechecks, self.reconnects = 7, 2, 1

        def telemetry(self):
            return {
                "env_steps": 0, "connects": 0,
                "reconnects": self.reconnects, "bytes_up": 0,
                "bytes_down": 0, "ring_doorbell_waits": self.waits,
                "ring_recheck_wakeups": self.rechecks,
            }

    fake_pool = FakePool()
    registry = MetricsRegistry()
    folder = native.NativeTelemetryFolder(
        registry, pool=fake_pool, batcher=batcher, queue=queue)
    folder.tick()
    assert registry.counter("ring.doorbell_waits").value() == 7
    assert registry.counter("ring.recheck_wakeups").value() == 2
    assert registry.counter("recovery.actor_reconnects").value() == 1
    assert registry.counter("learner_queue.items_in").value() == 1
    rtt = registry.histogram("actor.request_rtt_s")
    wait = registry.histogram("inference.request_wait_s")
    assert rtt.count == 1 and wait.count == 1
    assert rtt.mean >= wait.mean >= 0.0
    assert registry.histogram("learner_queue.batch_size").count == 1
    fake_pool.waits = 10
    folder.tick()
    assert registry.counter("learner_queue.items_in").value() == 1
    assert rtt.count == 1
    assert registry.counter("ring.doorbell_waits").value() == 10
    assert registry.counter("ring.recheck_wakeups").value() == 2
    assert registry.counter("recovery.actor_reconnects").value() == 1
    queue.close()
    batcher.close()


def test_native_trace_spans_fold(core):
    """Sampled C++ stage stamps (1 in 256 computes) fold into the port's
    tracer as the actor.request.* spans the Python pool emits."""
    from torchbeast_tpu_torch.telemetry.metrics import MetricsRegistry
    from torchbeast_tpu_torch.telemetry.trace import Tracer

    batcher = core.DynamicBatcher(batch_dim=0, timeout_ms=5)

    def serve():
        it = iter(batcher)
        while True:
            try:
                batch = next(it)
            except StopIteration:
                return
            batch.set_outputs(batch.get_inputs())

    serve_thread = _run_thread(serve)
    for _ in range(512):
        batcher.compute(np.zeros((1, 1), np.float32))
    tracer = Tracer()
    folder = native.NativeTelemetryFolder(MetricsRegistry(), batcher=batcher,
                                          tracer=tracer)
    folder.tick()
    events = [e for e in tracer.events() if e["cat"] == "actor.request"]
    assert {"actor.request", "actor.request.batch",
            "actor.request.reply"} <= {e["name"] for e in events}
    assert len([e for e in events if e["name"] == "actor.request"]) >= 2
    assert all(e["dur"] >= 0 for e in events)
    before = len(tracer.events())
    folder.tick()
    assert len(tracer.events()) == before
    batcher.close()
    serve_thread.join(WAIT_S)


# --------------------------------------------------------- adaptive recheck


def test_adaptive_recheck_cpp_tighten_and_relax(core):
    """A recheck-heavy window tightens the bound toward the floor, quiet
    windows relax it to the cap, a window inside the band holds it (the
    port's transport.py constants)."""
    from torchbeast_tpu_torch.runtime import transport as transport_lib

    w = transport_lib._RECHECK_WINDOW
    init = int(transport_lib._WAKE_RECHECK_S * 1000)
    bounds = core.adaptive_recheck_sim([True] * (4 * w))
    assert bounds[w - 1] == init // 2
    assert bounds[-1] == transport_lib._RECHECK_MIN_MS
    bounds = core.adaptive_recheck_sim([True] * (2 * w) + [False] * (8 * w))
    assert bounds[2 * w - 1] == transport_lib._RECHECK_MIN_MS
    assert bounds[-1] == transport_lib._RECHECK_MAX_MS
    mixed = [True] * (transport_lib._RECHECK_TIGHTEN - 1)
    mixed += [False] * (w - len(mixed))
    assert core.adaptive_recheck_sim(mixed)[-1] == init


def test_adaptive_recheck_matches_python_policy(core):
    """The core and the port's AdaptiveRecheck walk identically."""
    from torchbeast_tpu_torch.runtime.transport import AdaptiveRecheck

    rng = np.random.default_rng(3)
    outcomes = [bool(b) for b in rng.integers(0, 2, 512)]
    policy = AdaptiveRecheck()
    py_bounds = []
    for outcome in outcomes:
        policy.record(outcome)
        py_bounds.append(policy.bound_ms)
    assert core.adaptive_recheck_sim(outcomes) == py_bounds


# ------------------------------------------------------ reconnect counting


def _flaky_step_message(i):
    return {
        "type": "step",
        "frame": np.asarray([i % 250], np.uint8),
        "reward": np.asarray(0.0, np.float32),
        "done": np.asarray(False),
        "episode_step": np.asarray(i, np.int32),
        "episode_return": np.asarray(0.0, np.float32),
        "last_action": np.asarray(0, np.int32),
    }


class _FlakyServer:
    """A unix-socket env stream that serves `serve_steps` steps and cuts
    the stream (the fault), closes the next `fail_next` connections
    before their first step (failed recovery dials), then serves on."""

    def __init__(self, path, serve_steps=12, fail_next=2):
        import socket

        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(8)
        self._serve_steps = serve_steps
        self._fail_next = fail_next
        self._phase = 0
        self._thread = _run_thread(self._run)

    def _run(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            try:
                if self._phase == 0:
                    self._phase = 1
                    self._serve(conn, self._serve_steps)
                elif self._phase == 1 and self._fail_next > 0:
                    self._fail_next -= 1
                else:
                    self._phase = 2
                    self._serve(conn, None)
            except Exception:  # noqa: BLE001  the actor cut the stream
                pass
            finally:
                conn.close()

    def _serve(self, conn, limit):
        from torchbeast_tpu_torch.runtime import wire

        i = 0
        wire.send_message(conn, _flaky_step_message(i))
        while limit is None or i < limit:
            if wire.recv_message(conn) is None:
                return
            i += 1
            wire.send_message(conn, _flaky_step_message(i))

    def close(self):
        self._sock.close()


@pytest.mark.parametrize("kind", ["native", "port"])
def test_reconnect_counts_completed_recoveries(core, kind):
    """One stream cut, two failed dials and one good one are one
    recovery on the core's pool and the port's Python pool alike."""
    path = os.path.join(tempfile.mkdtemp(), f"flaky_{kind}")
    server = _FlakyServer(path, serve_steps=4 * T, fail_next=2)
    pool = _Pool(core, kind, f"unix:{path}", max_reconnects=3)
    try:
        pool.take(7)  # 4 rollouts before the cut, 3 after the recovery
        assert pool.pool.reconnect_count() == 1
        assert list(pool.pool.errors) == []
        if kind == "native":
            assert pool.pool.telemetry()["reconnects"] == 1
    finally:
        pool.close()
        server.close()
