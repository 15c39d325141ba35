"""The port's copies of the host runtime (torchbeast_tpu_torch/runtime/)
against the reference's:

- wire frames: what one package encodes, the other decodes to the same
  arrays, and the bytes are equal (the actor traffic and the env
  servers' step messages, every dtype the wire carries);
- cases of the reference's queue and inference tests, run against both
  packages (parametrised by `rt`);
- the port's host <-> device helpers (`to_device`, `to_host`) on CPU
  tensors.
"""

import os
import threading
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torchbeast_tpu.runtime.inference as jax_inference  # noqa: E402
import torchbeast_tpu.runtime.queues as jax_queues  # noqa: E402
import torchbeast_tpu.runtime.wire as jax_wire  # noqa: E402
import torchbeast_tpu_torch.runtime.inference as port_inference  # noqa: E402
import torchbeast_tpu_torch.runtime.queues as port_queues  # noqa: E402
import torchbeast_tpu_torch.runtime.wire as port_wire  # noqa: E402

RUNTIMES = {"reference": (jax_queues, jax_inference),
            "port": (port_queues, port_inference)}


def _messages():
    rng = np.random.default_rng(0)
    return [
        None, True, False, 42, -1, 2 ** 40, 2.5, "héllo",
        {"type": "action", "action": 3},
        {"frame": rng.integers(0, 256, (84, 84, 4), dtype=np.uint8),
         "reward": 1.0, "done": False, "episode_step": 7,
         "episode_return": 12.5, "last_action": 2, "num_actions": 6},
        *[(rng.random((3, 4, 5)) * 100).astype(dtype) for dtype in (
            np.uint8, np.int8, np.int16, np.int32, np.int64, np.float16,
            np.float32, np.float64, np.bool_)],
        np.arange(12).reshape(3, 4).T,
        np.zeros((0, 3), np.float32),
        np.float32(1.5), np.int32(-4), np.asarray(5, np.int64),
        {"list": [np.ones(3, np.float32), "x", None, 7], "t": (1, 2.0),
         "nested": {"a": {"b": np.arange(4, dtype=np.int32)}}},
    ]


def _equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("index", range(len(_messages())))
def test_wire_frames_are_the_references_bytes(index):
    value = _messages()[index]
    theirs, ours = jax_wire.encode(value), port_wire.encode(value)
    assert ours == theirs
    assert port_wire.encode_legacy(value) == jax_wire.encode_legacy(value)
    for encoder, decoder in ((jax_wire, port_wire), (port_wire, jax_wire)):
        framed = encoder.encode(value)
        _equal(decoder.decode(framed[4:]), jax_wire.decode(theirs[4:]))


def test_wire_constants_match():
    assert port_wire.DEFAULT_MAX_FRAME_BYTES == \
        jax_wire.DEFAULT_MAX_FRAME_BYTES


def test_wire_refuses_the_snapshot_frame():
    # The fleet's policy snapshot frame (tag 0x09) is in the port: both
    # encoders give the same bytes, each decodes the other's, and a
    # truncated frame is refused as malformed, not decoded to something
    # else.
    assert port_wire.TAG_SNAPSHOT == jax_wire.TAG_SNAPSHOT == 0x09
    snapshot = jax_wire.PolicySnapshot(
        3, {"w": np.ones(2, np.float32)}, {"w": "float32"})
    ours = port_wire.PolicySnapshot(
        3, {"w": np.ones(2, np.float32)}, {"w": "float32"})
    theirs = jax_wire.encode(snapshot)
    assert port_wire.encode(ours) == theirs
    assert port_wire.encode_legacy(ours) == theirs
    decoded = port_wire.decode(theirs[4:])
    assert isinstance(decoded, port_wire.PolicySnapshot)
    assert decoded.version == 3 and decoded.dtypes == {"w": "float32"}
    np.testing.assert_array_equal(decoded.params["w"], np.ones(2))
    back = jax_wire.decode(port_wire.encode(ours)[4:])
    assert isinstance(back, jax_wire.PolicySnapshot) and back.version == 3
    with pytest.raises(port_wire.WireError):
        port_wire.decode(theirs[4:12])


@pytest.mark.parametrize("rt", sorted(RUNTIMES))
def test_batched_dequeue(rt):
    queues, _ = RUNTIMES[rt]
    queue = queues.BatchingQueue(batch_dim=0, minimum_batch_size=3)
    for i in range(3):
        queue.enqueue({"x": np.full((1, 2), i)})
    batch, payloads = queue.dequeue_many()
    assert batch["x"].shape == (3, 2)
    np.testing.assert_array_equal(batch["x"][:, 0], [0, 1, 2])
    assert len(payloads) == 3


@pytest.mark.parametrize("rt", sorted(RUNTIMES))
def test_batched_compute_slices_rows(rt):
    queues, _ = RUNTIMES[rt]
    batcher = queues.DynamicBatcher(batch_dim=0, minimum_batch_size=3)
    outs = {}

    def producer(i):
        outs[i] = batcher.compute(np.full((1, 2), i))

    threads = [threading.Thread(target=producer, args=(i,), daemon=True)
               for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    batch = next(iter(batcher))
    inputs = batch.get_inputs()
    assert inputs.shape == (3, 2)
    batch.set_outputs(inputs + 100)
    for t in threads:
        t.join(5)
        assert not t.is_alive()
    for i in range(3):
        np.testing.assert_array_equal(outs[i], [[i + 100, i + 100]])


@pytest.mark.parametrize("rt", sorted(RUNTIMES))
def test_prefetcher_stages_in_order(rt):
    queues, _ = RUNTIMES[rt]
    placed = []

    def place(x):
        placed.append(x)
        return ("staged", x)

    pf = queues.DevicePrefetcher(iter([1, 2, 3]), place, depth=2).start()
    got = [pf.get(timeout=5) for _ in range(3)]
    assert got == [("staged", 1), ("staged", 2), ("staged", 3)]
    assert placed == [1, 2, 3]


def _act_fn(env_outputs, agent_state, batch_size):
    assert env_outputs["frame"].shape[1] == batch_size
    return ({"action": env_outputs["frame"] * 2},
            {"h": agent_state["h"] + 1})


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("rt", sorted(RUNTIMES))
def test_rows_route_back_to_their_producers(rt, pipelined):
    queues, inference = RUNTIMES[rt]
    batcher = queues.DynamicBatcher(batch_dim=1, minimum_batch_size=1,
                                    maximum_batch_size=8, timeout_ms=5)
    server = threading.Thread(target=inference.inference_loop,
                              args=(batcher, _act_fn, 8),
                              kwargs={"pipelined": pipelined}, daemon=True)
    server.start()
    results, errors = {}, []

    def producer(i):
        try:
            results[i] = batcher.compute({
                "env": {"frame": np.full((1, 1, 3), i, np.float32)},
                "agent_state": {"h": np.full((1, 1, 2), 10 * i,
                                             np.float32)},
            })
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(i,))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    assert len(results) == 16
    for i, out in results.items():
        np.testing.assert_array_equal(out["outputs"]["action"],
                                      np.full((1, 1, 3), 2 * i, np.float32))
        np.testing.assert_array_equal(out["agent_state"]["h"],
                                      np.full((1, 1, 2), 10 * i + 1,
                                              np.float32))
    batcher.close()
    server.join(timeout=10)
    assert not server.is_alive()


@pytest.mark.parametrize("n,max_batch", [(1, 1), (3, 8), (5, 64), (64, 64),
                                         (33, 48)])
def test_bucket_padding_matches(n, max_batch):
    buckets = port_inference.default_buckets(max_batch)
    assert buckets == jax_inference.default_buckets(max_batch)
    size = port_inference.bucket_size(n, buckets)
    assert size == jax_inference.bucket_size(n, buckets)
    tree = {"frame": np.arange(2 * n * 3).reshape(2, n, 3)}
    for fn in ("pad_to", "slice_to"):
        arg = size if fn == "pad_to" else n
        _equal(getattr(port_inference, fn)(tree, arg, 1),
               getattr(jax_inference, fn)(tree, arg, 1))
    slots = np.arange(n, dtype=np.int32)
    np.testing.assert_array_equal(
        port_inference.pad_slots(slots, size, 99),
        jax_inference.pad_slots(slots, size, 99))
    advance = np.ones(n, bool)
    np.testing.assert_array_equal(
        port_inference.pad_advance(advance, size),
        jax_inference.pad_advance(advance, size))


def test_to_host_copies_every_leaf_once_and_exactly():
    gen = torch.Generator().manual_seed(0)
    tree = {
        "action": torch.randint(0, 6, (1, 5), generator=gen,
                                dtype=torch.int32),
        "policy_logits": torch.randn(1, 5, 6, generator=gen),
        "bf16": torch.randn(2, 3, generator=gen).to(torch.bfloat16),
        "state": (torch.randn(1, 5, 4, generator=gen),
                  torch.zeros(1, 5, 4, dtype=torch.bool)),
        "host": np.arange(3),
        "none": None,
    }
    host = port_inference.to_host(tree)
    np.testing.assert_array_equal(host["action"], tree["action"].numpy())
    assert host["action"].dtype == np.int32
    np.testing.assert_array_equal(host["policy_logits"],
                                  tree["policy_logits"].numpy())
    np.testing.assert_array_equal(host["bf16"], tree["bf16"].float().numpy())
    assert isinstance(host["state"], tuple)
    assert host["state"][1].dtype == np.bool_
    np.testing.assert_array_equal(host["host"], np.arange(3))
    assert host["none"] is None
    back = port_inference.to_device({"x": host["policy_logits"]}, "cpu")
    assert torch.equal(back["x"], tree["policy_logits"])


def test_launch_counts_stay_exact_across_threads():
    """count_launch under contention (more threads than cores, a short
    switch interval): no increment is lost."""
    import sys

    from torchbeast_tpu_torch.ops._route import count_launch

    def wrapper():
        pass

    wrapper.launches, wrapper.bf16_launches = 0, 0
    threads, per_thread = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            count_launch(wrapper, bf16_launches=1)
            for _ in range(per_thread)]) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == wrapper.bf16_launches == threads * per_thread
