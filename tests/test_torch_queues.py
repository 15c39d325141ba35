"""The port's superstep staging (torchbeast_tpu_torch/runtime/queues.py):
BatchingQueue.dequeue_item, BatchArena and DevicePrefetcher's superstep
mode, as the reference's tests/test_queues.py holds the JAX package's
(TestBatchArena without its replay cases, which tests/test_torch_replay.py
holds, and TestDevicePrefetcherSuperstepMode), and
the port's arena against the reference's on the same items: the stacks
must be equal element for element (both are pure copies)."""

import threading

import numpy as np
import pytest

from torchbeast_tpu.runtime import queues as jax_queues
from torchbeast_tpu_torch.runtime.queues import (
    BatchArena,
    BatchingQueue,
    DevicePrefetcher,
)


def _item(rng, rows=1, t=3):
    return {
        "batch": {
            "obs": rng.standard_normal((t, rows, 5)).astype(np.float32),
            "act": rng.integers(0, 4, (t, rows)).astype(np.int32),
        },
        "initial_agent_state": (
            rng.standard_normal((1, rows, 6)).astype(np.float32),
        ),
    }


def _filled_queue(items, cls=BatchingQueue):
    q = cls(batch_dim=1, minimum_batch_size=1,
            maximum_queue_size=len(items) + 1)
    for item in items:
        q.enqueue(item)
    return q


class TestDequeueItem:
    def test_fifo_raw_items_with_rows(self):
        rng = np.random.default_rng(0)
        items = [_item(rng, rows=r) for r in (1, 2, 1)]
        q = _filled_queue(items)
        for want in items:
            got, rows = q.dequeue_item()
            assert rows == want["batch"]["obs"].shape[1]
            np.testing.assert_array_equal(got["batch"]["obs"],
                                          want["batch"]["obs"])
        assert q.size() == 0

    def test_waits_for_an_item_then_stops_at_close(self):
        rng = np.random.default_rng(1)
        q = BatchingQueue(batch_dim=1, maximum_queue_size=2)
        item = _item(rng)
        feeder = threading.Timer(0.1, q.enqueue, args=(item,))
        feeder.start()
        got, rows = q.dequeue_item()
        feeder.join()
        assert rows == 1
        np.testing.assert_array_equal(got["batch"]["act"],
                                      item["batch"]["act"])
        closer = threading.Timer(0.1, q.close)
        closer.start()
        with pytest.raises(StopIteration):
            q.dequeue_item()
        closer.join()


class TestBatchArena:
    def test_roundtrip_bit_identical_to_stack_path(self):
        k, rows = 3, 2
        rng = np.random.default_rng(0)
        items = [_item(rng) for _ in range(k * rows)]
        arena = BatchArena(k=k, rows=rows, pool=2)
        stacked, release = arena.assemble_from(_filled_queue(items))
        for key in ("obs", "act"):
            ref = np.stack([
                np.concatenate([items[b * rows + c]["batch"][key]
                                for c in range(rows)], axis=1)
                for b in range(k)
            ])
            np.testing.assert_array_equal(stacked["batch"][key], ref)
        ref_state = np.stack([
            np.concatenate([items[b * rows + c]["initial_agent_state"][0]
                            for c in range(rows)], axis=1)
            for b in range(k)
        ])
        np.testing.assert_array_equal(stacked["initial_agent_state"][0],
                                      ref_state)
        release()

    def test_multi_row_items_tile_batches(self):
        rng = np.random.default_rng(1)
        items = [_item(rng, rows=2) for _ in range(4)]  # K=2, B=4
        arena = BatchArena(k=2, rows=4, pool=2)
        stacked, release = arena.assemble_from(_filled_queue(items))
        np.testing.assert_array_equal(
            stacked["batch"]["obs"][0],
            np.concatenate([items[0]["batch"]["obs"],
                            items[1]["batch"]["obs"]], axis=1))
        release()

    def test_straddling_item_rejected(self):
        rng = np.random.default_rng(2)
        q = _filled_queue([_item(rng, rows=2), _item(rng, rows=3)])
        arena = BatchArena(k=1, rows=4, pool=2)
        with pytest.raises(ValueError, match="straddles"):
            arena.assemble_from(q)

    def test_slot_fence_blocks_until_release_then_grows(self):
        """An unreleased slot is never rewritten: with every slot held,
        assembly grows the pool, and the held data stays intact."""
        rng = np.random.default_rng(3)
        arena = BatchArena(k=1, rows=1, pool=2, grow_timeout_s=0.2)
        held = []
        for _ in range(3):  # one past the pool size
            stacked, release = arena.assemble_from(
                _filled_queue([_item(rng)]))
            held.append((stacked["batch"]["obs"].copy(), stacked, release))
        assert len(arena._slots) == 3  # grew exactly once
        for copy_before, stacked, release in held:
            np.testing.assert_array_equal(copy_before,
                                          stacked["batch"]["obs"])
            release()
        _, release = arena.assemble_from(_filled_queue([_item(rng)]))
        assert len(arena._slots) == 3
        release()

    def test_closed_queue_drops_partial_and_releases_slot(self):
        rng = np.random.default_rng(4)
        q = BatchingQueue(batch_dim=1, maximum_queue_size=4)
        q.enqueue(_item(rng))
        closer = threading.Timer(0.2, q.close)
        closer.start()
        arena = BatchArena(k=2, rows=2, pool=2)
        with pytest.raises(StopIteration):
            arena.assemble_from(q)
        closer.join()
        assert all(slot.free for slot in arena._slots)

    @pytest.mark.parametrize("k,rows", [(1, 1), (2, 3), (4, 2)])
    def test_matches_the_reference_arena(self, k, rows):
        rng = np.random.default_rng(10 + k)
        items = [_item(rng) for _ in range(2 * k * rows)]
        ours = BatchArena(k=k, rows=rows, pool=2)
        theirs = jax_queues.BatchArena(k=k, rows=rows, pool=2)
        q_ours = _filled_queue(items)
        q_theirs = _filled_queue(items, jax_queues.BatchingQueue)
        for _ in range(2):
            (a, release_a) = ours.assemble_from(q_ours)
            (b, release_b) = theirs.assemble_from(q_theirs)
            for x, y in zip(jax_queues.nest.flatten(a),
                            jax_queues.nest.flatten(b)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            release_a()
            release_b()

    def test_rejects_bad_arguments(self):
        with pytest.raises(ValueError, match="superstep k"):
            BatchArena(k=0, rows=1)
        with pytest.raises(ValueError, match="rows"):
            BatchArena(k=1, rows=0)
        with pytest.raises(ValueError, match="pool"):
            BatchArena(k=1, rows=1, pool=1)


class TestDevicePrefetcherSuperstepMode:
    @staticmethod
    def _queue_of(n_items):
        rng = np.random.default_rng(0)
        items = [_item(rng) for _ in range(n_items)]
        return _filled_queue(items), items

    def test_yields_staged_release_pairs(self):
        k, rows = 2, 2
        q, items = self._queue_of(2 * k * rows)
        arena = BatchArena(k=k, rows=rows, pool=3)
        placed = []
        pf = DevicePrefetcher(q, lambda item: placed.append(item) or item,
                              depth=2, arena=arena).start()
        got = []
        q.close()
        for staged, release in pf:
            got.append(staged)
            release()
        assert len(got) == 2
        assert len(placed) == 2
        # Superstep 0 = the first k*rows items in order.
        np.testing.assert_array_equal(got[0]["batch"]["obs"][0, :, 0],
                                      items[0]["batch"]["obs"][:, 0])
        pf.join(timeout=5)
        assert not pf.is_alive()

    def test_partial_superstep_dropped_at_close(self):
        k, rows = 2, 2
        # 1.5 supersteps' worth: the second must be dropped.
        q, _ = self._queue_of(k * rows + rows)
        arena = BatchArena(k=k, rows=rows, pool=3)
        pf = DevicePrefetcher(q, lambda item: item, depth=2,
                              arena=arena).start()
        q.close()
        staged = [s for s, _ in pf]
        assert len(staged) == 1
        pf.join(timeout=5)
        assert not pf.is_alive()
