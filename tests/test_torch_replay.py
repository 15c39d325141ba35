"""The port's replay arena (--replay_reuse, runtime/queues.BatchArena's
replay bookkeeping): the reference's replay cases of tests/test_queues.py
held against the port's arena, and the port's handouts against the
reference arena's on the same items, fresh flags included."""

import threading

import numpy as np
import pytest

from torchbeast_tpu.runtime import queues as jax_queues
from torchbeast_tpu_torch import nest
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


def _busy(arena):
    return sum(1 for slot in arena._slots if not slot.free)


def test_replay_reuse_exact_accounting():
    """Each fresh fill is served exactly K' times (one fresh + K'-1
    replays, release.fresh marking which), the queue drains only on
    fresh fills, and the next fill starts a new K'-fold cycle."""
    rng = np.random.default_rng(5)
    items = [_item(rng) for _ in range(2)]
    q = _filled_queue(items)
    arena = BatchArena(k=1, rows=1, pool=3, replay_reuse=3)

    first = [arena.assemble_from(q) for _ in range(3)]
    assert [r.fresh for _, r in first] == [True, False, False]
    # Replays re-serve the same arena arrays: no copies.
    for stacked, _ in first[1:]:
        assert stacked["batch"]["obs"] is first[0][0]["batch"]["obs"]
    np.testing.assert_array_equal(first[0][0]["batch"]["obs"][0],
                                  items[0]["batch"]["obs"])
    stacked2, release2 = arena.assemble_from(q)
    assert release2.fresh
    np.testing.assert_array_equal(stacked2["batch"]["obs"][0],
                                  items[1]["batch"]["obs"])
    for _, release in first:
        release()
    release2()
    # The first cycle's slot is retired; the second still owes 2 replays.
    assert _busy(arena) == 1
    second = [arena.assemble_from(q) for _ in range(2)]
    assert [r.fresh for _, r in second] == [False, False]
    for _, release in second:
        release()
    assert _busy(arena) == 0


def test_replay_slot_not_rewritten_mid_reuse():
    """The rewrite fence holds until every handout of a slot is released
    and its quota is spent; a fill under pressure grows the pool instead
    of corrupting the replayed data."""
    rng = np.random.default_rng(6)
    items = [_item(rng) for _ in range(3)]
    q = _filled_queue(items)
    arena = BatchArena(k=1, rows=1, pool=2, grow_timeout_s=0.2,
                       replay_reuse=2)
    s_fresh, r_fresh = arena.assemble_from(q)
    _, r_replay = arena.assemble_from(q)
    before = s_fresh["batch"]["obs"].copy()
    r_fresh()
    assert _busy(arena) == 1
    _, r2f = arena.assemble_from(q)
    _, r2r = arena.assemble_from(q)
    _, r3 = arena.assemble_from(q)
    assert len(arena._slots) == 3  # grew exactly once
    np.testing.assert_array_equal(before, s_fresh["batch"]["obs"])
    r_replay()  # the last handout of slot 1: it frees
    _, r3r = arena.assemble_from(q)
    assert not r3r.fresh
    _, r4 = arena.assemble_from(_filled_queue([_item(rng)]))
    assert r4.fresh
    assert len(arena._slots) == 3  # reused the freed slot
    for release in (r2f, r2r, r3, r3r, r4):
        release()


def test_replay_reuse_one_is_single_release():
    """replay_reuse=1 is the single-release arena: every handout fresh,
    one release frees the slot."""
    rng = np.random.default_rng(7)
    items = [_item(rng) for _ in range(2)]
    q = _filled_queue(items)
    arena = BatchArena(k=1, rows=1, pool=2, replay_reuse=1)
    for item in items:
        stacked, release = arena.assemble_from(q)
        assert release.fresh
        np.testing.assert_array_equal(stacked["batch"]["obs"][0],
                                      item["batch"]["obs"])
        release()
        assert _busy(arena) == 0


def test_replay_aborted_fill_resets_quota():
    """A fill that dies mid-assembly (the source closed) clears the
    replay bookkeeping: nothing of a partial fill is re-served."""
    rng = np.random.default_rng(8)
    q = BatchingQueue(batch_dim=1, maximum_queue_size=4)
    q.enqueue(_item(rng))
    q.enqueue(_item(rng))
    arena = BatchArena(k=2, rows=1, pool=2, replay_reuse=2)
    _, r_fresh = arena.assemble_from(q)
    _, r_replay = arena.assemble_from(q)
    r_fresh()
    r_replay()
    q.enqueue(_item(rng))
    closer = threading.Timer(0.2, q.close)
    closer.start()
    with pytest.raises(StopIteration):
        arena.assemble_from(q)
    closer.join()
    assert arena._replay_slot is None
    assert all(slot.free for slot in arena._slots)


def test_replay_reuse_must_be_positive():
    with pytest.raises(ValueError, match="replay_reuse"):
        BatchArena(k=1, rows=1, replay_reuse=0)


@pytest.mark.parametrize("k,rows,reuse", [(1, 1, 2), (1, 2, 3), (2, 3, 2),
                                          (4, 2, 1)])
def test_handouts_match_the_reference_arena(k, rows, reuse):
    """The same items through both arenas: the same stacks, element for
    element, and the same fresh flags, handout for handout."""
    rng = np.random.default_rng(20 + k + reuse)
    items = [_item(rng) for _ in range(2 * k * rows)]
    ours = BatchArena(k=k, rows=rows, pool=3, replay_reuse=reuse)
    theirs = jax_queues.BatchArena(k=k, rows=rows, pool=3,
                                   replay_reuse=reuse)
    q_ours = _filled_queue(items)
    q_theirs = _filled_queue(items, jax_queues.BatchingQueue)
    for _ in range(2 * reuse):
        a, release_a = ours.assemble_from(q_ours)
        b, release_b = theirs.assemble_from(q_theirs)
        assert release_a.fresh == release_b.fresh
        for x, y in zip(nest.flatten(a), jax_queues.nest.flatten(b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        release_a()
        release_b()
    assert _busy(ours) == _busy(theirs) == 0


def test_prefetcher_stages_each_replay_handout():
    """DevicePrefetcher over a replaying arena: K' staged handouts per
    fresh fill, in order, each with its own release."""
    rng = np.random.default_rng(9)
    items = [_item(rng) for _ in range(2)]
    q = _filled_queue(items)
    arena = BatchArena(k=1, rows=1, pool=4, replay_reuse=2)
    staged_calls = []

    def place(stacked):
        staged_calls.append(stacked["batch"]["obs"].copy())
        return stacked

    pf = DevicePrefetcher(q, place, depth=2, arena=arena).start()
    got = []
    for _ in range(4):
        stacked, release = pf.get(timeout=5.0)
        got.append((stacked["batch"]["obs"][0].copy(), release.fresh))
        release()
    q.close()
    pf.close()
    pf.join(timeout=5.0)
    assert [fresh for _, fresh in got] == [True, False, True, False]
    for (obs, _), item in zip(got, [items[0]] * 2 + [items[1]] * 2):
        np.testing.assert_array_equal(obs, item["batch"]["obs"])
    assert len(staged_calls) == 4
