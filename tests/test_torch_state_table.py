"""The port's device-resident agent-state table
(torchbeast_tpu_torch/runtime/state_table.py) against the reference's
DeviceStateTable, with the same deep + LSTM weights (converted by
weights.py), the same env inputs and slots, greedy actions
(sample_action=False):

- actions equal, logits and the slots' new LSTM states within rtol 1e-5
  (atol 1e-6);
- only slots whose `advance` is set persist their new state;
- the trash slot absorbs bucket padding, and no real slot moves;
- a failed step poisons the table, and `rebuild` restores every slot to
  the initial state.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from torchbeast_tpu.models import create_model as jax_create_model  # noqa: E402
from torchbeast_tpu.runtime import state_table as jax_table  # noqa: E402
from torchbeast_tpu_torch import weights  # noqa: E402
from torchbeast_tpu_torch.models import create_model as port_create_model  # noqa: E402
from torchbeast_tpu_torch.runtime import inference  # noqa: E402
from torchbeast_tpu_torch.runtime import state_table as port_table  # noqa: E402
from tests.torch_port_fixtures import few_torch_threads  # noqa: E402,F401

A, FRAME, SLOTS = 6, (84, 84, 4), 3
KEYS = ("frame", "reward", "done", "last_action")
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def models():
    jmodel = jax_create_model("deep", num_actions=A, use_lstm=True)
    inputs = {"frame": np.zeros((1, 1) + FRAME, np.uint8),
              "reward": np.zeros((1, 1), np.float32),
              "done": np.zeros((1, 1), bool),
              "last_action": np.zeros((1, 1), np.int32)}
    params = jmodel.init({"params": jax.random.PRNGKey(0),
                          "action": jax.random.PRNGKey(1)}, inputs,
                         jmodel.initial_state(1))
    port = port_create_model("deep", A, use_lstm=True, frame_shape=FRAME)
    weights.load_jax_params(port, jax.device_get(params))
    return jmodel, params, port


def _filter(env):
    return {k: env[k] for k in KEYS}


def _tables(models, act_fail=None):
    jmodel, params, port = models

    def jax_act(ctx, env, state):
        out, new_state = jmodel.apply(params, env, state,
                                      sample_action=False)
        return {"action": out.action, "policy_logits": out.policy_logits,
                "baseline": out.baseline}, new_state

    def port_act(ctx, env, state):
        if act_fail is not None:
            raise act_fail
        out, new_state = port(env, state, sample_action=False)
        return {"action": out.action.to(torch.int32),
                "policy_logits": out.policy_logits,
                "baseline": out.baseline}, new_state

    jt = jax_table.DeviceStateTable(jmodel.initial_state(1), SLOTS, jax_act,
                                    batch_dim=1, input_filter=_filter)
    pt = port_table.DeviceStateTable(port.initial_state(1), SLOTS, port_act,
                                     batch_dim=1, input_filter=_filter)
    return jt, pt


def _env(rng, n):
    return {
        "frame": rng.integers(0, 256, (1, n) + FRAME, dtype=np.uint8),
        "reward": rng.standard_normal((1, n)).astype(np.float32),
        "done": rng.random((1, n)) < 0.2,
        "last_action": rng.integers(0, A, (1, n), dtype=np.int32),
        "episode_step": np.zeros((1, n), np.int32),
    }


def _step_both(jt, pt, slots, advance, env, bucket):
    n = len(slots)
    slots = inference.pad_slots(np.asarray(slots, np.int32), bucket,
                                jt.trash_slot)
    advance = inference.pad_advance(np.asarray(advance), bucket)
    env = inference.pad_to(env, bucket, 1)
    want = jt.fetch(jt.step(slots, advance, env), n)
    got = pt.fetch(pt.step(slots, advance, env), n)
    return want, got


def _close_states(want, got):
    for w, g in zip(jax.tree_util.tree_leaves(want), got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


def test_steps_match_the_reference(models):
    """Three steps over ragged batches and buckets: greedy actions equal,
    logits and baseline and every slot's state within rtol 1e-5."""
    jt, pt = _tables(models)
    rng = np.random.default_rng(0)
    for slots, advance, bucket in (([0, 2], [True, True], 2),
                                   ([1, 0, 2], [True, False, True], 4),
                                   ([2], [True], 1)):
        want, got = _step_both(jt, pt, slots, advance,
                               _env(rng, len(slots)), bucket)
        np.testing.assert_array_equal(got["action"],
                                      np.asarray(want["action"]))
        assert got["action"].dtype == np.int32
        for k in ("policy_logits", "baseline"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL)
        for s in range(SLOTS):
            _close_states(jt.read_slot(s), pt.read_slot(s))


def test_only_advanced_slots_persist(models):
    jt, pt = _tables(models)
    rng = np.random.default_rng(1)
    _step_both(jt, pt, [0, 1], [True, False], _env(rng, 2), 2)
    for table in (jt, pt):
        initial = jax.tree_util.tree_leaves(table.initial_state_host)
        moved = jax.tree_util.tree_leaves(table.read_slot(0))
        kept = jax.tree_util.tree_leaves(table.read_slot(1))
        assert any(np.abs(np.asarray(m) - np.asarray(i)).max() > 0
                   for m, i in zip(moved, initial))
        for k, i in zip(kept, initial):
            np.testing.assert_array_equal(np.asarray(k), np.asarray(i))


def test_the_trash_slot_absorbs_padding(models):
    """One real row padded to a bucket of 4: the three padding rows write
    the trash slot only; slots 1 and 2 stay at the initial state."""
    _, pt = _tables(models)
    rng = np.random.default_rng(2)
    slots = inference.pad_slots(np.asarray([0], np.int32), 4, pt.trash_slot)
    assert list(slots) == [0, 3, 3, 3]
    env = inference.pad_to(_env(rng, 1), 4, 1)
    pt.step(slots, np.ones(4, bool), env)
    initial = pt.initial_state_host
    for s in (1, 2):
        for k, i in zip(pt.read_slot(s), initial):
            np.testing.assert_array_equal(k, i)
    trash = [leaf[:, pt.trash_slot] for leaf in pt._table]
    assert any(float(t.abs().max()) > 0 for t in trash)


def test_a_failed_step_poisons_and_rebuild_restores(models):
    _, pt = _tables(models)
    rng = np.random.default_rng(3)
    env = _env(rng, 1)
    pt.step(np.asarray([0]), np.asarray([True]), env)
    failing = _tables(models, act_fail=RuntimeError("boom"))[1]
    failing._table = pt._table  # the same rows, an act_fn that raises
    with pytest.raises(RuntimeError, match="boom"):
        failing.step(np.asarray([0]), np.asarray([True]), env)
    assert failing.poisoned
    for call in (lambda: failing.step(np.asarray([0]), np.asarray([True]),
                                      env),
                 lambda: failing.read_slot(0),
                 lambda: failing.reset([0])):
        with pytest.raises(port_table.StateTablePoisonedError):
            call()
    failing.rebuild()
    assert not failing.poisoned
    for s in range(SLOTS):
        for k, i in zip(failing.read_slot(s), failing.initial_state_host):
            np.testing.assert_array_equal(k, i)
    pt.poison()
    assert pt.poisoned


def test_reset_returns_slots_to_the_initial_state(models):
    _, pt = _tables(models)
    rng = np.random.default_rng(4)
    pt.step(np.asarray([0, 1]), np.asarray([True, True]), _env(rng, 2))
    pt.reset([1])
    for k, i in zip(pt.read_slot(1), pt.initial_state_host):
        np.testing.assert_array_equal(k, i)
    assert any(np.abs(k - i).max() > 0
               for k, i in zip(pt.read_slot(0), pt.initial_state_host))
