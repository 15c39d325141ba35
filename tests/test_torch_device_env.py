"""The port's device envs (torchbeast_tpu_torch/envs/device_env.py) against
the JAX package's jittable envs (torchbeast_tpu/envs/jax_env.py) on the
CPU.

Transitions are held exactly: from the same state and action, the same
frame, reward and done and the same next state. States are drawn with
numpy from a seed over every reachable value and converted to the
reference's NamedTuples (its key is unused by a step). The accounting
wrapper's resets draw from different generators in the two packages, so
where a reset happened the reference's reset is replaced by the port's
drawn column or cue before the two are compared. The reference's own
TestCatch / TestMemoryJax cases run on the port too, and the Memory twin
is held against the port's host MemoryChainEnv.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu.envs import jax_env
from torchbeast_tpu_torch.envs import device_env
from torchbeast_tpu_torch.envs.mock import MemoryChainEnv
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

B = 64
KEY = jax.random.PRNGKey(0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.numpy()


def _jax_catch_state(state):
    return jax_env.CatchState(
        ball_row=jnp.asarray(_np(state.ball_row)),
        ball_col=jnp.asarray(_np(state.ball_col)),
        paddle_col=jnp.asarray(_np(state.paddle_col)),
        key=jnp.broadcast_to(KEY, (len(state.ball_row),) + KEY.shape),
    )


def _jax_memory_state(state):
    return jax_env.MemoryState(
        cue=jnp.asarray(_np(state.cue)), t=jnp.asarray(_np(state.t)),
        key=jnp.broadcast_to(KEY, (len(state.cue),) + KEY.shape),
    )


def _random_catch(rng, rows, cols):
    return device_env.CatchState(
        ball_row=_t(rng.integers(0, rows - 1, B).astype(np.int32)),
        ball_col=_t(rng.integers(0, cols, B).astype(np.int32)),
        paddle_col=_t(rng.integers(0, cols, B).astype(np.int32)),
    )


def _random_memory(rng, length):
    return device_env.MemoryState(
        cue=_t(rng.integers(0, 2, B).astype(np.int32)),
        t=_t(rng.integers(0, length, B).astype(np.int32)),
    )


@pytest.mark.parametrize("rows,cols", [(10, 5), (5, 3)])
def test_catch_step_matches_jax(rows, cols):
    rng = np.random.default_rng(rows)
    env, ref = device_env.Catch(rows, cols), jax_env.CatchJax(rows, cols)
    for _ in range(4):
        state = _random_catch(rng, rows, cols)
        action = rng.integers(0, 3, B).astype(np.int32)
        got_state, frame, reward, done = env.step(state, _t(action))
        want_state, want_frame, want_reward, want_done = jax.vmap(
            ref.step)(_jax_catch_state(state), jnp.asarray(action))
        np.testing.assert_array_equal(_np(frame), np.asarray(want_frame))
        np.testing.assert_array_equal(_np(reward), np.asarray(want_reward))
        np.testing.assert_array_equal(_np(done), np.asarray(want_done))
        assert frame.dtype == torch.uint8 and reward.dtype == torch.float32
        for name in device_env.CatchState._fields:
            np.testing.assert_array_equal(
                _np(getattr(got_state, name)),
                np.asarray(getattr(want_state, name)), err_msg=name)
        np.testing.assert_array_equal(
            _np(env.observe(state)),
            np.asarray(jax.vmap(ref.observe)(_jax_catch_state(state))))


@pytest.mark.parametrize("length", [6, 11])
def test_memory_step_matches_jax(length):
    rng = np.random.default_rng(length)
    env = device_env.MemoryChain(length)
    ref = jax_env.MemoryChainJax(length)
    for _ in range(4):
        state = _random_memory(rng, length)
        action = rng.integers(0, 3, B).astype(np.int32)
        got_state, frame, reward, done = env.step(state, _t(action))
        want_state, want_frame, want_reward, want_done = jax.vmap(
            ref.step)(_jax_memory_state(state), jnp.asarray(action))
        np.testing.assert_array_equal(_np(frame), np.asarray(want_frame))
        np.testing.assert_array_equal(_np(reward), np.asarray(want_reward))
        np.testing.assert_array_equal(_np(done), np.asarray(want_done))
        np.testing.assert_array_equal(_np(got_state.cue),
                                      np.asarray(want_state.cue))
        np.testing.assert_array_equal(_np(got_state.t),
                                      np.asarray(want_state.t))
        np.testing.assert_array_equal(
            _np(env.observe(state)),
            np.asarray(jax.vmap(ref.observe)(_jax_memory_state(state))))


def _to_jax(state, env_name):
    inner = (_jax_catch_state(state.env_state) if env_name == "Catch"
             else _jax_memory_state(state.env_state))
    return jax_env.AccountedState(
        inner, jnp.asarray(_np(state.episode_return)),
        jnp.asarray(_np(state.episode_step)))


@pytest.mark.parametrize("env_name", ["Catch", "Memory", "Memory-L9"])
def test_wrapper_accounting_and_autoreset_match_jax(env_name):
    """Every output field and the next counters equal the reference's
    wrapper's from the same accounted state; where an episode ended, the
    next env state is the reference's reset with the port's draw, and
    the frame is that state's."""
    env = device_env.create_device_env(env_name)
    ref = jax_env.create_jax_env(env_name)
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(4)
    state, out = env.initial(B, gen, torch.device("cpu"))
    _, want_out = jax.vmap(ref.initial)(jax.random.split(KEY, B))
    for key in ("reward", "done", "episode_return", "episode_step",
                "last_action"):
        np.testing.assert_array_equal(_np(out[key]),
                                      np.asarray(want_out[key]), key)
    resets = 0
    for _ in range(40):
        action = rng.integers(0, 3, B).astype(np.int32)
        ref_next, ref_out = jax.vmap(ref.step)(_to_jax(state, env_name),
                                               jnp.asarray(action))
        next_state, out = env.step(state, _t(action), gen)
        done = _np(out["done"])
        resets += int(done.sum())
        for key in ("reward", "done", "episode_return", "episode_step",
                    "last_action"):
            np.testing.assert_array_equal(_np(out[key]),
                                          np.asarray(ref_out[key]), key)
            assert out[key].dtype == _t(np.array(ref_out[key])).dtype, key
        np.testing.assert_array_equal(_np(next_state.episode_return),
                                      np.asarray(ref_next.episode_return))
        np.testing.assert_array_equal(_np(next_state.episode_step),
                                      np.asarray(ref_next.episode_step))
        # The port's draw where done, the reference's state elsewhere.
        drawn = "ball_col" if env_name == "Catch" else "cue"
        for name in type(next_state.env_state)._fields:
            want = np.asarray(getattr(ref_next.env_state, name))
            if name == drawn:
                want = np.where(done, _np(getattr(next_state.env_state,
                                                  name)), want)
            np.testing.assert_array_equal(
                _np(getattr(next_state.env_state, name)), want, name)
        ref_next = ref_next._replace(env_state=(
            _jax_catch_state(next_state.env_state)
            if env_name == "Catch" else
            _jax_memory_state(next_state.env_state)))
        want_frame = np.where(
            done[:, None, None, None],
            np.asarray(jax.vmap(ref.env.observe)(ref_next.env_state)),
            np.asarray(ref_out["frame"]))
        np.testing.assert_array_equal(_np(out["frame"]), want_frame)
        state = next_state
    assert resets > B  # every env ended at least one episode


def test_resets_draw_from_the_generator():
    """A reset's draws cover every column, follow the generator's seed,
    and differ between two draws of one generator."""
    env = device_env.Catch()
    cols = [env.reset(512, torch.Generator().manual_seed(s),
                      torch.device("cpu")).ball_col for s in (5, 5, 6)]
    assert torch.equal(cols[0], cols[1])
    assert not torch.equal(cols[0], cols[2])
    assert set(cols[0].tolist()) == set(range(5))
    gen = torch.Generator().manual_seed(7)
    a = env.reset(512, gen, torch.device("cpu")).ball_col
    b = env.reset(512, gen, torch.device("cpu")).ball_col
    assert not torch.equal(a, b)
    cues = device_env.MemoryChain().reset(
        512, gen, torch.device("cpu")).cue
    assert set(cues.tolist()) == {0, 1}


# The reference's TestCatch and TestMemoryJax (tests/test_anakin.py) on the
# port, one env of a batch of one.


def _one(v):
    return torch.tensor([v], dtype=torch.int32)


class TestCatch:
    def test_episode_mechanics(self):
        env = device_env.Catch(rows=5, cols=3)
        state = env.reset(1, torch.Generator().manual_seed(0),
                          torch.device("cpu"))
        assert int(state.ball_row) == 0
        total_reward = 0.0
        for _ in range(4):  # rows-1 steps to the bottom
            state, frame, reward, done = env.step(state, _one(1))
            total_reward += float(reward)
        assert bool(done)
        assert total_reward in (1.0, -1.0)
        assert frame.shape == (1, 5, 3, 1)

    def test_catching_gives_plus_one(self):
        env = device_env.Catch(rows=5, cols=3)
        state = env.reset(1, torch.Generator().manual_seed(0),
                          torch.device("cpu"))
        for _ in range(4):
            delta = torch.sign(state.ball_col - state.paddle_col)
            state, _, reward, done = env.step(state, delta + 1)
        assert bool(done) and float(reward) == 1.0

    def test_wrapper_accounting_and_autoreset(self):
        env = device_env.create_device_env("Catch")
        gen = torch.Generator().manual_seed(1)
        state, out = env.initial(1, gen, torch.device("cpu"))
        assert bool(out["done"])  # boundary convention
        for t in range(1, 10):  # 10 rows -> episode ends at step 9
            state, out = env.step(state, _one(1), gen)
            assert int(out["episode_step"]) == t
        assert bool(out["done"])
        assert float(out["episode_return"]) in (1.0, -1.0)
        state, out = env.step(state, _one(1), gen)
        assert int(out["episode_step"]) == 1
        assert not bool(out["done"])


class TestMemoryJax:
    def test_parameterized_corridor_id(self):
        env = device_env.create_device_env("Memory-L41")
        assert env.env.length == 41
        with pytest.raises(ValueError, match="length must be >= 6"):
            device_env.create_device_env("Memory-L5")
        with pytest.raises(ValueError, match="Unknown device env"):
            device_env.create_device_env("Pong")

    @pytest.mark.parametrize("cue", [0, 1])
    def test_parity_with_host_env(self, cue):
        """The device twin of the host MemoryChainEnv: identical frames,
        rewards and dones for the same cue and action script."""
        fwd = device_env.MemoryChain.FORWARD
        scripts = [
            [fwd, fwd, fwd, fwd, fwd, cue],       # honest solve
            [cue, cue, cue, cue, cue, cue],       # full relay (taxed)
            [0, 1, fwd, 0, fwd, 1 - cue],         # mixed + wrong answer
        ]
        for script in scripts:
            host = MemoryChainEnv(length=6, seed=0)
            host.reset()
            host._cue = cue  # force the drawn cue for parity
            env = device_env.MemoryChain(length=6)
            state = device_env.MemoryState(cue=_one(cue), t=_one(0))
            np.testing.assert_array_equal(_np(env.observe(state))[0],
                                          host._frame())
            for a in script:
                state, frame, reward, done = env.step(state, _one(a))
                hframe, hr, hd = host.step(a)
                assert float(reward) == hr, (cue, script, a)
                assert bool(done) == hd
                np.testing.assert_array_equal(_np(frame)[0], hframe)
