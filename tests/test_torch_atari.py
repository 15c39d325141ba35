"""The port's Atari stack (torchbeast_tpu_torch/envs/atari.py) on its
MiniAtari cabinet (envs/miniatari.py), against the JAX package's: the
same frames, rewards and dones bit for bit under one seed and one action
sequence, the wrapper contracts of tests/test_atari.py, and a real Atari
id without ale_py raising the reference's own ImportError."""

import subprocess
import sys

import numpy as np
import pytest

from torchbeast_tpu.envs import create_env as jax_create_env
from torchbeast_tpu.envs.environment import Environment as JaxEnvironment
from torchbeast_tpu_torch.envs import create_env, num_actions_of
from torchbeast_tpu_torch.envs.atari import (
    EpisodicLifeWrapper,
    FireResetWrapper,
    create_atari_env,
)
from torchbeast_tpu_torch.envs.environment import Environment
from torchbeast_tpu_torch.envs import miniatari

ENV_ID = "tbt/MiniAtari-v0"


def _chain(env):
    names = []
    while hasattr(env, "env"):
        names.append(type(env).__name__)
        env = env.env
    return names


@pytest.mark.parametrize("seed,steps", [(0, 400), (11, 900)])
def test_frames_equal_the_reference_bit_for_bit(seed, steps):
    """Both packages' full stacks under one seed and one action sequence
    (lives lost and episodes ended on the way): every frame, reward,
    done, episode return and step equal."""
    ours = Environment(create_env(ENV_ID, seed=seed))
    theirs = JaxEnvironment(jax_create_env(ENV_ID, seed=seed))
    assert type(ours._env.unwrapped).__module__ == miniatari.__name__
    assert type(theirs._env.unwrapped).__module__ != miniatari.__name__
    actions = np.random.default_rng(seed).integers(0, 4, steps)
    outs = [(ours.initial(), theirs.initial())]
    outs += [(ours.step(int(a)), theirs.step(int(a))) for a in actions]
    dones = 0
    for a, b in outs:
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)
        dones += bool(a["done"])
    assert dones >= 1
    ours.close()
    theirs.close()


def test_full_stack_output_contract():
    env = create_atari_env(ENV_ID)
    obs, _ = env.reset(seed=0)
    assert obs.shape == (84, 84, 4) and obs.dtype == np.uint8
    assert num_actions_of(env) == 4
    obs2, reward, _, _, _ = env.step(0)
    assert obs2.shape == (84, 84, 4) and obs2.dtype == np.uint8
    assert isinstance(float(reward), float)


def test_wrapper_composition():
    chain = _chain(create_atari_env(ENV_ID))
    for name in ("EpisodicLifeWrapper", "FireResetWrapper",
                 "AtariPreprocessing", "FrameStackObservation", "StackToHWC"):
        assert name in chain
    # FireReset wraps EpisodicLife: fire after every per-life reset.
    assert chain.index("FireResetWrapper") < chain.index(
        "EpisodicLifeWrapper")
    assert "EpisodicLifeWrapper" not in _chain(
        create_atari_env(ENV_ID, episodic_life=False))


def test_episodic_life_done_per_life_but_reset_per_game():
    env = create_atari_env(ENV_ID, noop_max=0)
    env.reset(seed=1)
    ale = env.unwrapped.ale
    start_lives, per_life_dones = ale.lives(), 0
    for _ in range(3000):
        _, _, terminated, truncated, _ = env.step(0)
        if terminated or truncated:
            per_life_dones += 1
            env.reset()
            if ale.lives() == start_lives:
                break
    assert per_life_dones == start_lives
    assert ale.lives() == start_lives


def test_fire_reset_serves_the_ball():
    env = create_atari_env(ENV_ID, noop_max=0)
    env.reset(seed=2)
    assert env.unwrapped.ale.in_play


def test_episodic_life_wrapper_unit():
    """On the raw cabinet: a lost life surfaces as termination, the game
    goes on, and the soft reset keeps it."""
    import gymnasium

    env = EpisodicLifeWrapper(
        FireResetWrapper(gymnasium.make(miniatari.SPEC, frameskip=1)))
    env.reset(seed=0)
    ale = env.unwrapped.ale
    lives0 = ale.lives()
    terminated = truncated = False
    for _ in range(5000):
        _, _, terminated, truncated, _ = env.step(3)
        if terminated or truncated:
            break
    assert terminated
    assert ale.lives() == lives0 - 1 and not env.was_real_done
    env.reset()
    assert ale.lives() == lives0 - 1


def test_real_atari_id_raises_the_reference_error():
    try:
        import ale_py  # noqa: F401

        pytest.skip("ale_py installed; the gate is not reachable")
    except ImportError:
        pass
    errors = []
    for make in (create_env, jax_create_env):
        with pytest.raises(ImportError) as info:
            make("PongNoFrameskip-v4")
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert "ale_py" in errors[0] and ENV_ID in errors[0]


def test_gymnasium_only_on_the_atari_branch():
    """The drivers and the dependency-free envs import no gymnasium (they
    run where it is not installed); a MiniAtari id does."""
    code = (
        "import sys\n"
        "from torchbeast_tpu_torch import monobeast, polybeast\n"
        "from torchbeast_tpu_torch.envs import create_env\n"
        "for name in ('Mock', 'Counting', 'Catch', 'Memory'):\n"
        "    create_env(name)\n"
        "assert 'gymnasium' not in sys.modules\n"
        f"create_env({ENV_ID!r})\n"
        "assert 'gymnasium' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
