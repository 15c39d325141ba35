"""Atari preprocessing: the DeepMind stack on gymnasium's wrappers (the
port's copy of torchbeast_tpu/envs/atari.py).

torchbeast vendors the openai/baselines wrappers (NoopReset(30),
MaxAndSkip(4), EpisodicLife, FireReset, WarpFrame 84x84 gray, ClipReward,
FrameStack(4), CHW). gymnasium.wrappers.AtariPreprocessing covers
noop/skip-max/warp/grayscale; FrameStackObservation covers the stack.
EpisodicLife and FireReset are not in gymnasium core, so they are
gymnasium.Wrapper subclasses here. Frames come out HWC uint8 [84, 84, 4]
(NHWC, as the port's models read them).

Both drivers use clip_rewards=False (clipping happens in the learner),
frame_stack=True and scale=False, as torchbeast's do.

gymnasium is imported here and in envs/miniatari.py only: envs/__init__
imports this module for an id that is none of the dependency-free envs.
ale_py (the Atari ROMs and emulator) is optional; a real Atari id without
it raises the reference's ImportError. "tbt/" ids build on the port's own
MiniAtari cabinet.
"""

import gymnasium
import numpy as np


class EpisodicLifeWrapper(gymnasium.Wrapper):
    """End episodes on life loss, but only truly reset when the game is
    over (torchbeast's EpisodicLifeEnv)."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def reset(self, **kwargs):
        if self.was_real_done:
            obs, info = self.env.reset(**kwargs)
        else:
            # no-op step to advance from the life-lost state
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                obs, info = self.env.reset(**kwargs)
        self.lives = self.env.unwrapped.ale.lives()
        return obs, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.was_real_done = terminated or truncated
        lives = self.env.unwrapped.ale.lives()
        if 0 < lives < self.lives:
            terminated = True
        self.lives = lives
        return obs, reward, terminated, truncated, info


class FireResetWrapper(gymnasium.Wrapper):
    """Press FIRE after reset for envs that need it (torchbeast's
    FireResetEnv)."""

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        obs, _, terminated, truncated, info = self.env.step(1)
        if terminated or truncated:
            obs, info = self.env.reset(**kwargs)
        obs, _, terminated, truncated, info = self.env.step(2)
        if terminated or truncated:
            obs, info = self.env.reset(**kwargs)
        return obs, info


class StackToHWC(gymnasium.ObservationWrapper):
    """FrameStackObservation yields [stack, H, W]; models want [H, W, stack]."""

    def __init__(self, env):
        super().__init__(env)
        old = env.observation_space
        self.observation_space = gymnasium.spaces.Box(
            low=np.moveaxis(old.low, 0, -1),
            high=np.moveaxis(old.high, 0, -1),
            dtype=old.dtype,
        )

    def observation(self, obs):
        return np.moveaxis(np.asarray(obs), 0, -1)


def create_atari_env(
    env_name: str,
    *,
    frame_stack: int = 4,
    episodic_life: bool = True,
    noop_max: int = 30,
    seed=None,
):
    """Build the full preprocessing stack -> HWC uint8 [84, 84, frame_stack]."""
    env_id = env_name
    if env_name.startswith("tbt/"):
        # The dependency-free ALE-compatible cabinet, from its own spec.
        from torchbeast_tpu_torch.envs import miniatari

        if env_name == miniatari.ENV_ID:
            env_id = miniatari.SPEC
    else:
        try:
            import ale_py

            gymnasium.register_envs(ale_py)
        except ImportError as e:
            raise ImportError(
                f"Env {env_name!r} needs ale_py; install it, or use "
                "--env tbt/MiniAtari-v0 (dependency-free Atari-like, same "
                "preprocessing stack) or --env Mock."
            ) from e

    env = gymnasium.make(env_id, frameskip=1)  # AtariPreprocessing skips
    env = gymnasium.wrappers.AtariPreprocessing(
        env,
        noop_max=noop_max,
        frame_skip=4,
        screen_size=84,
        grayscale_obs=True,
        scale_obs=False,
    )
    if episodic_life:
        env = EpisodicLifeWrapper(env)
    if "FIRE" in env.unwrapped.get_action_meanings():
        env = FireResetWrapper(env)
    env = gymnasium.wrappers.FrameStackObservation(env, stack_size=frame_stack)
    env = StackToHWC(env)
    if seed is not None:
        # Gymnasium seeds at reset; seeding once here pins np_random's
        # stream, and the subsequent unseeded resets (Environment's
        # initial/auto-reset) continue it deterministically.
        env.reset(seed=int(seed))
    return env
