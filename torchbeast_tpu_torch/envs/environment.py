"""Environment adapter (a copy of torchbeast_tpu/envs/environment.py): raw env -> numpy EnvOutput steps with episode
accounting.

Re-design of the reference's gym->tensor adapter
(upstream torchbeast, torchbeast/core/environment.py:30-69). Differences:
- numpy arrays; frames stay HWC uint8 (the models read them as NHWC,
  which is PyTorch's channels_last layout).
- unbatched: returns scalar/array fields per env; drivers batch across envs
  (the reference baked [T=1,B=1] dims in here because its actors were
  single-env processes).
- speaks both the gymnasium 5-tuple API and a minimal `reset()->obs /
  step(a)->(obs, reward, done)` protocol (our Mock envs).

Episode accounting lives here, as in the reference (episode_step/
episode_return travel with each step so the learner can extract returns of
episodes that ended inside a batch, SURVEY.md §5.5). The initial state has
done=True, reward=0, last_action=0 (reference environment.py:31-45), and the
env auto-resets on done with counters zeroed for the following step.
"""

from typing import Any, Dict

import numpy as np


def _step_env(env, action):
    """Normalize gymnasium's 5-tuple and the minimal 3-tuple protocols."""
    result = env.step(action)
    if len(result) == 5:
        obs, reward, terminated, truncated, _info = result
        return obs, float(reward), bool(terminated or truncated)
    obs, reward, done = result[:3]
    return obs, float(reward), bool(done)


def _reset_env(env):
    result = env.reset()
    if isinstance(result, tuple) and len(result) == 2:
        return result[0]  # gymnasium: (obs, info)
    return result


class Environment:
    """Stateful single-env stepper producing EnvOutput-shaped dicts."""

    def __init__(self, env):
        self._env = env
        self._episode_return = 0.0
        self._episode_step = 0

    def initial(self) -> Dict[str, Any]:
        self._episode_return = 0.0
        self._episode_step = 0
        frame = _reset_env(self._env)
        return {
            "frame": np.asarray(frame),
            "reward": np.float32(0.0),
            "done": True,  # marks the boundary step (reference convention)
            "episode_return": np.float32(0.0),
            "episode_step": np.int32(0),
            "last_action": np.int32(0),
        }

    def step(self, action: int) -> Dict[str, Any]:
        frame, reward, done = _step_env(self._env, int(action))
        self._episode_step += 1
        self._episode_return += reward
        episode_step = self._episode_step
        episode_return = self._episode_return
        if done:
            frame = _reset_env(self._env)
            # Counters reported with THIS step keep the finished episode's
            # totals; they restart on the next step (reference
            # environment.py:49-62, rpcenv.cc:106-119).
            self._episode_step = 0
            self._episode_return = 0.0
        return {
            "frame": np.asarray(frame),
            "reward": np.float32(reward),
            "done": done,
            "episode_return": np.float32(episode_return),
            "episode_step": np.int32(episode_step),
            "last_action": np.int32(action),
        }

    def close(self):
        if hasattr(self._env, "close"):
            self._env.close()
