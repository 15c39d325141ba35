"""Deterministic test/demo environments (no gym dependency); a copy of
torchbeast_tpu/envs/mock.py.

MockEnv mirrors the reference's trivial Mock env for manual runs
(upstream torchbeast, torchbeast/polybeast_env.py:39-46). CountingEnv is the
deterministic frame-counting env used to verify on-policy bookkeeping
invariants (modeled on the behavior of the reference's agent-state test env,
tests/core_agent_state_env.py: frame counts steps, episode ends every
`episode_length` steps)."""

import numpy as np


def parse_memory_id(name: str):
    """Memory-probe env ids -> corridor length, or None if `name` is not
    a Memory id. "Memory" = default length; "Memory-L41" = length 41.
    Same grammar as torchbeast_tpu/envs/mock.py."""
    if name == "Memory":
        return MemoryChainEnv.__init__.__defaults__[0]  # default length
    if name.startswith("Memory-L"):
        suffix = name[len("Memory-L"):]
        if not suffix.isdigit():
            raise ValueError(
                f"Bad Memory id {name!r}: expected Memory-L<n> with a "
                "positive integer length (e.g. Memory-L41)"
            )
        return int(suffix)
    return None


class MockEnv:
    """Fixed-length episodes, constant reward, zero frames."""

    def __init__(self, frame_shape=(84, 84, 4), num_actions=6, episode_length=200):
        self.frame_shape = tuple(frame_shape)
        self.num_actions = num_actions
        self.episode_length = episode_length
        self._t = 0

    def reset(self):
        self._t = 0
        return np.zeros(self.frame_shape, dtype=np.uint8)

    def step(self, action):
        self._t += 1
        done = self._t >= self.episode_length
        frame = np.full(self.frame_shape, self._t % 255, dtype=np.uint8)
        return frame, 1.0, done


class CatchEnv:
    """Host-side (numpy) Catch: ball falls rows-1 steps; move the paddle under it;
    +1/-1 at episode end. A real learnable task for end-to-end learning
    tests of the host drivers (Mock/Counting carry no learnable signal)."""

    def __init__(self, rows=10, cols=5, seed=None):
        self.rows, self.cols = rows, cols
        self.num_actions = 3
        # seed=None: each instance draws OS entropy, so parallel actors
        # see independent ball trajectories (pass a seed for determinism).
        self._rng = np.random.default_rng(seed)
        self._ball_row = 0
        self._ball_col = 0
        self._paddle_col = cols // 2

    def _frame(self):
        frame = np.zeros((self.rows, self.cols, 1), np.uint8)
        frame[min(self._ball_row, self.rows - 1), self._ball_col, 0] = 255
        frame[self.rows - 1, self._paddle_col, 0] = 255
        return frame

    def reset(self):
        self._ball_row = 0
        self._ball_col = int(self._rng.integers(0, self.cols))
        self._paddle_col = self.cols // 2
        return self._frame()

    def step(self, action):
        self._paddle_col = int(
            np.clip(self._paddle_col + int(action) - 1, 0, self.cols - 1)
        )
        self._ball_row += 1
        done = self._ball_row >= self.rows - 1
        reward = 0.0
        if done:
            reward = 1.0 if self._paddle_col == self._ball_col else -1.0
        return self._frame(), reward, done


class CountingEnv:
    """Frame value == step index within the episode; done every N steps.

    Frame after reset is all-zero, so tests can assert that boundary steps
    observed by the learner carry reset frames (reference
    core_agent_state_test.py:81-84). The default 48px frame is the smallest
    square the shallow conv trunk accepts, so the driver can run on
    --env Counting too."""

    def __init__(self, frame_shape=(48, 48, 1), num_actions=2, episode_length=5):
        self.frame_shape = tuple(frame_shape)
        self.num_actions = num_actions
        self.episode_length = episode_length
        self._t = 0

    def reset(self):
        self._t = 0
        return np.zeros(self.frame_shape, dtype=np.uint8)

    def step(self, action):
        self._t += 1
        done = self._t >= self.episode_length
        frame = np.full(self.frame_shape, self._t, dtype=np.uint8)
        return frame, float(self._t), done


class MemoryChainEnv:
    """T-maze memory probe: a binary cue is visible ONLY in the reset
    frame, a featureless corridor follows, a distinct QUERY frame marks
    the decision step, and the final action must reproduce the cue
    (+1 / −1). Every pre-decision step demands the `forward` action
    (2) — anything else costs −0.5.

    Why it exists: Catch is solvable reactively, so a feed-forward
    policy learning it proves nothing about the recurrent core. Here
    nothing the decision-step policy can SEE correlates with the cue:
    the query frame is cue-independent, reward before the decision
    depends only on the agent's own compliance, and — the subtle leak —
    the model's last-action input cannot be used as a relay (encode the
    cue in a₀, then copy last action forward to the query). The best
    such relay is ASYMMETRIC: encode cue 0 as FORWARD (penalty-free)
    and only cue 1 as a non-forward action, paying the corridor tax in
    one branch. Its expected return is 1 − (length−1)·0.25 (half the
    episodes relay for free, half pay (length−1)·0.5), versus ≈ 0 for
    honest play (forward corridor, coin-flip at the query). The relay
    is strictly losing only when (length−1)·0.25 > 1, i.e. length ≥ 6
    — hence the constructor floor below; at length 5 the relay ties
    honest play and below that it WINS, breaking the probe. With
    length ≥ 6 a feed-forward policy caps at expected return ≈ 0,
    while a recurrent core that carries the cue across the unroll (the
    machinery the reference's core_agent_state_test pins,
    monobeast.py:599-611) reaches +1. The FF-vs-LSTM gap on this env
    is the direct functional proof that --use_lstm carries memory.
    """

    FORWARD = 2

    def __init__(self, length=6, seed=None):
        if length < 6:
            raise ValueError(
                "length must be >= 6: below that the asymmetric "
                "last-action relay (cue 0 -> FORWARD, cue 1 -> "
                "non-forward) returns 1 - (length-1)*0.25 >= 0 and a "
                "feed-forward policy can match or beat honest play, "
                "voiding the FF-vs-LSTM differential the probe exists "
                "to measure"
            )
        self.length = length
        self.num_actions = 3  # 0/1 = answers, 2 = forward
        # seed=None: OS entropy per instance so parallel actors see
        # independent cue draws (pass a seed for determinism).
        self._rng = np.random.default_rng(seed)
        self._cue = 0
        self._t = 0

    def _frame(self):
        # (4, 1, 1): rows 0/1 = cue indicators, 2 = corridor beacon,
        # 3 = query beacon.
        frame = np.zeros((4, 1, 1), np.uint8)
        if self._t == 0:
            frame[self._cue, 0, 0] = 255
        elif self._t == self.length - 1:
            frame[3, 0, 0] = 255
        else:
            frame[2, 0, 0] = 255
        return frame

    def reset(self):
        self._cue = int(self._rng.integers(0, 2))
        self._t = 0
        return self._frame()

    def step(self, action):
        at_query = self._t == self.length - 1  # action answers the query
        self._t += 1
        done = self._t >= self.length
        if at_query:
            reward = 1.0 if int(action) == self._cue else -1.0
        else:
            reward = 0.0 if int(action) == self.FORWARD else -0.5
        return self._frame(), reward, done
