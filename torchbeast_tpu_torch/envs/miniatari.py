"""MiniAtari: a dependency-free, ALE-compatible game cabinet.

The reference's raison d'être is Atari IMPALA, but the Atari emulator
(ale_py) is an optional heavyweight dependency. This module provides a
self-contained game that exposes EXACTLY the surface the DeepMind
preprocessing stack consumes — `_frameskip`, `get_action_meanings()`, and
an `ale` object with `lives()` / `getScreenRGB(buf)` /
`getScreenGrayscale(buf)` (in-place, like the real ALE) — so the full
`create_atari_env` stack (gymnasium AtariPreprocessing noop/skip/max/warp,
EpisodicLife, FireReset, FrameStack; torchbeast's atari_wrappers.py)
executes and trains without ale_py.

The game is a Pong-serve catcher at native Atari resolution (210x160 RGB):
a ball drops from the top with horizontal drift, the bottom paddle must
catch it. +1 per catch (auto-serves the next ball), -1 and a lost life per
miss; 5 lives; FIRE serves the first ball of an episode (exercising the
FireReset wrapper — with an auto-serve failsafe so NOOP policies are not
stuck). Random play returns ~-4; a tracking policy catches every ball, so
learning shows up quickly and unambiguously in mean_episode_return.

Registered as "tbt/MiniAtari-v0"; `create_env("tbt/MiniAtari-v0")` builds
the full preprocessing stack on it.

The port's copy of torchbeast_tpu/envs/miniatari.py, frame for frame the
same game. It registers the id only where no other module has (the JAX
package's copy registers the same id), and the port's create_atari_env
builds from this module's own `SPEC`, so a process that imports both
packages still gets each package's own cabinet.
"""

import gymnasium
import numpy as np

SCREEN_H, SCREEN_W = 210, 160
PADDLE_W, PADDLE_H = 24, 4
PADDLE_Y = 192  # top of the paddle
PADDLE_SPEED = 6
BALL_W, BALL_H = 4, 4
BALL_VY = 3
SERVE_Y = 20
START_LIVES = 5
AUTO_SERVE_AFTER = 60  # frames without a ball before it serves itself

_BG_RGB = (0, 0, 40)
_BALL_RGB = (236, 236, 236)
_PADDLE_RGB = (213, 130, 74)


def _luma(rgb):
    r, g, b = rgb
    return int(round(0.299 * r + 0.587 * g + 0.114 * b))


_BG_GRAY = _luma(_BG_RGB)
_BALL_GRAY = _luma(_BALL_RGB)
_PADDLE_GRAY = _luma(_PADDLE_RGB)


class _MiniALE:
    """The 'emulator': game state + in-place screen getters, mirroring the
    ALE interface AtariPreprocessing binds to (atari_preprocessing.py:
    151-184 of gymnasium)."""

    def __init__(self):
        self._rng = np.random.default_rng(0)
        self.reset(self._rng)

    def reset(self, rng):
        self._rng = rng
        self._lives = START_LIVES
        self.paddle_x = (SCREEN_W - PADDLE_W) // 2
        self.in_play = False
        self.idle_frames = 0
        self.ball_x = 0.0
        self.ball_y = 0.0
        self.ball_vx = 0
        self.game_over = False

    def lives(self) -> int:
        return self._lives

    def _serve(self):
        self.ball_x = float(self._rng.integers(0, SCREEN_W - BALL_W))
        self.ball_y = float(SERVE_Y)
        self.ball_vx = int(self._rng.integers(-2, 3))
        self.in_play = True
        self.idle_frames = 0

    def act(self, action: int):
        """One raw frame. Returns (reward, terminated)."""
        if self.game_over:
            return 0.0, True
        if action == 2:  # RIGHT
            self.paddle_x = min(SCREEN_W - PADDLE_W, self.paddle_x + PADDLE_SPEED)
        elif action == 3:  # LEFT
            self.paddle_x = max(0, self.paddle_x - PADDLE_SPEED)
        elif action == 1 and not self.in_play:  # FIRE serves
            self._serve()

        reward = 0.0
        if not self.in_play:
            self.idle_frames += 1
            if self.idle_frames >= AUTO_SERVE_AFTER:
                self._serve()
            return reward, False

        self.ball_y += BALL_VY
        self.ball_x += self.ball_vx
        if self.ball_x < 0:
            self.ball_x = -self.ball_x
            self.ball_vx = -self.ball_vx
        elif self.ball_x > SCREEN_W - BALL_W:
            self.ball_x = 2 * (SCREEN_W - BALL_W) - self.ball_x
            self.ball_vx = -self.ball_vx

        if self.ball_y + BALL_H >= PADDLE_Y:
            caught = (
                self.ball_x + BALL_W > self.paddle_x
                and self.ball_x < self.paddle_x + PADDLE_W
            )
            if caught:
                reward = 1.0
                self._serve()  # next ball immediately, dense signal
            else:
                reward = -1.0
                self._lives -= 1
                self.in_play = False  # FIRE (or auto-serve) restarts play
                if self._lives <= 0:
                    self.game_over = True
                    return reward, True
        return reward, False

    # -- screen getters (ALE fills caller-provided buffers in place) --

    def _draw(self, buf, bg, ball, paddle):
        buf[...] = bg
        buf[PADDLE_Y : PADDLE_Y + PADDLE_H,
            self.paddle_x : self.paddle_x + PADDLE_W] = paddle
        if self.in_play:
            y, x = int(self.ball_y), int(self.ball_x)
            buf[max(0, y) : y + BALL_H, max(0, x) : x + BALL_W] = ball

    def getScreenRGB(self, buf):  # noqa: N802 — ALE spelling
        self._draw(buf, _BG_RGB, _BALL_RGB, _PADDLE_RGB)

    def getScreenGrayscale(self, buf):  # noqa: N802 — ALE spelling
        self._draw(buf, _BG_GRAY, _BALL_GRAY, _PADDLE_GRAY)


class MiniAtariEnv(gymnasium.Env):
    """gymnasium face of the cabinet (raw frames; the preprocessing stack
    goes on top, exactly as with a real ALE env)."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, frameskip: int = 1, render_mode=None,
                 max_frames: int = 20000):
        if frameskip != 1:
            raise ValueError(
                "MiniAtariEnv is always frameskip=1; AtariPreprocessing "
                "does the skipping (pass frameskip=1, as create_atari_env "
                "does)."
            )
        self._frameskip = frameskip
        self.render_mode = render_mode
        self.max_frames = max_frames
        self.ale = _MiniALE()
        self._frame = 0
        self.action_space = gymnasium.spaces.Discrete(4)
        self.observation_space = gymnasium.spaces.Box(
            low=0, high=255, shape=(SCREEN_H, SCREEN_W, 3), dtype=np.uint8
        )

    def get_action_meanings(self):
        return ["NOOP", "FIRE", "RIGHT", "LEFT"]

    def _rgb(self):
        buf = np.empty((SCREEN_H, SCREEN_W, 3), np.uint8)
        self.ale.getScreenRGB(buf)
        return buf

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self.ale.reset(self.np_random)
        self._frame = 0
        return self._rgb(), {}

    def step(self, action):
        reward, terminated = self.ale.act(int(action))
        self._frame += 1
        truncated = self._frame >= self.max_frames
        return self._rgb(), reward, terminated, truncated, {}

    def render(self):
        return self._rgb()


ENV_ID = "tbt/MiniAtari-v0"
SPEC = gymnasium.envs.registration.EnvSpec(id=ENV_ID,
                                            entry_point=MiniAtariEnv)
if ENV_ID not in gymnasium.registry:
    gymnasium.register(id=ENV_ID, entry_point=MiniAtariEnv)
