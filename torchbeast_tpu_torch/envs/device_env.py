"""Environments that step on the device, for the Anakin trainer
(counterpart of torchbeast_tpu/envs/jax_env.py).

The reference writes each env as a JAX function of one env's state and
vmaps it over the batch inside the jitted iteration. Here the env IS the
batch: every state field is a `[B]` tensor on the device, and one call of
`step` moves all B envs with tensor ops, no branch and no host sync. The
rules are the reference's:

- `Catch` (jax_env.py:32-76): a ball falls down a rows x cols board; the
  paddle (left, stay, right) must be under it at row rows - 1; reward +1
  on a catch, -1 on a miss, at the episode's end (rows - 1 steps).
- `MemoryChain` (jax_env.py:85-138): the twin of envs/mock.MemoryChainEnv
  with its 4x1x1 frame: the cue shows at t=0 only, every corridor step
  asks for FORWARD (-0.5 otherwise), and the query action at t=length-1
  must reproduce the cue (+1 / -1).
- `DeviceEnvironment` (jax_env.py:147-206): the episode accounting and
  auto-reset. `initial` reports `done` True (the boundary convention);
  `step` reports the counters with the done step and restarts them after
  it. The reset is computed for every env on every step and chosen with
  `torch.where`.

Protocol: `env.reset(batch_size, generator, device) -> state`,
`env.step(state, action) -> (state, frame, reward, done)`,
`env.observe(state) -> frame`, `env.num_actions`, `env.frame_shape`.

The reference threads a JAX key through each env's state. The port keeps
no key: a reset draws its column or cue from `generator`, a
torch.Generator on the envs' device passed in by the caller (the
iteration's CUDA graph registers it, so each replay draws new numbers).
"""

from typing import Any, NamedTuple, Tuple

import torch

from torchbeast_tpu_torch.envs.mock import parse_memory_id


class CatchState(NamedTuple):
    ball_row: torch.Tensor  # [B] int32
    ball_col: torch.Tensor  # [B] int32
    paddle_col: torch.Tensor  # [B] int32


class Catch:
    """Catch (bsuite) over a batch of boards."""

    def __init__(self, rows: int = 10, cols: int = 5):
        self.rows = rows
        self.cols = cols
        self.num_actions = 3  # left, stay, right
        self.frame_shape = (rows, cols, 1)

    def reset(self, batch_size: int, generator, device) -> CatchState:
        ball_col = torch.randint(0, self.cols, (batch_size,),
                                 generator=generator, device=device,
                                 dtype=torch.int32)
        return CatchState(
            ball_row=torch.zeros_like(ball_col),
            ball_col=ball_col,
            paddle_col=torch.full_like(ball_col, self.cols // 2),
        )

    def step(self, state: CatchState, action):
        paddle = torch.clamp(state.paddle_col + action.to(torch.int32) - 1,
                             0, self.cols - 1)
        ball_row = state.ball_row + 1
        done = ball_row >= self.rows - 1
        caught = torch.where(paddle == state.ball_col, 1.0, -1.0)
        reward = torch.where(done, caught, 0.0)
        new_state = CatchState(ball_row, state.ball_col, paddle)
        return new_state, self.observe(new_state), reward, done

    def observe(self, state: CatchState):
        device = state.ball_row.device
        rows = torch.arange(self.rows, device=device)[None, :, None]
        cols = torch.arange(self.cols, device=device)[None, None, :]
        ball_row = torch.clamp(state.ball_row, 0, self.rows - 1)
        ball = ((rows == ball_row[:, None, None])
                & (cols == state.ball_col[:, None, None]))
        paddle = ((rows == self.rows - 1)
                  & (cols == state.paddle_col[:, None, None]))
        return ((ball | paddle).to(torch.uint8) * 255)[..., None]


class MemoryState(NamedTuple):
    cue: torch.Tensor  # [B] int32 in {0, 1}
    t: torch.Tensor  # [B] int32, the step within the episode


class MemoryChain:
    """The Memory probe over a batch of corridors; solvable only by a
    recurrent core (the reference's MemoryChainJax)."""

    FORWARD = 2

    def __init__(self, length: int = 6):
        if length < 6:
            # Same floor (and same reason) as MemoryChainEnv: below 6 the
            # asymmetric last-action relay returns 1-(length-1)*0.25 >= 0,
            # so feed-forward matches honest play.
            raise ValueError("length must be >= 6 (see MemoryChainEnv)")
        self.length = length
        self.num_actions = 3  # 0/1 = answers, 2 = forward
        self.frame_shape = (4, 1, 1)

    def reset(self, batch_size: int, generator, device) -> MemoryState:
        cue = torch.randint(0, 2, (batch_size,), generator=generator,
                            device=device, dtype=torch.int32)
        return MemoryState(cue=cue, t=torch.zeros_like(cue))

    def observe(self, state: MemoryState):
        # Rows 0/1: the cue (t == 0), 2: the corridor, 3: the query
        # (t == length - 1).
        corridor = torch.where(state.t == self.length - 1, 3, 2)
        row = torch.where(state.t == 0, state.cue, corridor)
        rows = torch.arange(4, device=row.device)[None, :]
        frame = (rows == row[:, None]).to(torch.uint8) * 255
        return frame.reshape((-1,) + self.frame_shape)

    def step(self, state: MemoryState, action):
        action = action.to(torch.int32)
        at_query = state.t == self.length - 1
        t = state.t + 1
        done = t >= self.length
        answer = torch.where(action == state.cue, 1.0, -1.0)
        corridor = torch.where(action == self.FORWARD, 0.0, -0.5)
        reward = torch.where(at_query, answer, corridor)
        new_state = MemoryState(cue=state.cue, t=t)
        return new_state, self.observe(new_state), reward, done


class AccountedState(NamedTuple):
    env_state: Any
    episode_return: torch.Tensor  # [B] f32
    episode_step: torch.Tensor  # [B] int32


class DeviceEnvironment:
    """Episode accounting and auto-reset around a batched device env: the
    EnvOutput fields of envs/environment.py (frame, reward, done,
    episode_return, episode_step, last_action), each [B, ...]."""

    def __init__(self, env):
        self.env = env
        self.num_actions = env.num_actions
        self.frame_shape = env.frame_shape

    def initial(self, batch_size: int, generator,
                device) -> Tuple[AccountedState, dict]:
        env_state = self.env.reset(batch_size, generator, device)
        zeros = torch.zeros(batch_size, device=device)
        counts = torch.zeros(batch_size, dtype=torch.int32, device=device)
        out = {
            "frame": self.env.observe(env_state),
            "reward": zeros.clone(),
            "done": torch.ones(batch_size, dtype=torch.bool,
                               device=device),  # boundary convention
            "episode_return": zeros.clone(),
            "episode_step": counts.clone(),
            "last_action": counts.clone(),
        }
        return AccountedState(env_state, zeros, counts), out

    def step(self, state: AccountedState, action,
             generator) -> Tuple[AccountedState, dict]:
        env_state, frame, reward, done = self.env.step(state.env_state,
                                                       action)
        episode_return = state.episode_return + reward
        episode_step = state.episode_step + 1

        # Auto-reset: the reset is drawn for every env and selected where
        # done. Counters restart after the done step.
        reset = self.env.reset(done.shape[0], generator, done.device)
        next_env_state = type(env_state)(*(
            torch.where(done, r, c) for r, c in zip(reset, env_state)))
        select = done.reshape((-1,) + (1,) * (frame.dim() - 1))
        frame = torch.where(select, self.env.observe(reset), frame)

        out = {
            "frame": frame,
            "reward": reward,
            "done": done,
            "episode_return": episode_return,
            "episode_step": episode_step,
            "last_action": action.to(torch.int32),
        }
        next_state = AccountedState(
            env_state=next_env_state,
            episode_return=torch.where(done, 0.0, episode_return),
            episode_step=torch.where(done, 0, episode_step),
        )
        return next_state, out


_DEVICE_ENVS = {
    "Catch": Catch,
    "Memory": MemoryChain,
}


def create_device_env(name: str, **kwargs) -> DeviceEnvironment:
    """The wrapped device env of an --env id: Catch, Memory or
    Memory-L<n> (the host drivers' grammar, envs/mock.parse_memory_id)."""
    memory_length = parse_memory_id(name)
    if memory_length is not None:
        return DeviceEnvironment(MemoryChain(length=memory_length, **kwargs))
    try:
        cls = _DEVICE_ENVS[name]
    except KeyError:
        raise ValueError(
            f"Unknown device env {name!r}; available: "
            f"{sorted(_DEVICE_ENVS)}"
        ) from None
    return DeviceEnvironment(cls(**kwargs))
