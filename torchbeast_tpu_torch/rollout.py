"""Rollout collection with the reference's on-policy bookkeeping
invariants (counterpart of torchbeast_tpu/rollout.py).

One batched policy call per env step for all B envs. Invariants, as in
the reference:
- overlap-by-one: slot 0 of rollout k+1 == slot T of rollout k (env and
  agent sides);
- pairing: the agent output at slot i was computed from the env output at
  slot i-1;
- agent-state carry: `initial_agent_state` returned with a rollout is the
  recurrent state entering its first policy call. It is a copy: the
  acting step on the card (a CUDA graph) writes each new state into the
  same static buffers, which the next step overwrites.

Two schedules over the same data flow:
- `RolloutCollector`: the policy returns host (numpy) outputs every step.
- `PipelinedRolloutCollector` (lag-1, the drivers' default): per env step
  only the action is copied to the host; the previous tick's logits and
  baseline are copied while the envs step, and agent state stays on the
  device. Batches are identical to the synchronous collector's.
"""

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from torchbeast_tpu_torch import nest
from torchbeast_tpu_torch.types import AgentOutput

# policy(env_output [B,...] dict, agent_state) -> (AgentOutput [B,...], state)
PolicyFn = Callable[[Dict[str, np.ndarray], Any], Tuple[AgentOutput, Any]]


def to_host(x):
    """Tensors (anywhere in a nest) -> numpy arrays."""
    return nest.map(
        lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) else t, x
    )


def _kept(state):
    """A copy of an agent state that outlives the next policy call."""
    return nest.map(
        lambda t: t.clone() if torch.is_tensor(t) else np.array(t), state)


def _build_batch(
    env_steps: List[Dict[str, np.ndarray]], agent_steps: List[AgentOutput]
) -> Dict[str, np.ndarray]:
    """Stack T+1 env dicts + host AgentOutputs into the [T+1, B] batch."""
    batch = {
        k: np.stack([s[k] for s in env_steps], axis=0) for k in env_steps[0]
    }
    batch["action"] = np.stack([np.asarray(a.action) for a in agent_steps])
    batch["policy_logits"] = np.stack(
        [np.asarray(a.policy_logits) for a in agent_steps]
    )
    batch["baseline"] = np.stack(
        [np.asarray(a.baseline) for a in agent_steps]
    )
    return batch


class RolloutCollector:
    def __init__(self, pool, policy: PolicyFn, initial_agent_state,
                 unroll_length: int):
        self._pool = pool
        self._policy = policy
        self._unroll_length = unroll_length
        self._agent_state = initial_agent_state

        self._pending_env = pool.initial()
        # Prime the boundary agent output; the state advance is discarded
        # (the first in-rollout call re-consumes this env output).
        self._pending_agent, _ = policy(self._pending_env, self._agent_state)

    def collect(self) -> Tuple[Dict[str, np.ndarray], Any]:
        """Run one unroll; return (batch [T+1, B, ...], initial_agent_state).
        The batch carries the env fields (frame, reward, done,
        episode_return, episode_step, last_action) and the behavior
        agent's (action, policy_logits, baseline)."""
        initial_agent_state = _kept(self._agent_state)
        env_steps = [self._pending_env]
        agent_steps = [self._pending_agent]
        for _ in range(self._unroll_length):
            agent_out, self._agent_state = self._policy(
                self._pending_env, self._agent_state
            )
            self._pending_env = self._pool.step(np.asarray(agent_out.action))
            env_steps.append(self._pending_env)
            agent_steps.append(agent_out)
        self._pending_agent = agent_steps[-1]
        return _build_batch(env_steps, agent_steps), initial_agent_state


class PipelinedRolloutCollector:
    """Lag-1 collector: the policy returns device outputs; per tick only
    the action is copied to the host before the envs step, and the
    previous tick's outputs are copied while they step (the pool's
    step_async/step_wait window). Pools without step_async take the
    synchronous phase order, with the same results."""

    def __init__(self, pool, policy: PolicyFn, initial_agent_state,
                 unroll_length: int):
        self._pool = pool
        self._policy = policy
        self._unroll_length = unroll_length
        self._agent_state = initial_agent_state
        self._split_step = hasattr(pool, "step_async")

        self._pending_env = pool.initial()
        self._pending_agent, _ = policy(self._pending_env, self._agent_state)

    def collect(self) -> Tuple[Dict[str, np.ndarray], Any]:
        """One unroll; the same contract and results as RolloutCollector.
        `initial_agent_state` stays on the device."""
        initial_agent_state = _kept(self._agent_state)
        env_steps = [self._pending_env]
        agent_steps: List[AgentOutput] = [self._pending_agent]
        for _ in range(self._unroll_length):
            agent_out, self._agent_state = self._policy(
                self._pending_env, self._agent_state
            )
            action = to_host(agent_out.action)
            if self._split_step:
                self._pool.step_async(action)
                agent_steps[-1] = to_host(agent_steps[-1])
                self._pending_env = self._pool.step_wait()
            else:
                self._pending_env = self._pool.step(action)
            env_steps.append(self._pending_env)
            agent_steps.append(agent_out)
        agent_steps = to_host(agent_steps)
        self._pending_agent = agent_steps[-1]
        return _build_batch(env_steps, agent_steps), initial_agent_state
