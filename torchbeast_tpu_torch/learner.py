"""The learner: loss, optimizer and the update step (counterpart of
torchbeast_tpu/learner.py).

Algorithm as in the reference: forward the [T+1, B] batch; bootstrap
from the last baseline; time-shift batch[1:] against outputs[:-1]; clip
rewards to [-1, 1]; discounts = ~done * gamma; V-trace; pg + baseline_cost
* baseline + entropy_cost * entropy losses, sum-reduced; gradient clip to
a global norm of 40; torch-semantics RMSprop (eps outside the sqrt); the
learning rate decays linearly to zero over the run's updates.

Where the reference builds one jitted XLA program, the port runs eagerly:
the update step launches the model's forward and backward, the V-trace
kernel (--vtrace_impl pallas) and the optimizer tail (--opt_impl pallas:
the fused kernel; xla: the torch form of the optax chain), and updates
the module's parameters in place. It returns its stats as device tensors,
so the driver reads them one update late without a sync per update.
"""

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from torchbeast_tpu_torch.ops import compute_entropy_loss, vtrace_policy_losses
from torchbeast_tpu_torch.ops.opt import FusedRMSpropTail, linear_schedule
from torchbeast_tpu_torch.types import AgentOutput


class HParams(NamedTuple):
    """Learner hyperparameters, the reference's fields and defaults. The
    port takes opt_state_dtype/param_dtype "f32", opt_factored False,
    loss "vtrace" and replay_reuse 1 only; make_optimizer and
    compute_loss raise for the others."""

    discounting: float = 0.99
    baseline_cost: float = 0.5
    entropy_cost: float = 0.0006
    entropy_cost_final: float = None
    reward_clipping: str = "abs_one"  # or "none"
    learning_rate: float = 4.8e-4
    rmsprop_alpha: float = 0.99
    rmsprop_eps: float = 0.01
    rmsprop_momentum: float = 0.0
    grad_norm_clipping: float = 40.0
    total_steps: int = 100_000_000
    unroll_length: int = 80
    batch_size: int = 8
    vtrace_impl: str = "associative"
    opt_state_dtype: str = "f32"
    param_dtype: str = "f32"
    opt_factored: bool = False
    opt_impl: str = "xla"
    loss: str = "vtrace"
    impact_clip: float = 0.2
    replay_reuse: int = 1


def updates_horizon(hp: HParams) -> int:
    """Optimizer updates in a run: total_steps env frames at T*B frames
    per update, times the replay reuse factor. The one schedule clock of
    the LR decay and the entropy anneal."""
    return max(
        1, hp.total_steps // (hp.unroll_length * hp.batch_size)
    ) * max(1, hp.replay_reuse)


class RMSpropChain(FusedRMSpropTail):
    """--opt_impl xla: the torch form of the reference's optax chain,
    clip_by_global_norm -> torch-denominator RMSprop -> momentum trace ->
    scale_by_learning_rate, one op at a time in optax's order. State,
    construction and interface (`step` returns the squared global norm)
    are FusedRMSpropTail's; only `step`'s body differs.

    The momentum trace comes before the LR, as in torch.optim.RMSprop and
    the reference's Pallas tail. (optax.rmsprop, which the reference's
    chain uses on optax >= 0.2.4, applies the LR first; the two agree
    while the LR holds still and drift apart as it decays.)"""

    def step(self, grads) -> torch.Tensor:
        lr = self.schedule(self.state.count)
        with torch.no_grad():
            grads = [g.float() for g in grads]
            sumsq = torch.stack([torch.sum(g * g) for g in grads]).sum()
            if self.max_norm is not None:
                g_norm = torch.sqrt(sumsq)
                trigger = g_norm < self.max_norm
                grads = [
                    torch.where(trigger, g, (g / g_norm) * self.max_norm)
                    for g in grads
                ]
            for i, (p, g, nu) in enumerate(
                zip(self.params, grads, self.state.nu)
            ):
                nu.copy_((1.0 - self.decay) * (g * g) + self.decay * nu)
                upd = g / (torch.sqrt(nu) + self.eps)
                if self.momentum:
                    mom = self.state.mom[i]
                    mom.copy_(upd + self.momentum * mom)
                    upd = mom
                p.add_(upd * -lr)
        self.state = self.state._replace(count=self.state.count + 1)
        return sumsq


def make_optimizer(hp: HParams, params):
    """torch.optim.RMSprop semantics + grad clip + linear LR decay over
    `params` (a list of the module's parameters, updated in place)."""
    if hp.opt_state_dtype != "f32" or hp.param_dtype != "f32":
        raise NotImplementedError(
            "bf16 optimizer state / bf16-resident params are not in the "
            "port yet: ROADMAP.md Queue 1 item 'precision'"
        )
    if hp.opt_factored:
        raise NotImplementedError(
            "--factored_opt_state is not in the port yet: ROADMAP.md "
            "Queue 1 item 'precision'"
        )
    if hp.opt_impl not in ("xla", "pallas"):
        raise ValueError(
            f"opt_impl must be 'xla' or 'pallas', got {hp.opt_impl!r}"
        )
    schedule = linear_schedule(hp.learning_rate, 0.0, updates_horizon(hp))
    cls = FusedRMSpropTail if hp.opt_impl == "pallas" else RMSpropChain
    return cls(
        params, schedule, decay=hp.rmsprop_alpha, eps=hp.rmsprop_eps,
        momentum=hp.rmsprop_momentum, max_norm=hp.grad_norm_clipping,
    )


def entropy_schedule(hp: HParams):
    """optimizer state -> entropy cost for this update (None = the
    constant hp.entropy_cost). The anneal reads the optimizer's update
    count, the LR schedule's clock, in f32 as the reference does."""
    if hp.entropy_cost_final is None:
        return lambda opt_state: None
    total_updates = np.float32(updates_horizon(hp))

    def entropy_cost_at(opt_state):
        frac = min(np.float32(opt_state.count) / total_updates,
                   np.float32(1.0))
        return float(
            np.float32(hp.entropy_cost) + frac * np.float32(
                hp.entropy_cost_final - hp.entropy_cost
            )
        )

    return entropy_cost_at


def compute_loss(model, batch: Dict[str, torch.Tensor], initial_agent_state,
                 hp: HParams, entropy_cost=None):
    """Forward the full [T+1, B] batch and build the IMPALA loss.
    Returns (total_loss, stats), stats as 0-d device tensors."""
    if hp.loss != "vtrace":
        raise NotImplementedError(
            "--loss impact is not in the port yet: ROADMAP.md Queue 1 "
            "item 'IMPACT'"
        )
    learner_outputs, _ = model(batch, initial_agent_state,
                               sample_action=False)
    bootstrap_value = learner_outputs.baseline[-1]

    # Shift: env/behavior fields drop slot 0, learner outputs slot T.
    target_logits = learner_outputs.policy_logits[:-1]
    values = learner_outputs.baseline[:-1]
    behavior_logits = batch["policy_logits"][1:].float()
    actions = batch["action"][1:]
    rewards = batch["reward"][1:].float()
    done = batch["done"][1:]

    if hp.reward_clipping == "abs_one":
        rewards = torch.clamp(rewards, -1.0, 1.0)
    discounts = (~done).float() * hp.discounting

    pg_loss, baseline_loss = vtrace_policy_losses(
        behavior_policy_logits=behavior_logits,
        target_policy_logits=target_logits,
        actions=actions,
        discounts=discounts,
        rewards=rewards,
        values=values,
        bootstrap_value=bootstrap_value,
        scan_impl=hp.vtrace_impl,
    )
    baseline_loss = hp.baseline_cost * baseline_loss
    if entropy_cost is None:
        entropy_cost = hp.entropy_cost
    entropy_loss = entropy_cost * compute_entropy_loss(target_logits)
    total_loss = pg_loss + baseline_loss + entropy_loss

    episode_returns_sum = torch.sum(torch.where(
        done, batch["episode_return"][1:].float(), 0.0
    ))
    stats = {
        "total_loss": total_loss,
        "pg_loss": pg_loss,
        "baseline_loss": baseline_loss,
        "entropy_loss": entropy_loss,
        "aux_loss": torch.zeros((), device=total_loss.device),
        "episode_returns_sum": episode_returns_sum,
        "episode_count": torch.sum(done),
    }
    return total_loss, stats


def update_body(model, optimizer, hp: HParams):
    """The learner step:

    (batch, initial_agent_state) -> stats

    Forward, loss, gradient, then the optimizer updates the module's
    parameters (and its own state) in place. `optimizer` must have been
    built over `list(model.parameters())`.
    """
    entropy_cost_at = entropy_schedule(hp)
    params = list(model.parameters())
    if len(params) != len(optimizer.params) or any(
        p is not q for p, q in zip(params, optimizer.params)
    ):
        raise ValueError("the optimizer must hold model.parameters()")

    def update_step(batch, initial_agent_state):
        ecost = entropy_cost_at(optimizer.state)
        total_loss, stats = compute_loss(
            model, batch, initial_agent_state, hp, entropy_cost=ecost
        )
        grads = torch.autograd.grad(total_loss, params)
        stats = {k: v.detach() for k, v in stats.items()}
        # The optimizer's norm pass already sums the squares.
        stats["grad_norm"] = torch.sqrt(optimizer.step(grads))
        return stats

    return update_step


def act_body(model, env_output, agent_state, generator=None,
             sample_action: bool = True):
    """One T=1 acting step on `[B, ...]` env-output tensors: adds and
    strips the time axis around the time-major model."""
    batched = {k: v[None] for k, v in env_output.items()}
    out, new_state = model(batched, agent_state, sample_action=sample_action,
                           generator=generator)
    return AgentOutput(*(x[0] for x in out)), new_state


MODEL_INPUT_KEYS = ("frame", "reward", "done", "last_action")


def make_act_step(model, device):
    """(generator, env_output {key: [B, ...] numpy}, agent_state) ->
    (AgentOutput [B, ...] on `device`, new agent state on `device`).
    Sampled actions draw from `generator` (a torch.Generator on
    `device`)."""

    @torch.no_grad()
    def act_step(generator, env_output, agent_state):
        inputs = {
            k: torch.as_tensor(env_output[k]).to(device, non_blocking=True)
            for k in MODEL_INPUT_KEYS
        }
        return act_body(model, inputs, agent_state, generator)

    return act_step


def episode_stat_postprocess(stats: Dict[str, Any]) -> Dict[str, Any]:
    """Host-side: turn sum/count aggregates into mean_episode_return.
    Leaves are scalars or 1-D per-update arrays: episode sums and counts
    SUM, loss-like keys MEAN."""
    out = {}
    for key, v in stats.items():
        if torch.is_tensor(v):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v, np.float64)
        if key in ("episode_returns_sum", "episode_count"):
            out[key] = float(arr.sum())
        else:
            out[key] = float(arr.mean())
    count = out.pop("episode_count", 0.0)
    returns_sum = out.pop("episode_returns_sum", 0.0)
    if count > 0:
        out["mean_episode_return"] = returns_sum / count
    out["episodes_finished"] = count
    return out
