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

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from torchbeast_tpu_torch.ops import compute_entropy_loss, vtrace_policy_losses
from torchbeast_tpu_torch.ops.opt import FusedRMSpropTail, linear_schedule
from torchbeast_tpu_torch.types import AgentOutput


class HParams(NamedTuple):
    """Learner hyperparameters, the reference's fields and defaults. The
    port takes loss "vtrace" and replay_reuse 1 only; compute_loss raises
    for the others."""

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
    """--opt_impl xla: the torch form of the reference's optax chain
    (torchbeast_tpu/learner.py make_optimizer), one op at a time in its
    order. State, construction and interface (`step` returns the squared
    global norm) are FusedRMSpropTail's; only `step`'s body differs.

    - Clip: the gradients widened to f32, their global norm, and
      `where(norm < max_norm, g, (g / norm) * max_norm)` (optax's
      clip_by_global_norm, and _clip_by_global_norm_f32 for bf16 grads).
    - RMSprop, as each branch of the reference's _rmsprop_torch:
      with f32 state it is optax.rmsprop (eps outside the sqrt):
      nu = (1 - decay) g^2 + decay nu, u = (1 / (sqrt(nu) + eps)) g, then
      the LR, then the momentum trace; with compact state (`state_dtype`
      bf16) it is _scale_by_rms_torch: nu = decay nu + (1 - decay) g^2 in
      f32, u = g / (sqrt(nu) + eps), nu stored narrowed, then the trace,
      then the LR. The two orders agree while the LR holds still.
    - Factored (`factored`, --factored_opt_state): the reference's
      _scale_by_factored_rms_torch on each JAX leaf in its own layout
      (`layouts`, from weights.jax_layouts, required: a conv weight's
      OIHW axes are not the reference's HWIO ones): a leaf of 2 or more
      dims keeps f32 EMAs of the mean of g^2 over its last axis (row) and
      its second-last (col) and divides by
      sqrt((row / mean(row)) x col) + eps; a vector keeps the full nu.
      The composed order: then the trace, then the LR. `state.nu` holds,
      per tensor, one (row, col, nu) triple per JAX leaf.
    - Apply: params += u; bf16 params (the reference's
      _bf16_resident_params) add u to the f32 master and become
      bf16(master), one narrowing cast per leaf."""

    def __init__(self, params, learning_rate, decay: float, eps: float,
                 momentum: float = 0.0, max_norm: Optional[float] = None,
                 param_dtype: str = "f32", state_dtype=None,
                 factored: bool = False, layouts=None):
        super().__init__(params, learning_rate, decay, eps,
                         momentum=momentum, max_norm=max_norm,
                         param_dtype=param_dtype, state_dtype=state_dtype)
        # optax.rmsprop applies the LR before the trace; the composed
        # chain of compact or factored state after it.
        self.lr_first = (not factored
                         and self.state.nu[0].dtype == torch.float32)
        self.layouts = None
        if factored:
            if layouts is None or len(layouts) != len(self.params):
                raise ValueError(
                    "the factored second moment needs each parameter's "
                    "JAX leaves: pass layouts=weights.jax_layouts(model)")
            self.layouts = layouts
            self.state = self.state._replace(nu=[
                [_factored_leaf(v) for v in views(p)]
                for p, (views, _) in zip(self.params, self.layouts)
            ])

    def step(self, grads) -> torch.Tensor:
        lr = self.schedule(self.state.count)
        st = self.state
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
            for i, (p, g, nu) in enumerate(zip(self.params, grads, st.nu)):
                if self.lr_first:
                    nu.copy_((1.0 - self.decay) * (g * g) + self.decay * nu)
                    upd = (1.0 / (torch.sqrt(nu) + self.eps)) * g
                    upd = upd * -lr
                    upd = self._trace(i, upd)
                elif self.layouts is not None:
                    views, join = self.layouts[i]
                    upd = join([self._factored(leaf, v) for leaf, v in
                                zip(nu, views(g))])
                    upd = self._trace(i, upd) * -lr
                else:
                    nu_f = self.decay * nu.float() + (1.0 - self.decay) * (
                        g * g)
                    upd = g / (torch.sqrt(nu_f) + self.eps)
                    nu.copy_(nu_f)
                    upd = self._trace(i, upd) * -lr
                if st.master is None:
                    p.add_(upd)
                else:
                    st.master[i].add_(upd)
                    p.copy_(st.master[i])
        self.state = st._replace(count=st.count + 1)
        return sumsq

    def _factored(self, leaf, g):
        """One JAX leaf's factored scaling; updates its (row, col, nu)."""
        row, col, nu = leaf
        g2 = g * g
        d = self.decay
        if g.dim() >= 2:
            row.copy_(d * row + (1.0 - d) * g2.mean(dim=-1))
            col.copy_(d * col + (1.0 - d) * g2.mean(dim=-2))
            scale = torch.clamp(row.mean(dim=-1, keepdim=True), min=1e-30)
            v_hat = (row / scale)[..., None] * col[..., None, :]
            return g / (torch.sqrt(v_hat) + self.eps)
        nu.copy_(d * nu + (1.0 - d) * g2)
        return g / (torch.sqrt(nu) + self.eps)

    def _trace(self, i, upd):
        """optax.trace: mom = upd + momentum * mom, the new update."""
        if not self.momentum:
            return upd
        mom = self.state.mom[i]
        mom.copy_(upd + self.momentum * mom)
        return mom


def _factored_leaf(v):
    """Zero (row, col, nu) of one JAX leaf's factored second moment: row
    and col EMAs for 2+ dims, the full nu for vectors and scalars, an
    empty placeholder for the other side."""
    z = lambda shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                  device=v.device)
    if v.dim() >= 2:
        return (z(v.shape[:-1]), z(v.shape[:-2] + v.shape[-1:]), z((0,)))
    return (z((0,)), z((0,)), z(v.shape))


def make_optimizer(hp: HParams, params, layouts=None):
    """torch.optim.RMSprop semantics + grad clip + linear LR decay over
    `params` (a list of the module's parameters, updated in place; cast
    to the policy's resident dtype first). hp.opt_state_dtype "bf16"
    stores the second moment half-width, hp.param_dtype "bf16" keeps an
    f32 master of bf16-resident params, as the reference's make_optimizer
    does; hp.opt_factored takes the factored second moment over each
    JAX leaf of `layouts` (weights.jax_layouts(model); see
    RMSpropChain)."""
    if hp.opt_state_dtype not in ("f32", "bf16"):
        raise ValueError(
            f"opt_state_dtype must be 'f32' or 'bf16', got "
            f"{hp.opt_state_dtype!r}"
        )
    if hp.param_dtype not in ("f32", "bf16"):
        raise ValueError(
            f"param_dtype must be 'f32' or 'bf16', got {hp.param_dtype!r}"
        )
    if hp.opt_impl not in ("xla", "pallas"):
        raise ValueError(
            f"opt_impl must be 'xla' or 'pallas', got {hp.opt_impl!r}"
        )
    if hp.opt_factored and hp.opt_impl == "pallas":
        raise ValueError(
            "--opt_impl pallas does not compose with "
            "--factored_opt_state (the fused tail implements the "
            "exact elementwise torch-RMSprop only)"
        )
    schedule = linear_schedule(hp.learning_rate, 0.0, updates_horizon(hp))
    kw = dict(decay=hp.rmsprop_alpha, eps=hp.rmsprop_eps,
              momentum=hp.rmsprop_momentum, max_norm=hp.grad_norm_clipping,
              param_dtype=hp.param_dtype, state_dtype=hp.opt_state_dtype)
    if hp.opt_impl == "pallas":
        return FusedRMSpropTail(params, schedule, **kw)
    return RMSpropChain(params, schedule, factored=hp.opt_factored,
                        layouts=layouts, **kw)


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
