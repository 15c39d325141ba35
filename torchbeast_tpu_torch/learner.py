"""The learner: loss, optimizer and the update step (counterpart of
torchbeast_tpu/learner.py).

Algorithm as in the reference: forward the [T+1, B] batch; bootstrap
from the last baseline; time-shift batch[1:] against outputs[:-1]; clip
rewards to [-1, 1]; discounts = ~done * gamma; V-trace (or, under --loss
impact, the IMPACT surrogate against the target network's outputs that
TargetNetwork merges into the batch); pg + baseline_cost
* baseline + entropy_cost * entropy losses, sum-reduced; gradient clip to
a global norm of 40; torch-semantics RMSprop (eps outside the sqrt); the
learning rate decays linearly to zero over the run's updates.

Where the reference builds one jitted XLA program, the port's update step
is PyTorch code: it launches the model's forward and backward, the V-trace
kernel (--vtrace_impl pallas) and the optimizer tail (--opt_impl pallas:
the fused kernel; xla: the torch form of the optax chain), and updates
the module's parameters in place. The drivers dispatch it through
make_update_dispatch: on the card as one captured CUDA graph per update or
per K-update superstep (graphs.py), on the CPU eagerly. The schedules
(the LR decay and the entropy anneal) read the optimizer's update count
on the device, so a replay applies its own update's values. The step
returns its stats as device tensors, so the driver reads them one
dispatch late without a sync per update.
"""

import copy
import threading
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from torchbeast_tpu_torch import graphs, nest, precision, telemetry
from torchbeast_tpu_torch.models.moe import recording_losses
from torchbeast_tpu_torch.ops import (
    compute_entropy_loss,
    impact_policy_losses,
    vtrace_policy_losses,
)
from torchbeast_tpu_torch.ops.opt import (
    FusedRMSpropTail,
    f32_constants,
    linear_schedule,
)
from torchbeast_tpu_torch.serving.snapshot import PolicySnapshotStore
from torchbeast_tpu_torch.types import AgentOutput


class HParams(NamedTuple):
    """Learner hyperparameters, the reference's fields and defaults: loss
    "vtrace" (IMPALA) or "impact" (the clipped target-network surrogate,
    ops/impact.py, clip impact_clip), and replay_reuse K', the updates
    each staged batch feeds (the drivers dispatch it K' times)."""

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
        st = self.state
        lr = self.tick()
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


class EntropySchedule:
    """The entropy anneal (hp.entropy_cost_final set): the cost moves
    linearly from hp.entropy_cost to entropy_cost_final over the run's
    updates, reading the optimizer's update count, the LR schedule's
    clock, in f32 as the reference does. Called with an optimizer state it
    returns the cost as a Python float holding an f32; `on_device(count)`
    computes the same bits from the device count."""

    def __init__(self, hp: HParams):
        self.total = np.float32(updates_horizon(hp))
        self.start = np.float32(hp.entropy_cost)
        self.span = np.float32(hp.entropy_cost_final - hp.entropy_cost)
        self._consts = {}

    def __call__(self, opt_state) -> float:
        frac = min(np.float32(opt_state.count) / self.total, np.float32(1.0))
        return float(self.start + frac * self.span)

    def on_device(self, count: torch.Tensor) -> torch.Tensor:
        one, total, start, span = f32_constants(
            self._consts, count.device, 1.0, self.total, self.start,
            self.span)
        frac = torch.minimum(count.float() / total, one)
        return start + frac * span


def entropy_schedule(hp: HParams):
    """The entropy anneal of `hp` (an EntropySchedule), or None for the
    constant hp.entropy_cost."""
    if hp.entropy_cost_final is None:
        return None
    return EntropySchedule(hp)


# Batch keys of --loss impact: the target network's forward outputs,
# [T+1, B, ...] like the learner's (slot T gives the target's bootstrap
# value), merged in by TargetNetwork.merge and popped by compute_loss.
TARGET_LOGITS_KEY = "impact_target_logits"
TARGET_BASELINE_KEY = "impact_target_baseline"


def target_forward_body(model, superstep_k: int = 1):
    """The target network's forward, eager: (batch, initial_agent_state)
    -> (policy_logits, baseline), both [T+1, B, ...] f32 without
    gradient; with superstep_k > 1 over [K, ...] stacks, one forward per
    K slice (the reference's vmap), stacked [K, T+1, B, ...]."""

    @torch.no_grad()
    def forward(batch, initial_agent_state):
        out, _ = model(batch, initial_agent_state, sample_action=False)
        return out.policy_logits.float(), out.baseline.float()

    if superstep_k == 1:
        return forward

    @torch.no_grad()
    def stacked(batches, initial_agent_states):
        outs = [forward(nest.map(lambda v: v[i], batches),
                        nest.map(lambda s: s[i], initial_agent_states))
                for i in range(superstep_k)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    return stacked


def make_target_forward(model, superstep_k: int = 1):
    """The target network's forward of `model` (the reference's
    make_target_forward, with the params the module's own):

        (batch, initial_agent_state) -> (target_policy_logits,
                                         target_baseline)

    On a CUDA device one CUDA graph (graphs.CapturedForward over the
    model's input keys and the state), captured at the first call and
    replayed on the caller's stream; its outputs are device tensors. On
    the CPU the eager forward (target_forward_body)."""
    body = target_forward_body(model, superstep_k)
    device = next(model.parameters()).device
    if device.type != "cuda":
        return body
    captured = []

    def forward(batch, initial_agent_state):
        inputs = {"batch": {k: batch[k] for k in MODEL_INPUT_KEYS},
                  "state": initial_agent_state}
        if not captured:
            captured.append(graphs.CapturedForward(
                lambda static: body(static["batch"], static["state"]),
                inputs, device))
        return captured[0](inputs)

    return forward


class TargetNetwork:
    """The IMPACT target network (--loss impact) of a learner `model`.

    - The params buffer: a second instance of the model, which the
      target forward (make_target_forward: a CUDA graph of its own on the
      card) reads.
    - Versions: a PolicySnapshotStore under the "learner.target"
      namespace with cast_bf16=False (a full-precision copy, so the
      forward equals one of the exact stamped params), version 0 the
      model's params at construction, published before any update;
      `maybe_refresh(updates_done, params)` stamps a new version every
      `refresh_updates` updates (the store's due rule).
    - `merge(batch, state)` puts the forward's outputs of the latest
      version on the batch under TARGET_LOGITS_KEY / TARGET_BASELINE_KEY
      (device tensors: on the card they reach the update graph's static
      buffers by device-to-device copies). A version newer than the one
      in the buffer is copied in first, under the lock the forward runs
      under.

    `TargetNetwork.forwards` counts the forwards of every instance in the
    process (chip_smoke.py reads it)."""

    forwards = 0

    def __init__(self, model, refresh_updates: int, superstep_k: int = 1,
                 registry=None):
        self.model = copy.deepcopy(model).requires_grad_(False)
        self._params = list(self.model.parameters())
        self.store = PolicySnapshotStore(
            refresh_updates, registry=registry, namespace="learner.target",
            cast_bf16=False)
        self._forward = make_target_forward(self.model, superstep_k)
        self._lock = threading.Lock()
        self._loaded = None  # guarded-by: self._lock
        self.store.publish(0, list(model.parameters()))

    def maybe_refresh(self, updates_done: int, params) -> bool:
        """Advance the store's head to `updates_done`; publish `params`
        (a copy) when a refresh is due. True when one was published."""
        if self.store.note_update(updates_done):
            return self.store.publish(updates_done, list(params))
        return False

    def _run(self, batch, initial_agent_state):
        version, params = self.store.latest()
        with self._lock:
            if self._loaded != version:
                with torch.no_grad():
                    torch._foreach_copy_(self._params, nest.flatten(params))
                self._loaded = version
            return self._forward(batch, initial_agent_state)

    def capture(self, batch, initial_agent_state) -> None:
        """Run the forward once on example inputs, uncounted: on the card
        this captures its graph, which must happen before other threads
        launch CUDA work."""
        self._run(batch, initial_agent_state)

    def outputs(self, batch, initial_agent_state):
        """(target logits, target baseline) of the latest version."""
        out = self._run(batch, initial_agent_state)
        TargetNetwork.forwards += 1
        return out

    def merge(self, batch, initial_agent_state):
        """A new batch dict: `batch` plus the target outputs."""
        logits, baseline = self.outputs(batch, initial_agent_state)
        return {**batch, TARGET_LOGITS_KEY: logits,
                TARGET_BASELINE_KEY: baseline}


def compute_loss(model, batch: Dict[str, torch.Tensor], initial_agent_state,
                 hp: HParams, entropy_cost=None):
    """Forward the full [T+1, B] batch and build the IMPALA loss.
    Returns (total_loss, stats), stats as 0-d device tensors.

    The losses the model records during this forward (the MoE
    load-balance loss, models/moe.recording_losses; the reference's
    sown "losses" collection) are added to the objective and reported as
    `aux_loss`; a model that records none reports a zero and adds
    nothing. Under a data shard's routing scope (models/moe.routing,
    parallel/dp.py) each layer records this shard's piece of the whole
    batch's loss, so the shards' aux_loss stats and gradients sum to the
    whole batch's."""
    # --loss impact: the target network's outputs ride the batch (merged
    # in by TargetNetwork.merge), popped from a shallow copy so the model
    # forward sees the stock batch and the caller's dict (a captured
    # graph's static batch) keeps its keys.
    batch = dict(batch)
    target_net_logits_full = batch.pop(TARGET_LOGITS_KEY, None)
    target_net_baseline_full = batch.pop(TARGET_BASELINE_KEY, None)
    with recording_losses() as recorded:
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

    if hp.loss == "impact":
        if target_net_logits_full is None:
            raise ValueError(
                "--loss impact requires the target network's outputs on "
                "the batch (TargetNetwork.merge puts them there)"
            )
        pg_loss, baseline_loss = impact_policy_losses(
            behavior_policy_logits=behavior_logits,
            target_net_policy_logits=target_net_logits_full[:-1],
            learner_policy_logits=target_logits,
            actions=actions,
            discounts=discounts,
            rewards=rewards,
            target_net_values=target_net_baseline_full[:-1],
            values=values,
            target_net_bootstrap_value=target_net_baseline_full[-1],
            clip_epsilon=hp.impact_clip,
            scan_impl=hp.vtrace_impl,
        )
    elif hp.loss == "vtrace":
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
    else:
        raise ValueError(f"loss must be 'vtrace' or 'impact', got "
                         f"{hp.loss!r}")
    baseline_loss = hp.baseline_cost * baseline_loss
    if entropy_cost is None:
        entropy_cost = hp.entropy_cost
    entropy_loss = entropy_cost * compute_entropy_loss(target_logits)
    total_loss = pg_loss + baseline_loss + entropy_loss
    if recorded:
        aux_loss = sum(recorded.values())
        total_loss = total_loss + aux_loss
    else:
        aux_loss = torch.zeros((), device=total_loss.device)

    episode_returns_sum = torch.sum(torch.where(
        done, batch["episode_return"][1:].float(), 0.0
    ))
    stats = {
        "total_loss": total_loss,
        "pg_loss": pg_loss,
        "baseline_loss": baseline_loss,
        "entropy_loss": entropy_loss,
        "aux_loss": aux_loss,
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
    anneal = entropy_schedule(hp)
    params = list(model.parameters())
    if len(params) != len(optimizer.params) or any(
        p is not q for p, q in zip(params, optimizer.params)
    ):
        raise ValueError("the optimizer must hold model.parameters()")

    def update_step(batch, initial_agent_state):
        # The anneal reads the device count (before this update ticks it),
        # so a captured update computes each replay's own cost.
        ecost = (None if anneal is None
                 else anneal.on_device(optimizer.device_count))
        total_loss, stats = compute_loss(
            model, batch, initial_agent_state, hp, entropy_cost=ecost
        )
        grads = torch.autograd.grad(total_loss, params)
        stats = {k: v.detach() for k, v in stats.items()}
        # The optimizer's norm pass already sums the squares.
        stats["grad_norm"] = torch.sqrt(optimizer.step(grads))
        return stats

    return update_step


def superstep_body(model, optimizer, hp: HParams):
    """The K-update superstep (the port of the reference's
    superstep_body):

    (batches [K, T+1, B, ...], initial_agent_states [K, ...]) -> stats

    K applications of the exact update_body, in order (the reference's
    lax.scan becomes a loop), so one dispatch performs K parameter
    updates; the optimizer's count, the clock of the LR decay and the
    entropy anneal, ticks once per update, not once per dispatch. Each
    stat comes back stacked [K]: the host reads them once per K updates.
    """
    step = update_body(model, optimizer, hp)

    def superstep(batches, initial_agent_states):
        per_update = [
            step(nest.map(lambda v: v[i], batches),
                 nest.map(lambda s: s[i], initial_agent_states))
            for i in range(nest.front(batches).shape[0])
        ]
        return {key: torch.stack([s[key] for s in per_update])
                for key in per_update[0]}

    return superstep


def make_update_superstep(model, optimizer, hp: HParams, k: int):
    """The K-update superstep (see superstep_body) over inputs stacked
    [K, ...]. Each staged stack is read by exactly one dispatch (the
    reference's donate_batch / consume_staged_inputs rule): the drivers
    release a stack's host arena slot once that dispatch's stats are on
    the host."""
    if k < 1:
        raise ValueError(f"superstep k must be >= 1, got {k}")
    body = superstep_body(model, optimizer, hp)

    def superstep(batches, initial_agent_states):
        got = nest.front(batches).shape[0]
        if got != k:
            raise ValueError(f"a K={k} superstep got a stack of {got}")
        return body(batches, initial_agent_states)

    return superstep


def make_update_dispatch(model, optimizer, hp: HParams, k: int = 1):
    """The drivers' learner dispatch: (batch, initial_agent_state) ->
    stats of `k` updates. k=1 takes [T+1, B, ...] inputs (update_body),
    k>1 [K, T+1, B, ...] inputs with [K] stats (make_update_superstep).
    On a CUDA device it is one CUDA graph per dispatch
    (graphs.CapturedUpdate: captured at the first call, or by its
    `capture` method from example inputs), with every stat an f32 tensor;
    on the CPU the eager step."""
    step = (update_body(model, optimizer, hp) if k == 1
            else make_update_superstep(model, optimizer, hp, k))
    if optimizer.device_count.device.type == "cuda":
        return graphs.CapturedUpdate(step, optimizer, k)
    return step


def instrument_update_step(update_step, registry=None, superstep_k=1):
    """Wrap a dispatch (make_update_dispatch's) with the reference's
    learner-side telemetry (torchbeast_tpu/learner.py
    `instrument_update_step`):

    - learner.update_dispatch_s: host time to hand the update to the
      card (a graph replay; on the CPU the eager update itself);
    - learner.batch_bytes: bytes of the batch + initial agent state per
      dispatch;
    - learner.updates: +superstep_k per dispatch;
    - learner.superstep_k (gauge) and learner.updates_per_dispatch;
    - learner.host_syncs: the drivers call `wrapped.count_host_sync()`
      per stats fetch (once per K updates under supersteps);
    - learner.hbm_bytes_per_update (gauge): the bytes ONE update accesses
      (precision.count_bytes: the aten ops' operands and results, plus
      the hand kernels' own), set once at the first dispatch. On the card
      the figure comes from the first eager warm-up run of the dispatch's
      CUDA graph (graphs.CapturedUpdate.bytes_accessed; nothing is counted
      inside a capture), on the CPU from the first eager dispatch. A
      superstep body loops over its K updates, so the dispatch's figure is
      divided by K (the reference's scan counts its body once).
    """
    reg = registry if registry is not None else telemetry.get_registry()
    h_dispatch = reg.histogram("learner.update_dispatch_s")
    h_per_dispatch = reg.histogram("learner.updates_per_dispatch")
    c_bytes = reg.counter("learner.batch_bytes")
    c_updates = reg.counter("learner.updates")
    c_host_syncs = reg.counter("learner.host_syncs")
    reg.gauge("learner.superstep_k").set(superstep_k)
    g_hbm = reg.gauge("learner.hbm_bytes_per_update")
    # Single consumer (the learner thread): a plain flag, no lock.
    hbm_pending = [True]

    def wrapped(batch, initial_agent_state):
        nbytes = sum(
            int(t.numel() * t.element_size()) if torch.is_tensor(t)
            else int(getattr(t, "nbytes", 0))
            for t in nest.flatten((batch, initial_agent_state)))
        t0 = time.perf_counter()
        if hbm_pending[0]:
            hbm_pending[0] = False
            out, accessed = _counted_dispatch(update_step, batch,
                                              initial_agent_state)
            if accessed:
                g_hbm.set(accessed / superstep_k)
        else:
            out = update_step(batch, initial_agent_state)
        h_dispatch.observe(time.perf_counter() - t0)
        c_bytes.inc(nbytes)
        c_updates.inc(superstep_k)
        h_per_dispatch.observe(superstep_k)
        return out

    wrapped.count_host_sync = lambda: c_host_syncs.inc()
    return wrapped


def _counted_dispatch(update_step, batch, initial_agent_state):
    """(stats, bytes one dispatch accessed): a CUDA graph's figure is its
    capture's first warm-up run's (captured now if it was not yet; a
    data-parallel dispatch, parallel.ParallelUpdate, says with
    `captures_graphs` whether it captures); an eager dispatch is counted
    as it runs."""
    if getattr(update_step, "captures_graphs",
               isinstance(update_step, graphs.CapturedUpdate)):
        out = update_step(batch, initial_agent_state)
        return out, update_step.bytes_accessed
    with precision.count_bytes() as counted:
        out = update_step(batch, initial_agent_state)
    return out, counted.total


def stack_superstep_columns(batch, initial_agent_state, k: int,
                            columns: int, offset: int = 0,
                            batch_dim: int = 1):
    """Host-side superstep staging for the sync driver (a copy of the
    reference's): slice `k` consecutive `columns`-wide groups out of a
    wide [T+1, B_total, ...] unroll batch (from column `offset`) and stack
    them into the [K, T+1, columns, ...] superstep layout (states [K, ...]
    likewise). numpy leaves become fresh numpy stacks, tensor leaves fresh
    tensors on their device: the staged stack aliases nothing the
    collector still owns."""

    def stack(v):
        head = (slice(None),) * batch_dim
        parts = [v[head + (slice(offset + j * columns,
                                 offset + (j + 1) * columns),)]
                 for j in range(k)]
        if torch.is_tensor(v):
            return torch.stack(parts)
        return np.stack([np.asarray(p) for p in parts])

    return (
        {key: stack(v) for key, v in batch.items()},
        nest.map(stack, initial_agent_state),
    )


def act_body(model, env_output, agent_state, generator=None,
             sample_action: bool = True):
    """One T=1 acting step on `[B, ...]` env-output tensors: adds and
    strips the time axis around the time-major model."""
    batched = {k: v[None] for k, v in env_output.items()}
    out, new_state = model(batched, agent_state, sample_action=sample_action,
                           generator=generator)
    return AgentOutput(*(x[0] for x in out)), new_state


MODEL_INPUT_KEYS = ("frame", "reward", "done", "last_action")


def make_act_step(model, device, generator=None):
    """(env_output {key: [B, ...] numpy}, agent_state) ->
    (AgentOutput [B, ...] on `device`, new agent state on `device`).
    Sampled actions draw from `generator` (a torch.Generator on
    `device`).

    On a CUDA device the step is one CUDA graph (graphs.CapturedAct),
    captured at the first call for that call's B. The new state it
    returns is the graph's static state buffer, which the next call
    overwrites in place: a caller that keeps a state across calls clones
    it, and passing the returned state back skips its copy. On the CPU
    the step runs eagerly."""
    device = torch.device(device)

    @torch.no_grad()
    def eager(env_output, agent_state):
        inputs = {
            k: torch.as_tensor(env_output[k]).to(device, non_blocking=True)
            for k in MODEL_INPUT_KEYS
        }
        return act_body(model, inputs, agent_state, generator)

    if device.type != "cuda":
        return eager

    captured = []

    def graph_step(static):
        out, new_state = act_body(model, static["env"], static["state"],
                                  generator)
        for dst, src in zip(nest.flatten(static["state"]),
                            nest.flatten(new_state)):
            dst.copy_(src)
        return out

    def act_step(env_output, agent_state):
        inputs = {"env": {k: env_output[k] for k in MODEL_INPUT_KEYS},
                  "state": agent_state}
        if not captured:
            captured.append(graphs.CapturedAct(graph_step, inputs, device,
                                               generator))
        graph = captured[0]
        return graph(inputs), graph.inputs["state"]

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
