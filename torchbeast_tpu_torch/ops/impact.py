"""IMPACT surrogate objective (Luo et al.): a clipped target-network
policy loss that tolerates the policy lag of samples reused K'-fold from
the replay arena (counterpart of torchbeast_tpu/ops/impact.py).

Three policies meet in this loss:

- the behavior policy mu, whatever served the rollout (its logits ride
  the batch as `policy_logits`, as for V-trace);
- the target network pi_target, a lagged copy of the learner's params
  refreshed every --target_refresh_updates updates (learner.TargetNetwork;
  its forward outputs ride the batch under learner.TARGET_LOGITS_KEY and
  TARGET_BASELINE_KEY);
- the learner policy pi_theta, the params being optimized.

The V-trace correction runs between mu and pi_target, both constants
with respect to theta, so the recursion carries no gradient and the
V-trace machinery of ops/vtrace.py serves it unchanged (with
scan_impl="pallas" the CUDA kernel csrc/vtrace.cu). The policy gradient
then flows through a PPO-style clipped surrogate on pi_theta/pi_target:

    rho      = exp(log pi_target(a) - log mu(a))        (V-trace clip)
    vs, A    = vtrace(rho, rewards, V_target)           (no gradient)
    ratio    = exp(log pi_theta(a) - log pi_target(a))
    pg_loss  = -sum min(ratio * A, clip(ratio, 1-eps, 1+eps) * A)
    baseline = 0.5 * sum (vs - V_theta)^2

At zero lag the ratio is 1, so with the clip wide open the surrogate's
gradient equals V-trace's: d/dtheta[ratio * A] = A * d/dtheta[log
pi_theta(a)] at ratio 1. The values differ by construction.

Every input is upcast to f32 on entry, so the ratio and clip accumulate
in f32 under --precision bf16_train.
"""

import torch

from torchbeast_tpu_torch.ops import vtrace as vtrace_lib
from torchbeast_tpu_torch.ops.losses import compute_baseline_loss
from torchbeast_tpu_torch.ops.vtrace import action_log_probs


def impact_policy_losses(
    behavior_policy_logits,
    target_net_policy_logits,
    learner_policy_logits,
    actions,
    discounts,
    rewards,
    target_net_values,
    values,
    target_net_bootstrap_value,
    clip_rho_threshold=1.0,
    clip_pg_rho_threshold=1.0,
    clip_epsilon=0.2,
    scan_impl="associative",
):
    """IMPACT targets and the clipped-surrogate pg and baseline losses:
    (pg_loss, baseline_loss), sum-reduced scalars, the baseline loss
    without the driver's cost coefficient.

    [T, B(, A)] inputs as for `vtrace_policy_losses`. Gradients flow only
    through `learner_policy_logits` (the surrogate) and `values` (the
    baseline regression); everything derived from mu or the target
    network is a constant. `clip_epsilon=None` leaves the surrogate
    unclipped.
    """
    vtrace_lib.check_impl(scan_impl)
    learner_alp = action_log_probs(learner_policy_logits.float(), actions)
    values = values.float()
    with torch.no_grad():
        target_alp = action_log_probs(
            target_net_policy_logits.detach().float(), actions)
        behavior_alp = action_log_probs(
            behavior_policy_logits.detach().float(), actions)
        log_rhos = target_alp - behavior_alp
        discounts, rewards = vtrace_lib._f32(discounts, rewards)
        target_values, bootstrap_value = vtrace_lib._f32(
            target_net_values.detach(), target_net_bootstrap_value.detach())

        rhos = torch.exp(log_rhos)
        clipped_rhos = (
            torch.clamp(rhos, max=clip_rho_threshold)
            if clip_rho_threshold is not None else rhos
        )
        cs = torch.clamp(rhos, max=1.0)
        values_t_plus_1 = torch.cat(
            [target_values[1:], bootstrap_value[None]], 0)
        deltas = clipped_rhos * (
            rewards + discounts * values_t_plus_1 - target_values
        )
        clipped_pg_rhos = (
            torch.clamp(rhos, max=clip_pg_rho_threshold)
            if clip_pg_rho_threshold is not None else rhos
        )
        if scan_impl == "pallas":
            vs, pg_advantages = vtrace_lib.vtrace_targets(
                (discounts * cs).contiguous(), deltas.contiguous(),
                clipped_pg_rhos.contiguous(), rewards.contiguous(),
                discounts.contiguous(), target_values.contiguous(),
                bootstrap_value.contiguous(),
            )
        else:
            vs = vtrace_lib.vs_minus_v(
                deltas, discounts, cs, scan_impl) + target_values
            vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], 0)
            pg_advantages = clipped_pg_rhos * (
                rewards + discounts * vs_t_plus_1 - target_values
            )

    ratio = torch.exp(learner_alp - target_alp)
    surrogate = ratio * pg_advantages
    if clip_epsilon is not None:
        clipped_surrogate = (
            torch.clamp(ratio, 1.0 - clip_epsilon, 1.0 + clip_epsilon)
            * pg_advantages
        )
        surrogate = torch.minimum(surrogate, clipped_surrogate)
    pg_loss = torch.sum(-surrogate)
    baseline_loss = compute_baseline_loss(vs - values)
    return pg_loss, baseline_loss
