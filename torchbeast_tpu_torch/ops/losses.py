"""IMPALA loss functions (counterpart of torchbeast_tpu/ops/losses.py).

All reductions are sums over every element; the driver scales the total
by its cost coefficients.
"""

import torch
import torch.nn.functional as F

from torchbeast_tpu_torch.ops import vtrace as vtrace_lib
from torchbeast_tpu_torch.ops.vtrace import action_log_probs


def compute_baseline_loss(advantages):
    """0.5 * sum((vs - V)^2)."""
    return 0.5 * torch.sum(advantages ** 2)


def compute_entropy_loss(logits):
    """Negative entropy, sum(p * log p)."""
    policy = F.softmax(logits, dim=-1)
    log_policy = F.log_softmax(logits, dim=-1)
    return torch.sum(policy * log_policy)


def compute_policy_gradient_loss(logits, actions, advantages):
    """sum(-log pi(a) * advantage); the advantages carry no gradient."""
    cross_entropy = -action_log_probs(logits, actions)
    return torch.sum(cross_entropy * advantages.detach())


def vtrace_policy_losses(
    behavior_policy_logits,
    target_policy_logits,
    actions,
    discounts,
    rewards,
    values,
    bootstrap_value,
    clip_rho_threshold=1.0,
    clip_pg_rho_threshold=1.0,
    scan_impl="associative",
):
    """Fused V-trace targets + pg/baseline losses: (pg_loss,
    baseline_loss), sum-reduced scalars, the baseline loss without the
    driver's cost coefficient.

    One `action_log_probs` of the target logits serves both the
    importance weights and the policy-gradient cross-entropy. The
    targets are computed without gradient (with scan_impl="pallas" by the
    CUDA kernel, solve and advantages in one pass); gradients flow only
    through `target_policy_logits` (the cross-entropy) and `values` (the
    baseline regression). Everything accumulates in f32.
    """
    vtrace_lib.check_impl(scan_impl)
    target_alp = action_log_probs(target_policy_logits.float(), actions)
    behavior_alp = action_log_probs(behavior_policy_logits.float(), actions)
    values = values.float()
    with torch.no_grad():
        discounts, rewards, bootstrap_value = vtrace_lib._f32(
            discounts, rewards, bootstrap_value
        )
        values_sg = values.detach()
        rhos = torch.exp(target_alp.detach() - behavior_alp)
        clipped_rhos = (
            torch.clamp(rhos, max=clip_rho_threshold)
            if clip_rho_threshold is not None else rhos
        )
        cs = torch.clamp(rhos, max=1.0)
        values_t_plus_1 = torch.cat(
            [values_sg[1:], bootstrap_value[None]], 0
        )
        deltas = clipped_rhos * (
            rewards + discounts * values_t_plus_1 - values_sg
        )
        clipped_pg_rhos = (
            torch.clamp(rhos, max=clip_pg_rho_threshold)
            if clip_pg_rho_threshold is not None else rhos
        )
        if scan_impl == "pallas":
            vs, pg_advantages = vtrace_lib.vtrace_targets(
                (discounts * cs).contiguous(), deltas.contiguous(),
                clipped_pg_rhos.contiguous(), rewards.contiguous(),
                discounts.contiguous(), values_sg.contiguous(),
                bootstrap_value.contiguous(),
            )
        else:
            vs = vtrace_lib.vs_minus_v(
                deltas, discounts, cs, scan_impl
            ) + values_sg
            vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], 0)
            pg_advantages = clipped_pg_rhos * (
                rewards + discounts * vs_t_plus_1 - values_sg
            )
    pg_loss = torch.sum(-target_alp * pg_advantages)
    baseline_loss = compute_baseline_loss(vs - values)
    return pg_loss, baseline_loss
