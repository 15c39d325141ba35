"""V-trace off-policy actor-critic targets (IMPALA, arXiv:1802.01561);
counterpart of torchbeast_tpu/ops/vtrace.py.

The backward recursion

    acc_t = delta_t + discount_t * c_t * acc_{t+1},   vs = acc + V

runs one of three ways (`scan_impl`, the reference's SCAN_IMPLS):

- "sequential": a loop over t from T-1 down to 0;
- "associative": a log-depth (Hillis-Steele) scan over the affine maps
  f_t(x) = a_t x + b_t, the torch form of the reference's
  lax.associative_scan;
- "pallas": the hand-written CUDA kernel `csrc/vtrace.cu` (the reference's
  name for its fused kernel, kept so one command line runs on either
  package), which computes vs AND the policy-gradient advantages in one
  pass. On a CPU tensor it runs `vtrace_targets_plain`.

Contract (as in the reference): inputs are upcast to float32 on entry,
and no gradient flows through either output.
"""

import collections

import torch
import torch.nn.functional as F

from torchbeast_tpu_torch.ops import _build
from torchbeast_tpu_torch.ops._route import require, use_kernel

VTraceFromLogitsReturns = collections.namedtuple(
    "VTraceFromLogitsReturns",
    [
        "vs",
        "pg_advantages",
        "log_rhos",
        "behavior_action_log_probs",
        "target_action_log_probs",
    ],
)

VTraceReturns = collections.namedtuple("VTraceReturns", "vs pg_advantages")

SCAN_IMPLS = ("sequential", "associative", "pallas")


def action_log_probs(policy_logits, actions):
    """log pi(a | x) for integer actions: logits [..., A], actions [...]."""
    log_pi = F.log_softmax(policy_logits, dim=-1)
    return torch.gather(
        log_pi, -1, actions.long().unsqueeze(-1)
    ).squeeze(-1)


def _f32(*tensors):
    """The f32-accumulate entry cast."""
    return tuple(torch.as_tensor(t).float() for t in tensors)


def check_impl(scan_impl):
    if scan_impl not in SCAN_IMPLS:
        raise ValueError(
            f"scan_impl {scan_impl!r} must be one of {SCAN_IMPLS}"
        )


def vs_minus_v(deltas, discounts, cs, scan_impl):
    """Solve the recursion for acc ([T, ...]); vs = acc + values.
    Only the two torch formulations: "pallas" solves the fused form in
    `vtrace_targets`."""
    a = discounts * cs
    if scan_impl == "sequential":
        acc = torch.zeros_like(deltas[0])
        out = torch.empty_like(deltas)
        for t in range(deltas.shape[0] - 1, -1, -1):
            acc = deltas[t] + a[t] * acc
            out[t] = acc
        return out
    # Prefix-compose the time-reversed maps: element k of the flipped
    # sequence becomes (A, B) with acc = B, combining an earlier prefix p
    # into a later element q as q o p = (qa pa, qa pb + qb).
    fa = torch.flip(a, (0,))
    fb = torch.flip(deltas, (0,))
    T = fa.shape[0]
    d = 1
    while d < T:
        na = fa.clone()
        nb = fb.clone()
        na[d:] = fa[d:] * fa[:-d]
        nb[d:] = fa[d:] * fb[:-d] + fb[d:]
        fa, fb = na, nb
        d *= 2
    return torch.flip(fb, (0,))


def vtrace_targets_plain(a, deltas, clipped_pg_rhos, rewards, discounts,
                         values, bootstrap_value):
    """The plain PyTorch version of the CUDA kernel: one reverse loop that
    yields (vs, pg_advantages), the same operations in the same order."""
    vs = torch.empty_like(values)
    pg = torch.empty_like(values)
    acc = torch.zeros_like(bootstrap_value)
    vs_next = bootstrap_value
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + a[t] * acc
        vs_t = acc + values[t]
        pg[t] = clipped_pg_rhos[t] * (
            rewards[t] + discounts[t] * vs_next - values[t]
        )
        vs[t] = vs_t
        vs_next = vs_t
    return vs, pg


def vtrace_targets(a, deltas, clipped_pg_rhos, rewards, discounts, values,
                   bootstrap_value):
    """(vs, pg_advantages), both [T, ...] float32, with no gradient.

    a = discounts * cs; deltas = clipped_rhos * (r + disc * V_{t+1} - V).
    Every [T, ...] input is f32 and contiguous with one shape, and
    bootstrap_value is [...]. A CUDA tensor launches csrc/vtrace.cu (the
    trailing dims flattened into B; a block takes 32 columns: one warp
    stages chunks of rows of the six inputs in shared memory, one runs the
    chain on them, a lane a column, two write the outputs); a CPU tensor
    takes `vtrace_targets_plain`.
    """
    name = "vtrace_targets"
    seq = (a, deltas, clipped_pg_rhos, rewards, discounts, values)
    shape = values.shape
    require(len(shape) >= 1 and shape[0] > 0, name, f"bad shape {shape}")
    require(tuple(bootstrap_value.shape) == tuple(shape[1:]), name,
            f"bootstrap_value {tuple(bootstrap_value.shape)} must be "
            f"{tuple(shape[1:])}")
    for t in seq + (bootstrap_value,):
        require(t.dtype == torch.float32, name, f"dtype {t.dtype} != f32")
        require(t.device == values.device, name, "inputs on two devices")
    for t in seq:
        require(t.shape == shape, name, f"shape {tuple(t.shape)} != "
                f"{tuple(shape)}")
    with torch.no_grad():
        if not use_kernel(values, name):
            return vtrace_targets_plain(
                a, deltas, clipped_pg_rhos, rewards, discounts, values,
                bootstrap_value,
            )
        for t in seq + (bootstrap_value,):
            require(t.is_contiguous(), name, "inputs must be contiguous")
        T = shape[0]
        B = values.numel() // T
        vs = torch.empty_like(values)
        pg = torch.empty_like(values)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        lib = _build.library()
        with torch.cuda.device(values.device):
            status = lib.tbt_vtrace_targets(
                a.data_ptr(), deltas.data_ptr(), clipped_pg_rhos.data_ptr(),
                rewards.data_ptr(), discounts.data_ptr(), values.data_ptr(),
                bootstrap_value.data_ptr(), vs.data_ptr(), pg.data_ptr(),
                T, B, stream,
            )
        _build.check(status, name)
        vtrace_targets.launches += 1
        return vs, pg


vtrace_targets.launches = 0


def from_logits(
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
    """V-trace for softmax policies."""
    target_action_log_probs = action_log_probs(target_policy_logits, actions)
    behavior_action_log_probs = action_log_probs(
        behavior_policy_logits, actions
    )
    log_rhos = target_action_log_probs - behavior_action_log_probs
    vtrace_returns = from_importance_weights(
        log_rhos=log_rhos,
        discounts=discounts,
        rewards=rewards,
        values=values,
        bootstrap_value=bootstrap_value,
        clip_rho_threshold=clip_rho_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold,
        scan_impl=scan_impl,
    )
    return VTraceFromLogitsReturns(
        log_rhos=log_rhos,
        behavior_action_log_probs=behavior_action_log_probs,
        target_action_log_probs=target_action_log_probs,
        **vtrace_returns._asdict(),
    )


def from_importance_weights(
    log_rhos,
    discounts,
    rewards,
    values,
    bootstrap_value,
    clip_rho_threshold=1.0,
    clip_pg_rho_threshold=1.0,
    scan_impl="associative",
):
    """V-trace from log importance weights. Inputs are time-major
    `[T, B, ...]`, `bootstrap_value` is `[B, ...]`; returns
    VTraceReturns(vs, pg_advantages), float32 and without gradient."""
    check_impl(scan_impl)
    with torch.no_grad():
        log_rhos, discounts, rewards, values, bootstrap_value = _f32(
            log_rhos, discounts, rewards, values, bootstrap_value
        )
        rhos = torch.exp(log_rhos)
        clipped_rhos = (
            torch.clamp(rhos, max=clip_rho_threshold)
            if clip_rho_threshold is not None else rhos
        )
        cs = torch.clamp(rhos, max=1.0)
        values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], 0)
        deltas = clipped_rhos * (
            rewards + discounts * values_t_plus_1 - values
        )
        clipped_pg_rhos = (
            torch.clamp(rhos, max=clip_pg_rho_threshold)
            if clip_pg_rho_threshold is not None else rhos
        )
        if scan_impl == "pallas":
            vs, pg_advantages = vtrace_targets(
                (discounts * cs).contiguous(), deltas.contiguous(),
                clipped_pg_rhos.contiguous(), rewards.contiguous(),
                discounts.contiguous(), values.contiguous(),
                bootstrap_value.contiguous(),
            )
            return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
        vs = vs_minus_v(deltas, discounts, cs, scan_impl) + values
        vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], 0)
        pg_advantages = clipped_pg_rhos * (
            rewards + discounts * vs_t_plus_1 - values
        )
        return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
