"""The IMPALA learner update in plain PyTorch (Espeholt et al. 2018).

The network's outputs over the [T+1, B] rollout give the learner's
logits and values at steps 0..T-1 and the bootstrap value at step T;
the rollout's behaviour logits, actions, rewards and dones are taken at
steps 1..T. Rewards are clipped to [-1, 1]; discounts are `discounting`
where the next frame does not start an episode. V-trace with rho-bar,
c-bar and the policy-gradient rho-bar all 1 gives the targets vs and the
advantages. The loss is the sum over T x B of the policy gradient
-log pi(a) * advantage, `baseline_cost` * 0.5 (vs - V)^2 and
`entropy_cost` * sum(pi log pi). The gradient is clipped to a global
norm of `grad_norm_clipping`; RMSprop keeps nu = alpha nu + (1 - alpha)
g^2 and steps by lr g / (sqrt(nu) + epsilon), the learning rate decaying
linearly from `learning_rate` to 0 over total_steps / (T B) updates.
"""

import torch
import torch.nn.functional as F


def _log_prob(logits, actions):
    return F.log_softmax(logits, -1).gather(
        -1, actions.long().unsqueeze(-1)).squeeze(-1)


def loss(logits, baseline, batch, hp):
    """The total loss of one update from the network's [T+1, B] outputs."""
    learner_logits, values = logits[:-1], baseline[:-1]
    bootstrap = baseline[-1]
    actions = batch["action"][1:]
    rewards = torch.clamp(batch["reward"][1:].float(), -1.0, 1.0)
    discounts = (~batch["done"][1:]).float() * hp["discounting"]
    log_pi = _log_prob(learner_logits, actions)
    with torch.no_grad():
        log_mu = _log_prob(batch["policy_logits"][1:].float(), actions)
        rho = torch.clamp(torch.exp(log_pi - log_mu), max=1.0)
        v = values.detach()
        v_next = torch.cat([v[1:], bootstrap.detach()[None]])
        deltas = rho * (rewards + discounts * v_next - v)
        vs = torch.empty_like(v)
        acc = torch.zeros_like(bootstrap)
        for t in range(v.shape[0] - 1, -1, -1):
            acc = deltas[t] + discounts[t] * rho[t] * acc
            vs[t] = v[t] + acc
        vs_next = torch.cat([vs[1:], bootstrap.detach()[None]])
        advantages = rho * (rewards + discounts * vs_next - v)
    pg = torch.sum(-log_pi * advantages)
    base = hp["baseline_cost"] * 0.5 * torch.sum((vs - values) ** 2)
    policy = F.softmax(learner_logits, -1)
    entropy = hp["entropy_cost"] * torch.sum(
        policy * F.log_softmax(learner_logits, -1))
    return pg + base + entropy


def learning_rate(hp, count: int, frames_per_update: int) -> float:
    horizon = max(1, hp["total_steps"] // frames_per_update)
    return hp["learning_rate"] * (1.0 - min(count, horizon) / horizon)


def train(net_module, net, num_actions, params, steps, hp):
    """Run the updates `steps` ([(batch, initial state)]) from `params`
    ({name: f32 tensor}, left as they are). Returns (each update's loss,
    the first update's clipped gradient {name: tensor}, the first
    update's change of the params {name: tensor}, the params after the
    last update {name: tensor})."""
    start = params
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    names = list(params)
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad, first_step = [], None, None
    for count, (batch, state) in enumerate(steps):
        T1, B = batch["frame"].shape[:2]
        logits, baseline = net_module.forward(params, batch, state, net,
                                              num_actions)
        total = loss(logits, baseline, batch, hp)
        grads = torch.autograd.grad(total, [params[k] for k in names])
        losses.append(float(total.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            clip = hp["grad_norm_clipping"]
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            grads = [g * scale for g in grads]
            if first_grad is None:
                first_grad = dict(zip(names, grads))
            lr = learning_rate(hp, count, (T1 - 1) * B)
            for k, g in zip(names, grads):
                nu[k] = hp["alpha"] * nu[k] + (1.0 - hp["alpha"]) * g * g
                params[k] -= lr * g / (torch.sqrt(nu[k]) + hp["epsilon"])
            if first_step is None:
                first_step = {k: params[k].detach() - v
                              for k, v in start.items()}
    return (losses, first_grad, first_step,
            {k: v.detach() for k, v in params.items()})
