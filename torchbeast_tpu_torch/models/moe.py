"""Mixture-of-experts feed-forward layer (counterpart of
torchbeast_tpu/models/moe.py, on one device: the reference's `mesh` and
its expert-axis sharding constraints stay out, ROADMAP.md Queue 1 item
'expert parallel').

Routing, as the reference's (moe.py:59-148): each token takes its top-k
experts by router probability (a softmax in f32 over a bias-free router,
whatever the compute dtype); the k gates are renormalized to sum to 1
(+ 1e-9); an expert takes at most `capacity` = ceil(k * tokens / E *
capacity_factor) assignments, rank-0 selections of every token before
any rank-1 one, then token order; an assignment past capacity is dropped
(the token loses that expert's share; the residual around the layer
carries it). Dispatch and combine are dense one-hot products, the expert
MLPs batched matmuls over the expert axis, gelu the tanh form (flax's
`nn.gelu`). The experts run in `dtype`; the combine and the output are
f32.

Two points where torch differs from jax, handled here:

- Ties. `jax.lax.top_k` puts the lower index first among equal
  probabilities; `torch.topk` promises no order. The top-k here is the
  head of a stable descending sort, which keeps index order among ties
  (a token whose router logits all tie, such as an all-zero token, picks
  experts 0..k-1 in both packages).
- One-hot past capacity. `jax.nn.one_hot(pos, capacity)` gives a zero
  row for pos >= capacity; `F.one_hot` raises. The position is clamped,
  and the row multiplied by `kept`, which is zero there.

The load-balance loss (moe.py:131-148), aux_loss_weight * E * sum(top-1
dispatch fraction x mean router probability), is recorded only inside
`recording_losses()`, the port's counterpart of flax's mutable "losses"
collection: learner.compute_loss opens it around the learner's forward
and adds what was recorded to the objective. Outside it the layer records
nothing, and computes the loss only where a gradient is being taken: a
block that remat recomputes in the backward (outside the recording) must
run the ops its forward ran, or torch.utils.checkpoint refuses the
recompute. Acting, the target network and replicas run under no_grad
and compute none. A record is an overwrite, keyed by the layer (the
reference's `reduce_fn=lambda prev, new: new`), so no layer counts
twice. The recording is per thread, so an acting forward on another
thread never writes into the learner's.

Parameters, under the reference's names: `router` (a bias-free Linear,
weight [E, d], the flax kernel [d, E] transposed), `w_in` [E, d, ff],
`b_in` [E, ff], `w_out` [E, ff, d], `b_out` [E, d]. Fresh weights are
flax's (models/init.py): the router lecun_normal with fan_in d; w_in and
w_out lecun_normal on a rank-3 leaf, whose leading axis flax counts in
the receptive field, so fan_in is d * E and ff * E; the biases zero.
"""

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models import init
from torchbeast_tpu_torch.models.layers import linear

_RECORDING = threading.local()


@contextlib.contextmanager
def recording_losses():
    """Record the load-balance losses of every MoEFFN forward run on this
    thread inside the block: yields a dict {layer: loss tensor}, one
    entry per layer, in the order the layers first ran."""
    previous = getattr(_RECORDING, "losses", None)
    _RECORDING.losses = recorded = {}
    try:
        yield recorded
    finally:
        _RECORDING.losses = previous


class MoEFFN(nn.Module):
    """[tokens, d_model] -> [tokens, d_model] f32 mixture of expert MLPs."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 aux_loss_weight: float = 1e-2, dtype=torch.float32):
        super().__init__()
        if top_k > num_experts:
            raise ValueError(
                f"top_k={top_k} exceeds num_experts={num_experts}")
        self.d_model, self.d_ff = d_model, d_ff
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.dtype = dtype
        E = num_experts
        self.router = nn.Linear(d_model, E, bias=False)
        self.w_in = nn.Parameter(torch.empty(E, d_model, d_ff))
        self.b_in = nn.Parameter(torch.empty(E, d_ff))
        self.w_out = nn.Parameter(torch.empty(E, d_ff, d_model))
        self.b_out = nn.Parameter(torch.empty(E, d_model))
        self.reset_parameters()

    def reset_parameters(self):
        E = self.num_experts
        init.lecun_normal_(self.router.weight, self.d_model)
        init.lecun_normal_(self.w_in, self.d_model * E)
        init.lecun_normal_(self.w_out, self.d_ff * E)
        nn.init.zeros_(self.b_in)
        nn.init.zeros_(self.b_out)

    def capacity(self, tokens: int) -> int:
        return max(1, int(math.ceil(
            self.top_k * tokens / self.num_experts * self.capacity_factor)))

    def route(self, x):
        """(probs [t, E] f32, gate [t, K], idx [t, K] int64)."""
        probs = F.softmax(linear(self.router, x.float()), dim=-1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate = order.values[:, :self.top_k]
        idx = order.indices[:, :self.top_k]
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
        return probs, gate, idx

    def forward(self, x):
        tokens = x.shape[0]
        E, K, dtype = self.num_experts, self.top_k, self.dtype
        C = self.capacity(tokens)
        probs, gate, idx = self.route(x)

        # Capacity: rank-major flattening, so every rank-0 selection
        # precedes any rank-1 one, then token order.
        sel = F.one_hot(idx, E).float()  # [t, K, E]
        sel_flat = sel.transpose(0, 1).reshape(K * tokens, E)
        pos_flat = torch.cumsum(sel_flat, dim=0) - sel_flat
        pos = pos_flat.reshape(K, tokens, E).transpose(0, 1)  # [t, K, E]
        kept = sel * (pos < C)
        # slot [t, E, C] of rank k: the capacity slot token t's rank-k
        # pick takes in expert e, zero where dropped (and for the experts
        # it did not pick). A token's ranks pick distinct experts, so the
        # sums over k add one nonzero term: exact in any order.
        dispatch = combine = 0.0
        for k in range(K):
            slot = F.one_hot(pos[:, k].long().clamp(max=C - 1),
                             C).float() * kept[:, k, :, None]
            dispatch = dispatch + slot  # [t, E, C], 0/1
            combine = combine + gate[:, k, None, None] * slot

        expert_in = torch.einsum("tec,td->ecd", dispatch.to(dtype),
                                 x.to(dtype))
        h = F.gelu(torch.bmm(expert_in, self.w_in.to(dtype))
                   + self.b_in[:, None, :].to(dtype), approximate="tanh")
        expert_out = (torch.bmm(h, self.w_out.to(dtype))
                      + self.b_out[:, None, :].to(dtype))
        y = torch.einsum("ecd,tec->td", expert_out.float(), combine)

        recorded = getattr(_RECORDING, "losses", None)
        if recorded is not None or torch.is_grad_enabled():
            top1 = F.one_hot(idx[:, 0], E).float()
            aux = E * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
            if recorded is not None:
                recorded[self] = self.aux_loss_weight * aux
        return y
