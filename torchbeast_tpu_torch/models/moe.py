"""Mixture-of-experts feed-forward layer (counterpart of
torchbeast_tpu/models/moe.py), with the reference's whole-batch routing
under a sharded batch and its experts split over an `expert` axis.

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

Whole-batch routing (a `routing` scope). The reference routes over the
whole batch however XLA shards it: the capacity is that of every token,
the slot order rank-major, then token order over the whole batch, and
the load-balance loss a product of two whole-batch means. A data shard
of the port's learner (parallel/dp.py) holds one contiguous range of the
batch's tokens, shard s after shards 0..s-1 (the block's [B, T] tokens
flatten B-major). Inside `routing(exchange)` each layer hands its [K, E]
pick counts (rank k, expert e) to `exchange`, which returns every
shard's, [S, K, E] in shard order, and this shard's index s; then

- the capacity is capacity(S * tokens): the shards hold equal parts;
- the slot of token t's rank-k pick of e is its place among this shard's
  rank-k picks of e, plus every shard's picks of e at ranks below k,
  plus shards 0..s-1's rank-k picks of e: the reference's position;
- the recorded loss is this shard's piece, aux_loss_weight * E *
  sum_e frac_e * sum_{t in shard} probs[t, e] / N, frac_e the whole
  batch's top-1 fraction of e (from the counts, no gradient) and N the
  whole batch's tokens. The pieces add up to the reference's loss, and
  their gradients, summed over the shards, to its gradient.

The counts carry no gradient, so the backward exchanges nothing. A scope
remembers each layer's table: a layer called again in it (the remat
recompute of its block in the backward, models/layers.checkpointed,
which puts the scope back around the recompute) reuses the table of its
first call. Without a scope the layer is the one-device layer above.

Expert parallelism (`expert_devices`, set by parallel/ep.py). With G
devices the E experts split into G contiguous groups; group j's experts
run on expert_devices[j] on this layer's tokens: its [E/G, C, d] share
of the dispatched activations is copied there, its [E/G, C, d] outputs
come back, and the G groups' combines are summed on the tokens' device
in group order. Where the weights live, two ways:

- sharded storage (ep.shard_expert_params, polybeast's learner mesh, as
  the reference places its expert kernels): `w_in` and `w_out` are G
  resident slices (models/sharded.py), slice j on expert device j, which
  group j reads where it lies; their gradients land there;
- whole leaves (ep.set_expert_devices: monobeast's and anakin's expert
  mesh, whose reference does not place its params): group j's weights
  are copied to its device inside the forward (differentiably).

The biases are replicated leaves: whole on the tokens' device, group j's
rows copied to its device. On one device (every group on the tokens'
device) every copy is a no-op.

`track_routing` (off by default) keeps the last forward's router
probabilities [t, E] in `last_probs`, its kept mask [t, K, E] in
`last_kept` and its count of assignments past capacity in
`last_dropped` (0-d), all detached.

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
from torchbeast_tpu_torch.models.sharded import slots

_RECORDING = threading.local()
_ROUTING = threading.local()


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


class RoutingScope:
    """One forward's whole-batch routing: `exchange(counts [K, E]) ->
    (table [S, K, E], s)`, and the table each layer got from it."""

    def __init__(self, exchange):
        self.exchange = exchange
        self.tables = {}

    def table(self, layer, counts):
        got = self.tables.get(layer)
        if got is None:
            got = self.tables[layer] = self.exchange(counts)
        return got


def current_routing():
    """The routing scope active on this thread, or None."""
    return getattr(_ROUTING, "scope", None)


@contextlib.contextmanager
def active(scope):
    """Make `scope` (a RoutingScope, or None for the one-device layer)
    this thread's routing scope inside the block."""
    previous = current_routing()
    _ROUTING.scope = scope
    try:
        yield scope
    finally:
        _ROUTING.scope = previous


def routing(exchange):
    """A fresh RoutingScope over `exchange`, active inside the block: one
    forward (or one acting step) of a data shard."""
    return active(RoutingScope(exchange))


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
        self.expert_devices = None
        self.track_routing = False
        self.last_probs = self.last_kept = self.last_dropped = None
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
        E, K = self.num_experts, self.top_k
        probs, gate, idx = self.route(x)
        sel = F.one_hot(idx, E).float()  # [t, K, E]
        scope = current_routing()
        if scope is None:
            C = self.capacity(tokens)
            # Capacity: rank-major flattening, so every rank-0 selection
            # precedes any rank-1 one, then token order.
            sel_flat = sel.transpose(0, 1).reshape(K * tokens, E)
            pos_flat = torch.cumsum(sel_flat, dim=0) - sel_flat
            pos = pos_flat.reshape(K, tokens, E).transpose(0, 1)
        else:
            table, s = scope.table(self, sel.sum(dim=0).detach())
            table = table.to(x.device)
            N = tokens * table.shape[0]
            C = self.capacity(N)
            every = table.sum(dim=0)  # [K, E]: the whole batch's picks
            offset = (torch.cumsum(every, dim=0) - every
                      + table[:s].sum(dim=0))
            pos = torch.cumsum(sel, dim=0) - sel + offset
        kept = sel * (pos < C)
        if self.track_routing:
            self.last_probs = probs.detach()
            self.last_kept = kept.detach()
            self.last_dropped = (sel.sum() - kept.sum()).detach()
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
        w_in, w_out = slots(self, "w_in"), slots(self, "w_out")
        devices = ([w.device for w in w_in] if w_in is not None
                   else self.expert_devices)
        if not devices or len(devices) == 1:
            y = self._experts(dispatch, combine, x, slice(None))
        else:
            per = E // len(devices)
            y = None
            for j, dev in enumerate(devices):
                part = self._experts(
                    dispatch, combine, x, slice(j * per, (j + 1) * per), dev,
                    None if w_in is None else (w_in[j], w_out[j]))
                y = part if y is None else y + part

        recorded = getattr(_RECORDING, "losses", None)
        if recorded is not None or torch.is_grad_enabled():
            top1 = F.one_hot(idx[:, 0], E).float()
            if scope is None:
                aux = E * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
            else:
                frac = table[:, 0].sum(dim=0) / N
                aux = E * torch.sum(frac * probs.sum(dim=0) / N)
            if recorded is not None:
                recorded[self] = self.aux_loss_weight * aux
        return y

    def _experts(self, dispatch, combine, x, experts, device=None,
                 resident=None):
        """The experts `experts` (a slice) on this layer's tokens: [t, d]
        f32 on x's device. With `device` another device, the dispatched
        [E/G, C, d] activations go there, and its [E/G, C, d] outputs come
        back for the combine (the reference's two all-to-alls); the
        group's kernels are `resident` (its w_in and w_out slots, on
        `device`) or copied there from the whole leaves."""
        dtype = self.dtype
        home = x.device
        away = device is not None and device != home
        to = ((lambda t: t.to(device)) if away  # noqa: E731
              else (lambda t: t))
        w_in, w_out = resident or (to(self.w_in[experts]),
                                   to(self.w_out[experts]))
        expert_in = to(torch.einsum("tec,td->ecd",
                                    dispatch[:, experts].to(dtype),
                                    x.to(dtype)))
        h = F.gelu(torch.bmm(expert_in, w_in.to(dtype))
                   + to(self.b_in[experts])[:, None, :].to(dtype),
                   approximate="tanh")
        expert_out = (torch.bmm(h, w_out.to(dtype))
                      + to(self.b_out[experts])[:, None, :].to(dtype))
        if away:
            expert_out = expert_out.to(home)
        return torch.einsum("ecd,tec->td", expert_out.float(),
                            combine[:, experts])
