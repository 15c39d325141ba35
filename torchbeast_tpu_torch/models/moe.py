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

from torchbeast_tpu_torch import marks
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


class _TileProduct(torch.autograd.Function):
    """y[i] = x[i] @ w[expert[i]]^T over row tiles: x [tiles, rows, k],
    w [E, n, k], expert [tiles] -> [tiles, rows, n]. Each tile's weight
    is gathered for the product and again in the backward, so no
    gathered copy is kept between the two; the weight's gradient is each
    tile's x^T dy added into its expert's slot."""

    @staticmethod
    def forward(ctx, x, w, expert):
        ctx.save_for_backward(x, w, expert)
        return torch.bmm(x, w.index_select(0, expert).transpose(1, 2))

    @staticmethod
    def backward(ctx, dy):
        x, w, expert = ctx.saved_tensors
        dx = torch.bmm(dy, w.index_select(0, expert))
        dw_tiles = torch.bmm(dy.transpose(1, 2), x)
        dw = torch.zeros_like(w).index_add_(0, expert, dw_tiles)
        return dx, dw, None


def tile_product(x, w, expert):
    """x [tiles, rows, k] times each tile's expert's w [E, n, k],
    transposed: [tiles, rows, n] (_TileProduct)."""
    return _TileProduct.apply(x, w, expert)


class SwiGLU(nn.Module):
    """down(silu(gate x) * up x), bias-free, in `dtype`; f32 out."""

    def __init__(self, d_model: int, width: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gate = nn.Linear(d_model, width, bias=False)
        self.up = nn.Linear(d_model, width, bias=False)
        self.down = nn.Linear(width, d_model, bias=False)
        self.reset_parameters()

    def reset_parameters(self):
        for layer in (self.gate, self.up, self.down):
            init.lecun_normal_(layer.weight, layer.in_features)

    def forward(self, x):
        h = F.silu(linear(self.gate, x, self.dtype)) * linear(
            self.up, x, self.dtype)
        return linear(self.down, h, self.dtype).float()


class DroplessMoE(nn.Module):
    """DeepSeekMoE's layer (DeepSeek-AI 2024, arXiv:2405.04434 section
    2.2): [tokens, d_model] -> [tokens, d_model] f32, every pick kept.

    Routing: p = softmax_f32(x W_r^T) over all `num_experts`; each token's
    top `top_k` experts by p, greedy, ties to the lower index (the head
    of a stable descending sort), the gates p_e not renormalised (times
    `routed_scaling_factor`). The layer holds experts
    [expert_offset, expert_offset + experts_held), the share one device
    of an expert-parallel deployment holds: it routes over all of them
    and computes its own experts' part of the output,

        y = sum_{e in top_k, e held} p_e SwiGLU_e(x) + SwiGLU_shared(x),

    the shared experts' SwiGLU of width `num_shared` * `expert_width`
    added for every token. The parts that the deployment's devices
    compute, with the shared experts counted once, add up to the layer
    that holds every expert.

    Dispatch is sorted and static-shaped, so a CUDA graph captures it: the
    held picks, ordered by expert (stable, so token order within one),
    fill row tiles of `tile_rows` rows, each expert's run of rows padded to
    a whole tile, and the tiles past the last held pick are empty (zero
    rows). The tile count is the most any routing can need,
    ceil(tokens * min(top_k, experts_held) / tile_rows) + experts_held,
    so no pick is ever dropped. Each expert's three products run over its
    tiles as one batched product (tile_product), then each row's output,
    times its gate, is added into its token (index_add).

    The expert-level balance loss (section 2.2.1, as DeepSeek's
    `seq_aux` gate computes it): per sequence, f_i = E / (K T) times the
    picks of expert i among its T tokens, P_i its mean p_i, and
    aux_loss_alpha * sum_i f_i P_i, averaged over the sequences; recorded
    under recording_losses() as MoEFFN records its loss. `sequences` in
    forward gives their count; the tokens are sequence-major.

    The largest held expert's picks over the held experts' mean, an
    update's largest over its layers, is a device value of the marks
    (marks.observe_max "moe_peak_load"), when a dispatch is recorded.

    Parameters: `router` (bias-free Linear, weight [E, d]), `w_gate` and
    `w_up` [held * expert_width, d], `w_down` [held * d, expert_width]
    (the published per-expert Linear weights, stacked along their rows
    and viewed per expert in forward, so each leaf is a matrix with its
    expert's own fan-in), and `shared` (a SwiGLU).
    `dtype` is the experts' compute dtype; routing and the combine stay
    f32.
    """

    def __init__(self, d_model: int, expert_width: int, num_experts: int,
                 top_k: int, experts_held=None, expert_offset: int = 0,
                 num_shared: int = 2, routed_scaling_factor: float = 1.0,
                 aux_loss_alpha: float = 1e-3, tile_rows: int = 256,
                 dtype=torch.float32):
        super().__init__()
        held = num_experts if experts_held is None else experts_held
        if top_k > num_experts:
            raise ValueError(
                f"top_k={top_k} exceeds num_experts={num_experts}")
        if not 0 < held <= num_experts - expert_offset or expert_offset < 0:
            raise ValueError(
                f"experts [{expert_offset}, {expert_offset + held}) are not "
                f"among the {num_experts}")
        self.d_model, self.expert_width = d_model, expert_width
        self.num_experts, self.top_k = num_experts, top_k
        self.experts_held, self.expert_offset = held, expert_offset
        self.routed_scaling_factor = routed_scaling_factor
        self.aux_loss_alpha = aux_loss_alpha
        self.tile_rows = tile_rows
        self.dtype = dtype
        self.router = nn.Linear(d_model, num_experts, bias=False)
        self.w_gate = nn.Parameter(torch.empty(held * expert_width, d_model))
        self.w_up = nn.Parameter(torch.empty(held * expert_width, d_model))
        self.w_down = nn.Parameter(torch.empty(held * d_model, expert_width))
        self.shared = SwiGLU(d_model, num_shared * expert_width, dtype)
        self.reset_parameters()

    def reset_parameters(self):
        init.lecun_normal_(self.router.weight, self.d_model)
        init.lecun_normal_(self.w_gate, self.d_model)
        init.lecun_normal_(self.w_up, self.d_model)
        init.lecun_normal_(self.w_down, self.expert_width)

    def route(self, x):
        """(probs [t, E] f32, gate [t, K] f32, idx [t, K] int64)."""
        probs = F.softmax(linear(self.router, x.float()), dim=-1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate = order.values[:, :self.top_k] * self.routed_scaling_factor
        return probs, gate, order.indices[:, :self.top_k]

    def tiles(self, tokens: int) -> int:
        """The most row tiles any routing of `tokens` tokens needs."""
        picks = tokens * min(self.top_k, self.experts_held)
        return -(-picks // self.tile_rows) + self.experts_held

    def dispatch(self, idx, gate):
        """The sorted layout of the held picks: (row_token [R], the token
        of each of the R = tiles * tile_rows rows, `tokens` (a zero row)
        where empty; row_gate [R] f32, 0 where empty; tile_expert [tiles],
        each tile's held expert; counts [held], each held expert's
        picks)."""
        tokens, K = idx.shape
        held, rows = self.experts_held, self.tile_rows
        device = idx.device
        local = idx.reshape(-1) - self.expert_offset
        is_held = (local >= 0) & (local < held)
        # Picks of experts held elsewhere sort after every held one.
        key = torch.where(is_held, local, torch.full_like(local, held))
        order = torch.sort(key, stable=True).indices
        # scatter_add, not bincount: bincount sizes its output from the
        # data, a sync that a graph capture refuses.
        counts = torch.zeros(held + 1, dtype=torch.int64,
                             device=device).scatter_add_(
            0, key, torch.ones_like(key))[:held]
        tiles = (counts + rows - 1) // rows
        tile_end = torch.cumsum(tiles, 0)
        first_row = (tile_end - tiles) * rows  # each expert's first row
        first_pick = torch.cumsum(counts, 0) - counts  # in sorted order
        sorted_key = key[order]
        e = sorted_key.clamp(max=held - 1)
        rank = torch.arange(tokens * K, device=device) - first_pick[e]
        R = self.tiles(tokens) * rows
        # Picks held elsewhere go to row R, cut off below.
        row = torch.where(sorted_key < held, first_row[e] + rank,
                          torch.full_like(rank, R))
        row_token = torch.full((R + 1,), tokens, dtype=torch.int64,
                               device=device)
        row_token[row] = order // K
        row_gate = torch.zeros(R + 1, device=device)
        row_gate[row] = gate.reshape(-1)[order].float()
        tile_expert = torch.bucketize(
            torch.arange(self.tiles(tokens), device=device), tile_end,
            right=True).clamp(max=held - 1)
        return row_token[:R], row_gate[:R], tile_expert, counts

    def forward(self, x, sequences: int = 1):
        tokens, d = x.shape
        probs, gate, idx = self.route(x)
        row_token, row_gate, tile_expert, counts = self.dispatch(idx, gate)
        dtype = self.dtype
        held, f = self.experts_held, self.expert_width
        padded = torch.cat([x.to(dtype), x.new_zeros(1, d, dtype=dtype)])
        xt = padded[row_token].view(-1, self.tile_rows, d)
        w_gate = self.w_gate.to(dtype).view(held, f, d)
        w_up = self.w_up.to(dtype).view(held, f, d)
        w_down = self.w_down.to(dtype).view(held, d, f)
        h = F.silu(tile_product(xt, w_gate, tile_expert)) * (
            tile_product(xt, w_up, tile_expert))
        yt = tile_product(h, w_down, tile_expert)
        rows = yt.reshape(-1, d).float() * row_gate[:, None]
        routed = torch.zeros(tokens + 1, d, device=x.device).index_add_(
            0, row_token, rows)[:tokens]
        y = routed + self.shared(x)

        recorded = getattr(_RECORDING, "losses", None)
        if recorded is not None or torch.is_grad_enabled():
            E, K = self.num_experts, self.top_k
            length = tokens // sequences
            picks = F.one_hot(idx, E).sum(1).view(sequences, length, E)
            f = picks.sum(1).float() * (E / (K * length))
            mean_p = probs.view(sequences, length, E).mean(1)
            aux = self.aux_loss_alpha * (f * mean_p).sum(1).mean()
            if recorded is not None:
                recorded[self] = aux
        if marks.recording_now():
            with torch.no_grad():
                load = counts.float()
                marks.observe_max("moe_peak_load",
                                  load.max() / load.mean().clamp_min(1e-9))
        return y
