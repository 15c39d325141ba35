"""Transformer policy with an episode-aware KV-cache memory (counterpart of
torchbeast_tpu/models/transformer.py).

The core attends over the unroll AND over a rolling key/value cache
carried across unrolls as the recurrent state, so acting at T=1 still
sees up to `memory_len` past steps. Episode boundaries, as in the
reference:

- within the unroll, attention stays inside the current segment
  (segments start at a done step);
- cache entries are visible only while no done has occurred in the
  unroll up to and including the query step;
- the cache written back keeps only entries of the final segment.

Attention is windowed to the last `memory_len` steps by a band over the
combined [cache; unroll] key axis, which makes the learner's batch
forward equal to the actor's stepwise T=1 forwards. Positions enter
through a learned relative bias over offsets 0..memory_len.

`attention_impl` picks the attention body: "dense" (ops/attention.py
dense_transformer_attend, from a materialized mask) or "pallas" (the
reference's name for its fused kernel, kept so one command line runs on
either package): ops/attention.py transformer_attention, the hand-written
CUDA kernels on the card.

State layout, the framework's convention (batch on axis 1): per layer
(k [M, B, H, hd], v [M, B, H, hd], valid [M, B]); the model works
batch-first inside. Submodule names follow the flax scopes (Dense_0,
extras, block_{i}.{LayerNorm_0, q, k, v, rel_bias, out, LayerNorm_1,
Dense_0, Dense_1}, LayerNorm_0, head), which is what weights.py maps
between. With `num_experts` > 0 the block's MLP is the mixture of experts
models/moe.MoEFFN (top `moe_top_k` of `num_experts` experts of width
4 * d_model) over the block's [B*T, d] tokens, under the name `moe` in
place of Dense_0 and Dense_1, as the reference's block builds it
(transformer.py:178-193); its load-balance loss is recorded for the
learner (moe.recording_losses). flax's LayerNorm has epsilon 1e-6 and
its gelu is the tanh approximation; both are set so here.

Tensor parallelism (parallel/tp.set_model_devices, which shards the
split leaves' storage, models/sharded.py): with K devices,
block device j holds slot j of q/k/v's weights and biases (head group j),
of rel_bias's rows, of `out`'s weight columns, of Dense_0's weight rows
and bias (FFN column group j) and of Dense_1's weight columns, and runs
on them, where they lie: the attention of its heads (the cache's heads
and the block's input copied to it) and a partial `out` projection, then
its FFN columns and a partial Dense_1. The K partial outputs come back
to the block's device and are summed in f32 in the order j = 0..K-1;
then the replicated biases and the residual are added. The gradients of
the slots land on their devices. On one device (every slot on the
block's device) the copies are no-ops and the split is the same
arithmetic in K pieces. The MoE layer is left to EP.

Sequence parallelism (set_seq_devices, which stands for the reference's
constructor arguments mesh, seq_axis, ring_schedule and sp_strategy):
with P seq devices the block's in-unroll attention runs as the
reference's _Block dispatches it: Ulysses (ops/attention.
ulysses_transformer_attention) when `sp_strategy` is "ulysses" and T and
the head count divide by P; the ring (ring_transformer_attention, q, k,
v and the cache in f32, the result cast back to v's dtype) when
`sp_strategy` is "ring" and T divides by P (by 2P under the zigzag
`ring_schedule`); otherwise the dense path, which is the acting step at
T=1. The weights stay whole leaves of the module, as under TP; the
mesh's data axis is each replica's own (parallel/dp.py gives replica i
its row's seq devices), so the reference's `batch_axis` has nothing to
name here.

Precision, as the reference's: `dtype` (the trunk's compute dtype) is
the frame Dense's, q/k/v/out's and the MLP's (the experts'; the MoE
routing stays f32); the residual stream, the
LayerNorms (which promote, carrying no dtype of their own) and the
`extras` Dense stay f32; the cache is cast to k's dtype before the
concat, and the new k and v are returned as f32. `head_dtype` is the
policy head's.

`remat` recomputes each block in the backward, keeping only its inputs
(models/layers.checkpointed; the reference's nn.remat around _Block):
the `blocks` stage of the remat planner (runtime/remat_plan.py), set by
--remat or the older --transformer_remat. Under the fused attention the
recompute runs the attention forward kernel again in the backward.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models.cores import RecurrentPolicyHead
from torchbeast_tpu_torch.models.layers import (
    Dense,
    checkpointed,
    layer_norm,
    linear,
)
from torchbeast_tpu_torch.models.moe import MoEFFN
from torchbeast_tpu_torch.models.sharded import slots
from torchbeast_tpu_torch.ops.attention import (
    band_relative_offsets,
    dense_transformer_attend,
    ring_transformer_attention,
    roll_kv_cache,
    segment_ids_from_done,
    transformer_attention,
    ulysses_transformer_attention,
)

ATTENTION_IMPLS = ("dense", "pallas")
RING_SCHEDULES = ("contiguous", "zigzag")
SP_STRATEGIES = ("ring", "ulysses")
LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


class _Block(nn.Module):
    """Pre-norm attention + GELU MLP (or, num_experts > 0, MoE) block;
    q/k/v/out are flax DenseGenerals over (H, hd), stored as Linear
    layers of H*hd."""

    def __init__(self, d_model: int, num_heads: int, memory_len: int,
                 attention_impl: str, dtype=torch.float32,
                 num_experts: int = 0, moe_top_k: int = 2):
        super().__init__()
        self.num_heads = num_heads
        self.memory_len = memory_len
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.seq_devices = None
        self.ring_schedule = "contiguous"
        self.sp_strategy = "ring"
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.q = Dense(d_model, d_model)
        self.k = Dense(d_model, d_model)
        self.v = Dense(d_model, d_model)
        self.rel_bias = nn.Parameter(torch.zeros(num_heads, memory_len + 1))
        self.out = Dense(d_model, d_model)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        if num_experts > 0:
            self.moe = MoEFFN(d_model, 4 * d_model, num_experts,
                              top_k=moe_top_k, dtype=dtype)
        else:
            self.Dense_0 = Dense(d_model, 4 * d_model)
            self.Dense_1 = Dense(4 * d_model, d_model)

    def forward(self, x, k_cache, v_cache, mask, offsets, seg, cache_valid,
                no_done):
        """x: [B, T, d]; k_cache/v_cache: [B, M, H, hd]; mask/offsets: the
        dense path's [B, T, M+T] mask and [T, M+T] offsets (None on the
        fused path, which builds both from seg [B, T] int32, cache_valid
        [B, M] f32 and no_done [B, T]). Returns (y, k, v), k and v this
        unroll's [B, T, H, hd]."""
        if slots(self.q, "weight") is not None:
            return self._split(x, k_cache, v_cache, mask, offsets, seg,
                               cache_valid, no_done)
        B, T, d = x.shape
        H = self.num_heads
        hd = d // H
        dtype = self.dtype
        h = layer_norm(self.LayerNorm_0, x)
        q = linear(self.q, h, dtype).view(B, T, H, hd)
        k = linear(self.k, h, dtype).view(B, T, H, hd)
        v = linear(self.v, h, dtype).view(B, T, H, hd)
        attended = self._attend(q, k, v, k_cache, v_cache, mask, offsets,
                                seg, cache_valid, no_done, self.rel_bias)
        x = x + linear(self.out, attended.reshape(B, T, d), dtype).float()
        h = layer_norm(self.LayerNorm_1, x)
        if hasattr(self, "moe"):
            x = x + self.moe(h.reshape(B * T, d)).reshape(B, T, d)
        else:
            h = F.gelu(linear(self.Dense_0, h, dtype), approximate="tanh")
            x = x + linear(self.Dense_1, h, dtype).float()
        return x, k.float(), v.float()

    def _sequence_parallel(self, T: int, H: int):
        """"ulysses", "ring" or None: the reference's dispatch for an
        unroll of T steps and H heads over the seq devices."""
        P = len(self.seq_devices) if self.seq_devices else 0
        if P <= 1:
            return None
        if self.sp_strategy == "ulysses":
            return "ulysses" if T % P == 0 and H % P == 0 else None
        divisor = 2 * P if self.ring_schedule == "zigzag" else P
        return "ring" if T % divisor == 0 else None

    def _attend(self, q, k, v, k_cache, v_cache, mask, offsets, seg,
                cache_valid, no_done, rel_bias):
        """The attention of q's heads over [cache; unroll]."""
        path = self._sequence_parallel(q.shape[1], q.shape[2])
        if path == "ulysses":
            return ulysses_transformer_attention(
                q, k, v, k_cache.to(k.dtype), v_cache.to(v.dtype), mask,
                offsets, rel_bias, self.seq_devices).to(v.dtype)
        if path == "ring":
            # Softmax in f32 on both paths; the ring keeps its products
            # in f32 too, for the online merge's numerics.
            return ring_transformer_attention(
                q.float(), k.float(), v.float(), k_cache.float(),
                v_cache.float(), mask[..., :self.memory_len], rel_bias,
                self.memory_len, seg, self.seq_devices,
                schedule=self.ring_schedule).to(v.dtype)
        k_all = torch.cat([k_cache.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_cache.to(v.dtype), v], dim=1)
        if self.attention_impl == "pallas":
            return transformer_attention(
                self.memory_len, q, k_all, v_all, seg, cache_valid.float(),
                no_done, rel_bias,
            )
        return dense_transformer_attend(q, k_all, v_all, mask, offsets,
                                        rel_bias)

    def _split(self, x, k_cache, v_cache, mask, offsets, seg, cache_valid,
               no_done):
        """forward over the K head and FFN column groups of the resident
        slots (the module docstring's tensor parallelism)."""
        B, T, d = x.shape
        q_w, k_w, v_w = (slots(m, "weight") for m in (self.q, self.k, self.v))
        q_b, k_b, v_b = (slots(m, "bias") for m in (self.q, self.k, self.v))
        K = len(q_w)
        Hk = self.num_heads // K
        hd = d // self.num_heads
        dtype = self.dtype
        home = x.device

        def on(dev):
            return lambda t: None if t is None else t.to(dev)

        h = layer_norm(self.LayerNorm_0, x)
        attn, ks, vs = None, [], []
        for j, (rel, out_w) in enumerate(zip(slots(self, "rel_bias"),
                                              slots(self.out, "weight"))):
            to = on(rel.device)
            heads = slice(j * Hk, (j + 1) * Hk)
            hj = to(h).to(dtype)

            def project(w, b):
                return F.linear(hj, w.to(dtype), b.to(dtype)).view(
                    B, T, Hk, hd)

            q, k, v = (project(w[j], b[j]) for w, b in
                       ((q_w, q_b), (k_w, k_b), (v_w, v_b)))
            attended = self._attend(
                q, k, v, to(k_cache[:, :, heads]), to(v_cache[:, :, heads]),
                to(mask), to(offsets), to(seg), to(cache_valid),
                to(no_done), rel)
            part = F.linear(attended.reshape(B, T, Hk * hd).to(dtype),
                            out_w.to(dtype))
            part = part.to(home).float()
            attn = part if attn is None else attn + part
            ks.append(k.to(home).float())
            vs.append(v.to(home).float())
        x = x + (attn + self.out.bias.to(dtype).float())
        h = layer_norm(self.LayerNorm_1, x)
        if hasattr(self, "moe"):
            x = x + self.moe(h.reshape(B * T, d)).reshape(B, T, d)
        else:
            mlp = None
            for up_w, up_b, down_w in zip(slots(self.Dense_0, "weight"),
                                          slots(self.Dense_0, "bias"),
                                          slots(self.Dense_1, "weight")):
                to = on(up_w.device)
                u = F.gelu(F.linear(to(h).to(dtype), up_w.to(dtype),
                                    up_b.to(dtype)), approximate="tanh")
                part = F.linear(u, down_w.to(dtype)).to(home).float()
                mlp = part if mlp is None else mlp + part
            x = x + (mlp + self.Dense_1.bias.to(dtype).float())
        return x, torch.cat(ks, dim=2), torch.cat(vs, dim=2)


class TransformerNet(nn.Module):
    """forward(inputs, core_state, sample_action=True, generator=None) ->
    (AgentOutput, new core_state); inputs is a dict of time-major
    tensors: frame [T, B, H, W, C] uint8, reward [T, B], done [T, B] bool,
    last_action [T, B]."""

    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), num_layers: int = 2,
                 d_model: int = 128, num_heads: int = 4,
                 memory_len: int = 64, attention_impl: str = "dense",
                 dtype=torch.float32, head_dtype=torch.float32,
                 remat: bool = False, num_experts: int = 0,
                 moe_top_k: int = 2):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl {attention_impl!r} must be one of "
                f"{ATTENTION_IMPLS}"
            )
        if d_model % num_heads:
            raise ValueError(
                f"d_model {d_model} must divide by num_heads {num_heads}")
        self.num_actions = num_actions
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.memory_len = memory_len
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.remat = bool(remat)
        frame_size = 1
        for n in frame_shape:
            frame_size *= n
        self.Dense_0 = Dense(frame_size, d_model)
        self.extras = Dense(1 + num_actions, d_model)
        for layer in range(num_layers):
            setattr(self, f"block_{layer}", _Block(
                d_model, num_heads, memory_len, attention_impl, dtype,
                num_experts, moe_top_k))
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.head = RecurrentPolicyHead(
            d_model, num_actions, use_lstm=False, hidden_size=d_model,
            num_layers=1, dtype=head_dtype,
        )

    def forward(self, inputs, core_state, sample_action: bool = True,
                generator=None):
        frame = inputs["frame"]
        T, B = frame.shape[:2]
        M = self.memory_len
        device = frame.device

        # HWC flatten per (t, b), as the reference flattens.
        x = linear(self.Dense_0,
                   frame.reshape(T * B, -1).to(self.dtype) / 255.0,
                   self.dtype)
        one_hot = F.one_hot(inputs["last_action"].reshape(T * B).long(),
                            self.num_actions).float()
        reward = torch.clamp(inputs["reward"].float(), -1, 1).reshape(
            T * B, 1)
        x = x.float() + linear(self.extras,
                               torch.cat([reward, one_hot], dim=-1))
        x = x.reshape(T, B, self.d_model).transpose(0, 1).contiguous()

        done = inputs["done"]
        seg = segment_ids_from_done(done).t().contiguous()  # [B, T]
        # Both count slot 0's own done: a done at t=0 hides the cache.
        no_done_yet = (seg == 0)
        # The sequence-parallel paths read the dense path's mask.
        dense = self.attention_impl == "dense" or any(
            getattr(self, f"block_{i}")._sequence_parallel(
                T, self.num_heads) for i in range(self.num_layers))
        if dense:
            band, offsets = band_relative_offsets(T, M, device=device)
            same = seg[:, :, None] == seg[:, None, :]
            seq_mask = band[None, :, M:] & same  # [B, T, T]
        else:
            offsets = mask = None

        new_state = []
        for layer in range(self.num_layers):
            k_cache, v_cache, valid = core_state[layer]
            k_cache_b = k_cache.transpose(0, 1)
            v_cache_b = v_cache.transpose(0, 1)
            valid_b = valid.t().contiguous()  # [B, M] f32
            if dense:
                cache_mask = (band[None, :, :M] & (valid_b != 0)[:, None, :]
                              & no_done_yet[:, :, None])
                mask = torch.cat([cache_mask, seq_mask], dim=-1)
            block = getattr(self, f"block_{layer}")
            args = (x, k_cache_b, v_cache_b, mask, offsets, seg, valid_b,
                    no_done_yet)
            x, k_new, v_new = (checkpointed(block, *args) if self.remat
                               else block(*args))
            k_roll, v_roll, valid_roll = roll_kv_cache(
                k_cache_b, v_cache_b, valid_b, k_new, v_new, seg,
                no_done_yet,
            )
            new_state.append((k_roll.transpose(0, 1),
                              v_roll.transpose(0, 1), valid_roll.t()))

        x = layer_norm(self.LayerNorm_0, x)
        core_output = x.transpose(0, 1).reshape(T * B, self.d_model)
        out, _ = self.head(core_output, done, (), T, B, sample_action,
                           generator)
        return out, tuple(new_state)

    def initial_state(self, batch_size: int, device=None) -> Tuple:
        hd = self.d_model // self.num_heads
        M = self.memory_len
        return tuple(
            (
                torch.zeros(M, batch_size, self.num_heads, hd, device=device),
                torch.zeros(M, batch_size, self.num_heads, hd, device=device),
                torch.zeros(M, batch_size, device=device),
            )
            for _ in range(self.num_layers)
        )


def set_seq_devices(model, devices, ring_schedule=None,
                    sp_strategy=None) -> int:
    """Run each transformer block of `model` sequence-parallel over
    `devices` (a row's `seq` axis; None or one device: the one-device
    block), with `ring_schedule` and `sp_strategy` when given (else the
    blocks keep theirs). Returns the number of blocks set."""
    if ring_schedule is not None and ring_schedule not in RING_SCHEDULES:
        raise ValueError(f"Unknown ring schedule {ring_schedule!r}")
    if sp_strategy is not None and sp_strategy not in SP_STRATEGIES:
        raise ValueError(
            f"Unknown sp_strategy {sp_strategy!r} "
            "(expected 'ring' or 'ulysses')"
        )
    devices = list(devices) if devices else None
    n = 0
    for module in model.modules():
        if isinstance(module, _Block):
            module.seq_devices = (devices if devices and len(devices) > 1
                                  else None)
            if ring_schedule is not None:
                module.ring_schedule = ring_schedule
            if sp_strategy is not None:
                module.sp_strategy = sp_strategy
            n += 1
    return n
