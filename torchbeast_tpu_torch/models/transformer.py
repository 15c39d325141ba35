"""Transformer policy with an episode-aware KV-cache memory (counterpart of
torchbeast_tpu/models/transformer.py, single device, without experts).

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
between. flax's LayerNorm has epsilon 1e-6 and its gelu is the tanh
approximation; both are set so here.

Precision, as the reference's: `dtype` (the trunk's compute dtype) is
the frame Dense's, q/k/v/out's and the MLP's; the residual stream, the
LayerNorms (which promote, carrying no dtype of their own) and the
`extras` Dense stay f32; the cache is cast to k's dtype before the
concat, and the new k and v are returned as f32. `head_dtype` is the
policy head's.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models.cores import RecurrentPolicyHead
from torchbeast_tpu_torch.models.layers import Dense, layer_norm, linear
from torchbeast_tpu_torch.ops.attention import (
    band_relative_offsets,
    dense_transformer_attend,
    roll_kv_cache,
    segment_ids_from_done,
    transformer_attention,
)

ATTENTION_IMPLS = ("dense", "pallas")
LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


class _Block(nn.Module):
    """Pre-norm attention + GELU MLP block; q/k/v/out are flax
    DenseGenerals over (H, hd), stored as Linear layers of H*hd."""

    def __init__(self, d_model: int, num_heads: int, memory_len: int,
                 attention_impl: str, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.memory_len = memory_len
        self.attention_impl = attention_impl
        self.dtype = dtype
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.q = Dense(d_model, d_model)
        self.k = Dense(d_model, d_model)
        self.v = Dense(d_model, d_model)
        self.rel_bias = nn.Parameter(torch.zeros(num_heads, memory_len + 1))
        self.out = Dense(d_model, d_model)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.Dense_0 = Dense(d_model, 4 * d_model)
        self.Dense_1 = Dense(4 * d_model, d_model)

    def forward(self, x, k_cache, v_cache, mask, offsets, seg, cache_valid,
                no_done):
        """x: [B, T, d]; k_cache/v_cache: [B, M, H, hd]; mask/offsets: the
        dense path's [B, T, M+T] mask and [T, M+T] offsets (None on the
        fused path, which builds both from seg [B, T] int32, cache_valid
        [B, M] f32 and no_done [B, T]). Returns (y, k, v), k and v this
        unroll's [B, T, H, hd]."""
        B, T, d = x.shape
        H = self.num_heads
        hd = d // H
        dtype = self.dtype
        h = layer_norm(self.LayerNorm_0, x)
        q = linear(self.q, h, dtype).view(B, T, H, hd)
        k = linear(self.k, h, dtype).view(B, T, H, hd)
        v = linear(self.v, h, dtype).view(B, T, H, hd)
        k_all = torch.cat([k_cache.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_cache.to(v.dtype), v], dim=1)
        if self.attention_impl == "pallas":
            attended = transformer_attention(
                self.memory_len, q, k_all, v_all, seg, cache_valid.float(),
                no_done, self.rel_bias,
            )
        else:
            attended = dense_transformer_attend(q, k_all, v_all, mask,
                                                offsets, self.rel_bias)
        x = x + linear(self.out, attended.reshape(B, T, d), dtype).float()
        h = layer_norm(self.LayerNorm_1, x)
        h = F.gelu(linear(self.Dense_0, h, dtype), approximate="tanh")
        x = x + linear(self.Dense_1, h, dtype).float()
        return x, k.float(), v.float()


class TransformerNet(nn.Module):
    """forward(inputs, core_state, sample_action=True, generator=None) ->
    (AgentOutput, new core_state); inputs is a dict of time-major
    tensors: frame [T, B, H, W, C] uint8, reward [T, B], done [T, B] bool,
    last_action [T, B]."""

    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), num_layers: int = 2,
                 d_model: int = 128, num_heads: int = 4,
                 memory_len: int = 64, attention_impl: str = "dense",
                 dtype=torch.float32, head_dtype=torch.float32):
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
        frame_size = 1
        for n in frame_shape:
            frame_size *= n
        self.Dense_0 = Dense(frame_size, d_model)
        self.extras = Dense(1 + num_actions, d_model)
        for layer in range(num_layers):
            setattr(self, f"block_{layer}", _Block(
                d_model, num_heads, memory_len, attention_impl, dtype))
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
        dense = self.attention_impl == "dense"
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
            x, k_new, v_new = getattr(self, f"block_{layer}")(
                x, k_cache_b, v_cache_b, mask, offsets, seg, valid_b,
                no_done_yet,
            )
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
