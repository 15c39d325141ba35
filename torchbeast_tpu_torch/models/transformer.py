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

Tensor parallelism (`model_devices`, set by parallel/tp.py): with K
devices, block device j runs head group j (its q/k/v column slices, its
rel_bias rows and the cache's heads copied to it inside the forward),
the attention of those heads and a partial `out` projection over their
rows, then FFN column group j (Dense_0's columns) and a partial Dense_1
over its rows. The K partial outputs come back to the block's device and
are summed in f32 in the order j = 0..K-1; then the replicated biases
and the residual are added. The weights stay whole leaves of the module,
so the optimizer and the checkpoint see the one-device tree; autograd
carries the gradients back through the copies. On one device (every
group on the block's device) the copies are no-ops and the split is the
same arithmetic in K pieces. The MoE layer is left to EP.

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
        self.model_devices = None
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
        devices = self.model_devices
        if devices and len(devices) > 1:
            return self._split(devices, x, k_cache, v_cache, mask, offsets,
                               seg, cache_valid, no_done)
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

    def _attend(self, q, k, v, k_cache, v_cache, mask, offsets, seg,
                cache_valid, no_done, rel_bias):
        """The attention of q's heads over [cache; unroll]."""
        k_all = torch.cat([k_cache.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_cache.to(v.dtype), v], dim=1)
        if self.attention_impl == "pallas":
            return transformer_attention(
                self.memory_len, q, k_all, v_all, seg, cache_valid.float(),
                no_done, rel_bias,
            )
        return dense_transformer_attend(q, k_all, v_all, mask, offsets,
                                        rel_bias)

    def _split(self, devices, x, k_cache, v_cache, mask, offsets, seg,
               cache_valid, no_done):
        """forward over K = len(devices) head and FFN column groups (the
        module docstring's tensor parallelism)."""
        B, T, d = x.shape
        K = len(devices)
        H = self.num_heads
        hd = d // H
        Hk = H // K
        dtype = self.dtype
        home = x.device

        def on(dev):
            return lambda t: None if t is None else t.to(dev)

        h = layer_norm(self.LayerNorm_0, x)
        attn, ks, vs = None, [], []
        for j, dev in enumerate(devices):
            to = on(dev)
            cols = slice(j * Hk * hd, (j + 1) * Hk * hd)
            heads = slice(j * Hk, (j + 1) * Hk)
            hj = to(h).to(dtype)

            def project(layer):
                return F.linear(hj, to(layer.weight[cols]).to(dtype),
                                to(layer.bias[cols]).to(dtype)).view(
                                    B, T, Hk, hd)

            q, k, v = project(self.q), project(self.k), project(self.v)
            attended = self._attend(
                q, k, v, to(k_cache[:, :, heads]), to(v_cache[:, :, heads]),
                to(mask), to(offsets), to(seg), to(cache_valid),
                to(no_done), to(self.rel_bias[heads]))
            part = F.linear(attended.reshape(B, T, Hk * hd).to(dtype),
                            to(self.out.weight[:, cols]).to(dtype))
            part = part.to(home).float()
            attn = part if attn is None else attn + part
            ks.append(k.to(home).float())
            vs.append(v.to(home).float())
        x = x + (attn + self.out.bias.to(dtype).float())
        h = layer_norm(self.LayerNorm_1, x)
        if hasattr(self, "moe"):
            x = x + self.moe(h.reshape(B * T, d)).reshape(B, T, d)
        else:
            ff = self.Dense_0.out_features // K
            mlp = None
            for j, dev in enumerate(devices):
                to = on(dev)
                cols = slice(j * ff, (j + 1) * ff)
                u = F.gelu(F.linear(to(h).to(dtype),
                                    to(self.Dense_0.weight[cols]).to(dtype),
                                    to(self.Dense_0.bias[cols]).to(dtype)),
                           approximate="tanh")
                part = F.linear(u, to(self.Dense_1.weight[:, cols]).to(
                    dtype)).to(home).float()
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
