"""Transformer policy with stage-stacked blocks (counterpart of
torchbeast_tpu/models/transformer_pp.py).

The reference keeps every block parameter as one stacked `[L, ...]` leaf,
so that the tower can run as a pipeline over a `pipe` mesh axis, and
writes the block as a pure function over one layer's slice; without a
mesh it runs that function over the layers in turn. So does this module:
with `mesh` set (parallel/pp.set_pipeline) the [B, T, d] batch runs
through parallel/pp.pipeline_apply_multi over the mesh's pipe devices,
microbatched over B, each layer's KV cache its stage carry (resident on
its stage's device) and the segment ids and no-done mask its shared
inputs; the layer count must be a multiple of the pipe axis. A batch
whose B does not divide into the microbatches (an acting bucket) takes
the sequential loop on the same params, as in the reference;
`last_pipelined` says which path the last forward took.

Attention is models/transformer.py's dense path: the band-windowed
attention over [cache; unroll] with segment masking, the rolling
per-layer KV cache carried as the recurrent state, and the learned
relative bias, through the same helpers of ops/attention.py
(segment_ids_from_done, band_relative_offsets, dense_transformer_attend,
roll_kv_cache). It reaches no attention kernel: the drivers refuse
--attention_impl for this family, as the reference's do. The state
convention is TransformerNet's: per layer (k [M, B, H, hd], v [M, B, H,
hd], valid [M, B]).

Parameters, under the reference's names and in its layout: `encoder`
(the frame Dense), `extras`, the 17 stacked leaves of STAGE_PARAM_NAMES
(`wq`, `wk`, `wv` [L, d, H, hd], `bq`, `bk`, `bv` [L, H, hd], `rel_bias`
[L, H, M+1], `wo` [L, H, hd, d], `bo`, `w1` [L, d, 4d], `b1`, `w2`
[L, 4d, d], `b2`, and the two LayerNorms' scales and biases [L, d]),
`final_scale`, `final_bias` and `head`. No stacked leaf is named
`weight`, so weights.py carries each across as it is; utils/convert.py
maps them to TransformerNet's per-block layers and back.

Fresh weights are flax's (models/init.py): the stacked kernels are drawn
by the reference's `variance_scaling(1.0, "fan_in", "truncated_normal",
batch_axis=0)` with its input axes, so fan_in is d for wq, wk, wv and w1,
4d for w2 and H * hd for wo; the scales are ones, the biases and
rel_bias zeros.

Precision, as the reference's: `dtype` is the frame Dense's and the
stage's input dtype (each LayerNorm upcasts to f32, then casts to
`dtype`); each product runs in the promoted type of its operands
(layers.promoted_einsum), as jnp.einsum promotes, so under bf16_compute
(f32 params) q, k, v and the FFN compute in f32 from bf16 inputs, and
under bf16_train (bf16 params) in bf16. The residual stream and the
`extras` Dense stay f32, the cache is cast to k's dtype before the
concat, and the new k and v enter the cache in f32. `head_dtype` is the
policy head's (no LSTM).

`remat` recomputes each stage call, the cache roll included, in the
backward, keeping only its inputs (models/layers.checkpointed; the
reference's jax.checkpoint around its stage function): the `blocks`
stage of the remat planner (runtime/remat_plan.py).
"""

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch.models import init
from torchbeast_tpu_torch.models.cores import RecurrentPolicyHead
from torchbeast_tpu_torch.models.layers import (
    Dense,
    checkpointed,
    layer_norm_of,
    linear,
    promoted_einsum,
)
from torchbeast_tpu_torch.models.pipelined import _pp, check_pipe_axis
from torchbeast_tpu_torch.ops.attention import (
    band_relative_offsets,
    dense_transformer_attend,
    roll_kv_cache,
    segment_ids_from_done,
)

LAYER_NORM_EPS = 1e-6


class PipelinedTransformerNet(nn.Module):
    """forward(inputs, core_state, sample_action=True, generator=None) ->
    (AgentOutput, new core_state), TransformerNet's interface."""

    STAGE_PARAM_NAMES = (
        "ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk", "wv", "bv",
        "rel_bias", "wo", "bo", "ln2_scale", "ln2_bias",
        "w1", "b1", "w2", "b2",
    )

    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), num_layers: int = 4,
                 d_model: int = 128, num_heads: int = 4,
                 memory_len: int = 64, dtype=torch.float32,
                 head_dtype=torch.float32, remat: bool = False,
                 mesh=None, pipe_axis: str = "pipe",
                 n_microbatches=None, batch_axis=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(
                f"d_model {d_model} must divide by num_heads {num_heads}")
        self.num_actions = num_actions
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.memory_len = memory_len
        self.dtype = dtype
        self.remat = bool(remat)
        L, d, H, M = num_layers, d_model, num_heads, memory_len
        hd, ff = d // H, 4 * d
        self.encoder = Dense(int(np.prod(frame_shape)), d)
        self.extras = Dense(1 + num_actions, d)
        shapes = {
            "ln1_scale": (L, d), "ln1_bias": (L, d),
            "wq": (L, d, H, hd), "bq": (L, H, hd),
            "wk": (L, d, H, hd), "bk": (L, H, hd),
            "wv": (L, d, H, hd), "bv": (L, H, hd),
            "rel_bias": (L, H, M + 1),
            "wo": (L, H, hd, d), "bo": (L, d),
            "ln2_scale": (L, d), "ln2_bias": (L, d),
            "w1": (L, d, ff), "b1": (L, ff),
            "w2": (L, ff, d), "b2": (L, d),
        }
        fan_in = {"wq": d, "wk": d, "wv": d, "wo": H * hd, "w1": d,
                  "w2": ff}
        for name in self.STAGE_PARAM_NAMES:
            p = nn.Parameter(torch.zeros(shapes[name]))
            if name.endswith("_scale"):
                nn.init.ones_(p)
            elif name in fan_in:
                init.lecun_normal_(p, fan_in[name])
            self.register_parameter(name, p)
        self.final_scale = nn.Parameter(torch.ones(d))
        self.final_bias = nn.Parameter(torch.zeros(d))
        self.head = RecurrentPolicyHead(
            d, num_actions, use_lstm=False, hidden_size=d, num_layers=1,
            dtype=head_dtype,
        )
        self.last_pipelined = False
        _pp().set_pipeline(self, mesh, n_microbatches, batch_axis, pipe_axis)

    def check_pipe_axis(self):
        check_pipe_axis(self.mesh, self.pipe_axis, self.num_layers,
                        "num_layers")

    def _stage(self, layer, x, k_cache, v_cache, valid, seg, no_done,
               band, offsets, seq_mask):
        """One block on layer `layer`'s slice of the stacked params, then
        the cache roll. x: [B, T, d] f32; k_cache/v_cache: [B, M, H, hd];
        valid: [B, M]; seg/no_done: [B, T]; band/offsets: [T, M+T];
        seq_mask: [B, T, T]. Returns (x, k, v, valid), the rolled cache
        batch-first."""
        params = {name: getattr(self, name)[layer]
                  for name in self.STAGE_PARAM_NAMES}
        return self._block(params, x, k_cache, v_cache, valid, seg, no_done,
                           band, offsets, seq_mask)

    def _pipe_stage(self, band, offsets):
        """The stage function of pipeline_apply: one block on a stage's
        params, its cache the carry, (seg, no_done) the shared inputs;
        band and offsets go to the stage's device, the sequence mask is
        made there from the microbatch's segments."""
        M = self.memory_len

        def stage(p, x, carry, shared):
            k_cache, v_cache, valid = carry
            seg, no_done = shared
            b, o = band.to(x.device), offsets.to(x.device)
            seq_mask = b[None, :, M:] & (seg[:, :, None] == seg[:, None, :])
            x, k, v, valid = self._block(p, x, k_cache, v_cache, valid, seg,
                                         no_done, b, o, seq_mask)
            return x, (k, v, valid)

        if not self.remat:
            return stage
        return lambda p, x, carry, shared: checkpointed(stage, p, x, carry,
                                                        shared)

    def _block(self, params, x, k_cache, v_cache, valid, seg, no_done,
               band, offsets, seq_mask):
        """_stage's body on explicit params (a dict by stage name)."""
        def p(name):
            return params[name]

        M = self.memory_len
        h = layer_norm_of(x, p("ln1_scale"), p("ln1_bias"),
                          LAYER_NORM_EPS).to(self.dtype)
        q = promoted_einsum("btd,dhk->bthk", h, p("wq")) + p("bq")
        k = promoted_einsum("btd,dhk->bthk", h, p("wk")) + p("bk")
        v = promoted_einsum("btd,dhk->bthk", h, p("wv")) + p("bv")
        cache_mask = (band[None, :, :M] & (valid != 0)[:, None, :]
                      & no_done[:, :, None])
        mask = torch.cat([cache_mask, seq_mask], dim=-1)
        k_all = torch.cat([k_cache.to(k.dtype), k], dim=1)
        v_all = torch.cat([v_cache.to(v.dtype), v], dim=1)
        attended = dense_transformer_attend(q, k_all, v_all, mask, offsets,
                                            p("rel_bias"))
        x = x + (promoted_einsum("bthk,hkd->btd", attended, p("wo"))
                 + p("bo")).float()
        h = layer_norm_of(x, p("ln2_scale"), p("ln2_bias"),
                          LAYER_NORM_EPS).to(self.dtype)
        h = F.gelu(promoted_einsum("btd,df->btf", h, p("w1")) + p("b1"),
                   approximate="tanh")
        x = x + (promoted_einsum("btf,fd->btd", h, p("w2"))
                 + p("b2")).float()
        return (x, *roll_kv_cache(k_cache, v_cache, valid, k.float(),
                                  v.float(), seg, no_done))

    def forward(self, inputs, core_state, sample_action: bool = True,
                generator=None):
        frame = inputs["frame"]
        T, B = frame.shape[:2]
        M, d = self.memory_len, self.d_model
        x = linear(self.encoder,
                   frame.reshape(T * B, -1).to(self.dtype) / 255.0,
                   self.dtype)
        one_hot = F.one_hot(inputs["last_action"].reshape(T * B).long(),
                            self.num_actions).float()
        reward = torch.clamp(inputs["reward"].float(), -1, 1).reshape(
            T * B, 1)
        x = x.float() + linear(self.extras,
                               torch.cat([reward, one_hot], dim=-1))
        x = x.reshape(T, B, d).transpose(0, 1).contiguous()

        done = inputs["done"]
        seg = segment_ids_from_done(done).t().contiguous()  # [B, T]
        no_done = seg == 0
        band, offsets = band_relative_offsets(T, M, device=frame.device)
        seq_mask = band[None, :, M:] & (seg[:, :, None] == seg[:, None, :])

        new_state = []
        self.check_pipe_axis()
        self.last_pipelined = self.mesh is not None and _pp().can_pipeline(
            self.mesh, B, self.pipe_axis, self.n_microbatches,
            self.batch_axis)
        if self.last_pipelined:
            caches = tuple(torch.stack(leaves) for leaves in zip(*(
                (k.transpose(0, 1), v.transpose(0, 1), valid.t())
                for k, v, valid in core_state)))
            x, (ks, vs, valids) = _pp().pipeline_apply_multi(
                self._pipe_stage(band, offsets),
                {name: getattr(self, name)
                 for name in self.STAGE_PARAM_NAMES},
                x, mesh=self.mesh, axis=self.pipe_axis,
                n_microbatches=self.n_microbatches, stage_carry=caches,
                shared=(seg, no_done), batch_axis=self.batch_axis)
            new_state = [(ks[i].transpose(0, 1), vs[i].transpose(0, 1),
                          valids[i].t()) for i in range(self.num_layers)]
        for layer in range(0 if self.last_pipelined else self.num_layers):
            k_cache, v_cache, valid = core_state[layer]
            args = (layer, x, k_cache.transpose(0, 1),
                    v_cache.transpose(0, 1), valid.t(), seg, no_done, band,
                    offsets, seq_mask)
            x, k, v, valid = (checkpointed(self._stage, *args) if self.remat
                              else self._stage(*args))
            new_state.append((k.transpose(0, 1), v.transpose(0, 1),
                              valid.t()))

        x = layer_norm_of(x, self.final_scale, self.final_bias,
                          LAYER_NORM_EPS)
        core_output = x.transpose(0, 1).reshape(T * B, d)
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
