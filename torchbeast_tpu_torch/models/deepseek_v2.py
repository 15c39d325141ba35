"""DeepSeek-V2's block as the policy core: multi-head latent attention
(MLA) over a rolling latent cache, DeepSeekMoE's routed and shared
experts, RMSNorm (`--model deepseek_v2_lite`).

The block (DeepSeek-AI 2024, arXiv:2405.04434 sections 2.1 and 2.2; the
published DeepSeek-V2-Lite config.json gives the defaults: d 2048, 27
layers of which the first is dense (SwiGLU of 10,944), 16 heads, no query
LoRA, kv_lora_rank 512, qk_nope_head_dim 128, qk_rope_head_dim 64,
v_head_dim 128, 64 routed experts of 1,408 with top-6 greedy softmax
routing, no renormalisation, 2 shared experts, RMSNorm eps 1e-6, RoPE
theta 1e4 under YaRN (factor 40, original length 4096, beta_fast 32,
beta_slow 1, mscale = mscale_all_dim = 0.707)). Each layer, on x
[B, T, d] with an f32 residual:

    h = RMSNorm(x);  q = h W_q -> H x (nope + rope)
    [c, k_pe] = h W_kva;  c = RMSNorm_kv(c)
    over the [cache; unroll] axis: [k_nope, v] = c W_kvb -> H x (nope + v)
    q_pe, k_pe rotated by slot (k_pe shared by the heads)
    softmax over the band, segment and cache mask of
        (q_nope . k_nope + q_pe . k_pe) * scale, times v, then W_o
    x += that;  h = RMSNorm(x);  x += FFN(h)

with FFN the dense SwiGLU in the first `first_dense` layers and
models/moe.DroplessMoE in the rest. The attention runs in MLA's absorbed
form: q_nope W_UK per head gives a 512-wide latent query, the scores are
one product of [q_latent; q_pe] against the cached [c; k_pe] (576 wide),
the values the softmax times c, then W_UV and W_o; the per-head keys and
values are never formed. `scale` is qk_head_dim^-0.5 times DeepSeek's
YaRN logit factor (0.1 mscale_all_dim ln(factor) + 1)^2, as DeepSeek's
own code applies it.

Frames come in and actions go out, as in the transformer family
(models/transformer.py): the frame Dense `Dense_0` and `extras` (clipped
reward and one-hot last action) make the token; after the layers a final
RMSNorm `norm` and the policy and baseline heads (`head`).

The memory is MLA's latent cache, the recurrent state: per layer the
normalised c [M, B, kv_lora_rank], the un-rotated k_pe [M, B, rope] and
valid [M, B], as one flat tuple of 3 x layers tensors (batch on axis 1).
The transformer's episode rules hold (ops/attention.attention_mask and
roll_kv_cache): attention within the unroll stays inside the segment
that `done` starts, cache slots are seen only before a done, and the
cache written back keeps the last M steps of the final segment. RoPE is
applied by slot on the [cache; unroll] axis: key slot j at angle j,
query t at M + t. The cache is contiguous in time, so a score depends
only on the offset, as in an unbroken stream, and the acting step at
T=1 equals the learner's batch forward.

The cut of a deployment (the benchmark's configuration,
portbench/configs/deepseek_v2_lite.json): `num_layers`, `experts_held`
(the routed experts this device holds, of `num_experts`, from
`expert_offset`; the router keeps all of them) and `memory_len`.

Precision: `dtype` (the trunk's compute dtype) is the projections', the
FFN's and the experts'; the residual, the RMSNorms, the RoPE angles, the
router and the softmax stay f32; the cache is cast to `dtype` and the new
latents are returned as f32. `head_dtype` is the heads'.

Device marks (marks.py): each layer's attention, its norm included, is
one instance of the summed region MLA, forward and back; each MoE layer,
its norm, router and shared experts included, one of MOE.

Submodule names: Dense_0, extras, layer_{i}.{attn_norm, attn.{q, kv_a,
kv_norm, kv_b, o}, ffn_norm, mlp.{gate, up, down} | moe.{router, w_gate,
w_up, w_down, shared.{gate, up, down}}}, norm, head.
"""

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchbeast_tpu_torch import marks
from torchbeast_tpu_torch.models import init
from torchbeast_tpu_torch.models.cores import RecurrentPolicyHead
from torchbeast_tpu_torch.models.layers import Dense, linear
from torchbeast_tpu_torch.models.moe import DroplessMoE, SwiGLU
from torchbeast_tpu_torch.ops.attention import (
    BIG_NEG,
    attention_mask,
    roll_kv_cache,
    segment_ids_from_done,
)

# DeepSeek-V2-Lite's rope_scaling (config.json).
YARN = {"factor": 40.0, "original_max_position_embeddings": 4096,
        "beta_fast": 32.0, "beta_slow": 1.0, "mscale": 0.707,
        "mscale_all_dim": 0.707}


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention temperature factor: 0.1 mscale ln(scale) + 1."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(dim: int, base: float, factor: float,
                  original_max_position_embeddings: int, beta_fast: float,
                  beta_slow: float) -> torch.Tensor:
    """[dim / 2] f32 inverse frequencies: theta's extrapolated below the
    correction range, interpolated (divided by `factor`) above it, a
    linear ramp between (DeepSeek's DeepseekV2YarnRotaryEmbedding)."""

    def correction_dim(rotations):
        return (dim * math.log(original_max_position_embeddings
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                           / dim)
    inter = extra / factor
    keep = 1.0 - ramp  # 1 where the frequency extrapolates
    return inter * (1 - keep) + extra * keep


def rope(x, cos, sin):
    """x [B, S, rope] or [B, S, H, rope] rotated in interleaved pairs
    (x[2i], x[2i+1]) by angle pos * inv_freq[i]: DeepSeek's complex form.
    cos, sin [S, rope / 2] of the S slots' positions."""
    if x.dim() == 4:
        cos, sin = cos[:, None], sin[:, None]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * cos - odd * sin, even * sin + odd * cos],
                       dim=-1).flatten(-2)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, in f32."""

    def __init__(self, size: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))

    def forward(self, x):
        x = x.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight.float() * x


def _bias_free(d_in: int, d_out: int) -> nn.Linear:
    layer = nn.Linear(d_in, d_out, bias=False)
    init.lecun_normal_(layer.weight, d_in)
    return layer


class MLA(nn.Module):
    """Multi-head latent attention over [cache; unroll], absorbed form."""

    def __init__(self, d_model, num_heads, nope, rope_dim, v_dim, kv_lora,
                 eps, scale, dtype):
        super().__init__()
        self.num_heads, self.nope, self.rope_dim = num_heads, nope, rope_dim
        self.v_dim, self.kv_lora = v_dim, kv_lora
        self.scale, self.dtype = scale, dtype
        self.q = _bias_free(d_model, num_heads * (nope + rope_dim))
        self.kv_a = _bias_free(d_model, kv_lora + rope_dim)
        self.kv_norm = RMSNorm(kv_lora, eps)
        self.kv_b = _bias_free(kv_lora, num_heads * (nope + v_dim))
        self.o = _bias_free(num_heads * v_dim, d_model)

    def forward(self, h, c_cache, pe_cache, mask, cos, sin):
        """h [B, T, d] (normalised); c_cache [B, M, kv_lora], pe_cache
        [B, M, rope]; mask [B, T, M+T]; cos, sin [M+T, rope/2] by slot.
        Returns (out [B, T, d] f32, c [B, T, kv_lora] f32, k_pe
        [B, T, rope] f32), the last two this unroll's latents."""
        B, T, _ = h.shape
        H, dtype = self.num_heads, self.dtype
        M = c_cache.shape[1]
        q = linear(self.q, h, dtype).view(B, T, H, self.nope + self.rope_dim)
        q_nope, q_pe = q.split([self.nope, self.rope_dim], dim=-1)
        kv = linear(self.kv_a, h, dtype)
        c, k_pe = kv.float().split([self.kv_lora, self.rope_dim], dim=-1)
        c = self.kv_norm(c)
        c_all = torch.cat([c_cache.to(dtype), c.to(dtype)], dim=1)
        pe_all = rope(torch.cat([pe_cache.float(), k_pe], dim=1), cos, sin)
        q_pe = rope(q_pe.float(), cos[M:], sin[M:])
        w = self.kv_b.weight.to(dtype).view(H, self.nope + self.v_dim,
                                            self.kv_lora)
        w_uk, w_uv = w.split([self.nope, self.v_dim], dim=1)
        q_lat = torch.einsum("bthn,hnc->bthc", q_nope, w_uk)
        query = torch.cat([q_lat, q_pe.to(dtype)], -1).view(B, T * H, -1)
        key = torch.cat([c_all, pe_all.to(dtype)], -1)
        scores = torch.bmm(query, key.transpose(1, 2)).float() * self.scale
        scores = scores.view(B, T, H, -1).masked_fill(
            ~mask[:, :, None, :], BIG_NEG)
        weights = torch.softmax(scores, dim=-1).to(dtype)
        out_lat = torch.bmm(weights.view(B, T * H, -1), c_all)
        out = torch.einsum("bthc,hvc->bthv", out_lat.view(B, T, H, -1), w_uv)
        out = linear(self.o, out.reshape(B, T, H * self.v_dim), dtype)
        return out.float(), c, k_pe


class _Layer(nn.Module):
    """Pre-norm MLA, then the dense SwiGLU (`dense_width`) or the
    dropless MoE (`moe_kw`)."""

    def __init__(self, d_model, eps, mla_kw, dense_width=None, moe_kw=None,
                 dtype=torch.float32):
        super().__init__()
        self.attn_norm = RMSNorm(d_model, eps)
        self.attn = MLA(d_model, eps=eps, dtype=dtype, **mla_kw)
        self.ffn_norm = RMSNorm(d_model, eps)
        if moe_kw is None:
            self.mlp = SwiGLU(d_model, dense_width, dtype)
        else:
            self.moe = DroplessMoE(d_model, dtype=dtype, **moe_kw)

    def forward(self, x, c_cache, pe_cache, mask, cos, sin):
        B, T, d = x.shape
        h = self.attn_norm(marks.region_in(x, marks.MLA))
        a, c, k_pe = self.attn(h, c_cache, pe_cache, mask, cos, sin)
        x = x + marks.region_out(a, marks.MLA)
        if hasattr(self, "mlp"):
            return x + self.mlp(self.ffn_norm(x)), c, k_pe
        h = self.ffn_norm(marks.region_in(x, marks.MOE))
        y = self.moe(h.reshape(B * T, d), sequences=B).view(B, T, d)
        return x + marks.region_out(y, marks.MOE), c, k_pe


class DeepSeekV2Net(nn.Module):
    """forward(inputs, core_state, sample_action=True, generator=None) ->
    (AgentOutput, new core_state); inputs as the transformer's: frame
    [T, B, H, W, C] uint8, reward [T, B], done [T, B] bool, last_action
    [T, B]."""

    def __init__(self, num_actions: int, use_lstm: bool = False,
                 frame_shape=(84, 84, 4), num_layers: int = 27,
                 first_dense: int = 1, d_model: int = 2048,
                 num_heads: int = 16, qk_nope_head_dim: int = 128,
                 qk_rope_head_dim: int = 64, v_head_dim: int = 128,
                 kv_lora_rank: int = 512, dense_width: int = 10944,
                 num_experts: int = 64, experts_held=None,
                 expert_offset: int = 0, moe_top_k: int = 6,
                 expert_width: int = 1408, num_shared: int = 2,
                 routed_scaling_factor: float = 1.0,
                 aux_loss_alpha: float = 1e-3, memory_len: int = 4096,
                 rope_theta: float = 1e4, rope_scaling=None,
                 rms_eps: float = 1e-6, tile_rows: int = 256,
                 dtype=torch.float32, head_dtype=torch.float32,
                 device=None):
        super().__init__()
        yarn = dict(YARN if rope_scaling is None else rope_scaling)
        self.num_actions = num_actions
        self.num_layers = num_layers
        self.d_model = d_model
        self.kv_lora_rank = kv_lora_rank
        self.rope_dim = qk_rope_head_dim
        self.memory_len = memory_len
        self.dtype = dtype
        self.softmax_scale = ((qk_nope_head_dim + qk_rope_head_dim) ** -0.5
                              * yarn_mscale(yarn["factor"],
                                            yarn["mscale_all_dim"]) ** 2)
        mla_kw = dict(num_heads=num_heads, nope=qk_nope_head_dim,
                      rope_dim=qk_rope_head_dim, v_dim=v_head_dim,
                      kv_lora=kv_lora_rank, scale=self.softmax_scale)
        moe_kw = dict(expert_width=expert_width, num_experts=num_experts,
                      top_k=moe_top_k, experts_held=experts_held,
                      expert_offset=expert_offset, num_shared=num_shared,
                      routed_scaling_factor=routed_scaling_factor,
                      aux_loss_alpha=aux_loss_alpha, tile_rows=tile_rows)
        # The modules on the meta device, then storage on `device` and
        # weights drawn there (1.37 B parameters at the benchmark's cut:
        # drawn on the host they would take minutes).
        with torch.device("meta"):
            self.Dense_0 = Dense(math.prod(frame_shape), d_model)
            self.extras = Dense(1 + num_actions, d_model)
            for i in range(num_layers):
                dense = i < first_dense
                setattr(self, f"layer_{i}", _Layer(
                    d_model, rms_eps, mla_kw,
                    dense_width=dense_width if dense else None,
                    moe_kw=None if dense else moe_kw, dtype=dtype))
            self.norm = RMSNorm(d_model, rms_eps)
            self.head = RecurrentPolicyHead(
                d_model, num_actions, use_lstm=False, hidden_size=d_model,
                num_layers=1, dtype=head_dtype)
        device = torch.device("cpu" if device is None else device)
        self.to_empty(device=device)
        self.register_buffer("inv_freq", yarn_inv_freq(
            qk_rope_head_dim, rope_theta, yarn["factor"],
            yarn["original_max_position_embeddings"], yarn["beta_fast"],
            yarn["beta_slow"]).to(device), persistent=False)
        # A generator of the device's own, seeded from the global one, so
        # the draw follows the caller's seed and leaves the device's
        # global generator as it was.
        self.reset_parameters(torch.Generator(device=device).manual_seed(
            int(torch.randint(0, 2 ** 62, ()))))

    def reset_parameters(self, generator):
        """Fresh weights from `generator`: every matrix (each expert's
        too) lecun_normal with its input width as fan_in, as the port
        draws a Dense (models/init.py); biases zero; RMSNorm weights
        one."""
        norms = {id(m.weight) for m in self.modules()
                 if isinstance(m, RMSNorm)}
        with torch.no_grad():
            for p in self.parameters():
                if id(p) in norms:
                    p.fill_(1.0)
                elif p.dim() == 1:
                    p.zero_()
                else:
                    init.lecun_normal_(p, p.shape[-1], generator=generator)

    def rotations(self, slots: int, device):
        """(cos, sin) [slots, rope / 2] f32 of slot positions 0..slots-1."""
        angle = torch.outer(torch.arange(slots, device=device,
                                         dtype=torch.float32),
                            self.inv_freq.to(device))
        return torch.cos(angle), torch.sin(angle)

    def forward(self, inputs, core_state, sample_action: bool = True,
                generator=None):
        frame = inputs["frame"]
        T, B = frame.shape[:2]
        M = self.memory_len
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
        no_done_yet = seg == 0
        cos, sin = self.rotations(M + T, frame.device)

        new_state = []
        for i in range(self.num_layers):
            c_cache, pe_cache, valid = core_state[3 * i:3 * i + 3]
            c_b, pe_b = c_cache.transpose(0, 1), pe_cache.transpose(0, 1)
            valid_b = valid.t()
            mask = attention_mask(M, seg, valid_b, no_done_yet)
            x, c, k_pe = getattr(self, f"layer_{i}")(x, c_b, pe_b, mask,
                                                     cos, sin)
            c_roll, pe_roll, valid_roll = roll_kv_cache(
                c_b.float(), pe_b.float(), valid_b, c, k_pe, seg,
                no_done_yet)
            new_state += [c_roll.transpose(0, 1), pe_roll.transpose(0, 1),
                          valid_roll.t()]

        x = self.norm(x)
        core_output = x.transpose(0, 1).reshape(T * B, self.d_model)
        out, _ = self.head(core_output, done, (), T, B, sample_action,
                           generator)
        return out, tuple(new_state)

    def initial_state(self, batch_size: int, device=None) -> Tuple:
        M = self.memory_len
        state = []
        for _ in range(self.num_layers):
            state += [torch.zeros(M, batch_size, self.kv_lora_rank,
                                  device=device),
                      torch.zeros(M, batch_size, self.rope_dim,
                                  device=device),
                      torch.zeros(M, batch_size, device=device)]
        return tuple(state)
