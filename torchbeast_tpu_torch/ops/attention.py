"""The transformer policy's attention: the dense helpers (counterpart of
torchbeast_tpu/ops/attention.py) and the fused attention kernel
(counterpart of torchbeast_tpu/ops/pallas_attention.py).

Geometry, shared by every function here: cache slot m (of M, oldest
first) has time m - M, in-unroll step j has time j, and query t may
attend to times in [t - M, t] (the band). Over the combined key axis
[cache; unroll] of K = M + T keys, key j has time j - M, so query t sees
keys j in [t, t + M], at relative offset t - (j - M) in [0, M], which
indexes the learned bias rel_bias [H, M + 1].

`transformer_attention` is the `--attention_impl pallas` path. On CUDA
tensors its forward launches the hand-written kernel
`csrc/attention.cu::tbt_attention_fwd` and its backward the kernel of
`tbt_attention_bwd`; on CPU tensors it runs `transformer_attention_plain`
through autograd. Gradients flow to q, k_all, v_all and rel_bias only, as
in the reference's custom VJP.

Precision: q, k_all and v_all are f32 or bf16 (the trunk's dtype), and
rel_bias f32 or q's dtype. Both versions widen the inputs, compute in
f32 and narrow the output to q's dtype, as the reference's kernel does;
the gradients come back in their inputs' dtypes.
"""

import torch
import torch.nn.functional as F

from torchbeast_tpu_torch.ops import _build
from torchbeast_tpu_torch.ops._route import (
    count_launch,
    require,
    use_kernel,
)

BIG_NEG = -1e30

# The reference's guard: one (b, h) score tile [T, M+T] in f32, four
# times over for the live intermediates, within 6 MiB. Both packages
# accept the same shapes.
MAX_SCORE_TILE_BYTES = 6 * 1024 * 1024

# The kernels keep ceil(D / 32) head dims per lane in registers.
MAX_HEAD_DIM = 128

STORAGE = (torch.float32, torch.bfloat16)  # of q, k, v (and rel_bias)


def segment_ids_from_done(done):
    """[T, B] done flags -> [T, B] int32 segment ids (a segment starts AT
    a done step: state resets where done is set)."""
    return torch.cumsum(done.to(torch.int32), dim=0, dtype=torch.int32)


def band_relative_offsets(T: int, M: int, device=None):
    """(band [T, M+T] bool, offsets [T, M+T] int64 clipped to [0, M]) over
    the combined [cache; unroll] key axis."""
    q_time = torch.arange(T, device=device)
    key_time = torch.cat([torch.arange(M, device=device) - M,
                          torch.arange(T, device=device)])
    offsets = q_time[:, None] - key_time[None, :]
    band = (offsets >= 0) & (offsets <= M)
    return band, torch.clamp(offsets, 0, M)


def roll_kv_cache(k_cache, v_cache, valid, k_new, v_new, seg, no_done):
    """Keep the last M of [old cache; this unroll] (batch-first layout),
    validity restricted to the final segment: an episode boundary inside
    the unroll evicts everything before it.

    k_cache/v_cache: [B, M, H, hd]; valid: [B, M] (float or bool);
    k_new/v_new: [B, T, H, hd]; seg/no_done: [B, T].
    Returns (k, v, valid_f32) in the same layout.
    """
    M = k_cache.shape[1]
    seq_valid = seg == seg[:, -1:]
    old_valid = (valid != 0) & no_done[:, -1:]
    # A cache of another dtype joins the new keys in the promoted type, as
    # the reference's concatenate promotes it.
    dtype = torch.promote_types(k_cache.dtype, k_new.dtype)
    k_cat = torch.cat([k_cache.to(dtype), k_new.to(dtype)], dim=1)
    v_cat = torch.cat([v_cache.to(dtype), v_new.to(dtype)], dim=1)
    valid_cat = torch.cat([old_valid, seq_valid], dim=1)
    return (k_cat[:, -M:], v_cat[:, -M:],
            valid_cat[:, -M:].to(torch.float32))


def dense_transformer_attend(q, k_all, v_all, mask, offsets, rel_bias):
    """The `--attention_impl dense` body.

    q: [B, T, H, D]; k_all/v_all: [B, M+T, H, D] (cache prepended);
    mask: [B, T, M+T] bool (True = may attend); offsets: [T, M+T] int in
    [0, M]; rel_bias: [H, M+1]. Scores and softmax in f32; masked scores
    are BIG_NEG, so their weights are exactly 0.
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_all).float() * scale
    scores = scores + rel_bias[:, offsets][None]
    scores = torch.where(mask[:, None], scores, BIG_NEG)
    weights = torch.softmax(scores, dim=-1).to(v_all.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v_all)


def attention_mask(memory_len, seg, cache_valid, no_done):
    """The [B, T, M+T] bool mask (True = may attend) from the raw
    metadata, as the reference's `pallas_attention._reference` builds it.

    seg: [B, T] int segment ids; cache_valid: [B, M] (nonzero = valid);
    no_done: [B, T] bool (no done up to and including step t). Inside the
    band, cache keys are gated by validity and no_done, unroll keys by
    the segment.
    """
    M = memory_len
    B, T = seg.shape
    device = seg.device
    band, _ = band_relative_offsets(T, M, device=device)
    is_cache = torch.arange(M + T, device=device) < M
    seg_k = F.pad(seg, (M, 0))
    valid_k = torch.cat(
        [cache_valid != 0,
         torch.ones(B, T, dtype=torch.bool, device=device)], dim=1)
    same = seg[:, :, None] == seg_k[:, None, :]
    mask_unroll = band[None] & same
    mask_cache = band[None] & valid_k[:, None, :] & no_done[:, :, None]
    return torch.where(is_cache[None, None], mask_cache, mask_unroll)


def transformer_attention_plain(memory_len, q, k_all, v_all, seg,
                                cache_valid, no_done, rel_bias):
    """The plain PyTorch version of the kernel (the reference's
    `pallas_attention._reference`): `attention_mask`, then the dense
    body, on the inputs widened to f32; the output is narrowed to q's
    dtype. Its autograd is the plain backward."""
    _, offsets = band_relative_offsets(q.shape[1], memory_len,
                                       device=q.device)
    mask = attention_mask(memory_len, seg, cache_valid, no_done)
    out = dense_transformer_attend(q.float(), k_all.float(), v_all.float(),
                                   mask, offsets, rel_bias.float())
    return out.to(q.dtype)


def _check(memory_len, q, k_all, v_all, seg, cache_valid, no_done,
           rel_bias):
    """Shape, type and device checks of both versions; the shape guard."""
    name = "transformer_attention"
    require(q.dim() == 4, name, f"q must be [B, T, H, D], got "
            f"{tuple(q.shape)}")
    require(q.dtype in STORAGE, name, f"q dtype {q.dtype}: f32 or bf16")
    require(rel_bias.dtype in (torch.float32, q.dtype), name,
            f"rel_bias dtype {rel_bias.dtype}: f32 or q's {q.dtype}")
    B, T, H, D = q.shape
    M = memory_len
    K = M + T
    if 4 * T * K * 4 > MAX_SCORE_TILE_BYTES:
        raise ValueError(
            f"score tile [T={T}, M+T={K}] exceeds the fused attention "
            "budget (the reference's VMEM guard); the fused kernel targets "
            "RL-unroll scale, use --attention_impl dense for longer "
            "sequences"
        )
    for label, t, shape, dtype in (
        ("k_all", k_all, (B, K, H, D), q.dtype),
        ("v_all", v_all, (B, K, H, D), q.dtype),
        ("seg", seg, (B, T), torch.int32),
        ("cache_valid", cache_valid, (B, M), torch.float32),
        ("no_done", no_done, (B, T), torch.bool),
        ("rel_bias", rel_bias, (H, M + 1), rel_bias.dtype),
    ):
        require(tuple(t.shape) == shape, name,
                f"{label} {tuple(t.shape)} must be {shape}")
        require(t.dtype == dtype, name, f"{label} dtype {t.dtype} != {dtype}")
        require(t.device == q.device, name, "inputs on two devices")


def _kernel_inputs(name, tensors, D):
    """What the kernels take beyond `_check`: a head dim of at most
    MAX_HEAD_DIM, contiguous tensors."""
    require(1 <= D <= MAX_HEAD_DIM, name,
            f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    for t in tensors:
        require(t.is_contiguous(), name, "inputs must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_forward(memory_len, q, k_all, v_all, seg, cache_valid, no_done,
                    rel_bias):
    """(out [B, T, H, D], lse [B, H, T]) from the forward kernel; lse is
    each row's log-sum-exp, which the backward reuses."""
    name = "transformer_attention"
    B, T, H, D = q.shape
    _kernel_inputs(name, (q, k_all, v_all, seg, cache_valid, no_done,
                          rel_bias), D)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        status = lib.tbt_attention_fwd(
            q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
            seg.data_ptr(), cache_valid.data_ptr(), no_done.data_ptr(),
            rel_bias.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, T, H, D, memory_len, _bf16(q), _bf16(rel_bias), _stream(q),
        )
    _build.check(status, name)
    count_launch(transformer_attention, bf16_launches=_bf16(q))
    return out, lse


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


_tickets = {}


def _bwd_tickets(device, H):
    """The backward kernel's per-head ticket counters on `device`: zeroed
    once here, and left zero by every call, so no call needs a memset.
    Calls that share them must not overlap (one stream per device)."""
    t = _tickets.get(device)
    if t is None or t.numel() < H:
        t = _tickets[device] = torch.zeros(H, dtype=torch.int32,
                                           device=device)
    return t


def transformer_attention_bwd(memory_len, q, k_all, v_all, seg, cache_valid,
                              no_done, rel_bias, out, lse, grad_out):
    """(dq, dk_all, dv_all, drel_bias) from the backward kernel (one
    launch), given the forward's out and lse and the cotangent of out.
    CUDA tensors only: on the CPU the gradient comes from autograd through
    the plain version. out and grad_out have q's dtype, lse is f32; the
    gradients come in their inputs' dtypes."""
    name = "transformer_attention_bwd"
    require(q.is_cuda, name, "the backward kernel takes CUDA tensors")
    B, T, H, D = q.shape
    M = memory_len
    _kernel_inputs(name, (q, k_all, v_all, seg, cache_valid, no_done,
                          rel_bias, out, lse, grad_out), D)
    for label, t, dtype in (("out", out, q.dtype), ("lse", lse, torch.float32),
                            ("grad_out", grad_out, q.dtype)):
        require(t.dtype == dtype, name, f"{label} dtype {t.dtype} != {dtype}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k_all)
    dv = torch.empty_like(v_all)
    dbias = torch.empty_like(rel_bias)
    # Scratch: each (b, h)'s bias gradient over the M + 1 band offsets,
    # summed over b into dbias in a fixed order by the kernel; for bf16,
    # f32 room where dK and dV gather across row tiles (untouched when
    # one tile holds every row).
    partials = torch.empty(B, H, M + 1, dtype=torch.float64,
                           device=q.device)
    work = (torch.empty((2,) + tuple(k_all.shape), dtype=torch.float32,
                        device=q.device) if _bf16(q) else None)
    tickets = _bwd_tickets(q.device, H)
    lib = _build.library()
    with torch.cuda.device(q.device):
        status = lib.tbt_attention_bwd(
            q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
            seg.data_ptr(), cache_valid.data_ptr(), no_done.data_ptr(),
            rel_bias.data_ptr(), out.data_ptr(), lse.data_ptr(),
            grad_out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dbias.data_ptr(), partials.data_ptr(),
            tickets.data_ptr(), 0 if work is None else work.data_ptr(),
            B, T, H, D, M, _bf16(q), _bf16(rel_bias), _stream(q),
        )
    _build.check(status, name)
    count_launch(transformer_attention_bwd, bf16_launches=_bf16(q))
    return dq, dk, dv, dbias


transformer_attention_bwd.launches = 0
transformer_attention_bwd.bf16_launches = 0


class _FusedAttention(torch.autograd.Function):
    """Forward kernel, backward kernel; no gradient for the metadata."""

    @staticmethod
    def forward(ctx, memory_len, q, k_all, v_all, seg, cache_valid, no_done,
                rel_bias):
        out, lse = _launch_forward(memory_len, q, k_all, v_all, seg,
                                   cache_valid, no_done, rel_bias)
        ctx.memory_len = memory_len
        ctx.save_for_backward(q, k_all, v_all, seg, cache_valid, no_done,
                              rel_bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        dq, dk, dv, dbias = transformer_attention_bwd(
            ctx.memory_len, *ctx.saved_tensors, grad_out.contiguous())
        return None, dq, dk, dv, None, None, None, dbias


def transformer_attention(memory_len, q, k_all, v_all, seg, cache_valid,
                          no_done, rel_bias):
    """Fused attention of the transformer policy: [B, T, H, D] out.

    q [B, T, H, D], k_all/v_all [B, M+T, H, D] f32 or bf16 (one dtype);
    seg [B, T] int32; cache_valid [B, M] f32; no_done [B, T] bool;
    rel_bias [H, M+1] f32 or q's dtype. The output has q's dtype.
    A CUDA tensor launches csrc/attention.cu (forward, and backward when
    a gradient is taken; inputs contiguous, D <= 128); a CPU tensor runs
    `transformer_attention_plain` through autograd. Raises ValueError for
    a score tile beyond MAX_SCORE_TILE_BYTES, on either device.
    """
    _check(memory_len, q, k_all, v_all, seg, cache_valid, no_done, rel_bias)
    if not use_kernel(q, "transformer_attention"):
        return transformer_attention_plain(memory_len, q, k_all, v_all, seg,
                                           cache_valid, no_done, rel_bias)
    return _FusedAttention.apply(memory_len, q, k_all, v_all, seg,
                                 cache_valid, no_done, rel_bias)


transformer_attention.launches = 0
transformer_attention.bf16_launches = 0
