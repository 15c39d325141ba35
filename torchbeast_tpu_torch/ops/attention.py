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

import numpy as np
import torch
import torch.nn.functional as F

from torchbeast_tpu_torch.ops import _build
from torchbeast_tpu_torch.ops._route import (
    count_launch,
    note_bytes,
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
    note_bytes(q, k_all, v_all, seg, cache_valid, no_done, rel_bias, out,
               lse)
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
    note_bytes(q, k_all, v_all, seg, cache_valid, no_done, rel_bias, out,
               lse, grad_out, dq, dk, dv, dbias)
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


# ---------------------------------------------------------------------------
# Sequence parallelism (the reference's plain-JAX ops of the same names in
# torchbeast_tpu/ops/attention.py; none is a Pallas kernel).
#
# The reference shards the unroll axis T over a `seq` mesh axis inside a
# shard_map: device i holds query block i and K/V blocks rotate around the
# ring by ppermute (ring), or two all-to-alls move the tensors between
# sequence and head sharding (Ulysses). The port runs the same schedule in
# one process over a list of P devices: q, k, v arrive whole on their
# row's device; block i of them is copied to device i (on one card, a
# view); at ring step s device i takes K/V block (i - s) mod P by a copy
# from device (i - s) mod P, which stands in for the ppermute; Ulysses'
# all-to-alls become head-slice copies to each device, concatenated along
# the sequence, and the reverse. The online softmax runs as the
# reference's, block for block; the output comes back to the row's
# device in the reference's row order. Autograd carries the gradients
# back through the copies. Every tensor is indexed by slicing (no index
# tensors from the host), so a row on one card captures in a CUDA graph.


def causal_attention(q, k, v, segment_ids=None):
    """Dense causal(+segment) attention: q, k, v [B, T, H, D],
    segment_ids [B, T] (attend only within the same segment). Returns
    [B, T, H, D]."""
    T = q.shape[1]
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    mask = mask[None, None]
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        mask = mask & same[:, None]
    scores = torch.where(mask, scores, BIG_NEG)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _block_attend(q, k, v, mask, acc, row_max, row_sum, bias=None):
    """One online-softmax accumulation step over a K/V block.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; mask: [B or 1, Tq, Tk]
    (True = keep); acc: [B, Tq, H, D]; row_max/row_sum: [B, H, Tq];
    bias: optional additive [H, Tq, Tk], applied after scaling and
    before masking, as the dense order has it."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias[None]
    scores = torch.where(mask[:, None], scores, BIG_NEG)
    new_max = torch.maximum(row_max, scores.amax(dim=-1))
    correction = torch.exp(row_max - new_max)
    weights = torch.exp(scores - new_max[..., None])
    acc = acc * correction.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", weights, v)
    row_sum = row_sum * correction + weights.sum(dim=-1)
    return acc, new_max, row_sum


def _online_softmax_init(q_blk):
    """(acc, row_max, row_sum) carries of the online softmax. The
    running max starts at -1e9, well above the mask value BIG_NEG: from
    BIG_NEG a fully masked first block would give its masked scores
    weight exp(0) = 1; from -1e9 they are exact zeros."""
    B, Tb, H, _ = q_blk.shape
    zeros = torch.zeros(B, H, Tb, dtype=q_blk.dtype, device=q_blk.device)
    return torch.zeros_like(q_blk), zeros - 1e9, zeros


def _finalize(carry):
    acc, _, row_sum = carry
    return acc / row_sum.transpose(1, 2)[..., None]


def _blocks(x, devices, dim: int = 1):
    """x split into len(devices) equal blocks along `dim`, block i copied
    to devices[i] (the reference's sequence-sharded layout)."""
    return [part.to(d) for part, d in
            zip(x.chunk(len(devices), dim=dim), devices)]


def _positions(start: int, n: int, device):
    return start + torch.arange(n, device=device)


def _check_divides(T: int, P: int, what: str = "the ring"):
    if T % P != 0:
        raise ValueError(
            f"{what} needs T ({T}) divisible by the axis size ({P})")


def _ring_pass(devices, my_idx, q_blk, k_blocks, v_blocks, seg_blocks,
               carry, mask_bias_fn):
    """Device my_idx's ring: at step s it takes the K/V (and segment)
    block (my_idx - s) mod P, copied from its owner, and accumulates the
    online softmax into `carry` = (acc, row_max, row_sum).
    mask_bias_fn(q_pos, k_pos, seg_cur) -> (mask, bias or None) builds
    the block's mask and bias from global positions.

    Every device runs all P steps, including the blocks its causal mask
    fully rejects (their weights are exact zeros), as the reference's
    contiguous schedule does; the zigzag schedule skips them."""
    P = len(devices)
    dev = devices[my_idx]
    Tb = q_blk.shape[1]
    q_pos = _positions(my_idx * Tb, Tb, dev)
    for step in range(P):
        j = (my_idx - step) % P
        k_cur, v_cur = k_blocks[j].to(dev), v_blocks[j].to(dev)
        seg_cur = seg_blocks[j].to(dev)
        mask, bias = mask_bias_fn(q_pos, _positions(j * Tb, Tb, dev),
                                  seg_cur)
        carry = _block_attend(q_blk, k_cur, v_cur, mask, *carry, bias=bias)
    return _finalize(carry)


def zigzag_permutation(t: int, num_blocks: int) -> np.ndarray:
    """Row permutation mapping the contiguous sequence into the zigzag
    layout: device i holds chunks (i, 2P-1-i) of the 2P chunks, so a
    device owning an early chunk (few visible keys) also owns the
    mirror-image late chunk (many)."""
    assert t % (2 * num_blocks) == 0, (t, num_blocks)
    c = t // (2 * num_blocks)
    chunks = np.arange(t).reshape(2 * num_blocks, c)
    order = []
    for i in range(num_blocks):
        order.extend([i, 2 * num_blocks - 1 - i])
    return chunks[order].reshape(-1)


def _zigzag_blocks(x, devices, dim: int = 1):
    """x in the zigzag layout: block i = chunks (i, 2P-1-i) of 2P along
    `dim`, on devices[i]; by slicing (zigzag_permutation's rows)."""
    P = len(devices)
    chunks = x.chunk(2 * P, dim=dim)
    return [torch.cat([chunks[i], chunks[2 * P - 1 - i]], dim=dim).to(d)
            for i, d in enumerate(devices)]


def _unzigzag(blocks, home, dim: int = 1):
    """The inverse of _zigzag_blocks: the contiguous sequence on `home`."""
    P = len(blocks)
    early, late = [], []
    for b in blocks:
        e, l_ = b.to(home).chunk(2, dim=dim)
        early.append(e)
        late.append(l_)
    return torch.cat(early + late[::-1], dim=dim)


def _check_zigzag(T: int, P: int):
    if T % (2 * P) != 0:
        raise ValueError(
            f"zigzag schedule needs T ({T}) divisible by 2P ({2 * P})")


def _zigzag_pass(devices, c, my_idx, q_blk, k_blocks, v_blocks, seg_blocks,
                 accs_e, accs_l, mask_bias_fn):
    """Device my_idx's zigzag ring: block my_idx = (early chunk my_idx,
    late chunk 2P-1-my_idx). Step 0 runs both diagonal interactions and
    the always-visible late x early one; at step s >= 1, with K/V block
    j = (my_idx - s) mod P copied in, late x early always, then early x
    early when j < my_idx, else late x late (the other is never
    visible and skipped). mask_bias_fn(q_pos, k_pos, seg_q, seg_k) ->
    (mask, bias or None). accs_e/accs_l seed the two chunks' online
    softmax (a cache leg already in them). Returns the block's output."""
    P = len(devices)
    dev = devices[my_idx]
    e_pos = _positions(my_idx * c, c, dev)
    l_pos = _positions((2 * P - 1 - my_idx) * c, c, dev)
    q_e, q_l = q_blk[:, :c], q_blk[:, c:]
    seg_blk = seg_blocks[my_idx]
    seg_e_q, seg_l_q = seg_blk[:, :c], seg_blk[:, c:]

    def attend_at(accs, q_chunk, q_pos, seg_q, k_chunk, v_chunk, k_pos,
                  seg_k):
        mask, bias = mask_bias_fn(q_pos, k_pos, seg_q, seg_k)
        return _block_attend(q_chunk, k_chunk, v_chunk, mask, *accs,
                             bias=bias)

    k_blk, v_blk = k_blocks[my_idx], v_blocks[my_idx]
    accs_e = attend_at(accs_e, q_e, e_pos, seg_e_q, k_blk[:, :c],
                       v_blk[:, :c], e_pos, seg_e_q)
    accs_l = attend_at(accs_l, q_l, l_pos, seg_l_q, k_blk[:, c:],
                       v_blk[:, c:], l_pos, seg_l_q)
    accs_l = attend_at(accs_l, q_l, l_pos, seg_l_q, k_blk[:, :c],
                       v_blk[:, :c], e_pos, seg_e_q)
    for step in range(1, P):
        j = (my_idx - step) % P
        k_cur, v_cur = k_blocks[j].to(dev), v_blocks[j].to(dev)
        seg_cur = seg_blocks[j].to(dev)
        ke_pos = _positions(j * c, c, dev)
        kl_pos = _positions((2 * P - 1 - j) * c, c, dev)
        accs_l = attend_at(accs_l, q_l, l_pos, seg_l_q, k_cur[:, :c],
                           v_cur[:, :c], ke_pos, seg_cur[:, :c])
        if j < my_idx:
            accs_e = attend_at(accs_e, q_e, e_pos, seg_e_q, k_cur[:, :c],
                               v_cur[:, :c], ke_pos, seg_cur[:, :c])
        else:
            accs_l = attend_at(accs_l, q_l, l_pos, seg_l_q, k_cur[:, c:],
                               v_cur[:, c:], kl_pos, seg_cur[:, c:])
    return torch.cat([_finalize(accs_e), _finalize(accs_l)], dim=1)


def _segments(segment_ids, q):
    if segment_ids is None:
        return torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
    return segment_ids


def ring_attention(q, k, v, devices, segment_ids=None,
                   schedule: str = "contiguous"):
    """Sequence-parallel causal(+segment) attention over the P devices
    of `devices` (a row's `seq` axis): q, k, v [B, T, H, D] and
    segment_ids [B, T] on the row's device; returns [B, T, H, D] there.

    schedule "contiguous": device i holds rows [i*T/P, (i+1)*T/P).
    "zigzag": device i holds chunks (i, 2P-1-i) of 2P half-sized chunks
    (the permutation is applied and undone in here), which needs
    T % 2P == 0."""
    devices = list(devices)
    if schedule == "zigzag":
        return _zigzag_ring_attention(q, k, v, devices, segment_ids)
    if schedule != "contiguous":
        raise ValueError(f"Unknown ring schedule {schedule!r}")
    P = len(devices)
    _check_divides(q.shape[1], P)
    seg = _segments(segment_ids, q)
    qs, ks, vs = (_blocks(x, devices) for x in (q, k, v))
    segs = _blocks(seg, devices)
    outs = []
    for i in range(P):
        seg_blk = segs[i]

        def mask_bias(q_pos, k_pos, seg_cur, seg_blk=seg_blk):
            causal = q_pos[:, None] >= k_pos[None, :]
            mask = causal[None]
            if segment_ids is not None:
                mask = mask & (seg_blk[:, :, None] == seg_cur[:, None, :])
            return mask, None

        outs.append(_ring_pass(devices, i, qs[i], ks, vs, segs,
                               _online_softmax_init(qs[i]),
                               mask_bias).to(q.device))
    return torch.cat(outs, dim=1)


def _zigzag_ring_attention(q, k, v, devices, segment_ids):
    """ring_attention's zigzag schedule (see _zigzag_pass)."""
    P = len(devices)
    T = q.shape[1]
    _check_zigzag(T, P)
    c = T // (2 * P)
    seg = _segments(segment_ids, q)
    qz, kz, vz = (_zigzag_blocks(x, devices) for x in (q, k, v))
    segz = _zigzag_blocks(seg, devices)

    def mask_bias(q_pos, k_pos, seg_q, seg_k):
        causal = q_pos[:, None] >= k_pos[None, :]
        return causal[None] & (seg_q[:, :, None] == seg_k[:, None, :]), None

    outs = [_zigzag_pass(devices, c, i, qz[i], kz, vz, segz,
                         _online_softmax_init(qz[i][:, :c]),
                         _online_softmax_init(qz[i][:, c:]), mask_bias)
            for i in range(P)]
    return _unzigzag(outs, q.device)


def _cache_leg(q_chunk, q_pos, c_k, c_v, cm_chunk, bias_tbl, M):
    """A query chunk's attention into the M-entry cache (local on every
    device: cache slot m has time m - M, so the offset of query t to it
    is t + M - m; band, validity and no-done are in cm_chunk)."""
    offs = q_pos[:, None] + M - torch.arange(M, device=q_pos.device)[None]
    bias = bias_tbl[:, offs.clamp(0, M)]
    return _block_attend(q_chunk, c_k, c_v, cm_chunk,
                         *_online_softmax_init(q_chunk), bias=bias)


def ring_transformer_attention(q, k, v, cache_k, cache_v, cache_mask,
                               rel_bias, memory_len: int, segment_ids,
                               devices, schedule: str = "contiguous"):
    """Sequence-parallel attention of the transformer policy's block
    (models/transformer.py _Block) over `devices`: the band to the last
    `memory_len` steps, the segment mask, the relative-position bias and
    the rolling KV cache, softmax-merged online so the result is the
    dense path's. Each device's query block first attends the whole
    cache locally (copied to every device; M << T), then in-unroll K/V
    blocks rotate around the ring.

    q, k, v [B, T, H, D]; cache_k/v [B, M, H, D]; cache_mask [B, T, M]
    bool (band + validity + no done, the dense model's cache mask);
    rel_bias [H, M+1]; segment_ids [B, T] int; all on the row's device.
    Returns [B, T, H, D] there. schedule "contiguous" or "zigzag" (T %
    2P == 0), as ring_attention."""
    devices = list(devices)
    M = memory_len
    if schedule == "zigzag":
        return _zigzag_transformer_ring(q, k, v, cache_k, cache_v,
                                        cache_mask, rel_bias, M,
                                        segment_ids, devices)
    if schedule != "contiguous":
        raise ValueError(f"Unknown ring schedule {schedule!r}")
    P = len(devices)
    _check_divides(q.shape[1], P)
    qs, ks, vs = (_blocks(x, devices) for x in (q, k, v))
    segs = _blocks(segment_ids, devices)
    cms = _blocks(cache_mask, devices)
    Tb = q.shape[1] // P
    outs = []
    for i, dev in enumerate(devices):
        c_k, c_v, bias_tbl = cache_k.to(dev), cache_v.to(dev), rel_bias.to(
            dev)
        seg_blk = segs[i]
        carry = _cache_leg(qs[i], _positions(i * Tb, Tb, dev), c_k, c_v,
                           cms[i], bias_tbl, M)

        def mask_bias(q_pos, k_pos, seg_cur, seg_blk=seg_blk,
                      bias_tbl=bias_tbl):
            offsets = q_pos[:, None] - k_pos[None, :]
            band = (offsets >= 0) & (offsets <= M)
            same = seg_blk[:, :, None] == seg_cur[:, None, :]
            return band[None] & same, bias_tbl[:, offsets.clamp(0, M)]

        outs.append(_ring_pass(devices, i, qs[i], ks, vs, segs, carry,
                               mask_bias).to(q.device))
    return torch.cat(outs, dim=1)


def _zigzag_transformer_ring(q, k, v, cache_k, cache_v, cache_mask,
                             rel_bias, memory_len, segment_ids, devices):
    """ring_transformer_attention's zigzag schedule: the chunk-pair
    layout and skipping of _zigzag_pass, every computed interaction with
    the band + segment mask and the relative bias from global positions,
    each chunk attending the cache first. The band can mask pairs beyond
    causality; those are masked, not skipped."""
    P = len(devices)
    M = memory_len
    T = q.shape[1]
    _check_zigzag(T, P)
    c = T // (2 * P)
    qz, kz, vz = (_zigzag_blocks(x, devices) for x in (q, k, v))
    segz = _zigzag_blocks(segment_ids, devices)
    cmz = _zigzag_blocks(cache_mask, devices)
    outs = []
    for i, dev in enumerate(devices):
        c_k, c_v, bias_tbl = cache_k.to(dev), cache_v.to(dev), rel_bias.to(
            dev)

        def band_seg_bias(q_pos, k_pos, seg_q, seg_k, bias_tbl=bias_tbl):
            offsets = q_pos[:, None] - k_pos[None, :]
            band = (offsets >= 0) & (offsets <= M)
            mask = band[None] & (seg_q[:, :, None] == seg_k[:, None, :])
            return mask, bias_tbl[:, offsets.clamp(0, M)]

        e_pos = _positions(i * c, c, dev)
        l_pos = _positions((2 * P - 1 - i) * c, c, dev)
        outs.append(_zigzag_pass(
            devices, c, i, qz[i], kz, vz, segz,
            _cache_leg(qz[i][:, :c], e_pos, c_k, c_v, cmz[i][:, :c],
                       bias_tbl, M),
            _cache_leg(qz[i][:, c:], l_pos, c_k, c_v, cmz[i][:, c:],
                       bias_tbl, M),
            band_seg_bias))
    return _unzigzag(outs, q.device)


def _heads_to_devices(blocks, devices, hs):
    """The first all-to-all: sequence blocks (block j on devices[j]) ->
    per device i its head slice i over the whole sequence."""
    return [torch.cat([b[:, :, i * hs:(i + 1) * hs].to(d) for b in blocks],
                      dim=1) for i, d in enumerate(devices)]


def _heads_back(outs, devices, home):
    """The second all-to-all: per-device head slices over the whole
    sequence -> sequence block j (all heads) on devices[j], then the
    sequence on `home`."""
    P = len(devices)
    pieces = [o.chunk(P, dim=1) for o in outs]
    blocks = [torch.cat([pieces[i][j].to(d) for i in range(P)], dim=2)
              for j, d in enumerate(devices)]
    return torch.cat([b.to(home) for b in blocks], dim=1)


def ulysses_attention(q, k, v, devices, segment_ids=None):
    """All-to-all (DeepSpeed-Ulysses) sequence-parallel causal attention
    over `devices`: the tensors move from sequence to head sharding, each
    device runs the dense causal attention of H/P heads over the whole
    sequence, and the outputs move back. Needs T and H divisible by P.

    q, k, v [B, T, H, D], segment_ids [B, T], on the row's device;
    returns [B, T, H, D] there."""
    devices = list(devices)
    P = len(devices)
    B, T, H, D = q.shape
    if T % P != 0:
        raise ValueError(
            f"ulysses needs T ({T}) divisible by the axis size ({P})")
    if H % P != 0:
        raise ValueError(
            f"ulysses needs H ({H}) divisible by the axis size "
            f"({P}) — heads are the sharded resource"
        )
    hs = H // P
    qh, kh, vh = (_heads_to_devices(_blocks(x, devices), devices, hs)
                  for x in (q, k, v))
    outs = [causal_attention(qh[i], kh[i], vh[i],
                             None if segment_ids is None
                             else segment_ids.to(d))
            for i, d in enumerate(devices)]
    return _heads_back(outs, devices, q.device)


def ulysses_transformer_attention(q, k, v, cache_k, cache_v, mask, offsets,
                                  rel_bias, devices):
    """Ulysses for the transformer policy's block: the all-to-all to
    head sharding, then exactly the dense path's body
    (dense_transformer_attend: band, segment mask, relative bias, cache
    leg) over the whole sequence for H/P heads, then back. Dense and
    Ulysses cannot drift apart: it is the dense body on a head slice.

    q, k, v [B, T, H, D]; cache_k/v [B, M, H, D]; mask [B, T, M+T] bool
    (the dense path's combined mask); offsets [T, M+T]; rel_bias
    [H, M+1]; all on the row's device. Returns [B, T, H, D] there."""
    devices = list(devices)
    P = len(devices)
    B, T, H, D = q.shape
    if H % P != 0:
        raise ValueError(
            f"ulysses needs H ({H}) divisible by the axis size "
            f"({P})"
        )
    if T % P != 0:
        raise ValueError(
            f"ulysses needs T ({T}) divisible by the axis size ({P})")
    hs = H // P
    qh, kh, vh = (_heads_to_devices(_blocks(x, devices), devices, hs)
                  for x in (q, k, v))
    outs = []
    for i, d in enumerate(devices):
        heads = slice(i * hs, (i + 1) * hs)
        k_all = torch.cat([cache_k[:, :, heads].to(d), kh[i]], dim=1)
        v_all = torch.cat([cache_v[:, :, heads].to(d), vh[i]], dim=1)
        outs.append(dense_transformer_attend(
            qh[i], k_all, v_all, mask.to(d), offsets.to(d),
            rel_bias[heads].to(d)))
    return _heads_back(outs, devices, q.device)
