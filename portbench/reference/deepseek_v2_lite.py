"""DeepSeek-V2-Lite's block as the policy core, in plain PyTorch, f32,
step by step (DeepSeek-AI 2024, arXiv:2405.04434 sections 2.1 and 2.2;
the published config.json of deepseek-ai/DeepSeek-V2-Lite).

The frame (uint8 / 255, flattened H, W, C) and the extras (the clipped
reward and the one-hot last action) make the token: x = Dense_0(frame) +
extras(...). Each layer, on the f32 residual x:

- h = RMSNorm(x); q = h W_q per head [nope | rope]; [c, k_pe] = h W_kva,
  c = RMSNorm_kv(c);
- the latents over [cache; unroll] (S = M + T slots, the cache first):
  [k_nope | v] = c W_kvb per head, the per-head keys and values formed
  whole; k_pe and q_pe rotated as complex numbers (pairs x[2i], x[2i+1])
  by slot, key slot j at position j, query t at M + t, YaRN's inverse
  frequencies (theta 1e4, factor 40, original length 4096, beta 32 and
  1); k = [k_nope | k_pe], shared k_pe for every head;
- query t, one step at a time, sees key slot s where s lies in its band
  (t <= s <= M + t), and a cache slot (s < M) only where valid != 0 and
  no done fell at steps 0..t, an unroll step j only where no done fell
  at steps j+1..t; scores scaled by (nope + rope)^-0.5 times
  (0.1 * mscale_all_dim * ln(factor) + 1)^2 (the paper's sqrt(t) logit
  factor, as DeepSeek's code applies it), softmax, times v, then W_o;
- x += that; h = RMSNorm(x); the first `first_dense` layers add the dense
  SwiGLU down(silu(gate h) * up h); the others p = softmax(h W_r^T) over
  all `num_experts`, each token's `top_k` picked one at a time by
  argmax (the lower index on a tie), not renormalised, and add, over the
  held experts e in the token's picks, p_e SwiGLU_e(h), a loop over the
  held experts, plus the shared SwiGLU for every token.

The expert-level balance loss: for each actor's unroll column (one
sequence of T tokens), f_i = E / (K T) times its picks of expert i and
P_i its mean p_i; aux_loss_alpha times sum_i f_i P_i, averaged over the
columns, summed over the MoE layers. The learner (learner.py, shared
with every network here) sums the IMPALA losses only, so `forward` adds
the balance loss's gradient through an identity on the logits whose
backward hands the summed balance loss a gradient of one, as its term in
the objective would; the compared loss value leaves it out (at the
cell's size a share of the total below the loss gaps the check reads).

After the layers: RMSNorm, then the policy logits and the baseline,
linear. The new state keeps the last M slots of [cache; unroll]: a cache
slot stays valid where it was and no done fell in the unroll, an unroll
step where no done fell after it.

The cut (portbench/configs/deepseek_v2_lite.json): `num_layers` layers
of the published 27, `experts_held` of the router's `num_experts` held
(experts 0..held-1; the others' share of every output is left out, as
the program leaves it out), `memory_len` steps of cache. Departures from
the published model, each also in the configuration's `assumed`:

- frames in and actions out: no vocabulary, no LM head;
- RoPE by slot in the rolling cache, not by absolute position;
- the paper's device-level token dropping and its device- and
  communication-level balance losses are left out with the cross-chip
  parts the cut removes;
- aux_loss_alpha (the paper's alpha_1) 0.001, assumed: the config does
  not give it; the paper gives 0.003 for DeepSeek-V2.

Parameter names and layouts are the program's
(torchbeast_tpu_torch/models/deepseek_v2.py): each Linear's weight
[out, in], the experts' stacked along their rows, [held * out, in], so
each leaf is a matrix with its expert's own fan-in.
"""

import torch
import torch.nn.functional as F


def _layer_shapes(prefix, net, dense):
    d, H = net["d_model"], net["num_heads"]
    nope, rope, vd = (net["qk_nope_head_dim"], net["qk_rope_head_dim"],
                      net["v_head_dim"])
    kv = net["kv_lora_rank"]
    shapes = [(f"{prefix}attn_norm.weight", (d,)),
              (f"{prefix}attn.q.weight", (H * (nope + rope), d)),
              (f"{prefix}attn.kv_a.weight", (kv + rope, d)),
              (f"{prefix}attn.kv_norm.weight", (kv,)),
              (f"{prefix}attn.kv_b.weight", (H * (nope + vd), kv)),
              (f"{prefix}attn.o.weight", (d, H * vd)),
              (f"{prefix}ffn_norm.weight", (d,))]
    if dense:
        w = net["dense_width"]
        return shapes + [(f"{prefix}mlp.gate.weight", (w, d)),
                         (f"{prefix}mlp.up.weight", (w, d)),
                         (f"{prefix}mlp.down.weight", (d, w))]
    f, held = net["expert_width"], net["experts_held"]
    shared = net["num_shared"] * f
    return shapes + [
        (f"{prefix}moe.router.weight", (net["num_experts"], d)),
        (f"{prefix}moe.w_gate", (held * f, d)),
        (f"{prefix}moe.w_up", (held * f, d)),
        (f"{prefix}moe.w_down", (held * d, f)),
        (f"{prefix}moe.shared.gate.weight", (shared, d)),
        (f"{prefix}moe.shared.up.weight", (shared, d)),
        (f"{prefix}moe.shared.down.weight", (d, shared))]


def param_shapes(net, frame_shape, num_actions):
    d = net["d_model"]
    frame = 1
    for n in frame_shape:
        frame *= n
    shapes = [("Dense_0.weight", (d, frame)), ("Dense_0.bias", (d,)),
              ("extras.weight", (d, 1 + num_actions)),
              ("extras.bias", (d,))]
    for i in range(net["num_layers"]):
        shapes += _layer_shapes(f"layer_{i}.", net, i < net["first_dense"])
    return shapes + [("norm.weight", (d,)),
                     ("head.policy.weight", (num_actions, d)),
                     ("head.policy.bias", (num_actions,)),
                     ("head.baseline.weight", (1, d)),
                     ("head.baseline.bias", (1,))]


def state_shapes(net, num_actions, batch_size):
    M = net["memory_len"]
    return [(M, batch_size, net["kv_lora_rank"]),
            (M, batch_size, net["qk_rope_head_dim"]),
            (M, batch_size)] * net["num_layers"]


def _ln(x: float) -> float:
    return float(torch.log(torch.tensor(x, dtype=torch.float64)))


def inv_freq(net):
    """YaRN's [rope / 2] inverse frequencies, f32."""
    dim, base = net["qk_rope_head_dim"], float(net["rope_theta"])
    y = net["rope_scaling"]
    pi = float(torch.pi)

    def correction(rotations):
        return (dim * _ln(y["original_max_position_embeddings"]
                          / (rotations * 2 * pi)) / (2 * _ln(base)))

    low = max(int(torch.tensor(correction(y["beta_fast"])).floor()), 0)
    high = min(int(torch.tensor(correction(y["beta_slow"])).ceil()),
               dim - 1)
    if low == high:
        high += 0.001
    extrapolate = 1.0 - torch.clamp(
        (torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low),
        0, 1)
    fast = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    slow = fast / y["factor"]
    return slow * (1 - extrapolate) + fast * extrapolate


def softmax_scale(net):
    """(nope + rope)^-0.5 times YaRN's logit factor squared."""
    y = net["rope_scaling"]
    m = 0.1 * y["mscale_all_dim"] * _ln(y["factor"]) + 1.0
    return (net["qk_nope_head_dim"] + net["qk_rope_head_dim"]) ** -0.5 * m * m


def _rms(x, w, eps):
    return w * (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps))


def _swiglu(x, gate, up, down):
    return (F.silu(x @ gate.t()) * (x @ up.t())) @ down.t()


def _rotate(x, positions, net):
    """x [..., S, (H,) rope] by angle positions[s] * inv_freq, pairs as
    complex numbers."""
    angle = torch.outer(positions.float(), inv_freq(net).to(x.device))
    turn = torch.polar(torch.ones_like(angle), angle)  # [S, rope / 2]
    if x.dim() == 4:
        turn = turn[:, None, None]
    else:
        turn = turn[:, None]
    z = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(z * turn).flatten(-2)


def _attention(p, prefix, h, c_cache, pe_cache, valid, done, net):
    """h [T, B, d]; cache [M, B, ...]; valid [M, B]; done [T, B] ->
    (out [T, B, d], c [T, B, kv], k_pe [T, B, rope])."""
    T, B, _ = h.shape
    M = c_cache.shape[0]
    H = net["num_heads"]
    nope, rope, vd = (net["qk_nope_head_dim"], net["qk_rope_head_dim"],
                      net["v_head_dim"])
    kv_rank = net["kv_lora_rank"]
    q = (h @ p[prefix + "attn.q.weight"].t()).view(T, B, H, nope + rope)
    kv = h @ p[prefix + "attn.kv_a.weight"].t()
    c = _rms(kv[..., :kv_rank], p[prefix + "attn.kv_norm.weight"],
             net["rms_eps"])
    k_pe = kv[..., kv_rank:]
    c_all = torch.cat([c_cache, c])  # [S, B, kv]
    pe_all = torch.cat([pe_cache, k_pe])  # [S, B, rope]
    S = M + T
    kv_full = (c_all @ p[prefix + "attn.kv_b.weight"].t()).view(
        S, B, H, nope + vd)
    k_nope, v = kv_full[..., :nope], kv_full[..., nope:]
    slots = torch.arange(S, device=h.device)
    k_rot = _rotate(pe_all, slots, net)  # [S, B, rope]
    k = torch.cat([k_nope, k_rot[:, :, None].expand(S, B, H, rope)], -1)
    q_rot = _rotate(q[..., nope:], slots[M:], net)
    q = torch.cat([q[..., :nope], q_rot], -1)
    scale = softmax_scale(net)
    kb = k.permute(1, 2, 0, 3).contiguous()  # [B, H, S, nope + rope]
    vb = v.permute(1, 2, 0, 3).contiguous()  # [B, H, S, v]
    dones = torch.cumsum(done.long(), 0)  # [T, B]: dones at steps 0..t
    outs = []
    for t in range(T):
        seen = torch.zeros(B, S, dtype=torch.bool, device=h.device)
        seen[:, t:M] = (valid[t:] != 0).t() & (dones[t] == 0)[:, None]
        lo = max(0, t - M)  # the band's oldest unroll step
        seen[:, M + lo:M + t + 1] = (dones[t][None] == dones[lo:t + 1]).t()
        scores = torch.matmul(q[t][:, :, None], kb.transpose(-1, -2))
        scores = scores[:, :, 0] * scale  # [B, H, S]
        scores = scores.masked_fill(~seen[:, None], float("-inf"))
        weights = torch.softmax(scores, -1)
        out_t = torch.matmul(weights[:, :, None], vb)[:, :, 0]
        outs.append(out_t.reshape(B, H * vd))
    out = torch.stack(outs) @ p[prefix + "attn.o.weight"].t()
    return out, c, k_pe


def _top_k(probs, k):
    """[N, k] picks, one at a time by argmax (the lower index on a tie)."""
    left = probs.detach().clone()
    picks = []
    for _ in range(k):
        i = torch.argmax(left, -1)
        picks.append(i)
        left.scatter_(1, i[:, None], float("-inf"))
    return torch.stack(picks, -1)


def _moe(p, prefix, h, net):
    """h [T, B, d] -> (out [T, B, d], the layer's balance loss)."""
    T, B, d = h.shape
    E, K = net["num_experts"], net["top_k"]
    x = h.reshape(T * B, d)
    probs = torch.softmax(x @ p[prefix + "moe.router.weight"].t(), -1)
    picks = _top_k(probs, K)
    gate = probs.gather(1, picks) * net["routed_scaling_factor"]
    out = _swiglu(x, p[prefix + "moe.shared.gate.weight"],
                  p[prefix + "moe.shared.up.weight"],
                  p[prefix + "moe.shared.down.weight"])
    held = net["experts_held"]
    w_gate = p[prefix + "moe.w_gate"].reshape(held, -1, d)
    w_up = p[prefix + "moe.w_up"].reshape(held, -1, d)
    w_down = p[prefix + "moe.w_down"].reshape(held, d, -1)
    for e in range(held):
        chosen = picks == e  # [N, K]
        rows = chosen.any(-1).nonzero().squeeze(-1)
        if rows.numel() == 0:
            continue
        g = (gate * chosen).sum(-1)[rows]
        y = _swiglu(x[rows], w_gate[e], w_up[e], w_down[e])
        out = out.index_add(0, rows, g[:, None] * y)
    # One sequence an actor: tokens t of column b.
    counts = torch.zeros(B, E, device=h.device)
    for k in range(K):
        counts += F.one_hot(picks[:, k].view(T, B), E).sum(0).float()
    f = counts * E / (K * T)
    mean_p = probs.view(T, B, E).mean(0)
    aux = net["aux_loss_alpha"] * (f * mean_p).sum(-1).mean()
    return out.view(T, B, d), aux


def _roll(cache, new, valid, done):
    """The last M of [cache; new], the validity as the docstring says."""
    M, T = cache.shape[0], new.shape[0]
    done = done.bool()
    old_ok = (valid != 0) & ~done.any(0)[None]
    new_ok = torch.stack([~done[j + 1:].any(0) for j in range(T)])
    return (torch.cat([cache, new])[-M:],
            torch.cat([old_ok, new_ok]).float()[-M:])


def forward_with_aux(params, batch, state, net, num_actions):
    """-> (policy logits [T, B, A], baseline [T, B], new state (as
    state_shapes), the summed balance loss)."""
    frame = batch["frame"]
    T, B = frame.shape[:2]
    p = params
    x = frame.reshape(T, B, -1).float() / 255.0
    x = x @ p["Dense_0.weight"].t() + p["Dense_0.bias"]
    reward = torch.clamp(batch["reward"].float(), -1, 1)[..., None]
    one_hot = F.one_hot(batch["last_action"].long(), num_actions).float()
    x = x + (torch.cat([reward, one_hot], -1) @ p["extras.weight"].t()
             + p["extras.bias"])
    done = batch["done"]
    eps = net["rms_eps"]
    new_state, aux = [], 0.0
    for i in range(net["num_layers"]):
        prefix = f"layer_{i}."
        c_cache, pe_cache, valid = state[3 * i:3 * i + 3]
        h = _rms(x, p[prefix + "attn_norm.weight"], eps)
        out, c, k_pe = _attention(p, prefix, h, c_cache.float(),
                                  pe_cache.float(), valid, done, net)
        x = x + out
        h = _rms(x, p[prefix + "ffn_norm.weight"], eps)
        if i < net["first_dense"]:
            x = x + _swiglu(h, p[prefix + "mlp.gate.weight"],
                            p[prefix + "mlp.up.weight"],
                            p[prefix + "mlp.down.weight"])
        else:
            y, layer_aux = _moe(p, prefix, h, net)
            x = x + y
            aux = aux + layer_aux
        c_new, valid_new = _roll(c_cache.float(), c, valid, done)
        pe_new, _ = _roll(pe_cache.float(), k_pe, valid, done)
        new_state += [c_new, pe_new, valid_new]
    x = _rms(x, p["norm.weight"], eps)
    logits = x @ p["head.policy.weight"].t() + p["head.policy.bias"]
    baseline = (x @ p["head.baseline.weight"].t()
                + p["head.baseline.bias"])[..., 0]
    return logits, baseline, tuple(new_state), aux


class _WithAux(torch.autograd.Function):
    """The logits, unchanged; the backward hands `aux` a gradient of one,
    as a term of the objective."""

    @staticmethod
    def forward(ctx, logits, aux):
        return logits.view_as(logits)

    @staticmethod
    def backward(ctx, grad):
        return grad, torch.ones((), device=grad.device)


def forward(params, batch, state, net, num_actions):
    """-> (policy logits [T, B, A], baseline [T, B]); the balance loss's
    gradient rides the logits (_WithAux)."""
    logits, baseline, _, aux = forward_with_aux(params, batch, state, net,
                                                num_actions)
    if torch.is_tensor(aux) and aux.requires_grad:
        logits = _WithAux.apply(logits, aux)
    return logits, baseline


def forward_flops(net, frame_shape, num_actions):
    """FLOPs of one frame's forward at the least work a layer needs (2 a
    multiply-add; norms, RoPE, softmax and routing's sort not counted):
    the frame Dense and extras; MLA in the absorbed form (q and the kv_a
    projection, q_nope W_UK, the scores over the band's M + 1 keys at
    kv_lora + rope, the values at kv_lora, W_UV and W_o); the dense
    SwiGLU; the router, top_k picks of the held share (experts_held /
    num_experts) of SwiGLUs of expert_width and the shared SwiGLU; the
    heads. The count does not depend on T."""
    d, H = net["d_model"], net["num_heads"]
    nope, rope, vd = (net["qk_nope_head_dim"], net["qk_rope_head_dim"],
                      net["v_head_dim"])
    kv, keys = net["kv_lora_rank"], net["memory_len"] + 1
    frame = 1
    for n in frame_shape:
        frame *= n
    total = 2 * d * (frame + 1 + num_actions)
    mla = 2 * (d * H * (nope + rope) + d * (kv + rope) + H * nope * kv
               + H * keys * (kv + rope) + H * keys * kv + H * kv * vd
               + H * vd * d)
    share = net["top_k"] * net["experts_held"] / net["num_experts"]
    moe = 2 * (d * net["num_experts"]
               + share * 3 * d * net["expert_width"]
               + 3 * d * net["num_shared"] * net["expert_width"])
    for i in range(net["num_layers"]):
        total += mla + (2 * 3 * d * net["dense_width"]
                        if i < net["first_dense"] else moe)
    return int(total + 2 * d * (num_actions + 1))
