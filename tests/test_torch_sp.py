"""The port's sequence-parallel attention ops (torchbeast_tpu_torch/ops/
attention.py) against the JAX package's (torchbeast_tpu/ops/attention.py)
on the CPU: the reference's shard_maps over P of its 8 forced CPU devices
(tests/conftest.py), the port's schedules over P CPU "devices" of one
process, the same numpy inputs from a seed.

- Each op at P = 2 and 4: forward at rtol 1e-5, atol 1e-6 in f32; the
  gradients of a fixed cotangent (torch autograd against jax.grad) at
  rtol 1e-4. The reference runs jitted: its eager shard_maps took
  minutes a zigzag call here.
- The transformer's dispatch: a sequence-parallel TransformerNet against
  the reference's with its `seq` mesh, forward and gradients, and the
  acting step at T=1 falling back to the dense path bitwise.
- The reference's ValueErrors on shapes, text for text.

The reference's results are computed once per case (a module cache).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from torchbeast_tpu.ops import attention as jax_attn
from torchbeast_tpu_torch.models import transformer as port_transformer
from torchbeast_tpu_torch.ops import attention as port_attn

B, T, H, D, M = 2, 16, 4, 8, 4
RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
_CACHE = {}


def _jax_mesh(P):
    return JaxMesh(np.asarray(jax.devices()[:P]), ("seq",))


def _devices(P):
    return [torch.device("cpu")] * P


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = {name: rng.standard_normal((B, T, H, D)).astype(np.float32)
         for name in ("q", "k", "v", "ct")}
    x["cache_k"] = rng.standard_normal((B, M, H, D)).astype(np.float32)
    x["cache_v"] = rng.standard_normal((B, M, H, D)).astype(np.float32)
    x["rel_bias"] = rng.standard_normal((H, M + 1)).astype(np.float32)
    done = np.zeros((T, B), bool)
    done[5, 0] = done[11, 1] = True
    seg = np.cumsum(done.astype(np.int32), axis=0).T  # [B, T]
    valid = np.ones((B, M), np.float32)
    valid[1, :2] = 0
    no_done = np.cumsum(done.astype(np.int32), axis=0).T == 0
    q_time = np.arange(T)
    key_time = np.concatenate([np.arange(M) - M, np.arange(T)])
    offsets = q_time[:, None] - key_time[None, :]
    band = (offsets >= 0) & (offsets <= M)
    cache_mask = (band[None, :, :M] & (valid[:, None, :] != 0)
                  & no_done[:, :, None])
    same = seg[:, :, None] == seg[:, None, :]
    x["seg"] = seg.astype(np.int32)
    x["cache_mask"] = cache_mask
    x["mask"] = np.concatenate([cache_mask, band[None, :, M:] & same], -1)
    x["offsets"] = np.clip(offsets, 0, M)
    return x


X = _inputs()
DIFF = ("q", "k", "v")
DIFF_T = ("q", "k", "v", "cache_k", "cache_v", "rel_bias")


def _jax_call(op, P, schedule):
    mesh = _jax_mesh(P)
    if op == "ring":
        return (lambda q, k, v, seg: jax_attn.ring_attention(
            q, k, v, mesh, "seq", segment_ids=seg, schedule=schedule)), DIFF
    if op == "ulysses":
        return (lambda q, k, v, seg: jax_attn.ulysses_attention(
            q, k, v, mesh, "seq", segment_ids=seg)), DIFF
    if op == "ring_transformer":
        return (lambda q, k, v, c_k, c_v, rb, cm, seg:
                jax_attn.ring_transformer_attention(
                    q, k, v, c_k, c_v, cm, rb, M, seg, mesh, "seq",
                    schedule=schedule)), DIFF_T
    return (lambda q, k, v, c_k, c_v, rb, mask, off:
            jax_attn.ulysses_transformer_attention(
                q, k, v, c_k, c_v, mask, off, rb, mesh, "seq")), DIFF_T


def _port_call(op, P, schedule):
    devs = _devices(P)
    if op == "ring":
        return lambda q, k, v, seg: port_attn.ring_attention(
            q, k, v, devs, segment_ids=seg, schedule=schedule)
    if op == "ulysses":
        return lambda q, k, v, seg: port_attn.ulysses_attention(
            q, k, v, devs, segment_ids=seg)
    if op == "ring_transformer":
        return (lambda q, k, v, c_k, c_v, rb, cm, seg:
                port_attn.ring_transformer_attention(
                    q, k, v, c_k, c_v, cm, rb, M, seg, devs,
                    schedule=schedule))
    return (lambda q, k, v, c_k, c_v, rb, mask, off:
            port_attn.ulysses_transformer_attention(
                q, k, v, c_k, c_v, mask, off, rb, devs))


def _args(op, diff):
    rest = {"ring": ("seg",), "ulysses": ("seg",),
            "ring_transformer": ("cache_mask", "seg"),
            "ulysses_transformer": ("mask", "offsets")}[op]
    return list(diff), list(rest)


def _reference(op, P, schedule):
    """(out, {name: grad}) of the reference's op, computed once."""
    key = (op, P, schedule)
    if key not in _CACHE:
        fn, diff = _jax_call(op, P, schedule)
        names, rest = _args(op, diff)
        fixed = [jnp.asarray(X[n]) for n in rest]

        def loss(*xs):
            out = fn(*xs, *fixed)
            return (out * X["ct"]).sum(), out

        xs = [jnp.asarray(X[n]) for n in names]
        value_and_grad = jax.jit(jax.value_and_grad(
            loss, argnums=tuple(range(len(xs))), has_aux=True))
        (_, out), grads = value_and_grad(*xs)
        _CACHE[key] = (np.asarray(out),
                       {n: np.asarray(g) for n, g in zip(names, grads)})
    return _CACHE[key]


CASES = [
    ("ring", 2, "contiguous"), ("ring", 4, "contiguous"),
    ("ring", 2, "zigzag"), ("ring", 4, "zigzag"),
    ("ulysses", 2, None), ("ulysses", 4, None),
    ("ring_transformer", 2, "contiguous"),
    ("ring_transformer", 4, "contiguous"),
    ("ring_transformer", 2, "zigzag"), ("ring_transformer", 4, "zigzag"),
    ("ulysses_transformer", 2, None), ("ulysses_transformer", 4, None),
]


@pytest.mark.parametrize("op,P,schedule", CASES)
def test_op_matches_the_reference(op, P, schedule):
    ref_out, ref_grads = _reference(op, P, schedule)
    _, diff = _jax_call(op, P, schedule)
    names, rest = _args(op, diff)
    xs = [torch.tensor(X[n], requires_grad=True) for n in names]
    fixed = [torch.as_tensor(X[n]) for n in rest]
    out = _port_call(op, P, schedule)(*xs, *fixed)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=RTOL,
                               atol=ATOL)
    (out * torch.as_tensor(X["ct"])).sum().backward()
    for n, x in zip(names, xs):
        np.testing.assert_allclose(x.grad.numpy(), ref_grads[n],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=n)


def test_causal_attention_matches_the_reference():
    seg = X["seg"]
    ours = port_attn.causal_attention(
        *(torch.as_tensor(X[n]) for n in DIFF), torch.as_tensor(seg))
    theirs = jax_attn.causal_attention(
        *(jnp.asarray(X[n]) for n in DIFF), jnp.asarray(seg))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL,
                               atol=ATOL)


def test_ring_matches_the_dense_path_without_segments():
    q, k, v = (torch.as_tensor(X[n]) for n in DIFF)
    dense = port_attn.causal_attention(q, k, v)
    for schedule in ("contiguous", "zigzag"):
        ring = port_attn.ring_attention(q, k, v, _devices(4),
                                        schedule=schedule)
        np.testing.assert_allclose(ring.numpy(), dense.numpy(), rtol=RTOL,
                                   atol=ATOL)
    ulysses = port_attn.ulysses_attention(q, k, v, _devices(4))
    np.testing.assert_allclose(ulysses.numpy(), dense.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_zigzag_permutation_is_the_references():
    for t, p in ((16, 2), (16, 4), (80, 4)):
        np.testing.assert_array_equal(
            port_attn.zigzag_permutation(t, p),
            jax_attn.zigzag_permutation(t, p))
        x = torch.arange(t)[None]
        blocks = port_attn._zigzag_blocks(x, _devices(p))
        np.testing.assert_array_equal(
            torch.cat(blocks, dim=1)[0].numpy(),
            jax_attn.zigzag_permutation(t, p))
        assert torch.equal(port_attn._unzigzag(blocks, x.device), x)


def _errors(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("case", [
    "zigzag_T", "zigzag_transformer_T", "ulysses_T", "ulysses_H",
    "ulysses_transformer_H", "unknown_schedule"])
def test_shape_refusals_match_the_reference(case):
    """The reference's ValueErrors (ops/attention.py :336, :490,
    :644-651, :709 and the unknown schedule), raised by the port with
    the same text."""
    rng = np.random.default_rng(1)
    t, h = (10, 4) if case.endswith("_T") else (16, 6)
    a = rng.standard_normal((B, t, h, D)).astype(np.float32)
    c = rng.standard_normal((B, M, h, D)).astype(np.float32)
    rb = np.zeros((h, M + 1), np.float32)
    seg = np.zeros((B, t), np.int32)
    cm = np.ones((B, t, M), bool)
    mask = np.ones((B, t, M + t), bool)
    off = np.zeros((t, M + t), np.int32)
    P = 4
    mesh = _jax_mesh(P)
    devs = _devices(P)
    j, p = jnp.asarray, torch.as_tensor
    calls = {
        "zigzag_T": (
            lambda: jax_attn.ring_attention(j(a), j(a), j(a), mesh, "seq",
                                            schedule="zigzag"),
            lambda: port_attn.ring_attention(p(a), p(a), p(a), devs,
                                             schedule="zigzag")),
        "zigzag_transformer_T": (
            lambda: jax_attn.ring_transformer_attention(
                j(a), j(a), j(a), j(c), j(c), j(cm), j(rb), M, j(seg), mesh,
                "seq", schedule="zigzag"),
            lambda: port_attn.ring_transformer_attention(
                p(a), p(a), p(a), p(c), p(c), p(cm), p(rb), M, p(seg), devs,
                schedule="zigzag")),
        "ulysses_T": (
            lambda: jax_attn.ulysses_attention(j(a), j(a), j(a), mesh),
            lambda: port_attn.ulysses_attention(p(a), p(a), p(a), devs)),
        "ulysses_H": (
            lambda: jax_attn.ulysses_attention(j(a), j(a), j(a), mesh),
            lambda: port_attn.ulysses_attention(p(a), p(a), p(a), devs)),
        "ulysses_transformer_H": (
            lambda: jax_attn.ulysses_transformer_attention(
                j(a), j(a), j(a), j(c), j(c), j(mask), j(off), j(rb), mesh),
            lambda: port_attn.ulysses_transformer_attention(
                p(a), p(a), p(a), p(c), p(c), p(mask), p(off), p(rb),
                devs)),
        "unknown_schedule": (
            lambda: jax_attn.ring_attention(j(a), j(a), j(a), mesh, "seq",
                                            schedule="spiral"),
            lambda: port_attn.ring_attention(p(a), p(a), p(a), devs,
                                             schedule="spiral")),
    }
    theirs, ours = calls[case]
    assert _errors(ours) == _errors(theirs)


# ------------------------------------------------------------- the model

A = 5
FRAME = (6, 6, 2)
MODEL_KW = dict(num_layers=2, d_model=32, num_heads=4, memory_len=M)


def _model_inputs(t, seed=3):
    rng = np.random.default_rng(seed)
    done = rng.random((t, B)) < 0.15
    return {
        "frame": rng.integers(0, 255, (t, B) + FRAME, dtype=np.uint8),
        "reward": rng.standard_normal((t, B)).astype(np.float32),
        "done": done,
        "last_action": rng.integers(0, A, (t, B)).astype(np.int32),
    }


def _state(rng):
    hd = MODEL_KW["d_model"] // MODEL_KW["num_heads"]
    return tuple(
        (rng.standard_normal((M, B, MODEL_KW["num_heads"], hd)).astype(
            np.float32),
         rng.standard_normal((M, B, MODEL_KW["num_heads"], hd)).astype(
            np.float32),
         (rng.random((M, B)) < 0.7).astype(np.float32))
        for _ in range(MODEL_KW["num_layers"]))


def _models(P, strategy, schedule):
    from torchbeast_tpu.models.transformer import TransformerNet as JaxNet
    from torchbeast_tpu_torch import weights

    jax_model = JaxNet(num_actions=A, mesh=_jax_mesh(P), seq_axis="seq",
                       ring_schedule=schedule, sp_strategy=strategy,
                       **MODEL_KW)
    port = port_transformer.TransformerNet(
        A, frame_shape=FRAME, **MODEL_KW)
    port_transformer.set_seq_devices(port, _devices(P), schedule, strategy)
    rng = np.random.default_rng(7)
    inputs = _model_inputs(T)
    state = _state(rng)
    params = jax_model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v) for k, v in inputs.items()},
        tuple(tuple(jnp.asarray(a) for a in s) for s in state))
    weights.load_jax_params(port, params)
    return jax_model, port, params, inputs, state


@pytest.mark.parametrize("strategy,schedule", [
    ("ring", "contiguous"), ("ulysses", "contiguous")])
def test_sequence_parallel_model_matches_the_reference(strategy, schedule):
    """TransformerNet with 2 seq devices against the reference's on its
    `seq` mesh: the baseline and the next state at rtol 1e-5, the
    gradient of the baseline's sum at rtol 1e-4."""
    from torchbeast_tpu_torch import weights

    P = 2
    jax_model, port, params, inputs, state = _models(P, strategy, schedule)

    def jax_baseline(p):
        out, new = jax_model.apply(
            p, {k: jnp.asarray(v) for k, v in inputs.items()},
            tuple(tuple(jnp.asarray(a) for a in s) for s in state),
            sample_action=False)
        return out.baseline.sum(), (out, new)

    value_and_grad = jax.jit(jax.value_and_grad(jax_baseline, has_aux=True))
    (_, (j_out, j_state)), j_grads = value_and_grad(params)
    t_inputs = {k: torch.as_tensor(v) for k, v in inputs.items()}
    t_state = tuple(tuple(torch.as_tensor(a) for a in s) for s in state)
    assert port.block_0._sequence_parallel(T, 4) == strategy
    out, new = port(t_inputs, t_state, sample_action=False)
    np.testing.assert_allclose(out.baseline.detach().numpy(),
                               np.asarray(j_out.baseline), rtol=RTOL,
                               atol=ATOL)
    for ours, theirs in zip(new, j_state):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=RTOL, atol=ATOL)
    out.baseline.sum().backward()
    # The policy head takes no gradient from the baseline: zeros, as
    # jax.grad gives them.
    port_grads = weights.param_list_to_jax(
        port, [torch.zeros_like(p) if p.grad is None else p.grad
               for p in port.parameters()])
    flat_ours = dict(jax.tree_util.tree_flatten_with_path(port_grads)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(j_grads)[0]:
        np.testing.assert_allclose(flat_ours[path], np.asarray(g),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=str(path))


def test_acting_step_falls_back_to_dense():
    """At T=1 no schedule divides: the sequence-parallel model runs the
    dense path, bitwise the one-device model's."""
    port = port_transformer.TransformerNet(A, frame_shape=FRAME, **MODEL_KW)
    rng = np.random.default_rng(2)
    inputs = {k: torch.as_tensor(v) for k, v in _model_inputs(1).items()}
    state = tuple(tuple(torch.as_tensor(a) for a in s) for s in _state(rng))
    dense, dense_state = port(inputs, state, sample_action=False)
    for strategy, schedule in (("ring", "contiguous"), ("ring", "zigzag"),
                               ("ulysses", "contiguous")):
        port_transformer.set_seq_devices(port, _devices(2), schedule,
                                         strategy)
        assert port.block_0._sequence_parallel(1, 4) is None
        out, new = port(inputs, state, sample_action=False)
        assert torch.equal(out.baseline, dense.baseline)
        assert torch.equal(out.policy_logits, dense.policy_logits)
        for a, b in zip(new, dense_state):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    port_transformer.set_seq_devices(port, None)
