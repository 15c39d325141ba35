"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test needs a CUDA device and skips without one.

This module imports torch, numpy and the port only (no jax), so it also
runs on the GPU machine, where the JAX package is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
(tests/conftest.py configures jax, hence --noconftest there).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torchbeast_tpu_torch import ops
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.ops import attention, opt, pool, vtrace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The first CUDA device; skips the test where there is none. Defined
    here rather than imported from tests/, whose package name another
    installed package may shadow on the GPU machine."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("T,B", [(80, 32), (4000, 128)])
def test_vtrace_kernel_matches_plain_version(cuda, T, B):
    rng = np.random.default_rng(T)
    xs = [torch.from_numpy(rng.standard_normal((T, B)).astype(np.float32))
          for _ in range(6)]
    xs.append(torch.from_numpy(rng.standard_normal(B).astype(np.float32)))
    xs = [x.to(cuda) for x in xs]
    before = vtrace.vtrace_targets.launches
    got = vtrace.vtrace_targets(*xs)
    assert vtrace.vtrace_targets.launches == before + 1
    want = vtrace.vtrace_targets_plain(*xs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
def test_pool_kernel_matches_plain_version(cuda, ties):
    gen = torch.Generator(device=cuda).manual_seed(0)
    shape = (64, 84, 84, 16)
    if ties:
        x = torch.randint(0, 4, shape, generator=gen, device=cuda).float()
    else:
        x = torch.randn(shape, generator=gen, device=cuda)
    x = x.permute(0, 3, 1, 2)  # channels_last [N, C, H, W]
    y = F.max_pool2d(x, 3, 2, 1).contiguous(memory_format=torch.channels_last)
    g = torch.randn(y.shape, generator=gen, device=cuda).contiguous(
        memory_format=torch.channels_last)
    before = pool.pool_bwd.launches
    got = pool.pool_bwd(x, y, g)
    assert pool.pool_bwd.launches == before + 1
    torch.testing.assert_close(got, pool.pool_bwd_plain(x, y, g),
                               rtol=0, atol=0)


def _pool_inputs(cuda, shape, ties, seed=0):
    """x [N, C, H, W] in channels_last memory (values on a coarse grid with
    ties), its pooled y and a random g, both channels_last."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if ties:
        x = torch.randint(0, 4, shape, generator=gen, device=cuda).float()
    else:
        x = torch.randn(shape, generator=gen, device=cuda)
    x = x.permute(0, 3, 1, 2)
    y = F.max_pool2d(x, 3, 2, 1).contiguous(memory_format=torch.channels_last)
    g = torch.randn(y.shape, generator=gen, device=cuda).contiguous(
        memory_format=torch.channels_last)
    return x, y, g


def _run_pool(x, y, g):
    """(gx, whether the 16-byte path ran); checks the launch counts."""
    before = (pool.pool_bwd.launches, pool.pool_bwd.vector_launches)
    gx = pool.pool_bwd(x, y, g)
    after = (pool.pool_bwd.launches, pool.pool_bwd.vector_launches)
    assert after[0] == before[0] + 1
    return gx, after[1] == before[1] + 1


@pytest.mark.parametrize("shape", [(6, 84, 84, 16), (6, 42, 42, 32),
                                   (6, 21, 21, 32)])
def test_pool_kernel_matches_plain_version_on_trunk_stages(cuda, shape):
    """The deep trunk's three pool inputs (N, H, W, C) at a small N, with
    ties planted: the 16-byte path, exact."""
    x, y, g = _pool_inputs(cuda, shape, ties=True)
    got, vectorized = _run_pool(x, y, g)
    assert vectorized
    torch.testing.assert_close(got, pool.pool_bwd_plain(x, y, g),
                               rtol=0, atol=0)


def _at_offset(t, offset):
    """A copy of channels_last t that starts `offset` floats into its
    storage."""
    N, C, H, W = t.shape
    buf = torch.empty(offset + t.numel(), device=t.device)
    out = buf[offset:].view(N, H, W, C).permute(0, 3, 1, 2)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case", ["odd_hw_c3", "offset_c16", "nchw_c16"])
def test_pool_kernel_scalar_path_matches_plain_version(cuda, case):
    """Inputs the 16-byte path does not take: odd H and W with C=3, a C=16
    input one float into its storage (not 16-byte aligned), and NCHW
    strides; all with ties, exact."""
    if case == "odd_hw_c3":
        x, y, g = _pool_inputs(cuda, (5, 21, 19, 3), ties=True)
    else:
        x, y, g = _pool_inputs(cuda, (5, 42, 41, 16), ties=True)
        if case == "offset_c16":
            x, y, g = (_at_offset(t, 1) for t in (x, y, g))
        else:
            x, y, g = (t.contiguous() for t in (x, y, g))
    got, vectorized = _run_pool(x, y, g)
    assert not vectorized
    torch.testing.assert_close(got, pool.pool_bwd_plain(x, y, g),
                               rtol=0, atol=0)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 40.0), (1e-3, 40.0),
                                            (1.0, None)])
def test_rmsprop_tail_kernel_matches_plain_version(cuda, scale, max_norm):
    torch.manual_seed(0)
    params0 = [p.detach() for p in
               create_model("deep", 6, use_lstm=True).to(cuda).parameters()]
    gen = torch.Generator(device=cuda).manual_seed(1)
    grads = [[scale * torch.randn(p.shape, generator=gen, device=cuda)
              .contiguous(memory_format=(torch.channels_last if p.dim() == 4
                                         else torch.contiguous_format))
              for p in params0] for _ in range(3)]
    runs = []
    for plain in (False, True):
        p = [t.clone() for t in params0]
        nu = [torch.zeros_like(t) for t in p]
        sumsqs = []
        for step, gs in enumerate(grads):
            kw = dict(lr=4.8e-4 * (1 - step / 10), alpha=0.99, eps=0.01,
                      max_norm=max_norm)
            if plain:
                with ops.plain_on_device():
                    sumsqs.append(opt.rmsprop_tail(p, gs, nu, None, **kw))
            else:
                before = opt.rmsprop_tail.launches
                sumsqs.append(opt.rmsprop_tail(p, gs, nu, None, **kw))
                assert opt.rmsprop_tail.launches == before + 1
        runs.append(sumsqs + p + nu)
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_rmsprop_tail_kernel_matches_plain_version_on_transformer_tree(cuda):
    """The transformer's 4,012,047 parameters, momentum 0.9, clip active,
    three steps; some leaves' lengths are not a multiple of 4 (the policy
    bias has 6), so their ends take the scalar path."""
    torch.manual_seed(0)
    params0 = [p.detach() for p in create_model(
        "transformer", 6, attention_impl="pallas").to(cuda).parameters()]
    assert sum(p.numel() for p in params0) == 4_012_047
    assert any(p.numel() % 4 for p in params0)
    gen = torch.Generator(device=cuda).manual_seed(2)
    grads = [[torch.randn(p.shape, generator=gen, device=cuda)
              for p in params0] for _ in range(3)]
    runs = []
    for plain in (False, True):
        p = [t.clone() for t in params0]
        nu = [torch.zeros_like(t) for t in p]
        mom = [torch.zeros_like(t) for t in p]
        sumsqs = []
        for gs in grads:
            kw = dict(lr=4.8e-4, alpha=0.99, eps=0.01, momentum=0.9,
                      max_norm=40.0)
            if plain:
                with ops.plain_on_device():
                    sumsqs.append(opt.rmsprop_tail(p, gs, nu, mom, **kw))
            else:
                before = opt.rmsprop_tail.launches
                sumsqs.append(opt.rmsprop_tail(p, gs, nu, mom, **kw))
                assert opt.rmsprop_tail.launches == before + 1
        runs.append(sumsqs + p + nu + mom)
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def attention_inputs(B, T, H, D, M, seed, device):
    """Random attention inputs with planted dones (segments and the
    no-done gate matter) and a partly valid cache, made with numpy."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device)
    done = rng.random((T, B)) < 0.05
    done[min(3, T - 1), 0] = True
    seg = np.ascontiguousarray(np.cumsum(done, 0).T, dtype=np.int32)
    return (
        f32(B, T, H, D), f32(B, M + T, H, D), f32(B, M + T, H, D),
        torch.from_numpy(seg).to(device),
        torch.from_numpy((rng.random((B, M)) < 0.7).astype(np.float32)).to(
            device),
        torch.from_numpy(seg == 0).to(device),
        0.1 * f32(H, M + 1),
    )


@pytest.mark.parametrize("T", [81, 1])
def test_attention_kernels_match_plain_version(cuda, T):
    """The learner shape (T=81) and the acting shape (T=1), at the full
    model's B=32, H=4, D=32, M=64; TF32 off for the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    M = 64
    q, k, v, seg, valid, nodone, bias = attention_inputs(32, T, 4, 32, M,
                                                         T, cuda)
    grad = torch.randn(q.shape, generator=torch.Generator(
        device=cuda).manual_seed(T), device=cuda)
    leaves = [t.requires_grad_() for t in (q, k, v, bias)]
    runs = []
    for plain in (False, True):
        before = (attention.transformer_attention.launches,
                  attention.transformer_attention_bwd.launches)
        if plain:
            with ops.plain_on_device():
                out = attention.transformer_attention(M, q, k, v, seg, valid,
                                                      nodone, bias)
        else:
            out = attention.transformer_attention(M, q, k, v, seg, valid,
                                                  nodone, bias)
        grads = torch.autograd.grad(out, leaves, grad)
        after = (attention.transformer_attention.launches,
                 attention.transformer_attention_bwd.launches)
        assert after == (before if plain else (before[0] + 1, before[1] + 1))
        runs.append((out.detach(), grads))
    (out_k, g_k), (out_p, g_p) = runs
    torch.testing.assert_close(out_k, out_p, rtol=1e-5, atol=1e-6)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T,M,D", [
    (1, 64, 32), (2, 64, 32), (9, 64, 32), (81, 64, 32),  # the model's M
    (81, 0, 32), (1, 0, 32),  # no cache
    (9, 64, 20),  # D % 4 != 0: the scalar copy path
    (81, 130, 64), (1, 130, 64),  # bands over one chunk, 4 key splits
])
def test_attention_forward_matches_plain_version(cuda, T, M, D):
    """The forward kernel's out and log-sum-exp against the plain version
    across both launch geometries (acting T <= 4, learner above), TF32
    off for the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    xs = attention_inputs(8, T, 4, D, M, T + M, cuda)
    before = attention.transformer_attention.launches
    out, lse = attention._launch_forward(M, *xs)
    assert attention.transformer_attention.launches == before + 1
    want = attention.transformer_attention_plain(M, *xs)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    # lse from the plain scores: [B, H, T] log-sum-exp over visible keys.
    q, k, v, seg, valid, nodone, bias = xs
    _, offsets = attention.band_relative_offsets(T, M, device=cuda)
    mask = attention.attention_mask(M, seg, valid, nodone)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    scores = torch.where(mask[:, None], scores + bias[:, offsets][None],
                         -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1),
                               rtol=1e-5, atol=1e-5)


def _backward_leaves(T, M, D, B=8):
    """Attention inputs as leaves that take gradients, and a cotangent."""
    xs = attention_inputs(B, T, 4, D, M, T + M + D, torch.device("cuda", 0))
    g = torch.from_numpy(np.random.default_rng(T).standard_normal(
        xs[0].shape).astype(np.float32)).cuda()
    return xs, g


@pytest.mark.parametrize("T,M,D", [
    (1, 64, 32), (2, 64, 32), (9, 64, 32), (81, 64, 32),  # the model's M
    (81, 0, 32), (1, 0, 32),  # no cache
    (9, 64, 20),  # D % 4 != 0: the scalar copy path
    (81, 130, 64), (1, 130, 64),  # bands over one chunk of keys
    (300, 64, 64),  # rows over one tile: dK and dV gathered across tiles
])
def test_attention_backward_matches_plain_version(cuda, T, M, D):
    """The backward kernel (one launch) against autograd through the plain
    version, on the forward test's shapes and one beyond a block's rows;
    TF32 off for the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    xs, g = _backward_leaves(T, M, D)
    q, k, v, seg, valid, nodone, bias = xs
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = attention.transformer_attention_plain(
        M, leaves[0], leaves[1], leaves[2], seg, valid, nodone, leaves[3])
    want = torch.autograd.grad(out, leaves, g)
    out, lse = attention._launch_forward(M, *xs)
    before = attention.transformer_attention_bwd.launches
    got = attention.transformer_attention_bwd(M, *xs, out, lse, g)
    assert attention.transformer_attention_bwd.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T,M,D", [(81, 64, 32), (300, 64, 64)])
def test_attention_backward_is_deterministic(cuda, T, M, D):
    """Two backward calls on the same inputs agree bit for bit (no atomic
    decides an order of summation)."""
    xs, g = _backward_leaves(T, M, D, B=32)
    out, lse = attention._launch_forward(M, *xs)
    first = attention.transformer_attention_bwd(M, *xs, out, lse, g)
    second = attention.transformer_attention_bwd(M, *xs, out, lse, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
