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


def _vtrace_inputs(cuda, shape, offset=0):
    """The seven inputs at [T, ...] `shape`, each starting `offset` floats
    into its own storage (1: not 16-byte aligned)."""
    rng = np.random.default_rng(shape[0] * 1000 + int(np.prod(shape[1:])))
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(6)]
    arrays.append(rng.standard_normal(shape[1:]).astype(np.float32))
    xs = []
    for a in arrays:
        buf = torch.empty(offset + a.size, device=cuda)
        xs.append(buf[offset:].view(a.shape))
        xs[-1].copy_(torch.from_numpy(a))
    return xs


# The main path's shape, a long unroll, ragged T (1, 81) against ragged B
# (7, 33: the 4-byte copies; 100: a partial last block of columns), and
# trailing dims flattened into B.
@pytest.mark.parametrize("shape", [
    (80, 32), (4000, 128), (1, 7), (1, 33), (1, 100), (81, 7), (81, 33),
    (81, 100), (81, 32, 3)])
def test_vtrace_kernel_matches_plain_version(cuda, shape):
    xs = _vtrace_inputs(cuda, shape)
    before = vtrace.vtrace_targets.launches
    got = vtrace.vtrace_targets(*xs)
    assert vtrace.vtrace_targets.launches == before + 1
    want = vtrace.vtrace_targets_plain(*xs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_vtrace_kernel_takes_unaligned_inputs(cuda):
    xs = _vtrace_inputs(cuda, (80, 32), offset=1)
    got = vtrace.vtrace_targets(*xs)
    want = vtrace.vtrace_targets_plain(*xs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
    """A copy of channels_last t that starts `offset` elements into its
    storage."""
    N, C, H, W = t.shape
    buf = torch.empty(offset + t.numel(), device=t.device, dtype=t.dtype)
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


# ------------------------------------------------------------------ bf16
#
# The bf16 variants (--precision bf16_compute / bf16_train) against their
# plain versions in bf16 on the card. One bf16 ulp is 2**-7 of a value's
# binade at most, so "within 1 ulp" is rtol BF16_ULP.

BF16_ULP = 2.0 ** -7


def _bf16_ulps(a, b):
    """max |a - b| in units of b's bf16 ulp (2**(exponent - 7))."""
    a, b = a.double(), b.double()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return float(((a - b).abs() / ulp).max())


@pytest.mark.parametrize("shape,ties", [
    ((6, 84, 84, 16), True), ((6, 42, 42, 32), True), ((6, 21, 21, 32), True),
    ((64, 84, 84, 16), False)])
def test_pool_bf16_kernel_matches_plain_version(cuda, shape, ties):
    """The trunk stages in bf16: the 16-byte path (8 channels a thread),
    every sum rounded to bf16 in the plain version's order, exact."""
    x, y, g = (t.to(torch.bfloat16) for t in _pool_inputs(cuda, shape, ties))
    y = F.max_pool2d(x, 3, 2, 1).contiguous(memory_format=torch.channels_last)
    before = pool.pool_bwd.bf16_launches
    got, vectorized = _run_pool(x, y, g)
    assert vectorized and pool.pool_bwd.bf16_launches == before + 1
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, pool.pool_bwd_plain(x, y, g),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["odd_hw_c3", "offset_c16", "c12"])
def test_pool_bf16_kernel_scalar_path_matches_plain_version(cuda, case):
    """bf16 inputs the 16-byte path does not take: C=3 with odd H and W,
    an input one element into its storage, and C=12 (not a multiple of
    8); all with ties, exact."""
    shape = {"odd_hw_c3": (5, 21, 19, 3), "offset_c16": (5, 42, 41, 16),
             "c12": (5, 21, 21, 12)}[case]
    x, y, g = (t.to(torch.bfloat16)
               for t in _pool_inputs(cuda, shape, ties=True))
    y = F.max_pool2d(x, 3, 2, 1).contiguous(memory_format=torch.channels_last)
    if case == "offset_c16":
        x, y, g = (_at_offset(t, 1) for t in (x, y, g))
    got, vectorized = _run_pool(x, y, g)
    assert not vectorized
    torch.testing.assert_close(got, pool.pool_bwd_plain(x, y, g),
                               rtol=0, atol=0)


@pytest.mark.parametrize("tree,momentum,scale", [
    ("deep", 0.0, 1.0), ("deep", 0.0, 1e-3), ("transformer", 0.9, 1.0)])
def test_rmsprop_tail_bf16_kernel_matches_plain_version(cuda, tree, momentum,
                                                        scale):
    """bf16_train: bf16 params and grads, bf16 nu, f32 master and mom;
    three steps. The norm within rtol 1e-6; the master within rtol 1e-6,
    atol 4e-6, and nu and the params within 1 bf16 ulp or atol 4e-6 (a
    one-ulp difference of bf16 nu, where two f32 values straddle a
    rounding boundary, moves the next update by up to 2**-8 of itself);
    mom within one bf16 ulp of its largest entry; the kernel's params are
    bf16(master) bit for bit."""
    torch.manual_seed(0)
    model = (create_model("deep", 6, use_lstm=True) if tree == "deep"
             else create_model("transformer", 6, attention_impl="pallas"))
    params0 = [p.detach().to(cuda, torch.bfloat16) for p in
               model.to(memory_format=torch.channels_last).parameters()]
    gen = torch.Generator(device=cuda).manual_seed(3)
    grads = [[(scale * torch.randn(p.shape, generator=gen, device=cuda))
              .to(torch.bfloat16).contiguous(memory_format=(
                  torch.channels_last if p.dim() == 4
                  else torch.contiguous_format))
              for p in params0] for _ in range(3)]
    runs = []
    for plain in (False, True):
        p = [t.clone() for t in params0]
        master = [t.float() for t in p]
        nu = [torch.zeros_like(t) for t in p]
        mom = [torch.zeros_like(t, dtype=torch.float32) for t in p]
        sumsqs = []
        for step, gs in enumerate(grads):
            kw = dict(lr=4.8e-4 * (1 - step / 10), alpha=0.99, eps=0.01,
                      momentum=momentum, max_norm=40.0, masters=master)
            if plain:
                with ops.plain_on_device():
                    sumsqs.append(opt.rmsprop_tail(p, gs, nu, mom, **kw))
            else:
                before = (opt.rmsprop_tail.launches,
                          opt.rmsprop_tail.bf16_launches)
                sumsqs.append(opt.rmsprop_tail(p, gs, nu, mom, **kw))
                assert (opt.rmsprop_tail.launches,
                        opt.rmsprop_tail.bf16_launches) == (
                            before[0] + 1, before[1] + 1)
        runs.append((sumsqs, p, master, nu, mom))
    (sk, pk, mk, nk, momk), (sp, pp, mp, npl, momp) = runs
    for a, b in zip(sk, sp):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for a, b in zip(mk, mp):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=4e-6)
    for a, b in zip(momk if momentum else [], momp):
        assert float((a - b).abs().max()) <= BF16_ULP * float(b.abs().max())
    for a, b in zip(pk + nk, pp + npl):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=BF16_ULP,
                                   atol=4e-6)
    for a, m in zip(pk, mk):
        assert torch.equal(a, m.to(torch.bfloat16))


def _bf16_attention(xs, bias_bf16=True):
    q, k, v, seg, valid, nodone, bias = xs
    cast = lambda t: t.to(torch.bfloat16)  # noqa: E731
    return (cast(q), cast(k), cast(v), seg, valid, nodone,
            cast(bias) if bias_bf16 else bias)


@pytest.mark.parametrize("T,M,D,bias_bf16", [
    (81, 64, 32, True), (1, 64, 32, True), (81, 64, 32, False),
    (9, 64, 20, True), (81, 130, 64, True), (1, 130, 64, False)])
def test_attention_bf16_forward_matches_plain_version(cuda, T, M, D,
                                                      bias_bf16):
    """bf16 q, k, v (rel_bias bf16 or f32): out within 1 bf16 ulp of the
    plain version's (both round an f32 result), lse within 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    xs = _bf16_attention(attention_inputs(8, T, 4, D, M, T + M, cuda),
                         bias_bf16)
    before = attention.transformer_attention.bf16_launches
    out, lse = attention._launch_forward(M, *xs)
    assert attention.transformer_attention.bf16_launches == before + 1
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = attention.transformer_attention_plain(M, *xs)
    print(f"bf16 forward T={T} M={M} D={D}: {_bf16_ulps(out, want)} ulp")
    torch.testing.assert_close(out.float(), want.float(), rtol=BF16_ULP,
                               atol=1e-6)
    q, k, v, seg, valid, nodone, bias = xs
    _, offsets = attention.band_relative_offsets(T, M, device=cuda)
    mask = attention.attention_mask(M, seg, valid, nodone)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    scores = torch.where(mask[:, None],
                         scores + bias.float()[:, offsets][None], -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1),
                               rtol=1e-5, atol=1e-5)


# bf16 backward against autograd through the plain version: both narrow
# an f32 gradient, but the kernel's Delta = rowsum(dO * O) reads the bf16
# out of the forward and the plain version's its f32 out, so each
# gradient may differ by more than an ulp: max |err| <= BF16_BWD_TOL *
# max |gradient|.
BF16_BWD_TOL = 1e-2


@pytest.mark.parametrize("T,M,D,bias_bf16", [
    (81, 64, 32, True), (1, 64, 32, True), (81, 64, 32, False),
    (9, 64, 20, True), (300, 64, 64, True)])
def test_attention_bf16_backward_matches_plain_version(cuda, T, M, D,
                                                       bias_bf16):
    torch.backends.cuda.matmul.allow_tf32 = False
    xs, g = _backward_leaves(T, M, D)
    xs = _bf16_attention(xs, bias_bf16)
    g = g.to(torch.bfloat16)
    q, k, v, seg, valid, nodone, bias = xs
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = attention.transformer_attention_plain(
        M, leaves[0], leaves[1], leaves[2], seg, valid, nodone, leaves[3])
    want = torch.autograd.grad(out, leaves, g)
    out, lse = attention._launch_forward(M, *xs)
    before = attention.transformer_attention_bwd.bf16_launches
    got = attention.transformer_attention_bwd(M, *xs, out, lse, g)
    assert attention.transformer_attention_bwd.bf16_launches == before + 1
    for label, a, b in zip(("dq", "dk", "dv", "drel_bias"), got, want):
        assert a.dtype == b.dtype
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        print(f"bf16 backward T={T} M={M} D={D} {label}: max |err| {err:.3g}"
              f" of max {scale:.3g}")
        assert err <= BF16_BWD_TOL * scale, label


@pytest.mark.parametrize("T,M,D", [(81, 64, 32), (300, 64, 64)])
def test_attention_bf16_backward_is_deterministic(cuda, T, M, D):
    xs, g = _backward_leaves(T, M, D, B=32)
    xs = _bf16_attention(xs)
    g = g.to(torch.bfloat16)
    out, lse = attention._launch_forward(M, *xs)
    first = attention.transformer_attention_bwd(M, *xs, out, lse, g)
    second = attention.transformer_attention_bwd(M, *xs, out, lse, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_rmsprop_tail_f32_params_bf16_nu_kernel_matches_plain_version(cuda):
    """The tail's third instance: f32 params and grads with bf16 nu (the
    reference learner's opt_state_dtype="bf16" alone), deep tree, clip
    active, three steps. The norm within rtol 1e-6; params within rtol
    1e-6, atol 4e-6 and nu within 1 bf16 ulp or atol 4e-6, for the reason
    the bf16_train test gives; one bf16 launch a call."""
    torch.manual_seed(0)
    params0 = [p.detach() for p in create_model(
        "deep", 6, use_lstm=True).to(cuda).to(
            memory_format=torch.channels_last).parameters()]
    gen = torch.Generator(device=cuda).manual_seed(4)
    grads = [[torch.randn_like(p).copy_(torch.randn(
        p.shape, generator=gen, device=cuda)) for p in params0]
        for _ in range(3)]
    runs = []
    for plain in (False, True):
        p = [t.clone() for t in params0]
        nu = [torch.zeros_like(t, dtype=torch.bfloat16) for t in p]
        sumsqs = []
        for step, gs in enumerate(grads):
            kw = dict(lr=4.8e-4 * (1 - step / 10), alpha=0.99, eps=0.01,
                      max_norm=40.0)
            if plain:
                with ops.plain_on_device():
                    sumsqs.append(opt.rmsprop_tail(p, gs, nu, None, **kw))
            else:
                before = (opt.rmsprop_tail.launches,
                          opt.rmsprop_tail.bf16_launches)
                sumsqs.append(opt.rmsprop_tail(p, gs, nu, None, **kw))
                assert (opt.rmsprop_tail.launches,
                        opt.rmsprop_tail.bf16_launches) == (
                            before[0] + 1, before[1] + 1)
        runs.append((sumsqs, p, nu))
    (sk, pk, nk), (sp, pp, npl) = runs
    for a, b in zip(sk, sp):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for a, b in zip(pk, pp):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=4e-6)
    for a, b in zip(nk, npl):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=BF16_ULP,
                                   atol=4e-6)


def _table_pair(cuda):
    """The same deep + LSTM state table on the card and on the CPU, the
    acting forward greedy."""
    import copy

    from torchbeast_tpu_torch.runtime.state_table import DeviceStateTable

    model = create_model("deep", 6, use_lstm=True)
    tables = []
    for m, device in ((copy.deepcopy(model).to(cuda), cuda),
                      (model, torch.device("cpu"))):

        def act(ctx, env, state, m=m):
            out, new_state = m(env, state, sample_action=False)
            return {"action": out.action.to(torch.int32),
                    "policy_logits": out.policy_logits}, new_state

        tables.append(DeviceStateTable(
            m.initial_state(1, device), 5, act, batch_dim=1,
            input_filter=lambda e: {k: e[k] for k in (
                "frame", "reward", "done", "last_action")}))
    return tables


def test_state_table_on_the_card_matches_the_cpu_table(cuda):
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu, cpu = _table_pair(cuda)
        rng = np.random.default_rng(0)
        for slots, advance in (([0, 3, 5, 5], [1, 1, 0, 0]),
                               ([3, 1, 5, 5], [1, 0, 0, 0]),
                               ([4, 0, 2, 3], [1, 1, 1, 1])):
            n = len(slots)
            env = {"frame": rng.integers(0, 256, (1, n, 84, 84, 4),
                                         dtype=np.uint8),
                   "reward": rng.standard_normal((1, n)).astype(np.float32),
                   "done": rng.random((1, n)) < 0.3,
                   "last_action": rng.integers(0, 6, (1, n), dtype=np.int32)}
            got = gpu.fetch(gpu.step(np.asarray(slots), np.asarray(advance,
                                                                   bool), env),
                            n)
            want = cpu.fetch(cpu.step(np.asarray(slots), np.asarray(advance,
                                                                    bool), env),
                             n)
            np.testing.assert_array_equal(got["action"], want["action"])
            np.testing.assert_allclose(got["policy_logits"],
                                       want["policy_logits"], rtol=1e-4,
                                       atol=1e-5)
            for s in range(5):
                for g, w in zip(gpu.read_slot(s), cpu.read_slot(s)):
                    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32


def test_checkpoint_round_trip_of_cuda_tensors_is_bitwise(cuda, tmp_path):
    from torchbeast_tpu_torch import learner
    from torchbeast_tpu_torch.utils import checkpoint

    for param_dtype, opt_impl in (("bf16", "pallas"), ("f32", "xla")):
        models = []
        for seed in (0, 1):
            torch.manual_seed(seed)
            model = create_model("deep", 6, use_lstm=True).to(cuda)
            if param_dtype == "bf16":
                for p in model.parameters():
                    p.data = p.data.to(torch.bfloat16)
            hp = learner.HParams(opt_impl=opt_impl, param_dtype=param_dtype,
                                 opt_state_dtype=param_dtype)
            optimizer = learner.make_optimizer(hp, list(model.parameters()))
            with torch.no_grad():
                for t in [*optimizer.state.nu, *(optimizer.state.master or [])]:
                    t.copy_(torch.rand(t.shape, device=cuda))
            optimizer.state = optimizer.state._replace(count=5)
            models.append((model, optimizer))
        (m0, o0), (m1, o1) = models
        path = str(tmp_path / f"{opt_impl}.ckpt")
        checkpoint.save_train_state(path, m0, o0, step=9)
        assert checkpoint.load_train_state(path, m1, o1)["step"] == 9
        assert o1.state.count == 5
        for group in ("nu", "master"):
            for a, b in zip(getattr(o0.state, group) or [],
                            getattr(o1.state, group) or []):
                assert a.device == b.device and a.dtype == b.dtype
                assert torch.equal(a, b)
        for a, b in zip(m0.parameters(), m1.parameters()):
            assert b.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b)
