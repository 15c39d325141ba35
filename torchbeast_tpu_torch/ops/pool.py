"""The deep trunk's 3x3, stride-2, pad-1 max-pool and its backward;
counterpart of torchbeast_tpu/ops/pool.py.

Tensors are NCHW in PyTorch's channels_last memory format (physically
NHWC, the reference's layout). The forward is `F.max_pool2d` everywhere,
as the reference leaves its forward to XLA's reduce_window. The backward
depends on where the tensor lies:

- CPU: the plain all-ties tap-sum (`pool_bwd_plain`, the reference's CPU
  custom VJP);
- CUDA with TBT_POOL_PALLAS=1 (the reference's switch for its Pallas
  kernel): the hand-written kernel `csrc/pool_bwd.cu`;
- CUDA without it: PyTorch's own max_pool2d backward, as the reference
  leaves XLA's SelectAndScatter.

Tie semantics of the first two: every input position that ties at its
window's max is credited (a valid subgradient). PyTorch's own backward,
like SelectAndScatter, credits one position; ties are measure-zero for
conv outputs.

Tensors are f32 or, under the bf16 precision policies, bf16. In bf16 the
gradient is summed as the reference's kernel sums it: taps added in
(kh, kw) order into zeros, rounded to bf16 after every add; the tap
comparisons are exact (y is a max of x).
"""

import ctypes
import os

import torch
import torch.nn.functional as F

from torchbeast_tpu_torch.ops import _build
from torchbeast_tpu_torch.ops._route import (
    count_launch,
    note_bytes,
    require,
    use_kernel,
)

WINDOW, STRIDE, PAD = 3, 2, 1


def pooled_size(n: int) -> int:
    return (n + 2 * PAD - WINDOW) // STRIDE + 1


def _tap(k: int, n_in: int, n_out: int):
    """(output slice, input slice) that tap offset k places onto: output
    index o lands on input index STRIDE * o + k - PAD."""
    o_start = 1 if k < PAD else 0
    o_end = min(n_out, (n_in - 1 - k + PAD) // STRIDE + 1)
    if o_end <= o_start:
        return None
    i_start = STRIDE * o_start + k - PAD
    i_stop = STRIDE * (o_end - 1) + k - PAD + 1
    return slice(o_start, o_end), slice(i_start, i_stop, STRIDE)


def pool_bwd_plain(x, y, g):
    """The plain PyTorch version of the kernel: the all-ties tap-sum. For
    each of the 9 taps, place y (fill +inf) and g (fill 0) onto the input
    grid and credit g where x equals the window max; taps are added in
    the reference's (kh, kw) order, each add rounded to the tensors'
    dtype."""
    H, W = x.shape[2:]
    Ho, Wo = y.shape[2:]
    gx = torch.zeros_like(x)
    for kh in range(WINDOW):
        rows = _tap(kh, H, Ho)
        for kw in range(WINDOW):
            cols = _tap(kw, W, Wo)
            if rows is None or cols is None:
                continue
            y_up = torch.full_like(x, float("inf"))
            g_up = torch.zeros_like(x)
            y_up[:, :, rows[1], cols[1]] = y[:, :, rows[0], cols[0]]
            g_up[:, :, rows[1], cols[1]] = g[:, :, rows[0], cols[0]]
            gx = gx + torch.where(x == y_up, g_up, 0.0)
    return gx


def pool_bwd(x, y, g):
    """Gradient of the 3x3/2 pad-1 max-pool with respect to x, all ties
    credited. x: [N, C, H, W] pool input, y: its pooled output, g: the
    cotangent of y, all f32 or all bf16, in any memory layout. A CUDA
    tensor launches csrc/pool_bwd.cu, which reads the strides as they are
    and returns gx in channels_last; a CPU tensor takes `pool_bwd_plain`.

    `pool_bwd.vector_launches` counts the launches that took the kernel's
    16-byte path (4 f32 or 8 bf16 channels a thread: C a multiple of
    that, channels contiguous, 16-byte aligned), a subset of
    `pool_bwd.launches`; `pool_bwd.bf16_launches` counts the bf16
    ones."""
    name = "pool_bwd"
    require(x.dim() == 4, name, f"x must be 4-D, got {tuple(x.shape)}")
    N, C, H, W = x.shape
    out = (N, C, pooled_size(H), pooled_size(W))
    require(tuple(y.shape) == out and tuple(g.shape) == out, name,
            f"y {tuple(y.shape)} and g {tuple(g.shape)} must be {out}")
    require(x.dtype in (torch.float32, torch.bfloat16), name,
            f"dtype {x.dtype}: f32 or bf16")
    for t in (x, y, g):
        require(t.dtype == x.dtype, name, f"dtype {t.dtype} != {x.dtype}")
        require(t.device == x.device, name, "inputs on two devices")
    if not use_kernel(x, name):
        return pool_bwd_plain(x, y, g)
    gx = torch.empty_like(x, memory_format=torch.channels_last)
    strides = (ctypes.c_longlong * 16)(
        *(s for t in (x, y, g, gx) for s in t.stride()))
    vectorized = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.library()
    with torch.cuda.device(x.device):
        status = lib.tbt_pool_bwd(
            x.data_ptr(), y.data_ptr(), g.data_ptr(), gx.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), N, H, W, C, out[2],
            out[3], int(x.dtype == torch.bfloat16),
            ctypes.byref(vectorized), stream,
        )
    _build.check(status, name)
    count_launch(pool_bwd, vector_launches=vectorized.value,
                 bf16_launches=int(x.dtype == torch.bfloat16))
    note_bytes(x, y, g, gx)
    return gx


pool_bwd.launches = 0
pool_bwd.vector_launches = 0
pool_bwd.bf16_launches = 0


class _AllTiesMaxPool(torch.autograd.Function):
    """F.max_pool2d forward, `pool_bwd` backward; x, y and g go to the
    kernel in the layout they have (no copy)."""

    @staticmethod
    def forward(ctx, x):
        y = F.max_pool2d(x, WINDOW, STRIDE, PAD)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return pool_bwd(x, y, g)


def max_pool2d(x):
    """3x3, stride-2, pad-1 max pooling of an [N, C, H, W] tensor, with
    the backward chosen as the module docstring says."""
    if x.is_cuda and os.environ.get("TBT_POOL_PALLAS") != "1":
        return F.max_pool2d(x, WINDOW, STRIDE, PAD)
    return _AllTiesMaxPool.apply(x)
