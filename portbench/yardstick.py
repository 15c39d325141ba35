"""The benchmark's arithmetic: the card's peaks, the window's rates and
tails, the union of device intervals, kernel groups and the least time
that moving a kernel's bytes takes. Nothing here reads the program."""

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth, and TF32 on the
# tensor cores (the fastest rate at which the card runs any operation of
# a float32 configuration, so a share of it cannot pass 100%).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12

# Substrings of device kernel names -> group, tried in order. The port's
# own kernels first; then the library's pooling, whose channels-last
# kernels (at::native max_pool_forward_nhwc) would otherwise match the
# convolutions' layout keys; cuDNN's convolutions carry a direction
# (fprop/dgrad/wgrad) or "conv" in their names or run inside cudnn:: (its
# layout conversions too); cuBLAS's Hopper products are sm90_xmma_gemm_*,
# so a bare "xmma" would file them under convolutions.
GROUPS = (
    ("port kernels", ("vtrace_targets_kernel", "rmsprop_",
                      "pool_bwd_kernel", "attention_")),
    ("pooling", ("max_pool", "avg_pool", "adaptive_max", "adaptive_avg")),
    ("convolution", ("conv", "cudnn", "implicit", "wgrad", "dgrad",
                     "fprop", "nchw", "nhwc")),
    ("matrix product", ("gemm", "gemv", "cutlass", "nvjet")),
)


def group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other"


def intervals_ms(completions_ms):
    """The intervals between consecutive completions, the first from the
    window's start (time 0) to the first completion."""
    return [b - a for a, b in zip([0.0] + list(completions_ms),
                                  completions_ms)]


def rate(work_per_update, completions_ms):
    """Work a second over the whole window: every update's work over the
    time from the window's start to the last update's completion."""
    return len(completions_ms) * work_per_update / (completions_ms[-1] / 1e3)


def percentile(values, q: float):
    """The q-th percentile (0 < q < 100), linear between order statistics
    (numpy's default)."""
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def union_us(spans, lo, hi):
    """Microseconds of [lo, hi] that the (start, end) spans cover."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in spans
                     if b > lo and a < hi)
    total, reach = 0.0, lo
    for a, b in clipped:
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def bytes_ms(nbytes: float) -> float:
    """The least milliseconds in which the card moves `nbytes` of HBM."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def pool_bwd_bytes(n: int, pools, itemsize: int) -> int:
    """Bytes of the 3x3/2 pad-1 max-pool backward over `pools`, each
    (channels, height, width) of the pool's input: x, the pooled y and
    its cotangent g read once, gx written once, for n images."""
    total = 0
    for c, h, w in pools:
        ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        total += n * c * (2 * h * w + 2 * ho * wo) * itemsize
    return total


def rmsprop_tail_bytes(num_params: int, itemsize: int = 4) -> int:
    """Bytes of the clip, RMSprop and learning-rate apply over a tree of
    `num_params` float32 parameters without momentum: params, gradients
    and nu read once, params and nu written once."""
    return num_params * 5 * itemsize


def conv_flops(c_in, c_out, k, h_out, w_out) -> int:
    """Multiply-adds of one frame's convolution, counted as 2 FLOPs."""
    return 2 * c_in * c_out * k * k * h_out * w_out


def lstm_flops(input_size, hidden, layers) -> int:
    """One step of a stacked LSTM's four gate products."""
    total, d = 0, input_size
    for _ in range(layers):
        total += 2 * 4 * hidden * (d + hidden)
        d = hidden
    return total
