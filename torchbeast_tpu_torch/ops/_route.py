"""Which version of a kernel's function a tensor takes.

A kernel wrapper runs its hand-written CUDA kernel for a CUDA tensor and
its plain PyTorch version for a CPU tensor; any other device raises. There
is no fallback from the kernel to the plain version: a kernel that fails
to build or launch raises.

Each wrapper also adds the bytes its kernel reads and writes (each
operand once, each result once: PERF.md's bound by bytes) to every count
that precision.count_bytes has open (`note_bytes`): a TorchDispatchMode
sees the aten ops of the plain versions, never a ctypes launch.

`plain_on_device()` is the one exception, for tests only: inside it a CUDA
tensor takes the plain version on the card, so a whole update can be held
against its kernel twin on the same device (chip_smoke.py does this);
`plain_on_device("lstm_layer")` does so for the named kernels only. It is
process-wide, not per thread, because autograd runs CUDA backward
functions on its own device threads.
"""

import contextlib
import threading

import torch

# The kernels whose plain versions CUDA tensors take: None for none, () for
# every kernel.
_switch = {"plain": None}


def use_kernel(t: torch.Tensor, name: str) -> bool:
    """True to launch the kernel `name`, False to take its plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(
            f"{name}: tensors must be on a CUDA device or the CPU, got "
            f"{t.device}"
        )
    plain = _switch["plain"]
    return plain is None or (bool(plain) and name not in plain)


@contextlib.contextmanager
def plain_on_device(*names: str):
    """Test-only: run the plain versions of the kernels `names` (default:
    every kernel) on CUDA tensors."""
    prev = _switch["plain"]
    _switch["plain"] = tuple(names)
    try:
        yield
    finally:
        _switch["plain"] = prev


_count_lock = threading.Lock()


def count_launch(wrapper, **more) -> None:
    """Add one to `wrapper.launches`, and each `more` amount to the
    counter of that name, under one lock: the async driver's inference
    threads and its learner launch kernels concurrently, and `+=` on an
    attribute is not atomic."""
    with _count_lock:
        wrapper.launches += 1
        for name, n in more.items():
            setattr(wrapper, name, getattr(wrapper, name) + n)


def add_counts(amounts) -> None:
    """Add each `n` of `amounts` ((wrapper, attribute name, n) triples) to
    that counter, under the same lock: a CUDA graph replay launches the
    kernels that its capture counted once, and adds them per replay."""
    with _count_lock:
        for wrapper, name, n in amounts:
            setattr(wrapper, name, getattr(wrapper, name) + n)


def require(cond: bool, name: str, what: str) -> None:
    """Input check of a kernel wrapper."""
    if not cond:
        raise ValueError(f"{name}: {what}")


# The byte counts precision.count_bytes has open, process-wide as
# `_switch` is: a backward's kernels launch on autograd's device threads.
_byte_counts = []


def note_bytes(*tensors) -> None:
    """Add the bytes of `tensors` (a kernel launch's operands and results;
    None entries skipped) to every open byte count."""
    if not _byte_counts:
        return
    n = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    with _count_lock:
        for count in _byte_counts:
            count.total += n
