"""Which version of a kernel's function a tensor takes.

A kernel wrapper runs its hand-written CUDA kernel for a CUDA tensor and
its plain PyTorch version for a CPU tensor; any other device raises. There
is no fallback from the kernel to the plain version: a kernel that fails
to build or launch raises.

`plain_on_device()` is the one exception, for tests only: inside it a CUDA
tensor takes the plain version on the card, so a whole update can be held
against its kernel twin on the same device (chip_smoke.py does this). It
is process-wide, not per thread, because autograd runs CUDA backward
functions on its own device threads.
"""

import contextlib

import torch

_switch = {"plain": False}


def use_kernel(t: torch.Tensor, name: str) -> bool:
    """True to launch the kernel `name`, False to take its plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(
            f"{name}: tensors must be on a CUDA device or the CPU, got "
            f"{t.device}"
        )
    return not _switch["plain"]


@contextlib.contextmanager
def plain_on_device():
    """Test-only: run the plain versions on CUDA tensors."""
    prev = _switch["plain"]
    _switch["plain"] = True
    try:
        yield
    finally:
        _switch["plain"] = prev


def require(cond: bool, name: str, what: str) -> None:
    """Input check of a kernel wrapper."""
    if not cond:
        raise ValueError(f"{name}: {what}")
