"""The fused RMSprop optimizer tail (--opt_impl pallas); counterpart of
torchbeast_tpu/ops/pallas_opt.py.

Global-norm clip -> torch-RMSprop second moment -> optional momentum
trace -> learning-rate apply, over every parameter leaf at once. A CUDA
tensor runs the hand-written kernel `csrc/rmsprop_tail.cu` (one
cooperative launch per update for the whole tree); a CPU tensor runs
`rmsprop_tail_plain`.

Unlike the JAX transform, which returns new arrays, the port updates the
parameters, `nu`, `mom` and the master IN PLACE: no parameter-sized
output is allocated per update.

Precision, as the reference's policies set it: params (and so their
gradients) f32 or bf16, nu f32 or bf16 (bf16 with bf16 params, the one
pairing a policy makes), mom f32. bf16 params
(--precision bf16_train) keep an f32 master: the update is applied to
the master in f32 and the params become bf16(master), the narrowing cast
rounding to nearest even.
"""

import ctypes
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from torchbeast_tpu_torch.ops import _build
from torchbeast_tpu_torch.ops._route import require, use_kernel

MAX_LEAVES = 64  # kMaxLeaves in csrc/rmsprop_tail.cu
BLOCKS_PER_SM = 4  # kTailBlocksPerSm: the persistent grid's blocks an SM
STORAGE = (torch.float32, torch.bfloat16)  # of params/grads and of nu


def _sumsq(grads):
    """The global squared norm: f64 sums per leaf, summed, then f32."""
    return torch.stack(
        [g.double().square().sum() for g in grads]
    ).sum().float()


def rmsprop_tail_plain(params, grads, nus, moms, *, lr, alpha, eps,
                       momentum, max_norm, masters=None):
    """The plain PyTorch version of the kernel, in place, one elementary
    f32 operation at a time in the kernel's order: bf16 values are widened
    first and narrowed (to nearest even) when written back. Returns the
    gradients' squared global norm, a 0-d f32 tensor."""
    with torch.no_grad():
        sumsq = _sumsq(grads)
        scale = None
        if max_norm is not None:
            gnorm = torch.sqrt(sumsq)
            # Multiplying by exactly 1.0 below the threshold keeps the
            # gradient bit for bit, as the kernel's skipped multiply does.
            scale = torch.where(
                gnorm < max_norm, torch.ones_like(gnorm), max_norm / gnorm
            )
        one_minus_alpha = 1.0 - alpha
        for i, (p, g, nu) in enumerate(zip(params, grads, nus)):
            g = g.float()
            if scale is not None:
                g = g * scale
            new_nu = alpha * nu.float() + (one_minus_alpha * g) * g
            upd = g / (torch.sqrt(new_nu) + eps)
            if momentum:
                upd = momentum * moms[i] + upd
                moms[i].copy_(upd)
            nu.copy_(new_nu)
            w = p if masters is None else masters[i]
            w.copy_(w.float() - lr * upd)
            if masters is not None:
                p.copy_(w)
    return sumsq


def _dense(t) -> bool:
    return t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)
    )


_sm_count = {}


def _num_partials(device) -> int:
    """The most blocks the kernel's persistent grid may take, one f64
    partial of the norm each: BLOCKS_PER_SM per SM."""
    if device not in _sm_count:
        props = torch.cuda.get_device_properties(device)
        _sm_count[device] = props.multi_processor_count
    return BLOCKS_PER_SM * _sm_count[device]


def rmsprop_tail(params, grads, nus, moms, *, lr: float, alpha: float,
                 eps: float, momentum: float = 0.0,
                 max_norm: Optional[float] = None, masters=None):
    """Apply one update in place. `params`, `grads`, `nus` (and `moms`
    when momentum > 0, `masters` when the params are bf16) are
    equal-length lists; leaf i of each has one shape and one dense
    layout. Params and grads share one dtype, f32 or bf16; nus are all
    f32 or all bf16 (bf16 when the params are); moms and masters are f32.
    bf16 params need their f32 masters; f32 params take none. `lr` is this update's learning rate,
    `max_norm` None for no clipping. Returns the squared global norm of
    `grads` (before clipping), a 0-d f32 tensor on their device."""
    name = "rmsprop_tail"
    n = len(params)
    require(n > 0 and len(grads) == n and len(nus) == n, name,
            "params, grads and nus must be non-empty and of one length")
    has_mom = bool(momentum)
    if has_mom:
        require(moms is not None and len(moms) == n, name,
                "momentum > 0 needs one mom tensor per leaf")
    p_dtype, nu_dtype = params[0].dtype, nus[0].dtype
    require(p_dtype in STORAGE and nu_dtype in STORAGE, name,
            f"dtype {p_dtype} (params) / {nu_dtype} (nu): f32 or bf16")
    bf16_params = p_dtype == torch.bfloat16
    require((masters is not None) == bf16_params, name,
            "bf16 params need one f32 master per leaf, f32 params none")
    require(not bf16_params or nu_dtype == torch.bfloat16, name,
            "bf16 params take bf16 nu (the bf16_train policy)")
    if bf16_params:
        require(len(masters) == n, name, "one master per leaf")
    roles = ((params, p_dtype), (grads, p_dtype), (nus, nu_dtype))
    roles += ((moms, torch.float32),) if has_mom else ()
    roles += ((masters, torch.float32),) if bf16_params else ()
    device = params[0].device
    for i in range(n):
        for tensors, dtype in roles:
            t = tensors[i]
            require(t.dtype == dtype, name,
                    f"leaf {i}: dtype {t.dtype} != {dtype}")
            require(t.device == device, name, f"leaf {i}: two devices")
            require(t.shape == params[i].shape, name,
                    f"leaf {i}: shape {tuple(t.shape)} != "
                    f"{tuple(params[i].shape)}")
    if not use_kernel(params[0], name):
        return rmsprop_tail_plain(params, grads, nus, moms, lr=lr,
                                  alpha=alpha, eps=eps, momentum=momentum,
                                  max_norm=max_norm, masters=masters)
    require(n <= MAX_LEAVES, name,
            f"{n} leaves; the kernel's table holds {MAX_LEAVES}")
    for i in range(n):
        for tensors, _ in roles:
            t = tensors[i]
            require(_dense(t) and t.stride() == params[i].stride(), name,
                    f"leaf {i}: tensors must be dense with the param's "
                    "strides")
    ptrs = lambda ts: (ctypes.c_void_p * n)(  # noqa: E731
        *[t.data_ptr() for t in ts]
    )
    p_arr, g_arr, nu_arr = ptrs(params), ptrs(grads), ptrs(nus)
    mom_arr = ptrs(moms) if has_mom else p_arr
    mst_arr = ptrs(masters) if bf16_params else p_arr
    numels = (ctypes.c_longlong * n)(*[p.numel() for p in params])
    n_partials = _num_partials(device)
    partials = torch.empty(n_partials, dtype=torch.float64, device=device)
    sumsq = torch.empty((), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _build.library()
    with torch.cuda.device(device):
        status = lib.tbt_rmsprop_tail(
            ctypes.cast(p_arr, ctypes.c_void_p),
            ctypes.cast(g_arr, ctypes.c_void_p),
            ctypes.cast(nu_arr, ctypes.c_void_p),
            ctypes.cast(mom_arr, ctypes.c_void_p),
            ctypes.cast(mst_arr, ctypes.c_void_p),
            ctypes.cast(numels, ctypes.c_void_p),
            n, partials.data_ptr(), n_partials, sumsq.data_ptr(),
            lr, alpha, 1.0 - alpha, eps, momentum,
            0.0 if max_norm is None else max_norm,
            int(max_norm is not None), int(has_mom), int(bf16_params),
            int(nu_dtype == torch.bfloat16), stream,
        )
    _build.check(status, name)
    rmsprop_tail.launches += 1  # one cooperative launch, both passes
    rmsprop_tail.bf16_launches += int(bf16_params or nu_dtype != p_dtype)
    return sumsq


rmsprop_tail.launches = 0
rmsprop_tail.bf16_launches = 0  # launches with bf16 params or nu


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax.linear_schedule evaluated in f32 as the reference evaluates
    it on device: count -> learning rate (a Python float holding an f32)."""

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float(
            np.float32(init_value - end_value) * frac + np.float32(end_value)
        )

    return schedule


class FusedTailState(NamedTuple):
    """`count` is the schedule clock (updates applied so far); `nu` and
    `mom` are lists aligned with the parameter list (`mom` None when
    momentum is off). `master` holds the f32 master copy of bf16-resident
    params (--precision bf16_train), None when the params are f32."""

    count: int
    nu: List[torch.Tensor]
    mom: Optional[List[torch.Tensor]]
    master: Optional[List[torch.Tensor]] = None


def _state_dtype(state_dtype) -> torch.dtype:
    """HParams.opt_state_dtype ("f32", "bf16"; None for f32) -> the storage
    dtype of nu."""
    if state_dtype in (None, "f32"):
        return torch.float32
    if state_dtype == "bf16":
        return torch.bfloat16
    raise ValueError(f"state_dtype must be f32 or bf16, got {state_dtype!r}")


class FusedRMSpropTail:
    """The whole optimizer tail as one fused step (--opt_impl pallas):
    clip to `max_norm` (None = no clip), torch-denominator RMSprop
    (`decay`, `eps`, nu stored as `state_dtype`), momentum trace,
    `learning_rate(count)` apply. `param_dtype` "bf16": the params are
    bf16-resident (cast before the optimizer is built) and the state
    holds their f32 master."""

    def __init__(self, params, learning_rate, decay: float, eps: float,
                 momentum: float = 0.0, max_norm: Optional[float] = None,
                 param_dtype: str = "f32", state_dtype=None):
        if param_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"param_dtype must be 'f32' or 'bf16', got {param_dtype!r}")
        self.params = list(params)
        resident = torch.bfloat16 if param_dtype == "bf16" else torch.float32
        for p in self.params:
            if p.dtype != resident:
                raise ValueError(
                    f"param_dtype {param_dtype!r} needs {resident} params, "
                    f"got {p.dtype}: cast the params first")
        self.schedule = learning_rate
        self.decay, self.eps = decay, eps
        self.momentum, self.max_norm = momentum, max_norm
        nu_dtype = _state_dtype(state_dtype)
        with torch.no_grad():
            self.state = FusedTailState(
                count=0,
                nu=[torch.zeros_like(p, dtype=nu_dtype)
                    for p in self.params],
                mom=(
                    [torch.zeros_like(p, dtype=torch.float32)
                     for p in self.params]
                    if momentum else None
                ),
                master=(
                    [p.detach().to(torch.float32, copy=True)
                     for p in self.params]
                    if param_dtype == "bf16" else None
                ),
            )

    def step(self, grads) -> torch.Tensor:
        """Apply one update to the parameters in place; returns the
        gradients' squared global norm (0-d f32, on their device)."""
        # The kernel pairs elements by position: a gradient whose layout
        # differs from its parameter's (cuDNN may hand back a conv weight
        # gradient in another memory format) is copied into the
        # parameter's layout first.
        grads = [
            g if g.stride() == p.stride()
            else torch.empty_like(p).copy_(g)
            for p, g in zip(self.params, grads)
        ]
        sumsq = rmsprop_tail(
            self.params, grads, self.state.nu, self.state.mom,
            lr=self.schedule(self.state.count), alpha=self.decay,
            eps=self.eps, momentum=self.momentum, max_norm=self.max_norm,
            masters=self.state.master,
        )
        self.state = self.state._replace(count=self.state.count + 1)
        return sumsq
