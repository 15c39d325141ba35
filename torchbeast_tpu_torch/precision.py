"""Precision policies: what dtype each tensor of the learner step lives in
(counterpart of torchbeast_tpu/precision.py; the port's own copy of its
`Policy` table, `get`, `resolve_flags`, `cast_params` and `cast_batch`).

One hard contract, as in the reference: V-trace, the losses, the gradient
norm and the RMSprop second-moment EMA are COMPUTED in float32 whatever
the storage dtype, and the master params stay float32. bfloat16 changes
what is stored and moved, never what is accumulated.

    f32           Everything float32.
    bf16_compute  The trunk computes in bfloat16 (the old
                  `--model_dtype bfloat16`, which aliases to it).
    bf16_train    bf16_compute, plus the recurrent core and policy head
                  compute in bfloat16, the params are bfloat16-resident
                  with an f32 master in the optimizer state, the RMSprop
                  second moment is stored bfloat16, and the float32
                  leaves of the staged batch and of the initial agent
                  state are cast to bfloat16 before they reach the card.

Models take `dtype` and `head_dtype` and cast at each layer, as the flax
modules do; nothing here uses `torch.autocast`, whose own per-op lists
would pick other ops than the reference's.

Memory accounting, the counterpart of the reference's `bytes_accessed`,
`MemoryStats` and `memory_stats` (the remat planner's oracle,
runtime/remat_plan.py, and the learner's `learner.hbm_bytes_per_update`
gauge). The reference reads XLA's figures off a lowered or compiled
program without running it; the port runs the function once and watches
it:

- bytes accessed: `count_bytes` sums the bytes of the operands and
  results of every aten op a run dispatches (a TorchDispatchMode, so
  before any fusion and in each tensor's own dtype, as the lowered HLO
  counts them), plus what each hand kernel's wrapper reports for its
  launch (ops/_route.note_bytes): a dispatch mode never sees a ctypes
  launch. Ops that move no data (views, allocations) count nothing.
  Recomputed forward ops run again in the backward, so more remat reads
  more bytes.
- peak: on the card, the caching allocator's peak over the run
  (`torch.cuda.max_memory_allocated`, cuDNN's workspace included). The
  CPU keeps no allocator statistics, so there the peak is an estimate:
  the bytes autograd keeps for the backward (counted once per storage
  through `torch.autograd.graph.saved_tensors_hooks`), plus the
  arguments, the resident tensors and the outputs.

`hbm_gauge_async` has no separate counterpart: the port's figure rides a
run the learner makes anyway (a CUDA graph's eager warm-up, the first
eager dispatch on the CPU; learner.instrument_update_step), so nothing
is traced on another thread.
"""

import logging
from typing import NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from torchbeast_tpu_torch import nest
from torchbeast_tpu_torch.ops import _route

log = logging.getLogger(__name__)

CHOICES = ("f32", "bf16_compute", "bf16_train")


class Policy(NamedTuple):
    """`compute_dtype`: the trunk's compute dtype; `head_dtype`: the
    recurrent core's and policy head's; `param_dtype`: the resident
    params ("bf16" keeps an f32 master in the optimizer state);
    `batch_dtype`: what float32 leaves of the staged batch and initial
    agent state become (None = stay float32); `opt_state_dtype`: the
    RMSprop second moment's storage, as learner.HParams takes it."""

    name: str
    compute_dtype: torch.dtype
    head_dtype: torch.dtype
    param_dtype: str
    batch_dtype: Optional[torch.dtype]
    opt_state_dtype: str


POLICIES = {
    "f32": Policy("f32", torch.float32, torch.float32, "f32", None, "f32"),
    "bf16_compute": Policy(
        "bf16_compute", torch.bfloat16, torch.float32, "f32", None, "f32"
    ),
    "bf16_train": Policy(
        "bf16_train", torch.bfloat16, torch.bfloat16, "bf16",
        torch.bfloat16, "bf16",
    ),
}


def get(name: str) -> Policy:
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(
            f"Unknown precision policy {name!r}; choices: {CHOICES}"
        ) from None


def resolve_flags(flags) -> Policy:
    """Flags -> Policy. `--model_dtype bfloat16` is a deprecated alias of
    `--precision bf16_compute` (warned once per process); with an explicit
    `--precision bf16_train` it is a conflict, not a priority rule."""
    name = getattr(flags, "precision", "f32") or "f32"
    legacy = getattr(flags, "model_dtype", None)
    if legacy and legacy != "float32":
        if name != "f32" and name != "bf16_compute":
            raise ValueError(
                f"--model_dtype {legacy} conflicts with --precision "
                f"{name}; drop the deprecated --model_dtype flag"
            )
        if not getattr(resolve_flags, "_warned_model_dtype", False):
            resolve_flags._warned_model_dtype = True
            log.warning(
                "--model_dtype bfloat16 is deprecated; use --precision "
                "bf16_compute (aliased for you). bf16_train additionally "
                "makes params/activations bf16-resident and compacts "
                "the staged batch and optimizer second moment."
            )
        name = "bf16_compute"
    return get(name)


def cast_params(module: torch.nn.Module, policy: Policy) -> torch.nn.Module:
    """The module's float32 params -> the policy's resident dtype, in
    place (memory formats kept). Cast BEFORE the optimizer is built: its
    f32 master copy is made from the resident params."""
    if policy.param_dtype == "bf16":
        for p in module.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(torch.bfloat16)
    return module


def cast_batch(tree, batch_dtype: Optional[torch.dtype] = None):
    """Float32 tensor leaves -> `batch_dtype`; every other leaf untouched.
    The driver applies it to the staged batch on the host, before the
    copy to the card, so the copy is half-width too, and to the initial
    agent state; the learner widens at the point of use."""
    if batch_dtype is None:
        return tree
    return nest.map(
        lambda t: t.to(batch_dtype) if torch.is_tensor(t)
        and t.dtype == torch.float32 else t, tree)


def tensor_bytes(tree) -> int:
    """Bytes of the tensor leaves of a nest (tuples, lists, dicts)."""
    return sum(t.numel() * t.element_size() for t in nest.flatten(tree)
               if torch.is_tensor(t))


# aten ops that move no data: allocations (their bytes are counted where
# something writes them).
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}


class _CountingMode(TorchDispatchMode):
    def __init__(self, count):
        super().__init__()
        self._count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func.__name__.split(".")[0]
                in _ALLOCATIONS):
            leaves = tree_flatten((args, kwargs))[0]
            leaves += tree_flatten(out)[0]
            n = sum(t.numel() * t.element_size() for t in leaves
                    if isinstance(t, torch.Tensor))
            with _route._count_lock:
                self._count.total += n
        return out


class ByteCount:
    """What `count_bytes` counted so far: `total` bytes."""

    def __init__(self):
        self.total = 0


class count_bytes:
    """Context manager: count the bytes accessed by the ops this thread
    dispatches inside it (autograd's device threads included) and by the
    hand kernels launched meanwhile. `with count_bytes() as counted:
    ...; counted.total`."""

    def __init__(self):
        self.count = ByteCount()

    def __enter__(self) -> ByteCount:
        self._mode = _CountingMode(self.count)
        with _route._count_lock:
            _route._byte_counts.append(self.count)
        self._mode.__enter__()
        return self.count

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        with _route._count_lock:
            _route._byte_counts.remove(self.count)
        return False


def bytes_accessed(fn, *args) -> Optional[float]:
    """Bytes accessed by one call fn(*args) (count_bytes): dtype-faithful
    and before any fusion, the port's form of the reference's pre-opt HLO
    figure. Unlike the reference, fn RUNS (its side effects happen).
    Returns None when the call raises or counts nothing; never raises."""
    try:
        with count_bytes() as counted:
            fn(*args)
    except Exception:  # best-effort accounting, never sinks a run
        log.debug("bytes_accessed run failed", exc_info=True)
        return None
    return float(counted.total) if counted.total > 0 else None


class MemoryStats(NamedTuple):
    """Memory figures of one call (the reference's fields).

    `bytes_accessed` is bytes_accessed's figure. `argument_bytes`: the
    call's tensor arguments plus the `resident` tensors it reads (params,
    optimizer state: the reference's jitted step takes them as
    arguments); `output_bytes`: its tensor results. On the card
    `peak_bytes` is the caching allocator's peak over the call and
    `temp_bytes` that peak less the argument bytes: what the allocator
    held beyond them (activations, gradients, workspaces, and anything
    else live on the card). On the CPU `temp_bytes` is the estimate of
    the module docstring (the bytes autograd keeps for the backward) and
    `peak_bytes` the arguments + outputs + temps sum."""

    bytes_accessed: Optional[float]
    argument_bytes: Optional[float]
    output_bytes: Optional[float]
    temp_bytes: Optional[float]
    peak_bytes: Optional[float]


class _SavedBytes:
    """Pack hook of torch.autograd.graph.saved_tensors_hooks: the bytes
    of each storage autograd saves, once, beyond the storages in
    `known`."""

    def __init__(self, known):
        self.seen = {t.untyped_storage().data_ptr() for t in known}
        self.total = 0

    def pack(self, t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in self.seen:
            self.seen.add(ptr)
            self.total += t.untyped_storage().nbytes()
        return t


def memory_stats(fn, *args, resident=()) -> MemoryStats:
    """Run fn(*args) once and report its MemoryStats (see there); the
    remat planner's oracle. `resident` is a nest of the tensors fn reads
    besides its arguments. Never raises: a call that raises reports None
    fields (torch.cuda.OutOfMemoryError included), and the planner never
    chooses such a candidate."""
    leaves = [t for t in nest.flatten((args, resident)) if torch.is_tensor(t)]
    arg_b = float(tensor_bytes(leaves))
    device = next((t.device for t in leaves), torch.device("cpu"))
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            with count_bytes() as counted:
                out = fn(*args)
            torch.cuda.synchronize(device)
            peak = float(torch.cuda.max_memory_allocated(device))
            temp = peak - arg_b
        else:
            saved = _SavedBytes(leaves)
            with count_bytes() as counted, \
                    torch.autograd.graph.saved_tensors_hooks(saved.pack,
                                                             lambda t: t):
                out = fn(*args)
            temp = float(saved.total)
            peak = None
        out_b = float(tensor_bytes(out))
    except Exception:  # never sinks a run; OOM included
        log.debug("memory_stats run failed", exc_info=True)
        return MemoryStats(None, arg_b, None, None, None)
    if peak is None:
        peak = arg_b + out_b + temp
    return MemoryStats(
        bytes_accessed=float(counted.total) if counted.total else None,
        argument_bytes=arg_b, output_bytes=out_b, temp_bytes=temp,
        peak_bytes=peak)
