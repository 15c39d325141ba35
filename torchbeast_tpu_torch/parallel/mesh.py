"""The learner's device mesh (counterpart of torchbeast_tpu/parallel/
mesh.py).

The reference builds a `jax.sharding.Mesh` over its chips with a `data`
axis (the batch is sharded along it, params are replicated) and inner
`model`, `seq`, `expert` and `pipe` axes nested inside it. The port's Mesh
is the same grid of devices, held as a numpy array of `torch.device`s of
this process, with the axis names and sizes the reference reports. The
grid is (data, model, seq, pipe, expert), the inner axes in the
reference's order (`pipe` never with `seq` or `expert` above 1), and
`axis_names`, `shape` and `devices` report `seq`, `pipe` and `expert`
only above 1, as the reference's mesh has those axes only then: (data,
model), (data, model, seq), (data, model, expert), (data, model, seq,
expert) and (data, model, pipe).

Each data row is one replica of the learner (parallel/dp.py), whose
inner axes are its devices by role: `model_devices(row)` run its
head and FFN groups (parallel/tp.py), `seq_devices(row)` its sequence
blocks (models/transformer.py's sequence-parallel attention),
`pipe_devices(row)` its pipeline stages (parallel/pp.py),
`expert_devices(row)` its expert groups (parallel/ep.py). `row(i)` is
data row i alone, a data-1 mesh: the mesh a replica's pipelined model
runs its GPipe over.

Devices: the CUDA devices, or the CPU. A CPU "device" is the host itself;
the number of them follows what the reference's CPU device count follows,
`--xla_force_host_platform_device_count=N` in XLA_FLAGS (the tests set 8),
else 1. Shards on CPU devices are separate model replicas in one process,
updated one after the other.

Across processes (dp.initialize_distributed) the mesh's `data` axis spans
every process: `shape["data"]` is the global count, `devices` this
process's part of it, and `group` the torch.distributed group the
gradient sum runs over (the default group whenever one is up, of any
size: a group of one process runs its collectives too). The inner axes
stay within a process, as the reference keeps them innermost.
"""

import os
import re
from typing import Optional, Sequence

import numpy as np
import torch

def cpu_device_count() -> int:
    """The CPU device count of the reference's backend: the
    --xla_force_host_platform_device_count of XLA_FLAGS, else 1."""
    m = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                  os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def visible_devices(platform: Optional[str] = None) -> list:
    """This process's devices of `platform` ("cuda" or "cpu"); None takes
    the CUDA devices when there are any, else the CPU, as the reference's
    default backend does. The drivers always name the platform of the
    device they selected."""
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if platform == "cpu":
        return [torch.device("cpu")] * cpu_device_count()
    raise ValueError(f"platform must be 'cuda' or 'cpu', got {platform!r}")


def _process_group():
    """(world size, group) of the default torch.distributed group, or
    (1, None) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.group.WORLD
    return 1, None


AXES = ("data", "model", "seq", "pipe", "expert")


class Mesh:
    """A (data, model, seq, pipe, expert) grid of this process's
    devices; see the module docstring. `process_count`
    processes hold one such grid each, in rank order along `data`. A
    mesh describes devices and is never copied: deepcopy of a model that
    holds one keeps the mesh."""

    def __init__(self, grid: np.ndarray, process_count: int = 1,
                 group=None):
        if grid.ndim != 5:
            raise ValueError(f"a mesh grid is (data, model, seq, pipe, "
                             f"expert), got {grid.ndim} axes")
        self.grid = grid
        self.process_count = process_count
        self.group = group

    def __deepcopy__(self, memo):
        return self

    def _inner(self) -> tuple:
        """The inner axes the reference's mesh has: `model` always,
        `seq`, `pipe` and `expert` above 1."""
        return ("model",) + tuple(
            axis for axis, n in zip(AXES[2:], self.grid.shape[2:]) if n > 1)

    @property
    def axis_names(self) -> tuple:
        return ("data",) + self._inner()

    @property
    def devices(self) -> np.ndarray:
        """The grid with the axes of `axis_names`, as the reference's
        mesh.devices."""
        names = self.axis_names
        drop = tuple(i for i, axis in enumerate(AXES) if axis not in names)
        return self.grid.squeeze(axis=drop) if drop else self.grid

    @property
    def shape(self) -> dict:
        shape = {"data": self.grid.shape[0] * self.process_count,
                 "model": self.grid.shape[1]}
        for axis, n in zip(AXES[2:], self.grid.shape[2:]):
            if n > 1:
                shape[axis] = n
        return shape

    @property
    def local_devices(self) -> list:
        """This process's data shards' devices (each row's first), lead
        first."""
        return list(self.grid[:, 0, 0, 0, 0])

    def model_devices(self, row: int) -> list:
        """The `model` axis of this process's data row `row`."""
        return list(self.grid[row, :, 0, 0, 0])

    def seq_devices(self, row: int) -> list:
        """The `seq` axis of this process's data row `row`."""
        return list(self.grid[row, 0, :, 0, 0])

    def pipe_devices(self, row: int) -> list:
        """The `pipe` axis of this process's data row `row`."""
        return list(self.grid[row, 0, 0, :, 0])

    def expert_devices(self, row: int) -> list:
        """The `expert` axis of this process's data row `row`."""
        return list(self.grid[row, 0, 0, 0, :])

    def row(self, row: int) -> "Mesh":
        """Data row `row` alone: a mesh of data 1 with the row's inner
        axes, in this process, without a group."""
        return Mesh(self.grid[row:row + 1])

    def spans_cards(self) -> bool:
        """Whether a data row holds more than one distinct device: its
        step then copies between cards and runs eagerly
        (parallel/dp.py)."""
        return any(len(set(row.reshape(-1))) > 1 for row in self.grid)

    @property
    def lead(self) -> torch.device:
        return self.grid[0, 0, 0, 0, 0]

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices={self.local_devices}, "
                f"processes={self.process_count})")


def create_mesh(
    n_devices: Optional[int] = None,
    model_parallelism: int = 1,
    devices: Optional[Sequence] = None,
    expert_parallelism: int = 1,
    seq_parallelism: int = 1,
    pipe_parallelism: int = 1,
    platform: Optional[str] = None,
) -> Mesh:
    """The (data, model[, seq][, pipe][, expert]) mesh over the first
    `n_devices` devices, with the reference's checks and error texts.

    `n_devices` is the total count, over every process when a process
    group is up (each process takes n / world of its own devices).
    `devices` overrides this process's visible devices (visible_devices
    of `platform`). An explicit list may name one device twice: two
    shards on one card, each a replica of its own, run the same sharded
    update, reduce and apply that two cards would (chip_smoke.py does
    this on a one-card machine; nothing else should).
    Each data row is model x seq x pipe x expert consecutive devices, in
    that order (the reference's reshape; seq and pipe are never both
    above 1)."""
    world, group = _process_group()
    if devices is None:
        devices = visible_devices(platform)
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices) * world:
            raise ValueError(
                f"Requested a {n_devices}-device mesh but only "
                f"{len(devices) * world} devices are visible"
            )
        if n_devices % world != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by the {world} "
                "processes"
            )
        devices = devices[:n_devices // world]
    if pipe_parallelism > 1 and (
        expert_parallelism > 1 or seq_parallelism > 1
    ):
        raise ValueError(
            "pipe_parallelism does not combine with expert/seq axes "
            "(the GPipe shard_map owns its schedule; only a data axis "
            "composes with it)"
        )
    n = len(devices)
    inner = (
        model_parallelism * expert_parallelism * seq_parallelism
        * pipe_parallelism
    )
    if n % inner != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallelism="
            f"{model_parallelism} x expert_parallelism="
            f"{expert_parallelism} x seq_parallelism={seq_parallelism}"
            f" x pipe_parallelism={pipe_parallelism}"
        )
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        grid[i] = torch.device(d)
    return Mesh(grid.reshape(n // inner, model_parallelism,
                             seq_parallelism, pipe_parallelism,
                             expert_parallelism),
                process_count=world, group=group)
