"""The data-parallel learner (counterpart of torchbeast_tpu/parallel/dp.py).

The reference jits its update over a mesh whose `data` axis shards the
batch along B while params and optimizer state stay replicated; XLA
inserts the gradient all-reduce. The port does the same by hand:

- one replica of the model per data shard, on the shard's device (the
  lead's is the caller's model, which the optimizer holds);
- each shard runs learner.compute_loss and the backward pass over its
  columns of the batch on its own device. The losses are sums over the
  batch, so the full-batch gradient is the SUM of the shard gradients
  (not their mean, as DDP's default would make it);
- the lead sums them in f32 in a fixed order, shard 0 first, then the
  others in order, and across processes all-reduces the sum
  (`torch.distributed`, SUM); bf16 gradients are widened to f32 first;
- the optimizer (the --opt_impl xla chain, learner.RMSpropChain) runs
  once on the lead on the summed gradient: the clip takes the global norm
  of the sum, and the LR decay and the entropy anneal tick once per
  update;
- every replica then takes the lead's params and update count by copies,
  so all replicas are bitwise equal after every update.

The stats are the global batch's: the losses and episode sums added over
the shards (and processes), the grad norm that of the summed gradient.
The recursion of V-trace, the LSTM and the attention are per column, so
the sharded update computes the one-device update on the whole batch up
to the order of the sums (the reference's docstring promise).

On the card each shard's forward and backward is one CUDA graph on its
device, and the reduce and the optimizer one more on the lead
(graphs.CapturedStep), captured at the first call. A gloo group's
collectives cannot be captured, so under gloo the lead's part runs
eagerly; NCCL's can. On the CPU everything runs eagerly.

The fused RMSprop tail (--opt_impl pallas) is refused, as the reference
refuses it on every learner mesh.

A mixture-of-experts model routes over the whole batch, as the
reference's sharded forward does: its capacity, slots and load-balance
loss are the whole batch's (models/moe.py, `routing`). Each MoE layer of
each shard's forward hands its [K, E] pick counts to a RoutingExchange,
which returns every shard's: within a process a copy of the local
shards' counts, across processes an all_gather on the mesh's group.
That exchange sits in the middle of the forward, so the local shards run
in lockstep, one thread each, and the step runs eagerly (no CUDA graph
can hold one shard's forward while it waits on another's). The
backward exchanges nothing.

Sharded storage, as the reference's polybeast places its params on the
merged EP and TP rules. On a mesh with an `expert` axis data row i's
replica keeps slot j of each expert kernel resident on the row's expert
device j (parallel/ep.shard_expert_params), and on one with a `model`
axis slot j of each leaf the Megatron pairing splits on the row's model
device j (parallel/tp.set_model_devices); the replicated leaves stay
whole on the row's device (models/sharded.py). The lead's optimizer is
realigned with row 0's slots (sharded.shard_optimizer): each slot device
of row 0 holds its slices' RMSprop state, and no whole copy of a split
leaf stays in the params, the gradients or the state. The gradient of a
leaf is summed over `data` on row 0's device of that leaf (its slot
device, or the lead), shard 0 first; one flat f32 buffer a device holds
that device's sums (the lead's also the stats) and is all-reduced across
processes on the mesh's group. The optimizer then applies each slice
where it lies, and every other row's slots take row 0's by copies, slot
by slot. On a mesh with a `pipe` axis replica i's pipelined model runs
its GPipe over the row's pipe devices (parallel/pp.py: the replica's
model holds mesh.row(i)), its stage params replicated as the reference's
drivers keep them; on one with a `seq` axis replica i's transformer
blocks run their attention sequence-parallel over the row's seq devices
(models/transformer.set_seq_devices, ops/attention.py's ring and
Ulysses).

Graph or eager is chosen from the device list, up front: when every
device of each data row is one card, each shard's step stays one CUDA
graph on it; when a row spans cards (its model, pipe or expert devices
are other cards), the step runs eagerly, since one shard's graph cannot
launch on several cards. A capture that fails raises.

Multi-process: `initialize_distributed` joins the processes (nccl for
CUDA devices, gloo for the CPU), then mesh.create_mesh spans them. Each
process passes its LOCAL rows of the batch, as the reference's
shard_batch takes process-local data.
"""

import contextlib
import copy
import functools
import logging
import os
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from torchbeast_tpu_torch import graphs, nest, telemetry
from torchbeast_tpu_torch import learner as learner_lib
from torchbeast_tpu_torch.models import moe, sharded
from torchbeast_tpu_torch.models.transformer import set_seq_devices
from torchbeast_tpu_torch.parallel import ep, pp, tp
from torchbeast_tpu_torch.parallel.mesh import Mesh

log = logging.getLogger(__name__)

PALLAS_REFUSAL = (
    "--opt_impl pallas does not compose with --num_learner_devices > 1 "
    "yet (the fused tail is a per-chip kernel; its sharded-update story "
    "is the Sebulba item's)"
)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """torch.distributed.init_process_group with the reference's env-var
    fallbacks: TORCHBEAST_COORDINATOR (host:port of process 0),
    TORCHBEAST_NUM_PROCESSES (default 1) and TORCHBEAST_PROCESS_ID
    (default 0; 0 is a valid id). `backend` defaults to nccl when CUDA is
    available, else gloo; the drivers pass the one of the device they
    selected. Returns False (single-process mode) when no coordinator is
    configured."""
    coordinator_address = coordinator_address or os.environ.get(
        "TORCHBEAST_COORDINATOR"
    )
    if coordinator_address is None:
        log.info("No coordinator configured; single-process mode.")
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("TORCHBEAST_NUM_PROCESSES", 1))
    if process_id is None:  # NB: 0 is a valid id — test None explicitly
        process_id = int(os.environ.get("TORCHBEAST_PROCESS_ID", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id))
    log.info("Joined %d processes as rank %d (%s, %s)", int(num_processes),
             int(process_id), backend, address)
    return True


def fleet_strategy(device) -> str:
    """How a multi-host fleet composes its learner, from the device the
    driver selected (a torch.device or its type), never from a probe:

    - "xla" on CUDA (the reference's name for the process-group path,
      kept for the telemetry's `fleet` record): the hosts join one
      torch.distributed group (fleet.fleet_rendezvous, NCCL), and one
      learner mesh's `data` axis runs host-major over every host's
      learner devices, the multi-process DP learner of this module;
    - "wire" on the CPU: no process group; each host updates over its
      local learner devices and the fleet coordinator's control plane
      averages the params after each dispatch
      (fleet.FleetCoordinator.sync_params), as the reference does on
      its CPU backend."""
    kind = getattr(device, "type", device)
    return "xla" if kind == "cuda" else "wire"


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Sharded:
    """A batch split over a mesh's local shards: `shards[i]` is
    (batch_i, agent_state_i) on the i-th local device. A ParallelUpdate
    takes it as it is (ShardedTarget.merge hands one over)."""

    def __init__(self, shards):
        self.shards = list(shards)

    @property
    def nbytes(self) -> int:
        return sum(int(t.numel() * t.element_size())
                   for t in nest.flatten([list(s) for s in self.shards]))


def shard_batch(mesh: Mesh, batch, initial_agent_state,
                leading_axes: int = 0) -> Sharded:
    """Split a [T+1, B, ...] batch and its agent state (batch axis 1 of
    every leaf: the LSTM's [L, B, H], the transformer's memory) over the
    mesh's local devices, in order, each part contiguous on its device.
    `leading_axes=1` splits [K, T+1, B, ...] superstep stacks (B one axis
    further in). numpy leaves become tensors. In a multi-process run the
    batch is this process's rows."""
    devices = mesh.local_devices
    n = len(devices)
    axis = leading_axes + 1

    def parts(v):
        t = torch.as_tensor(v)
        rows = t.shape[axis]
        if rows % n != 0:
            raise ValueError(
                f"batch of {rows} rows not divisible by the learner "
                f"mesh's {n} local data shards")
        return t.chunk(n, dim=axis)

    def split(tree):
        leaves = [parts(v) for v in nest.flatten(tree)]
        return [nest.pack_as(tree, [p[i].to(devices[i]).contiguous()
                                    for p in leaves]) for i in range(n)]

    return Sharded(zip(split(batch), split(initial_agent_state)))


def replicate(mesh: Mesh, tree) -> list:
    """One copy of `tree` (a nest of tensors) on each local device."""
    return [nest.map(lambda t: torch.as_tensor(t).to(d, copy=True), tree)
            for d in mesh.local_devices]


def _copy_all(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]):
    """dst[j] <- src[j]: one fused copy when every tensor is on one
    device, one copy per tensor otherwise."""
    if len({t.device for t in list(dst) + list(src)}) == 1:
        torch._foreach_copy_(list(dst), list(src))
    else:
        for d, s in zip(dst, src):
            d.copy_(s)


class RoutingExchange:
    """The count exchange of whole-batch MoE routing (models/moe.
    RoutingScope) among a mesh's shards. `shard(i)` is local shard i's
    exchange: counts [K, E] -> (table [S, K, E] of every shard's counts
    in global shard order, i's global index). The local shards meet at a
    barrier; shard 0 stacks their counts on the lead and, with a process
    group, all_gathers the stack, process rank-major as the data axis
    runs. `run` calls the shards' functions on one thread each; a shard's
    error breaks the barrier for the others and is raised."""

    def __init__(self, mesh: Mesh, timeout_s: float = 600.0):
        self.n = len(mesh.local_devices)
        self.group = mesh.group
        self.first = (dist.get_rank(self.group) * self.n
                      if self.group is not None else 0)
        self.lead = mesh.lead
        self._barrier = threading.Barrier(self.n, timeout=timeout_s)
        self._posted = [None] * self.n
        self._table = None

    def shard(self, i: int):
        return functools.partial(self._exchange, i)

    def _exchange(self, i, counts):
        self._posted[i] = counts
        self._barrier.wait()
        if i == 0:
            table = torch.stack([c.to(self.lead) for c in self._posted])
            if self.group is not None:
                parts = [torch.empty_like(table) for _ in
                         range(dist.get_world_size(self.group))]
                dist.all_gather(parts, table, group=self.group)
                table = torch.cat(parts)
            self._table = table
        self._barrier.wait()
        return self._table, self.first + i

    def run(self, fns: Sequence[Callable]) -> list:
        if len(fns) == 1:
            return [fns[0]()]
        results = [None] * len(fns)
        errors = []

        def body(i):
            try:
                results[i] = fns[i]()
            except BaseException as e:  # noqa: BLE001  raised below
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(i,),
                                    name=f"shard{i}")
                   for i in range(len(fns))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            self._barrier.reset()
            first = [e for e in errors
                     if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or errors)[0]
        return results


class ParallelLearner:
    """The replicas and the reduce/apply of a data-parallel update (see
    the module docstring). Build it after a checkpoint was loaded into
    `model` and `optimizer`: it copies the lead's params and count to
    every replica."""

    def __init__(self, model, optimizer, hp: learner_lib.HParams,
                 mesh: Mesh):
        if not isinstance(optimizer, learner_lib.RMSpropChain):
            raise ValueError(PALLAS_REFUSAL)
        params = list(model.parameters())
        if len(params) != len(optimizer.params) or any(
                p is not q for p, q in zip(params, optimizer.params)):
            raise ValueError("the optimizer must hold model.parameters()")
        self.mesh = mesh
        self.devices = mesh.local_devices
        self.lead = self.devices[0]
        if params[0].device != self.lead:
            raise ValueError(f"the model is on {params[0].device}, the "
                             f"mesh's lead device is {self.lead}")
        self.hp = hp
        self.optimizer = optimizer
        self.group = mesh.group
        self.anneal = learner_lib.entropy_schedule(hp)
        self.replicas = [model] + [copy.deepcopy(model).to(d)
                                   for d in self.devices[1:]]
        for i, replica in enumerate(self.replicas):
            if "expert" in mesh.shape:
                ep.shard_expert_params(replica, mesh.expert_devices(i))
            if mesh.shape["model"] > 1:
                tp.set_model_devices(replica, mesh.model_devices(i))
            if "seq" in mesh.shape:
                set_seq_devices(replica, mesh.seq_devices(i))
            if "pipe" in mesh.shape:
                pp.set_pipeline(replica, mesh.row(i))
        if sharded.is_sharded(model):
            sharded.shard_optimizer(optimizer, model)
        # A row over several cards cannot be one shard's CUDA graph.
        self.spans_cards = mesh.spans_cards()
        self.params = [list(r.parameters()) for r in self.replicas]
        # Where each leaf's gradient is summed and applied: row 0's device
        # of it (its slot's, or the lead).
        self.homes = [p.device for p in self.params[0]]
        # Whole-batch routing needs the exchange when the batch is split.
        self.exchange = (
            RoutingExchange(mesh) if mesh.shape["data"] > 1 and any(
                isinstance(m, moe.MoEFFN) for m in model.modules())
            else None)
        self.counts = [optimizer.device_count] + [
            torch.zeros_like(optimizer.device_count, device=d)
            for d in self.devices[1:]]
        self.keys = None  # the stats' names, in compute_loss's order
        self.sync()

    @property
    def num_shards(self) -> int:
        return len(self.replicas)

    def sync(self) -> None:
        """Every replica takes the lead's params and update count, slot
        by slot."""
        with torch.no_grad():
            for i in range(1, self.num_shards):
                _copy_all(self.params[i], self.params[0])
                self.counts[i].copy_(self.counts[0])

    def routing(self, i: int):
        """The whole-batch routing scope of one forward of local shard i
        (models/moe.routing over the exchange); a null context for a
        dense model or an unsplit batch."""
        if self.exchange is None:
            return contextlib.nullcontext()
        return moe.routing(self.exchange.shard(i))

    def grads(self, i: int, batch, initial_agent_state):
        """Shard i's loss and gradient on its device: (the gradients of
        replica i's params, its stats as one f32 vector in `keys`
        order)."""
        ecost = (None if self.anneal is None
                 else self.anneal.on_device(self.counts[i]))
        with self.routing(i):
            total_loss, stats = learner_lib.compute_loss(
                self.replicas[i], batch, initial_agent_state, self.hp,
                entropy_cost=ecost)
        grads = torch.autograd.grad(total_loss, self.params[i])
        if self.keys is None:
            self.keys = list(stats)
        with torch.no_grad():
            vec = torch.stack([stats[k].detach().float()
                               for k in self.keys])
        return list(grads), vec

    def apply(self, grads_per_shard, vecs) -> torch.Tensor:
        """On row 0: each gradient summed in f32 on its home device
        (shard 0 first, then the others in order; all-reduced across
        processes), the optimizer step on the sums, and the stats the
        same way on the lead. Returns one f32 vector: the summed stats in
        `keys` order, then the grad norm."""
        lead = self.lead
        with torch.no_grad():
            summed = [g.float() for g in grads_per_shard[0]]
            vec = vecs[0]
            for grads, v in zip(grads_per_shard[1:], vecs[1:]):
                summed = [s + g.to(s.device).float()
                          for s, g in zip(summed, grads)]
                vec = vec + v.to(lead)
            # One flat f32 buffer a device, with or without a group: the
            # optimizer then sees the same (contiguous) layout either way,
            # and its norm's reduction order with it. The lead's carries
            # the stats.
            order = list(dict.fromkeys([lead] + self.homes))
            for dev in order:
                idx = [i for i, h in enumerate(self.homes) if h == dev]
                tail = [vec] if dev == lead else []
                flat = torch.cat([summed[i].reshape(-1) for i in idx]
                                 + tail)
                if self.group is not None:
                    dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                    group=self.group)
                parts = flat.split([summed[i].numel() for i in idx]
                                   + [t.numel() for t in tail])
                for i, p in zip(idx, parts):
                    summed[i] = p.view(summed[i].shape)
                if tail:
                    vec = parts[-1]
            sumsq = self.optimizer.step(summed)
            return torch.cat([vec, torch.sqrt(sumsq).reshape(1)])

    def unpack(self, row: torch.Tensor) -> dict:
        return {key: row[..., j]
                for j, key in enumerate(self.keys + ["grad_norm"])}

    def captures(self) -> bool:
        """Whether the shards' steps are CUDA graphs by default: on a
        CUDA lead, without a routing exchange, each row on one card."""
        return (self.lead.type == "cuda" and self.exchange is None
                and not self.spans_cards)

    def capturable_apply(self) -> bool:
        """Whether the lead's reduce and update can be one CUDA graph:
        on a CUDA lead without a group or with an NCCL one."""
        return self.lead.type == "cuda" and (
            self.group is None or dist.get_backend(self.group) == "nccl")


class ShardedStep:
    """One data-parallel step: `shard_fns[i]()` -> (gradients, stats
    vector) of shard i on its device (ParallelLearner.grads over buffers
    the function closes over), then the lead's reduce and update
    (ParallelLearner.apply), then the replicas' sync. Returns the stats
    as a dict of 0-d f32 tensors on the lead.

    On a CUDA lead each shard function is one CUDA graph on its device
    (graphs.CapturedStep; `generators[i]` and `restores[i]` as it takes
    them), captured at the first call, whose gradients reach the lead by
    copies into buffers of the lead's when the shard's device is another;
    the lead's part is one more graph where capturable_apply() says so,
    else it runs eagerly. `capture=False` runs every part eagerly on the
    card too (the graphs' eager twin). `launches_per_replay` sums what one
    step's graphs launch of the port's kernels, `bytes_accessed` what
    their first warm-up runs accessed.

    A learner with a routing exchange (a MoE model over a split batch)
    runs its shard functions in lockstep (RoutingExchange.run), eagerly:
    `capture=True` raises for it. A learner whose rows span cards runs
    eagerly by default (ParallelLearner.captures)."""

    def __init__(self, learner: ParallelLearner, shard_fns: List[Callable],
                 generators=None, restores=None,
                 capture: Optional[bool] = None):
        self.learner = learner
        if learner.exchange is not None and capture:
            raise ValueError(
                "a MoE model's data-parallel step exchanges routing "
                "counts in the middle of the forward and runs eagerly; "
                "it cannot be captured")
        self.graphs = learner.captures() if capture is None else capture
        self._fns = list(shard_fns)
        n = len(self._fns)
        self._generators = list(generators or [None] * n)
        self._restores = list(restores or [()] * n)
        self._shard_graphs = None
        self._apply_graph = None
        self.launches_per_replay = {}
        self.bytes_accessed = None

    def capture(self) -> None:
        L = self.learner
        self._shard_graphs = [
            graphs.CapturedStep(fn, dev, generator=gen, restore=restore)
            for fn, dev, gen, restore in zip(
                self._fns, L.devices, self._generators, self._restores)]
        # Row 0 reads a shard's graph outputs in place where each lies on
        # its home device, and another row's through staging buffers of
        # its own.
        self._staged = []
        for g in self._shard_graphs:
            grads, vec = g.out
            if vec.device == L.lead and all(
                    t.device == h for t, h in zip(grads, L.homes)):
                self._staged.append(None)
            else:
                with torch.no_grad():
                    self._staged.append((
                        [t.to(h, copy=True) for t, h in zip(grads, L.homes)],
                        vec.to(L.lead, copy=True)))
        inputs = [s if s is not None else g.out
                  for s, g in zip(self._staged, self._shard_graphs)]
        apply = lambda: L.apply([x[0] for x in inputs],  # noqa: E731
                                [x[1] for x in inputs])
        if L.capturable_apply():
            self._apply_graph = graphs.CapturedStep(
                apply, L.lead, optimizer=L.optimizer)
        else:
            self._apply_graph = None
            self._apply_eager = apply
        parts = self._shard_graphs + [g for g in (self._apply_graph,) if g]
        self.bytes_accessed = sum(g.bytes_accessed for g in parts)
        self.launches_per_replay = {}
        for g in parts:
            for w, k in g.launches_per_replay.items():
                self.launches_per_replay[w] = (
                    self.launches_per_replay.get(w, 0) + k)

    def __call__(self) -> dict:
        L = self.learner
        if not self.graphs:
            outs = (L.exchange.run(self._fns) if L.exchange is not None
                    else [fn() for fn in self._fns])
            row = L.apply([o[0] for o in outs], [o[1] for o in outs])
            L.sync()
            return L.unpack(row)
        if self._shard_graphs is None:
            self.capture()
        for g, staged in zip(self._shard_graphs, self._staged):
            grads, vec = g()
            if staged is not None:
                with torch.no_grad():
                    _copy_all(staged[0], grads)
                    staged[1].copy_(vec)
        if self._apply_graph is not None:
            row = self._apply_graph().clone()
            L.optimizer.advance_host_count(1)
        else:
            row = self._apply_eager()
        L.sync()
        return L.unpack(row)


class ParallelUpdate:
    """The data-parallel learner dispatch, the port's
    make_parallel_update_step: (batch, initial_agent_state) -> stats of
    `superstep_k` updates, like learner.make_update_dispatch's (at K > 1
    over [K, T+1, B, ...] stacks, with [K] stats). The batch is this
    process's rows on any device (shard_batch splits it), or a Sharded
    already split (ShardedTarget.merge's; the state argument is then
    ignored). Each of the K updates runs its own reduce and apply, so K
    updates in one dispatch equal K dispatches of one.

    Each shard's inputs are copied into buffers of its device that the
    step reads (a CUDA graph's static inputs on the card)."""

    def __init__(self, learner: ParallelLearner, superstep_k: int = 1,
                 capture: Optional[bool] = None):
        if superstep_k < 1:
            raise ValueError(f"superstep_k must be >= 1, got {superstep_k}")
        self.learner = learner
        self.k = superstep_k
        self._capture = capture
        self._step = None
        self._static = None

    @property
    def mesh(self) -> Mesh:
        return self.learner.mesh

    @property
    def captures_graphs(self) -> bool:
        if self._capture is not None:
            return self._capture
        return self.learner.captures()

    @property
    def launches_per_replay(self) -> dict:
        return self._step.launches_per_replay if self._step else {}

    @property
    def bytes_accessed(self):
        return None if self._step is None else self._step.bytes_accessed

    def _build(self, shards) -> None:
        L = self.learner
        self._static = [
            (nest.map(lambda t: t.detach().clone(), b),
             nest.map(lambda t: t.detach().clone(), s))
            for b, s in shards]
        fns = [
            (lambda i=i, b=b, s=s: L.grads(i, b, s))
            for i, (b, s) in enumerate(self._static)]
        self._step = ShardedStep(L, fns, capture=self._capture)

    def _update(self, shards) -> dict:
        if self._step is None:
            self._build(shards)
        with torch.no_grad():
            for (sb, ss), (b, s) in zip(self._static, shards):
                statics, values = nest.flatten((sb, ss)), nest.flatten((b, s))
                if len(statics) != len(values):
                    raise ValueError(
                        f"{len(values)} input leaves for a step built "
                        f"with {len(statics)}")
                for static, value in zip(statics, values):
                    graphs._fill(static, value, "sharded input")
        return self._step()

    def _updates(self, batch, initial_agent_state) -> list:
        """The shards of each of the dispatch's K updates, in order."""
        if isinstance(batch, Sharded):
            sharded = batch
        else:
            sharded = shard_batch(self.mesh, batch, initial_agent_state,
                                  leading_axes=1 if self.k > 1 else 0)
        if self.k == 1:
            return [sharded.shards]
        got = nest.front(sharded.shards[0][0]).shape[0]
        if got != self.k:
            raise ValueError(f"a K={self.k} superstep got a stack of {got}")
        return [[(nest.map(lambda v: v[j], b), nest.map(lambda v: v[j], s))
                 for b, s in sharded.shards] for j in range(self.k)]

    def capture(self, batch, initial_agent_state) -> None:
        """Build the step from example inputs and, on the card, capture
        its graphs now (their warm-up updates are undone), as
        graphs.CapturedUpdate.capture does."""
        self._build(self._updates(batch, initial_agent_state)[0])
        if self._step.graphs:
            self._step.capture()

    def __call__(self, batch, initial_agent_state):
        updates = self._updates(batch, initial_agent_state)
        if self.k == 1:
            return self._update(updates[0])
        per_update = [self._update(shards) for shards in updates]
        return {key: torch.stack([u[key] for u in per_update])
                for key in per_update[0]}


def make_parallel_update_step(model, optimizer, hp: learner_lib.HParams,
                              mesh: Mesh, superstep_k: int = 1,
                              capture: Optional[bool] = None
                              ) -> ParallelUpdate:
    """Data-parallel version of learner.make_update_dispatch over `mesh`
    (see ParallelUpdate and the module docstring). `optimizer` must be
    the --opt_impl xla chain over model.parameters(); `model` lives on
    the mesh's lead device. `capture` as ShardedStep takes it."""
    return ParallelUpdate(ParallelLearner(model, optimizer, hp, mesh),
                          superstep_k, capture)


class ShardedTarget:
    """The IMPACT target network (--loss impact) of a data-parallel
    learner: one learner.TargetNetwork per shard over that shard's
    replica, so each shard's target forward runs on its own device (a
    copy of the replica, so under sharded storage its split leaves stay
    slices on the row's slots, as the reference's sharded copy does).
    They publish the same versions from bitwise-equal params; the lead's
    store is `store` and writes the "learner.target" series. `merge`
    splits the batch (shard_batch) and puts each shard's target outputs
    on its part, returning a Sharded for the dispatch. A MoE model's
    target forwards route over the whole batch as the learner's do: the
    shards run them in lockstep, eagerly, each forward (each of a
    superstep's K) in a routing scope of its own."""

    def __init__(self, update: ParallelUpdate, refresh_updates: int,
                 superstep_k: int = 1, registry=None):
        self.update = update
        learner = update.learner
        self.targets = [
            learner_lib.TargetNetwork(
                replica, refresh_updates, superstep_k=superstep_k,
                registry=(registry if i == 0
                          else telemetry.MetricsRegistry()))
            for i, replica in enumerate(learner.replicas)]
        self.store = self.targets[0].store
        if learner.exchange is not None:
            for i, t in enumerate(self.targets):
                t._forward = _routed_target_forward(
                    t.model, superstep_k,
                    functools.partial(learner.routing, i))

    def maybe_refresh(self, updates_done: int, params=None) -> bool:
        """Each shard's target takes its own replica's params when a
        refresh is due (the lead's `params` argument is not needed: the
        replicas equal it)."""
        published = [t.maybe_refresh(updates_done, p) for t, p in
                     zip(self.targets, self.update.learner.params)]
        return published[0]

    def _split(self, batch, initial_agent_state) -> Sharded:
        return shard_batch(self.update.mesh, batch, initial_agent_state,
                           leading_axes=1 if self.update.k > 1 else 0)

    def _each(self, method, batch, initial_agent_state) -> list:
        fns = [functools.partial(getattr(t, method), b, s)
               for t, (b, s) in zip(
                   self.targets,
                   self._split(batch, initial_agent_state).shards)]
        exchange = self.update.learner.exchange
        return (exchange.run(fns) if exchange is not None
                else [fn() for fn in fns])

    def capture(self, batch, initial_agent_state) -> None:
        self._each("capture", batch, initial_agent_state)

    def merge(self, batch, initial_agent_state) -> Sharded:
        shards = self._split(batch, initial_agent_state).shards
        merged = self._each("merge", batch, initial_agent_state)
        return Sharded([(m, s) for m, (_, s) in zip(merged, shards)])


def _routed_target_forward(model, superstep_k: int, routing):
    """learner.target_forward_body of `model`, eager, each forward (one,
    or one per K slice) inside `routing()`."""
    one = learner_lib.target_forward_body(model)

    def forward(batch, initial_agent_state):
        if superstep_k == 1:
            with routing():
                return one(batch, initial_agent_state)
        outs = []
        for j in range(superstep_k):
            with routing():
                outs.append(one(nest.map(lambda v: v[j], batch),
                                nest.map(lambda s: s[j],
                                         initial_agent_state)))
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    return forward


def check_consistent_restore(mesh: Mesh, step: int, params) -> None:
    """Across processes: every process must have restored the same
    checkpoint (the reference's startup check). A process that resumed
    other params would sum gradients of other params and hang at the end
    when the update counts part; fail loudly at startup instead. `params`
    may be whole leaves or a sharded learner's slices (the sum of
    squares is the same tree's either way)."""
    if mesh.group is None or mesh.process_count == 1:
        return
    with torch.no_grad():
        sumsq = sum(float(torch.sum(p.detach().double() ** 2))
                    for p in params)
    mine = torch.tensor([float(step), sumsq], dtype=torch.float64,
                        device=mesh.lead)
    gathered = [torch.zeros_like(mine) for _ in range(mesh.process_count)]
    dist.all_gather(gathered, mine, group=mesh.group)
    table = np.stack([g.cpu().numpy() for g in gathered])
    if not np.allclose(table, table[0], rtol=1e-9):
        raise RuntimeError(
            "Hosts restored inconsistent checkpoints "
            f"(step/param fingerprints {table.tolist()}); the savedir "
            "must be a shared filesystem so every host resumes the "
            "lead's checkpoint.")

