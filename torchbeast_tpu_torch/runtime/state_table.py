"""Device-resident agent-state table for the async acting path (the port
of torchbeast_tpu/runtime/state_table.py).

Recurrent state lives on the card in one `[.., num_slots+1, ..]` tensor
per state leaf, keyed by slot id (one slot per actor). One `step`
gathers the batch's states by slot index (`index_select`), runs the
bound acting function, and scatters back (`index_copy_`) only the rows
whose `advance` flag is set, writing the current state back for the
others. Per env step the only host<->card traffic is observations down
and actions/logits up; agent state never crosses.

Contract, as the reference's:

- Slot `num_slots` is a TRASH slot: bucket padding scatters its rows
  there, so padded rows never touch a real slot.
- Real slot ids are unique within a batch (each actor owns one slot and
  has at most one request in flight).
- `advance=False` rows write their current state back (a no-op write).
- Every table access runs under one lock, under torch.no_grad(), on the
  calling thread's current stream. The table is updated in place, so a
  step that raises after it began may have written some rows: the table
  is then POISONED, every further call raises StateTablePoisonedError,
  and `rebuild()` (the inference supervisor's recovery) puts every slot
  back at the initial state, in the same tensors.

On the card the driver calls `capture` before its threads start: one
CUDA graph per bucket size holds the whole step (the slot gather, the
acting forward with its sampling, the merge and the scatter), reading
the slot ids, advance flags and env inputs from static buffers that each
step fills from pinned host memory. The graphs address the table's
tensors, which is why it never moves. Once captured, every step replays
the graph of its size (under the caller's `replay_lock` too), and a size
without one raises.

Replica serving (serving/replica.py) steps the same rows with another
set of params: `bind_context(act_fn, params)` names a params buffer,
allocated once, and the acting function that reads it; a step given a
`context` = (version, params tree) first copies the tree into the
buffer when the buffer holds another version, then acts. On the card
`capture_context` captures that step as a second set of graphs, one per
bucket, bound to the buffer and to the same rows, before any thread
starts; a poison and `rebuild` leave both sets valid, since `rebuild`
writes into the same storage. The copy and the replay run under one
hold of the table lock (and the replay lock), so no poison lands between
them.
"""

# beastlint: hot-module — the table step runs once per acting batch.

import contextlib
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from torchbeast_tpu_torch import graphs, nest
from torchbeast_tpu_torch import telemetry
from torchbeast_tpu_torch.runtime.errors import (  # noqa: F401
    StateTablePoisonedError,
)
from torchbeast_tpu_torch.runtime.inference import to_device, to_host


class DeviceStateTable:
    """On-card `[.., num_slots+1, ..]` agent-state tensors keyed by slot.

    act_fn(ctx, env_outputs, agent_state) -> (outputs, new_agent_state)
        Runs inside the table's step on tensors on the table's device.
        `ctx` is whatever `context_fn()` returns (polybeast: the acting
        model and its sampling generator).
    """

    def __init__(
        self,
        initial_state: Any,
        num_slots: int,
        act_fn: Callable,
        context_fn: Optional[Callable] = None,
        batch_dim: int = 1,
        input_filter: Optional[Callable] = None,
    ):
        """`initial_state`: a nest of tensors, each of size 1 along
        `batch_dim`, on the device the table lives on."""
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        leaves = nest.flatten(initial_state)
        if not leaves:
            raise ValueError(
                "DeviceStateTable needs a non-empty state nest; "
                "feed-forward models should use the legacy stateless path"
            )
        bd = batch_dim
        for leaf in leaves:
            if leaf.dim() <= bd or leaf.shape[bd] != 1:
                raise ValueError(
                    "initial_state leaves must have size 1 along "
                    f"batch_dim {bd}; got shape {tuple(leaf.shape)}"
                )
        self.num_slots = num_slots
        self.batch_dim = batch_dim
        self.device = leaves[0].device
        self._act_fn = act_fn
        self._context_fn = context_fn
        self._input_filter = input_filter
        self._lock = threading.Lock()
        _reg = telemetry.get_registry()
        self._tm_dispatches = _reg.counter("state_table.dispatches")
        self._tm_fetch_s = _reg.histogram("state_table.fetch_s")
        self._tm_read_slot_s = _reg.histogram("state_table.read_slot_s")
        self._initial = nest.map(lambda t: t.detach().clone(),
                                 initial_state)
        # Host copy: the actor pool hands it to rollouts as the boundary
        # state of freshly connected actors.
        self.initial_state_host = to_host(self._initial)
        # The table's tensors for its whole life (captured graphs address
        # them); `_table` is they, or None while poisoned.
        self._rows = self._fresh_table()
        self._table = self._rows
        self._graphs = {}  # batch size -> graphs.CapturedAct
        self._replay_lock = contextlib.nullcontext()
        # Replica serving: the acting function over the params buffer,
        # the buffer, the snapshot version it holds and its graphs.
        self._context_act_fn = None
        self._context_params = None
        self._context_version = None  # guarded-by: self._lock
        self._context_graphs = {}  # batch size -> graphs.CapturedAct

    def _fresh_table(self):
        """A new [.., num_slots+1, ..] table (+1: the trash slot), every
        slot at the initial state."""
        rows = self.num_slots + 1

        def expand(leaf):
            shape = list(leaf.shape)
            shape[self.batch_dim] = rows
            return leaf.expand(shape).contiguous()

        return nest.map(expand, self._initial)

    @property
    def trash_slot(self) -> int:
        """Slot id bucket padding scatters to (never read back)."""
        return self.num_slots

    @property
    def poisoned(self) -> bool:
        """True after a table-mutating step failed (see the module
        docstring); read under the table lock."""
        with self._lock:
            return self._table is None

    def poison(self) -> None:
        """Testing hook: put the table into the state a failed step
        leaves."""
        with self._lock:
            self._table = None

    def rebuild(self) -> None:
        """Recover from poisoning: a fresh table, every actor slot back
        at the initial state. Actors whose request was in the failed
        batch re-prime through their retry path; the others continue
        their unroll against a reset slot (a bounded glitch, like an
        episode boundary)."""
        with self._lock, torch.no_grad():
            for leaf, fresh in zip(nest.flatten(self._rows),
                                   nest.flatten(self._fresh_table())):
                leaf.copy_(fresh)
            self._table = self._rows

    def _require_alive(self):
        if self._table is None:
            raise StateTablePoisonedError(
                "DeviceStateTable is poisoned: a prior step/reset failed "
                "part way; rebuild() it (the inference supervisor does) "
                "before serving again"
            )

    def _ids(self, slots) -> torch.Tensor:
        return to_device(np.asarray(slots, np.int64).reshape(-1),
                         self.device)

    def _gather(self, table, ids):
        return nest.map(
            lambda leaf: leaf.index_select(self.batch_dim, ids), table)

    def _scatter(self, table, ids, values) -> None:
        for leaf, value in zip(nest.flatten(table), nest.flatten(values)):
            leaf.index_copy_(self.batch_dim, ids, value.to(leaf.dtype))

    def _advance(self, table, ids, advance_d, env_d, act):
        """Gather, `act(env_d, state)`, merge and scatter on the card;
        the outputs."""
        bd = self.batch_dim
        state = self._gather(table, ids)
        outputs, new_state = act(env_d, state)

        def merge(new, old):
            shape = [1] * new.dim()
            shape[bd] = advance_d.shape[0]
            return torch.where(advance_d.reshape(shape), new, old)

        merged = [merge(new, old) for new, old in zip(
            nest.flatten(new_state), nest.flatten(state))]
        self._scatter(table, ids, merged)
        return outputs

    def capture(self, sizes, env_example: Callable[[int], Any],
                generator=None, replay_lock=None) -> None:
        """Capture one CUDA graph of the whole step for each batch size in
        `sizes`, before any other thread launches CUDA work.
        `env_example(n)` gives env outputs padded to n; the warm-up runs
        put every row on the trash slot with advance False, so no real
        slot moves. `generator` is the one act_fn samples from;
        `replay_lock` is held around each replay, as act_fn holds it
        around its eager forward."""
        ctx = self._context_fn() if self._context_fn is not None else None
        if replay_lock is not None:
            self._replay_lock = replay_lock
        for n in sizes:
            env = env_example(n)
            if self._input_filter is not None:
                env = self._input_filter(env)
            example = {"ids": np.full(n, self.trash_slot, np.int64),
                       "advance": np.zeros(n, bool), "env": env}

            def run(static):
                return self._advance(
                    self._rows, static["ids"], static["advance"],
                    static["env"],
                    lambda env_d, state: self._act_fn(ctx, env_d, state))

            with self._lock, torch.no_grad():
                self._require_alive()
                self._graphs[n] = graphs.CapturedAct(
                    run, example, self.device, generator)

    def bind_context(self, act_fn: Callable, params) -> None:
        """Arm replica steps: `act_fn(env_outputs, agent_state)` acts
        with the params in `params` (a list of tensors on the table's
        device, allocated once), which each step's context is copied
        into."""
        self._context_act_fn = act_fn
        self._context_params = list(params)

    def capture_context(self, sizes, env_example: Callable[[int], Any],
                        generator=None) -> None:
        """Capture the replica step (bind_context's act_fn over the
        params buffer, on the table's rows) as one CUDA graph per batch
        size, as `capture` does for the central step; `generator` is the
        one the replica act_fn samples from. A failed capture raises."""
        if self._context_act_fn is None:
            raise ValueError("capture_context needs bind_context first")
        for n in sizes:
            env = env_example(n)
            if self._input_filter is not None:
                env = self._input_filter(env)
            example = {"ids": np.full(n, self.trash_slot, np.int64),
                       "advance": np.zeros(n, bool), "env": env}

            def run(static):
                return self._advance(self._rows, static["ids"],
                                     static["advance"], static["env"],
                                     self._context_act_fn)

            with self._lock, torch.no_grad():
                self._require_alive()
                self._context_graphs[n] = graphs.CapturedAct(
                    run, example, self.device, generator)

    # beastlint: holds self._lock
    def _load_context(self, context) -> None:
        """Copy a (version, params tree) context into the params
        buffer unless the buffer holds that version already. Called
        under the table lock."""
        version, params = context
        if version == self._context_version:
            return
        values = nest.flatten(params)
        if len(values) != len(self._context_params):
            raise ValueError(
                f"context has {len(values)} params, the buffer "
                f"{len(self._context_params)}")
        self._context_version = None  # until the copy is queued
        torch._foreach_copy_(self._context_params, values)
        self._context_version = version

    @property
    def context_version(self):
        """The snapshot version the replica params buffer holds."""
        with self._lock:
            return self._context_version

    def step(self, slots, advance, env_outputs, context=None):
        """One acting step over already-padded inputs.

        slots: [n] int ids (padding rows = trash_slot), advance: [n]
        bool, env_outputs: a numpy env nest padded to n along batch_dim.
        Returns the outputs nest on the card (fetch with `fetch`).
        With `bind_context`, a `context` = (version, params tree) makes
        this a replica step over those params; without it, `context`
        overrides the table's context_fn for an eager step (a captured
        central step binds its context at capture).
        """
        if self._input_filter is not None:
            env_outputs = self._input_filter(env_outputs)
        slots = np.asarray(slots, np.int64).reshape(-1)
        advance = np.asarray(advance, bool).reshape(-1)
        replica = context is not None and self._context_act_fn is not None
        if self._graphs or self._context_graphs:
            # Captured: every step replays, a size or kind without its
            # graph raises.
            graph_set = self._context_graphs if replica else self._graphs
            return self._replay(graph_set, slots, advance, env_outputs,
                                context, replica)
        if replica:
            act = self._context_act_fn
        else:
            ctx = context
            if ctx is None and self._context_fn is not None:
                ctx = self._context_fn()
            act = lambda env_d, state: self._act_fn(ctx, env_d, state)  # noqa: E731
        ids = to_device(slots, self.device)
        advance_d = to_device(advance, self.device)
        env_d = to_device(env_outputs, self.device)

        with self._lock, torch.no_grad():
            self._require_alive()
            if replica:
                self._load_context(context)
            # Poisoned until the scatter is through: a raise on the way
            # leaves the table None.
            table, self._table = self._table, None
            outputs = self._advance(table, ids, advance_d, env_d, act)
            self._table = table
        self._tm_dispatches.inc()
        return outputs

    def _replay(self, graph_set, slots, advance, env_outputs, context,
                replica):
        n = slots.shape[0]
        graph = graph_set.get(n)
        if graph is None:
            raise ValueError(
                f"no captured {'replica' if replica else 'acting'} graph "
                f"for a batch of {n} (captured: {sorted(graph_set)})")
        if context is not None and not replica:
            raise ValueError("a captured table step binds its context at "
                             "capture")
        with self._lock, self._replay_lock, torch.no_grad():
            self._require_alive()
            if replica:
                self._load_context(context)
            table, self._table = self._table, None
            outputs = graph({"ids": slots, "advance": advance,
                             "env": env_outputs})
            self._table = table
        self._tm_dispatches.inc()
        return outputs

    def fetch(self, outputs: Any, n: int) -> Any:
        """One device->host copy of a step's padded outputs, sliced to the
        true batch size on the host."""
        t0 = time.perf_counter()
        host = to_host(outputs)
        bd = self.batch_dim

        def cut(arr):
            sl = [slice(None)] * arr.ndim
            sl[bd] = slice(0, n)
            return arr[tuple(sl)]

        out = nest.map(cut, host)
        self._tm_fetch_s.observe(time.perf_counter() - t0)
        return out

    def read_slot(self, slot: int) -> Any:
        """Host copy of one slot's state, shaped like `initial_state`
        (size 1 along batch_dim): the rollout-boundary
        `initial_agent_state`, once per unroll per actor. The copy to the
        host runs outside the table lock."""
        t0 = time.perf_counter()
        ids = self._ids([slot])
        with self._lock, torch.no_grad():
            self._require_alive()
            piece = self._gather(self._table, ids)
        out = to_host(piece)
        self._tm_read_slot_s.observe(time.perf_counter() - t0)
        return out

    def reset(self, slots) -> None:
        """Reset `slots` to the initial state (actor connect/reconnect)."""
        ids = self._ids(slots)
        with self._lock, torch.no_grad():
            self._require_alive()
            values = nest.map(
                lambda leaf: leaf.expand(
                    [ids.shape[0] if d == self.batch_dim else s
                     for d, s in enumerate(leaf.shape)]),
                self._initial)
            table, self._table = self._table, None
            self._scatter(table, ids, values)
            self._table = table
