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
  and `rebuild()` (the inference supervisor's recovery) makes a fresh
  table with every slot at the initial state.
"""

# beastlint: hot-module — the table step runs once per acting batch.

import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from torchbeast_tpu_torch import nest
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
        self._table = self._fresh_table()

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
        with self._lock:
            self._table = self._fresh_table()

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

    def step(self, slots, advance, env_outputs, context=None):
        """One acting step over already-padded inputs.

        slots: [n] int ids (padding rows = trash_slot), advance: [n]
        bool, env_outputs: a numpy env nest padded to n along batch_dim.
        Returns the outputs nest on the card (fetch with `fetch`).
        `context` overrides the table's context_fn for this step.
        """
        if self._input_filter is not None:
            env_outputs = self._input_filter(env_outputs)
        ctx = context
        if ctx is None and self._context_fn is not None:
            ctx = self._context_fn()
        ids = self._ids(slots)
        advance_d = to_device(np.asarray(advance, bool).reshape(-1),
                              self.device)
        env_d = to_device(env_outputs, self.device)
        bd = self.batch_dim

        def merge(new, old):
            shape = [1] * new.dim()
            shape[bd] = advance_d.shape[0]
            return torch.where(advance_d.reshape(shape), new, old)

        with self._lock, torch.no_grad():
            self._require_alive()
            # Poisoned until the scatter is through: a raise on the way
            # leaves the table None.
            table, self._table = self._table, None
            state = self._gather(table, ids)
            outputs, new_state = self._act_fn(ctx, env_d, state)
            merged = [merge(new, old) for new, old in zip(
                nest.flatten(new_state), nest.flatten(state))]
            self._scatter(table, ids, merged)
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
