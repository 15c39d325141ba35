"""Policy-lag-tolerant replica serving (the port of
torchbeast_tpu/serving/replica.py).

Replica serving threads answer acting requests from the latest
PolicySnapshotStore snapshot instead of the live learner params.
IMPALA's V-trace correction (and IMPACT's clipped targets, PAPERS.md)
make the algorithm provably tolerant of BOUNDED policy lag — the
license to serve slightly stale and keep the rollout's recorded
behavior logits truthful. Two pieces:

- ReplicaServingHooks: the per-batch context provider a replica
  serving loop (runtime/inference.py `serving_hooks=`) uses. Each
  batch atomically picks (snapshot version, params) and an
  annotate closure that stamps `policy_lag` = learner head - snapshot
  version into the reply as a [1, B] int32 leaf — so the lag recorded
  in the rollout is the lag of the params that ACTUALLY served it
  (pinned by the version-skew test). The hook also owns the health
  gate: lag beyond max_policy_lag (a stalled refresh, a sprinting
  learner) degrades the replica through the resilience health machine
  and `serving_ok()` flips False until a fresh snapshot lands.

- ReplicaRouter: the batcher-shaped facade the (Python) actor pool
  talks to. While the replica is healthy, acting requests go to the
  replica batcher; on lag degradation (or a replica-side serving
  failure) they fall back to the central path — the actor never
  notices beyond `policy_lag` dropping back to 0 in its rollouts.

The central path always serves lag 0 (its params rebind every
update), so rollouts mixing both paths stay well-formed: the actor
pool normalizes a missing policy_lag leaf to zeros.

The port's replicas sample from a torch.Generator of their own
(`ReplicaServingHooks.generator`, seeded from `rng_seed`) where the
reference splits a jax PRNG key per batch: the state table's replica
graphs bind their generator at capture (runtime/state_table.py), so the
batch context carries the snapshot alone.
"""

import logging
import threading
from typing import Any, Callable, Optional, Tuple

import numpy as np

import torch

from torchbeast_tpu_torch import telemetry
from torchbeast_tpu_torch.serving.snapshot import PolicySnapshotStore

log = logging.getLogger(__name__)


class ReplicaServingHooks:
    """Per-batch snapshot context + lag annotation + the health gate."""

    def __init__(
        self,
        store: PolicySnapshotStore,
        max_policy_lag: int,
        rng_seed: int = 0,
        health=None,
        batch_dim: int = 1,
        registry=None,
        device=None,
        health_key: str = "replica_lag",
    ):
        """`device` pins this hook set to one acting device: its
        sampling generator lives there, and begin_batch hands out the
        snapshot placed there by `PolicySnapshotStore.latest_on` (one
        copy per version, on the serving thread's stream, after the
        publish's cast). The device split's slices each pass their own
        (parallel/sebulba.py). `health_key` scopes the lag degradation
        in the health machine's keyed causes (one slice's recovery must
        not mask another's stall)."""
        if max_policy_lag < 1:
            raise ValueError(
                f"max_policy_lag must be >= 1, got {max_policy_lag}"
            )
        self.store = store
        self.max_policy_lag = max_policy_lag
        self._health = health
        self._batch_dim = batch_dim
        self._device = device
        self._health_key = health_key
        self._rng_lock = threading.Lock()
        self._rng_seed = rng_seed
        self._generator = None  # built at first use, on `device`
        reg = registry if registry is not None else telemetry.get_registry()
        self._h_lag = reg.histogram("serving.policy_lag")
        self._c_degraded = reg.counter("serving.replica_degradations")
        self._degraded = False  # guarded-by: self._rng_lock

    @property
    def generator(self) -> torch.Generator:
        """The replica's sampling generator, seeded from `rng_seed`."""
        with self._rng_lock:
            if self._generator is None:
                self._generator = torch.Generator(
                    device=self._device if self._device is not None
                    else "cpu")
                self._generator.manual_seed(self._rng_seed)
            return self._generator

    def serving_ok(self) -> bool:
        """The router's per-request gate: a snapshot exists and its lag
        is within budget. Transitions drive the health machine (key
        "replica_lag") so dashboards see the degradation the moment
        requests start falling back to the central path."""
        lag = self.store.lag()
        ok = self.store.version >= 0 and lag <= self.max_policy_lag
        with self._rng_lock:
            was_degraded, self._degraded = self._degraded, not ok
        if ok and was_degraded:
            if self._health is not None:
                self._health.recover(
                    "replica snapshot refreshed within the lag budget",
                    key=self._health_key,
                )
        elif not ok and not was_degraded:
            self._c_degraded.inc()
            if self._health is not None:
                self._health.degrade(
                    f"replica policy lag {lag} exceeds --max_policy_lag "
                    f"{self.max_policy_lag} (refresh stalled?)",
                    key=self._health_key,
                )
        return ok

    def begin_batch(self) -> Tuple[Any, Callable]:
        """One atomic snapshot pick for a batch about to be dispatched.
        Returns (ctx, annotate): `ctx` = (version, params) feeds the
        state table's step (runtime/state_table.py loads it into the
        replica params buffer when the version is new) — or act_fn as
        its 4th argument — and `annotate(outputs, n)` stamps the
        matching policy_lag into the reply at flush time."""
        if self._device is not None:
            latest = self.store.latest_on(self._device)
        else:
            latest = self.store.latest()
        if latest is None:
            raise RuntimeError(
                "replica serving before the first snapshot publish "
                "(the driver publishes version 0 before serving starts)"
            )
        version, params = latest
        lag = max(0, self.store.head - version)
        self._h_lag.observe(lag)
        bd = self._batch_dim

        def annotate(outputs: dict, n: int) -> dict:
            shape = [1] * (bd + 1)
            shape[bd] = n
            outputs["policy_lag"] = np.full(shape, lag, np.int32)
            return outputs

        return (version, params), annotate


class ReplicaRouter:
    """Routes actor compute() calls: replica while healthy, central
    otherwise. Shaped like a DynamicBatcher from the actor pool's side
    (compute/size/is_closed), so it drops into the pool unchanged."""

    def __init__(self, central, replica, hooks: ReplicaServingHooks,
                 registry=None):
        self._central = central
        self._replica = replica
        self._hooks = hooks
        reg = registry if registry is not None else telemetry.get_registry()
        self._c_replica = reg.counter("serving.replica_requests")
        self._c_central = reg.counter("serving.central_requests")

    def compute(self, inputs, trace=None):
        if self._hooks.serving_ok() and not self._replica.is_closed():
            try:
                if trace is not None:
                    out = self._replica.compute(inputs, trace=trace)
                else:
                    out = self._replica.compute(inputs)
                # Counted on SUCCESS only: a fallen-back request must
                # land in exactly one routing series, or the two sum to
                # more than total requests.
                self._c_replica.inc()
                return out
            except Exception as e:  # noqa: BLE001
                from torchbeast_tpu_torch.runtime.errors import ShedError
                from torchbeast_tpu_torch.runtime.queues import (
                    AsyncError,
                    ClosedBatchingQueue,
                )

                if isinstance(e, ShedError) or not isinstance(
                    e, (AsyncError, ClosedBatchingQueue)
                ):
                    raise  # sheds keep their retry contract; real bugs stay loud
                # A dying/closing replica path must not fail the actor:
                # fall through to the central batcher for this request.
                log.warning(
                    "Replica serving failed (%s); request falls back to "
                    "the central path", e,
                )
        self._c_central.inc()
        if trace is not None:
            return self._central.compute(inputs, trace=trace)
        return self._central.compute(inputs)

    def size(self) -> int:
        return self._central.size() + self._replica.size()

    def is_closed(self) -> bool:
        return self._central.is_closed()
