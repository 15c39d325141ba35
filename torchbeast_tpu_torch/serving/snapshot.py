"""Versioned policy snapshots for replica serving (the port of
torchbeast_tpu/serving/snapshot.py to torch).

The learner publishes a bf16-cast copy of its params every
--replica_refresh_updates updates; replica serving threads answer
acting requests from the latest snapshot instead of the live learner
params. bf16 is the publication format (half the bytes per refresh);
`latest()` hands serving code a tree restored to the ORIGINAL param
dtypes (f32 params round-trip through bf16 rounding, bf16-resident
params pass through untouched), cached per version so repeated reads
cost one dict lookup.

A params tree is a nest (runtime nest.py: dicts, lists, tuples) of
tensors. The cast runs where the tensors live, on the calling thread's
current stream, a few launches for the whole tree (one flat tensor per
dtype): polybeast publishes its acting copy right after the learner
copied the update into it, so on the card the cast is queued on the
learner's stream behind that copy. The cast rounds to nearest even and
turns a NaN into the quiet NaN of its sign, as `astype(jnp.bfloat16)`
does.

Version bookkeeping is in UPDATES: `note_update(v)` advances the
learner head every update, `publish(v, params)` stamps a snapshot at
head version v, and `lag()` = head - latest snapshot version — the
number recorded into rollouts as `policy_lag` and compared against
--max_policy_lag by the replica health gate.

`fail_next_refreshes(n)` is the chaos/test hook: the next n publishes
are dropped (counted in serving.snapshot_refresh_failures) so the
lag-degradation path can be exercised deterministically.

Not here: the reference's `latest_on(device)`, the per-slice placement
of --device_split (ROADMAP.md Queue 1 item 'data parallel and the
fleet').
"""

import threading
from typing import Any, Optional, Tuple

import torch

from torchbeast_tpu_torch import nest, telemetry


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """A floating tensor to bfloat16, rounding to nearest even; a NaN
    becomes the quiet NaN of its sign (0x7FC0 | sign), which is what
    XLA's convert gives and torch's own cast does not (it gives 0xFFFF
    on the CPU and 0x7FFF on the card)."""
    out = x.to(torch.bfloat16).view(torch.int16)
    quiet = torch.where(torch.signbit(x), _QUIET_NAN_NEG, _QUIET_NAN_POS)
    return torch.where(torch.isnan(x), quiet.to(x.device),
                       out).view(torch.bfloat16)


_QUIET_NAN_POS = torch.tensor(0x7FC0, dtype=torch.int16)
_QUIET_NAN_NEG = torch.tensor(0xFFC0 - 0x10000, dtype=torch.int16)


def _grouped(leaves, indices, fn):
    """fn over the leaves at `indices` as one flat tensor per (dtype,
    device), so a tree of many leaves costs a few launches; the results
    come back as views of fn's output, in the leaves' shapes."""
    groups = {}
    for i in indices:
        groups.setdefault((leaves[i].dtype, leaves[i].device), []).append(i)
    out = {}
    for (dtype, _), idx in groups.items():
        flat = fn(torch.cat([leaves[i].detach().reshape(-1) for i in idx]),
                  dtype)
        for i, piece in zip(idx, flat.split([leaves[i].numel()
                                             for i in idx])):
            out[i] = piece.view(leaves[i].shape)
    return out


def bf16_cast(params: Any) -> Tuple[Any, Any]:
    """(bf16-cast tree, original-dtype tree) — THE publication cast:
    floating leaves go bfloat16 (new storage even when a leaf is bf16
    already), rounding to nearest even as `astype(jnp.bfloat16)` does,
    NaN included; every other leaf is copied as it is, and the dtype
    tree records what `latest()` restores to."""
    leaves = nest.flatten(params)
    floats = [i for i, t in enumerate(leaves) if t.is_floating_point()]
    cast = _grouped(leaves, floats, lambda flat, dtype: (
        flat if dtype == torch.bfloat16 else _round_bf16(flat)))
    bf16 = [cast[i] if i in cast else t.detach().clone()
            for i, t in enumerate(leaves)]
    return (nest.pack_as(params, bf16),
            nest.pack_as(params, [t.dtype for t in leaves]))


class PolicySnapshotStore:
    """`namespace` prefixes every instrument series (default "serving",
    the replica store).

    `cast_bf16=False` publishes FULL-PRECISION copies (the reference's
    IMPACT target network rides this class so: its forward must equal a
    forward of the exact stamped params)."""

    def __init__(
        self,
        refresh_updates: int,
        registry=None,
        namespace: str = "serving",
        cast_bf16: bool = True,
    ):
        if refresh_updates < 1:
            raise ValueError(
                f"refresh_updates must be >= 1, got {refresh_updates}"
            )
        self.refresh_updates = refresh_updates
        self._cast_bf16 = cast_bf16
        reg = registry if registry is not None else telemetry.get_registry()
        self._c_published = reg.counter(f"{namespace}.snapshots_published")
        self._c_bytes_published = reg.counter(
            f"{namespace}.snapshot_bytes_published"
        )
        self._c_refresh_failures = reg.counter(
            f"{namespace}.snapshot_refresh_failures"
        )
        self._g_version = reg.gauge(f"{namespace}.snapshot_version")
        self._g_lag = reg.gauge(f"{namespace}.snapshot_lag")
        self._lock = threading.Lock()
        self._head = 0  # guarded-by: self._lock
        self._version = -1  # guarded-by: self._lock (-1: nothing published)
        self._bf16 = None  # guarded-by: self._lock
        self._dtypes = None  # guarded-by: self._lock
        self._restored = None  # (version, tree) cache  # guarded-by: self._lock
        self._fail_next = 0  # guarded-by: self._lock

    # -- learner side -----------------------------------------------------
    def note_update(self, version: int) -> bool:
        """Advance the learner head; returns True when a refresh is DUE
        — the head has run >= refresh_updates past the last snapshot
        (or nothing is published yet). Due-based rather than modulo so
        superstep strides and dropped refreshes (the failure hook) retry
        on the next update."""
        with self._lock:
            self._head = version
            if self._version < 0:
                lag, due = version, True
            else:
                lag = version - self._version
                due = lag >= self.refresh_updates
        self._g_lag.set(lag)
        return due

    def publish(self, version: int, params: Any) -> bool:
        """Stamp a snapshot of `params` at `version`. Returns False when
        the refresh was dropped (the injected-failure hook)."""
        with self._lock:
            if self._fail_next > 0:
                self._fail_next -= 1
                drop = True
            else:
                drop = False
        if drop:
            self._c_refresh_failures.inc()
            return False
        if self._cast_bf16:
            bf16, dtypes = bf16_cast(params)
        else:
            # A copy: the learner changes its params in place.
            bf16 = nest.map(lambda t: t.detach().clone(), params)
            dtypes = nest.map(lambda t: t.dtype, params)
        with self._lock:
            self._version = version
            self._head = max(self._head, version)
            self._bf16 = bf16
            self._dtypes = dtypes
            self._restored = None
        self._c_published.inc()
        self._c_bytes_published.inc(sum(
            t.numel() * t.element_size() for t in nest.flatten(bf16)))
        self._g_version.set(version)
        self._g_lag.set(0)
        return True

    def fail_next_refreshes(self, n: int) -> None:
        with self._lock:
            self._fail_next += int(n)

    # -- replica side -----------------------------------------------------
    @property
    def head(self) -> int:
        with self._lock:
            return self._head

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def lag(self) -> int:
        """Updates the latest snapshot trails the learner head by."""
        with self._lock:
            if self._version < 0:
                return self._head
            return self._head - self._version

    def latest(self) -> Optional[Tuple[int, Any]]:
        """(version, params restored to their original dtypes), or None
        before the first publish. The restored tree is cached per
        version — replicas read this per batch."""
        with self._lock:
            if self._bf16 is None:
                return None
            if self._restored is not None and (
                self._restored[0] == self._version
            ):
                return self._restored
            version, bf16, dtypes = self._version, self._bf16, self._dtypes
        leaves, targets = nest.flatten(bf16), nest.flatten(dtypes)
        by_target = {}
        for i, (t, dt) in enumerate(zip(leaves, targets)):
            if t.dtype != dt:
                by_target.setdefault(dt, []).append(i)
        cast = {}
        for dt, idx in by_target.items():
            cast.update(_grouped(leaves, idx,
                                 lambda flat, _, dt=dt: flat.to(dt)))
        restored = nest.pack_as(bf16, [cast.get(i, t)
                                       for i, t in enumerate(leaves)])
        with self._lock:
            # Last-writer-wins on a racing publish is fine: the cache is
            # re-validated against _version on the next read.
            self._restored = (version, restored)
        return (version, restored)
