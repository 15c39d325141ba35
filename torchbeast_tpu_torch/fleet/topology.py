"""Fleet topology: who is in the fleet, and what each host owns (a copy
of torchbeast_tpu/fleet/topology.py, which imports no jax; the port
keeps its own, over its own runtime/placement.py).

`--fleet host=<rank>/<n>,coord=<addr>` names this process's place in an
<n>-host fleet whose rendezvous point is <addr> (host:port). From that
one line each host derives, with no communication:

- its per-host `DeviceSplit` (runtime/placement.py) over its local
  devices: inference slices stay host-local by construction (an acting
  batch never crosses hosts to reach its card);
- the global learner device group: every host's split learner devices,
  host-major, which is the order `compose_fleet_mesh_devices` returns
  for the data axis that spans hosts;
- the static actor -> (host, slice) assignment: host by the salted
  second-stage splitmix64 (`placement.fleet_host_for_slot`), slice by
  the first-stage hash; both process-stable, so a slot's device-resident
  state never migrates across actor reconnects or host restarts.

Callers pass device lists in (the driver passes torch devices, tests
pass stand-ins), so the grammar and the composition rules are
unit-testable without a device.

The control plane (fleet/coordinator.py) listens one port above the
rendezvous port: `coord=<host>:<p>` gives torch.distributed the
rendezvous at <p> and the fleet's health/snapshot/param traffic a
socket transport at <p>+1, so one flag names both.
"""

import dataclasses
import logging
from typing import Optional, Sequence, Tuple

from torchbeast_tpu_torch.runtime.placement import (
    DeviceSplit,
    fleet_host_for_slot,
    resolve_device_split,
)

log = logging.getLogger(__name__)

# Offset from the rendezvous port to the control-plane port (one flag
# names both planes; keep them adjacent so firewall rules stay one
# range).
CONTROL_PORT_OFFSET = 1


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """This process's place in the fleet, parsed from `--fleet`."""

    host_rank: int
    num_hosts: int
    coord_address: str  # host:port: the torch.distributed rendezvous

    def __post_init__(self):
        if self.num_hosts < 1:
            raise ValueError(
                f"--fleet names {self.num_hosts} hosts (need >= 1)"
            )
        if not 0 <= self.host_rank < self.num_hosts:
            raise ValueError(
                f"--fleet host rank {self.host_rank} outside "
                f"[0, {self.num_hosts})"
            )

    @property
    def is_lead(self) -> bool:
        return self.host_rank == 0

    @property
    def control_address(self) -> str:
        """The control-plane transport address: rendezvous port + 1."""
        host, _, port = self.coord_address.rpartition(":")
        return f"{host}:{int(port) + CONTROL_PORT_OFFSET}"

    def host_for_slot(self, slot: int) -> int:
        """STATIC slot -> host (salted splitmix64, uncorrelated with
        the split's slot -> slice draw)."""
        return fleet_host_for_slot(slot, self.num_hosts)

    def slots_for_host(self, num_slots: int) -> Tuple[int, ...]:
        """The slots THIS host serves out of a fleet-global slot space
        (env servers and actors are launched per host against this
        set, so every slot has exactly one home)."""
        return tuple(
            s for s in range(num_slots)
            if self.host_for_slot(s) == self.host_rank
        )

    def describe(self) -> dict:
        """JSON-serializable summary (the `fleet` telemetry static)."""
        return {
            "host_rank": self.host_rank,
            "num_hosts": self.num_hosts,
            "coord": self.coord_address,
            "control": self.control_address,
        }


def parse_fleet_spec(spec: Optional[str]) -> Optional[FleetSpec]:
    """Validate the `--fleet` grammar without touching devices or
    sockets. Returns None for unset/empty (single-host: today's path),
    else a FleetSpec. Raises ValueError on a malformed spec — at flag
    parse time, before any side effects (same discipline as
    `parse_device_split`).
    """
    if spec is None:
        return None
    spec = spec.strip()
    if not spec:
        return None
    parts = {}
    for piece in spec.split(","):
        if "=" not in piece:
            raise ValueError(
                f"--fleet piece {piece!r} is not key=value (expected "
                "'host=<rank>/<n>,coord=<host:port>')"
            )
        key, _, value = piece.partition("=")
        key = key.strip()
        if key not in ("host", "coord"):
            raise ValueError(f"--fleet key {key!r} unknown (host/coord)")
        if key in parts:
            raise ValueError(f"--fleet repeats {key!r}")
        parts[key] = value.strip()
    if "host" not in parts or "coord" not in parts:
        raise ValueError("--fleet needs both host=<rank>/<n> and coord=")
    rank_s, sep, n_s = parts["host"].partition("/")
    if not sep:
        raise ValueError(
            f"--fleet host={parts['host']!r} is not <rank>/<n>"
        )
    try:
        rank, n = int(rank_s), int(n_s)
    except ValueError:
        raise ValueError(
            f"--fleet host={parts['host']!r}: rank and n must be "
            "integers"
        ) from None
    coord = parts["coord"]
    host, sep, port = coord.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"--fleet coord={coord!r} is not host:port (the rendezvous "
            "needs a TCP address; the control plane listens one port "
            "above it)"
        )
    try:
        port_n = int(port)
    except ValueError:
        raise ValueError(
            f"--fleet coord={coord!r}: port must be an integer"
        ) from None
    if not 0 < port_n < 65535:
        # < 65535 (not <=): the control plane needs port+1 to exist.
        raise ValueError(
            f"--fleet coord port {port_n} out of range (1..65534; the "
            "control plane uses port+1)"
        )
    return FleetSpec(host_rank=rank, num_hosts=n, coord_address=coord)


def compose_fleet_mesh_devices(
    fleet: FleetSpec,
    split_spec: Optional[str],
    global_devices: Sequence,
    process_index_fn=None,
) -> Tuple[Optional[DeviceSplit], list]:
    """Compose per-host splits into the global learner device group.

    `global_devices` is the fleet-wide device list; `process_index_fn(
    device)` maps a device to its owning host rank (defaults to the
    `.process_index` attribute, else 0). Each host's split is resolved over ITS devices with the
    SAME spec, so the partition is identical no matter which host
    computes it; the returned learner group is host-major (host 0's
    learner devices, then host 1's, ...) — the DP axis order the fleet
    mesh uses, which makes `shard_batch`'s process-local placement line
    up with each host's own rows.

    Returns (this host's local DeviceSplit or None, global learner
    device list). With no split spec the whole of each host's device
    group learns (time-shared acting, as today).
    """
    if process_index_fn is None:
        def process_index_fn(d):
            return getattr(d, "process_index", 0)

    per_host = {r: [] for r in range(fleet.num_hosts)}
    for d in global_devices:
        r = process_index_fn(d)
        if r not in per_host:
            raise ValueError(
                f"device {d!r} reports process index {r} outside the "
                f"{fleet.num_hosts}-host fleet"
            )
        per_host[r].append(d)
    counts = {r: len(ds) for r, ds in per_host.items()}
    if min(counts.values()) == 0:
        raise ValueError(
            f"fleet composition: some hosts own no devices ({counts}); "
            "every host must contribute to the learner mesh"
        )
    if len(set(counts.values())) != 1:
        # A ragged fleet would need ragged batch shards; reject loudly
        # rather than silently under-using the bigger hosts.
        raise ValueError(
            f"fleet composition needs uniform hosts, got {counts} "
            "devices per host"
        )
    local_split = None
    learner_devices = []
    for r in range(fleet.num_hosts):
        split_r = resolve_device_split(split_spec, per_host[r])
        devs_r = (
            list(split_r.learner_devices) if split_r is not None
            else per_host[r]
        )
        learner_devices.extend(devs_r)
        if r == fleet.host_rank:
            local_split = split_r
    return local_split, learner_devices
