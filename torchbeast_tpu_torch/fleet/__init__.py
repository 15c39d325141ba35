"""The multi-host fleet (counterpart of torchbeast_tpu/fleet/).

Each host runs its own env servers, actors and inference, and the
learner's data axis spans the hosts. The package composes the per-host
pieces (runtime/placement.py splits, parallel/dp.py's learner,
serving/snapshot.py's versioned snapshots, resilience/supervisor.py's
health) into one fleet:

- `topology`: `FleetSpec` (`--fleet host=<rank>/<n>,coord=<addr>`),
  per-host split composition, the static actor -> (host, slice)
  assignment;
- `coordinator`: the rendezvous, the cross-host health plane, the
  wire strategy's parameter composition and the snapshot publication;
- `snapshot_wire`: the snapshot message helpers over the TAG_SNAPSHOT
  frame (runtime/wire.py), in the reference's leaf order and layout.
"""

from torchbeast_tpu_torch.fleet.topology import (  # noqa: F401
    FleetSpec,
    compose_fleet_mesh_devices,
    parse_fleet_spec,
)
from torchbeast_tpu_torch.fleet.coordinator import (  # noqa: F401
    FleetCoordinator,
    fleet_rendezvous,
)
from torchbeast_tpu_torch.fleet.snapshot_wire import (  # noqa: F401
    apply_snapshot,
    build_snapshot,
)
