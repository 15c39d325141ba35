"""The serving tier (the port of torchbeast_tpu/serving/, without the
remote replica hosts of serving/replica_server.py, which go with the
fleet: ROADMAP.md Queue 1 item 'data parallel and the fleet').

- admission: bounded-depth admission control + deadline-aware load
  shedding on the central inference path (--request_deadline_ms,
  --admission_depth_factor). Over-budget requests get a typed ShedError
  reply that the actor pool's retry path re-submits — a shed is flow
  control, never a lost rollout. Counters serving.admitted/shed/
  expired/resubmitted plus a queue-delay histogram feeding a p99-vs-SLO
  gauge.
- snapshot: PolicySnapshotStore — the learner publishes versioned bf16
  param snapshots every --replica_refresh_updates updates.
- replica: the replica serving hooks (per-batch snapshot context,
  policy_lag stamping, degradation past --max_policy_lag through the
  health machine) and the Python ReplicaRouter.

The typed ShedError lives in runtime/errors.py, where the actor pool
and the C++ core's exception bridge import it.
"""

from torchbeast_tpu_torch.runtime.errors import ShedError  # noqa: F401
from torchbeast_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionController,
)
from torchbeast_tpu_torch.serving.replica import (  # noqa: F401
    ReplicaRouter,
    ReplicaServingHooks,
)
from torchbeast_tpu_torch.serving.snapshot import (  # noqa: F401
    PolicySnapshotStore,
    bf16_cast,
)
