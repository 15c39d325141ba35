"""Recovery machinery of the async driver (the port's copy of
torchbeast_tpu/resilience/):

- `backoff`:    exponential backoff with decorrelated jitter + deadline,
                for the actor reconnect loop and env-server respawn.
- `supervisor`: the pipeline health state machine
                (HEALTHY/DEGRADED/HALTED), the inference-thread
                supervisor that rebuilds a poisoned state table under a
                bounded budget, and the learner stall watchdog.
- `chaos`:      deterministic, seeded fault injection (`FaultPlan`,
                JSON-loadable via `--chaos_plan`), every injected fault
                counted in telemetry so recovery can be asserted
                exactly (`python -m torchbeast_tpu_torch.chaos_run`).
"""

from torchbeast_tpu_torch.resilience.backoff import (  # noqa: F401
    Backoff,
    BackoffDeadline,
)
from torchbeast_tpu_torch.resilience.chaos import (  # noqa: F401
    FAULT_KINDS,
    ChaosController,
    FaultingTransport,
    FaultPlan,
    FaultSpec,
)
from torchbeast_tpu_torch.resilience.supervisor import (  # noqa: F401
    InferenceSupervisor,
    LearnerWatchdog,
    PipelineHealth,
)
