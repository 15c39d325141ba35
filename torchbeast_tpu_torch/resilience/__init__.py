"""Recovery machinery of the async driver (the parts of
torchbeast_tpu/resilience/ that its default path runs):

- `backoff`:    exponential backoff with decorrelated jitter + deadline,
                for the actor reconnect loop and env-server respawn.
- `supervisor`: the pipeline health state machine
                (HEALTHY/DEGRADED/HALTED), the inference-thread
                supervisor that rebuilds a poisoned state table under a
                bounded budget, and the learner stall watchdog.

The chaos harness (`--chaos_plan`) is not in the port yet: ROADMAP.md
Queue 1 item 'resilience'.
"""

from torchbeast_tpu_torch.resilience.backoff import (  # noqa: F401
    Backoff,
    BackoffDeadline,
)
from torchbeast_tpu_torch.resilience.supervisor import (  # noqa: F401
    InferenceSupervisor,
    LearnerWatchdog,
    PipelineHealth,
)
