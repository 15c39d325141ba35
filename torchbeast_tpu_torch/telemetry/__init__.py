"""Process-wide observability: the metrics registry and pipeline span
tracing (the parts of torchbeast_tpu/telemetry/ that the runtime
writes into; stdlib only).

- metrics: Counter/Gauge/Histogram with per-thread shards and mergeable
  log-bucketed histograms (p50/p95/p99).
- trace:   duration spans + cross-thread StageTraces.

The exporters and the drivers' DriverTelemetry (--telemetry_port,
--trace_path, --profile_dir) are not in the port yet: ROADMAP.md Queue 1
item 'telemetry'.
"""

from torchbeast_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    is_enabled,
    set_enabled,
)
from torchbeast_tpu_torch.telemetry.trace import (  # noqa: F401
    StageTrace,
    Tracer,
    get_tracer,
)
