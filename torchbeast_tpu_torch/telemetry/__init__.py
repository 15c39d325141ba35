"""Process-wide observability: the metrics registry, pipeline span
tracing and the exporters (the port's copy of torchbeast_tpu/telemetry/;
stdlib only).

- metrics: Counter/Gauge/Histogram with per-thread shards and mergeable
  log-bucketed histograms (p50/p95/p99).
- trace:   duration spans + cross-thread StageTraces, exportable as
  Chrome trace-event JSON.
- export:  snapshot / delta / merge, the JSON-lines exporter
  (`{xpid}/telemetry.jsonl`), a Prometheus-text HTTP endpoint
  (--telemetry_port), and a `--selftest` CLI
  (`python -m torchbeast_tpu_torch.telemetry --selftest`).
- driver:  the drivers' shared flag stanza and DriverTelemetry.

The `learner.hbm_bytes_per_update` gauge is set by
learner.instrument_update_step from precision.count_bytes, and the
`learner.remat_plan` static by the drivers from
runtime/remat_plan.last_plan().
"""

from torchbeast_tpu_torch.telemetry.driver import (  # noqa: F401
    DriverTelemetry,
    add_arguments,
)
from torchbeast_tpu_torch.telemetry.export import (  # noqa: F401
    JsonLinesExporter,
    PrometheusServer,
    SCHEMA_VERSION,
    delta,
    merge_snapshots,
    read_jsonl,
    render_prometheus,
    snapshot,
    telemetry_block,
    validate_snapshot,
)
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
