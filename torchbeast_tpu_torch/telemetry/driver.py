"""Shared telemetry lifecycle for the training drivers.

One implementation of the flags + setup/tick/shutdown sequence both
monobeast and polybeast run, so the two can't drift (and fixes land
once): `add_arguments` contributes the --telemetry/--no_telemetry/
--telemetry_port/--trace_path stanza to a driver parser;
`DriverTelemetry` owns the exporter, the optional Prometheus endpoint
(bind failures DEGRADE to a warning — an observability port conflict
must never abort a training run), and the guarded shutdown writes.
stdlib-only, like the rest of the package.

The port's copy of torchbeast_tpu/telemetry/driver.py.
"""

import logging
from typing import Dict, Optional

from torchbeast_tpu_torch.telemetry.export import (
    JsonLinesExporter,
    PrometheusServer,
)
from torchbeast_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    get_registry,
    set_enabled,
)
from torchbeast_tpu_torch.telemetry.trace import get_tracer

log = logging.getLogger(__name__)


def add_arguments(parser) -> None:
    """The telemetry flag stanza shared by every driver parser."""
    parser.add_argument("--telemetry", dest="telemetry",
                        action="store_true", default=True,
                        help="Process-wide metrics + span tracing "
                             "(default): queue depths, batch-size "
                             "distribution, stage latencies, wire "
                             "bytes; snapshots append to "
                             "{xpid}/telemetry.jsonl every monitor/"
                             "log tick. See README \"Telemetry\".")
    parser.add_argument("--no_telemetry", dest="telemetry",
                        action="store_false",
                        help="Disable all instrumentation (global "
                             "registry and tracer become no-ops).")
    parser.add_argument("--telemetry_port", type=int, default=0,
                        help="Serve a Prometheus-text /metrics HTTP "
                             "endpoint on this port (0 = off).")
    parser.add_argument("--telemetry_host", default="127.0.0.1",
                        help="Bind address for /metrics (default "
                             "loopback; the endpoint is "
                             "unauthenticated — pass 0.0.0.0 only to "
                             "deliberately expose it for remote "
                             "scraping).")
    parser.add_argument("--trace_path", default=None,
                        help="Write a Chrome trace-event JSON of the "
                             "run's recorded spans here at shutdown "
                             "(open in chrome://tracing or Perfetto).")


class DriverTelemetry:
    """Setup/tick/shutdown of a driver's telemetry surfaces.

    `enabled` mirrors the --telemetry flag; when off, every method is a
    cheap no-op and the global registry/tracer are gated off too.
    """

    def __init__(self, flags, jsonl_path: str, driver: str):
        self.enabled = bool(getattr(flags, "telemetry", True))
        set_enabled(self.enabled)
        self.registry: MetricsRegistry = get_registry()
        self.exporter: Optional[JsonLinesExporter] = None
        self.prometheus: Optional[PrometheusServer] = None
        self._trace_path = getattr(flags, "trace_path", None)
        self._tick_callbacks = []
        if not self.enabled:
            return
        self.exporter = JsonLinesExporter(
            jsonl_path, registry=self.registry, static={"driver": driver}
        )
        port = getattr(flags, "telemetry_port", 0)
        if port:
            try:
                self.prometheus = PrometheusServer(
                    self.registry, port=port,
                    host=getattr(flags, "telemetry_host", "127.0.0.1"),
                ).start()
                log.info(
                    "Telemetry: /metrics on port %d", self.prometheus.port
                )
            except OSError as e:
                # Observability must degrade, never abort training.
                self.prometheus = None
                log.warning(
                    "Telemetry: could not bind /metrics port %d (%s); "
                    "continuing without the endpoint", port, e,
                )

    def set_static(self, key: str, value) -> None:
        """Attach a static block to every exported line (e.g. the
        acting-path wire accounting)."""
        if self.exporter is not None:
            self.exporter.static[key] = value

    def add_tick_callback(self, fn) -> None:
        """Run `fn()` right before EVERY snapshot write — the periodic
        monitor ticks AND the final shutdown line. Sampled gauges
        (live-actor count, queue depths read off live objects) stay
        fresh on each exported line instead of freezing at whatever the
        last monitor tick saw."""
        self._tick_callbacks.append(fn)

    def write(self, extra: Optional[Dict] = None) -> None:
        """One snapshot line (monitor/log tick). Broad guard, not just
        OSError: json serialization of a bad static/extra value
        (TypeError/ValueError) must degrade too — observability can
        never abort the training loop it watches."""
        if self.exporter is None:
            return
        for cb in self._tick_callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001
                log.exception("Telemetry tick callback failed")
        try:
            self.exporter.write(extra=extra)
        except Exception:  # noqa: BLE001
            log.exception("Telemetry snapshot write failed")

    def shutdown(self, step: Optional[int] = None) -> None:
        """Final snapshot (short smoke runs may end before the first
        tick), Prometheus stop, optional Chrome-trace export. Every
        part guarded: teardown telemetry failures must not mask the
        run's own exit path."""
        if self.exporter is not None:
            extra = {"final": True}
            if step is not None:
                extra["step"] = step
            # Through write(): the tick callbacks refresh sampled
            # gauges on the final line too.
            self.write(extra=extra)
        if self.prometheus is not None:
            try:
                self.prometheus.stop()
            except Exception:  # noqa: BLE001
                log.exception("Prometheus endpoint stop failed")
        if self._trace_path:
            try:
                n = get_tracer().export_chrome(self._trace_path)
                log.info(
                    "Wrote %d trace events to %s", n, self._trace_path
                )
            except Exception:  # noqa: BLE001
                log.exception("Chrome trace export failed")
