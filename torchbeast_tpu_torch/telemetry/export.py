"""Snapshot/delta/merge + exporters for the telemetry registry.

Snapshot schema (SCHEMA_VERSION bumps on any breaking change; the
bench artifacts and the tests validate against it):

    {
      "schema": 1,
      "time": <wall seconds>,
      "counters":   {name: float},
      "gauges":     {name: float},
      "histograms": {name: {count, total, total_sq, min, max, mean,
                            std, p50, p95, p99, buckets: {idx: n}}},
    }

Histogram entries carry their raw sparse log-buckets, so two snapshots
subtract (delta — "what happened during this interval") or add (merge —
"both intervals together") EXACTLY, with interval percentiles re-derived
from the differenced buckets. Exporters:

- JsonLinesExporter: one snapshot JSON object per line, appended to
  `{xpid}/telemetry.jsonl` next to FileWriter's logs.csv (open/append/
  close per write — crash-safe, no fd held).
- PrometheusServer: optional `GET /metrics` text endpoint
  (--telemetry_port) in a daemon thread; counters/gauges map directly,
  histograms render as summaries with quantile labels.

`python -m torchbeast_tpu_torch.telemetry.export --selftest` exercises the
whole stack (instruments -> spans -> snapshot -> delta -> jsonl ->
validate -> prometheus render) and prints one machine-readable verdict
line — CI's cheap guard against exporter/schema drift.

The port's copy of torchbeast_tpu/telemetry/export.py.
"""

import argparse
import http.server
import json
import re
import socket
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional

from torchbeast_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    hist_stats,
)

SCHEMA_VERSION = 1

# Derived from the one stats constructor so the validator can never
# drift from the shape live histograms and deltas actually emit.
_HIST_KEYS = tuple(hist_stats({}, 0.0, 0.0).keys())


def snapshot(registry: Optional[MetricsRegistry] = None) -> Dict:
    """Cumulative snapshot of every instrument in the registry."""
    registry = registry if registry is not None else get_registry()
    counters, gauges, histograms = {}, {}, {}
    for name, inst in registry.instruments().items():
        if isinstance(inst, Counter):
            counters[name] = inst.value()
        elif isinstance(inst, Gauge):
            gauges[name] = inst.value()
        elif isinstance(inst, Histogram):
            histograms[name] = inst.stats()
    return {
        "schema": SCHEMA_VERSION,
        "time": time.time(),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
    }


def _combine_hist(a: Dict, b: Dict, sign: int) -> Dict:
    buckets = {int(k): v for k, v in a.get("buckets", {}).items()}
    for k, v in b.get("buckets", {}).items():
        buckets[int(k)] = buckets.get(int(k), 0) + sign * v
    total = a["total"] + sign * b["total"]
    total_sq = a["total_sq"] + sign * b["total_sq"]
    if sign > 0:
        # Empty sides contribute no extremes: their 0.0/0.0
        # placeholders would otherwise corrupt the merged min (or max,
        # for negative-valued series) when a histogram exists in only
        # one of the two snapshots.
        mins = [h["min"] for h in (a, b) if h["count"]]
        maxs = [h["max"] for h in (a, b) if h["count"]]
        lo = min(mins) if mins else None
        hi = max(maxs) if maxs else None
    else:
        # Exact min/max don't subtract; hist_stats falls back to the
        # surviving buckets' bounds (delta percentiles stay
        # bounded-error).
        lo = hi = None
    return hist_stats(buckets, total, total_sq, lo, hi)


def _combine(cur: Dict, other: Dict, sign: int) -> Dict:
    out = {
        "schema": SCHEMA_VERSION,
        "time": cur.get("time", 0.0),
        "counters": {},
        "gauges": dict(cur.get("gauges", {})),
        "histograms": {},
    }
    if sign < 0:
        out["interval_s"] = cur.get("time", 0.0) - other.get("time", 0.0)
    else:
        # Merge is a UNION: gauges present only in the second snapshot
        # (e.g. another process's registry) must survive; on collision
        # the first argument wins (last-write-wins has no meaning
        # across snapshots, so the choice just needs to be stable).
        for name, value in other.get("gauges", {}).items():
            out["gauges"].setdefault(name, value)
    names = set(cur.get("counters", {})) | set(other.get("counters", {}))
    for name in names:
        out["counters"][name] = cur.get("counters", {}).get(
            name, 0.0
        ) + sign * other.get("counters", {}).get(name, 0.0)
    empty = hist_stats({}, 0.0, 0.0)
    names = set(cur.get("histograms", {})) | set(
        other.get("histograms", {})
    )
    for name in names:
        out["histograms"][name] = _combine_hist(
            cur.get("histograms", {}).get(name, empty),
            other.get("histograms", {}).get(name, empty),
            sign,
        )
    return out


def delta(cur: Dict, prev: Dict) -> Dict:
    """What happened between two cumulative snapshots: counters and
    histogram buckets/moments subtracted (interval percentiles
    re-derived), gauges taken from `cur`."""
    return _combine(cur, prev, -1)


def merge_snapshots(a: Dict, b: Dict) -> Dict:
    """Union of two disjoint intervals (bucket/moment sums)."""
    return _combine(a, b, +1)


def validate_snapshot(snap) -> List[str]:
    """Schema check; returns a list of problems (empty = valid)."""
    problems = []
    if not isinstance(snap, dict):
        return [f"snapshot is {type(snap).__name__}, not dict"]
    if snap.get("schema") != SCHEMA_VERSION:
        problems.append(
            f"schema {snap.get('schema')!r} != {SCHEMA_VERSION}"
        )
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(snap.get(section), dict):
            problems.append(f"missing/invalid section {section!r}")
    if not isinstance(snap.get("time"), (int, float)):
        problems.append("missing/invalid 'time'")
    for name, value in snap.get("counters", {}).items():
        if not isinstance(value, (int, float)):
            problems.append(f"counter {name!r} value {value!r}")
    for name, value in snap.get("gauges", {}).items():
        if not isinstance(value, (int, float)):
            problems.append(f"gauge {name!r} value {value!r}")
    for name, h in snap.get("histograms", {}).items():
        if not isinstance(h, dict):
            problems.append(f"histogram {name!r} is not a dict")
            continue
        for key in _HIST_KEYS:
            if key not in h:
                problems.append(f"histogram {name!r} missing {key!r}")
        buckets = h.get("buckets", {})
        if isinstance(buckets, dict):
            bucket_total = sum(buckets.values())
            if bucket_total != h.get("count"):
                problems.append(
                    f"histogram {name!r}: bucket sum {bucket_total} != "
                    f"count {h.get('count')}"
                )
        else:
            problems.append(f"histogram {name!r} buckets not a dict")
    return problems


def telemetry_block(
    prev: Optional[Dict] = None,
    registry: Optional[MetricsRegistry] = None,
) -> Dict:
    """The `telemetry` block bench artifacts embed: the current
    snapshot (or the delta since `prev`) plus the enabled flag. ONE
    shared constructor so every artifact drifts together — and the
    schema test validates this exact shape."""
    from torchbeast_tpu_torch.telemetry.metrics import is_enabled

    snap = snapshot(registry)
    if prev is not None:
        snap = delta(snap, prev)
    return {
        "enabled": is_enabled(),
        "snapshot": snap,
    }


class JsonLinesExporter:
    """Append one snapshot JSON object per line to `path`.

    `static` entries ride along on every line (e.g. the acting-path
    wire accounting polybeast used to log as free text). `extra` merges
    per-write (step counters, SPS). Open/append/close per write: no fd
    leaks, and a crash never truncates prior lines.
    """

    def __init__(
        self,
        path: str,
        registry: Optional[MetricsRegistry] = None,
        static: Optional[Dict] = None,
    ):
        self.path = path
        self._registry = registry
        self.static = dict(static or {})
        self._lock = threading.Lock()
        self.lines_written = 0

    def write(self, extra: Optional[Dict] = None) -> Dict:
        snap = snapshot(self._registry)
        snap.update(self.static)
        if extra:
            snap.update(extra)
        line = json.dumps(snap, default=float)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")
            self.lines_written += 1
        return snap


def read_jsonl(path: str) -> List[Dict]:
    """All parseable snapshot lines of a telemetry.jsonl (skips
    torn/corrupt lines rather than dying on them)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        return []
    return out


_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _PROM_NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def render_prometheus(snap: Dict) -> str:
    """Prometheus text exposition (0.0.4) of a snapshot: counters and
    gauges directly, histograms as summaries."""
    lines = []
    for name, value in sorted(snap.get("counters", {}).items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} counter")
        lines.append(f"{pname} {value!r}")
    for name, value in sorted(snap.get("gauges", {}).items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f"{pname} {value!r}")
    for name, h in sorted(snap.get("histograms", {}).items()):
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} summary")
        for q in ("0.5", "0.95", "0.99"):
            key = "p" + str(int(float(q) * 100))
            lines.append(
                f'{pname}{{quantile="{q}"}} {h.get(key, 0.0)!r}'
            )
        lines.append(f"{pname}_sum {h.get('total', 0.0)!r}")
        lines.append(f"{pname}_count {h.get('count', 0)}")
    return "\n".join(lines) + "\n"


class PrometheusServer:
    """Tiny /metrics HTTP endpoint in a daemon thread (stdlib
    http.server; port=0 binds an ephemeral port — read `.port` after
    start()). Binds loopback by default: the endpoint is unauthenticated
    and carries run metadata, so exposure beyond the host is an explicit
    opt-in (the drivers' --telemetry_host)."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        self._registry = registry
        self._host = host
        self._requested_port = port
        self._httpd = None
        self._thread = None
        self.port = None

    def start(self) -> "PrometheusServer":
        registry = self._registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = render_prometheus(snapshot(registry)).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        class Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            address_family = socket.AF_INET

        self._httpd = Server((self._host, self._requested_port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            daemon=True,
            name="telemetry-prometheus",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def _selftest(out_path: Optional[str]) -> Dict:
    """Exercise the full stack on a private registry + tracer; returns
    the verdict dict (ok + per-check results)."""
    import os
    import tempfile

    from torchbeast_tpu_torch.telemetry.trace import Tracer

    checks = {}
    registry = MetricsRegistry()
    registry.counter("selftest.count").inc(3)
    registry.gauge("selftest.depth").set(7)
    hist = registry.histogram("selftest.latency_s")
    for i in range(1, 101):
        hist.observe(i / 1000.0)
    p50 = hist.percentile(0.5)
    checks["histogram_p50_bounded"] = bool(0.040 <= p50 <= 0.060)

    tracer = Tracer()
    with tracer.span("selftest.outer"):
        with tracer.span("selftest.inner"):
            pass
    st = tracer.stage("selftest.request")
    st.stamp("queue")
    st.stamp("reply")
    st.finish()
    names = {e["name"] for e in tracer.events()}
    checks["spans_recorded"] = bool(
        {"selftest.outer", "selftest.inner",
         "selftest.request.queue", "selftest.request.reply"} <= names
    )

    snap0 = snapshot(registry)
    hist.observe(5.0)
    registry.counter("selftest.count").inc(2)
    snap1 = snapshot(registry)
    d = delta(snap1, snap0)
    checks["delta_counter"] = d["counters"]["selftest.count"] == 2.0
    checks["delta_histogram"] = (
        d["histograms"]["selftest.latency_s"]["count"] == 1
    )
    checks["validate_snapshot"] = validate_snapshot(snap1) == []
    checks["validate_delta"] = validate_snapshot(d) == []

    path = out_path
    tmpdir = None
    if path is None:
        tmpdir = tempfile.mkdtemp(prefix="telemetry_selftest_")
        path = os.path.join(tmpdir, "telemetry.jsonl")
    exporter = JsonLinesExporter(path, registry, static={"driver": "selftest"})
    exporter.write(extra={"step": 1})
    exporter.write(extra={"step": 2})
    lines = read_jsonl(path)
    checks["jsonl_roundtrip"] = (
        len(lines) == 2
        and all(validate_snapshot(ln) == [] for ln in lines)
        and lines[-1]["step"] == 2
        and lines[-1]["driver"] == "selftest"
    )
    text = render_prometheus(snap1)
    checks["prometheus_render"] = (
        "selftest_count 5.0" in text
        and 'selftest_latency_s{quantile="0.5"}' in text
    )
    block = telemetry_block(prev=snap0, registry=registry)
    checks["telemetry_block"] = (
        validate_snapshot(block["snapshot"]) == []
        and isinstance(block["enabled"], bool)
    )
    return {
        "selftest": "telemetry",
        "ok": all(checks.values()),
        "checks": checks,
        "jsonl": path,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--selftest", action="store_true",
        help="Exercise instruments/spans/snapshot/delta/exporters and "
             "print one JSON verdict line (rc 0 iff every check passed).",
    )
    parser.add_argument(
        "--out", default=None,
        help="Where --selftest writes its scratch telemetry.jsonl "
             "(default: a temp dir).",
    )
    args = parser.parse_args(argv)
    if not args.selftest:
        parser.error("nothing to do (did you mean --selftest?)")
    verdict = _selftest(args.out)
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
