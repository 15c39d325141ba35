"""Pipeline span tracing, exportable as Chrome trace-event JSON.

Two granularities:

- `Tracer.span(name)` — a context-managed duration span on the calling
  thread (nesting renders as stacked bars in chrome://tracing /
  Perfetto, which nest "X" events on one tid by containment).
- `Tracer.stage(name)` — a StageTrace that travels WITH a request
  across threads: each pipeline stage calls `.stamp("stage")` as the
  request passes (actor -> wire -> inference-queue -> batch -> dispatch
  -> reply; learner dequeue -> stage -> update), and `.finish()` emits
  one span per consecutive stamp pair. This is how a single slow
  request's time is attributed to queue wait vs. batch wait vs. reply.

Events land in a bounded ring buffer (old events drop, hot paths never
block or grow memory); `export_chrome(path)` writes the standard
{"traceEvents": [...]} JSON that chrome://tracing and Perfetto load
directly. Orphaned spans (begun, never ended) are tracked and counted
but never exported — a crashed stage can't leave half-open garbage in
the trace. stdlib only; timestamps are perf_counter-based (monotonic),
mapped once to the wall clock for the export's displayTimeUnit.

The port's copy of torchbeast_tpu/telemetry/trace.py.
"""

import collections
import contextlib
import itertools
import json
import threading
import time
from typing import Dict, List, Optional

from torchbeast_tpu_torch.telemetry.metrics import _ENABLED


class _OpenSpan:
    __slots__ = ("name", "cat", "start", "tid", "args", "ended")

    def __init__(self, name, cat, start, tid, args):
        self.name = name
        self.cat = cat
        self.start = start
        self.tid = tid
        self.args = args
        self.ended = False


class StageTrace:
    """Stamps one request's passage through named pipeline stages.

    Thread-safe by handoff: exactly one thread holds the request at a
    time (the same discipline the request payload itself rides on), so
    stamps append without a lock. `finish()` (idempotent) emits the
    per-stage spans into the owning tracer.
    """

    __slots__ = ("_tracer", "name", "_stamps", "_done", "args")

    def __init__(self, tracer: "Tracer", name: str, **args):
        self._tracer = tracer
        self.name = name
        self._stamps = [("start", time.perf_counter())]
        self._done = False
        self.args = args or None

    def stamp(self, stage: str) -> None:
        if not self._done:
            self._stamps.append((stage, time.perf_counter()))

    def stages(self) -> List[str]:
        return [s for s, _ in self._stamps[1:]]

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        prev_t = self._stamps[0][1]
        for stage, t in self._stamps[1:]:
            self._tracer.add_complete(
                f"{self.name}.{stage}", self.name, prev_t, t - prev_t,
                args=self.args,
            )
            prev_t = t
        if len(self._stamps) > 1:
            self._tracer.add_complete(
                self.name, self.name, self._stamps[0][1],
                self._stamps[-1][1] - self._stamps[0][1], args=self.args,
            )


class Tracer:
    def __init__(self, max_events: int = 32768, gated: bool = False):
        self._events = collections.deque(maxlen=max_events)
        self._gated = gated
        self._ids = itertools.count(1)
        self._open: Dict[int, _OpenSpan] = {}
        self._open_lock = threading.Lock()
        self._tid_lock = threading.Lock()
        self._tids: Dict[int, int] = {}
        # One perf_counter<->wall-clock correspondence for the export.
        self._wall_at_zero = time.time() - time.perf_counter()

    def enabled(self) -> bool:
        return not (self._gated and not _ENABLED[0])

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._tid_lock:
                tid = self._tids.setdefault(ident, len(self._tids) + 1)
        return tid

    def add_complete(
        self, name: str, cat: str, start: float, dur: float,
        tid: Optional[int] = None, args: Optional[dict] = None,
    ) -> None:
        """Record a completed span (Chrome 'X' event). `start` is a
        perf_counter timestamp; `dur` seconds."""
        if not self.enabled():
            return
        event = {
            "name": name,
            "cat": cat or "span",
            "ph": "X",
            "ts": start * 1e6,
            "dur": max(dur, 0.0) * 1e6,
            "pid": 0,
            "tid": tid if tid is not None else self._tid(),
        }
        if args:
            event["args"] = dict(args)
        self._events.append(event)

    def begin(self, name: str, cat: str = "", **args) -> Optional[int]:
        """Open a span by token (for spans that end on another code
        path). Returns the token, or None when tracing is disabled."""
        if not self.enabled():
            return None
        token = next(self._ids)
        span = _OpenSpan(
            name, cat, time.perf_counter(), self._tid(), args or None
        )
        with self._open_lock:
            self._open[token] = span
        return token

    def end(self, token: Optional[int], **args) -> bool:
        """Close a span opened with begin(). Unknown/already-ended/None
        tokens are a no-op (returns False) — double-end can't corrupt
        the trace."""
        if token is None:
            return False
        with self._open_lock:
            span = self._open.pop(token, None)
        if span is None or span.ended:
            return False
        span.ended = True
        merged = dict(span.args or {})
        merged.update(args)
        self.add_complete(
            span.name, span.cat, span.start,
            time.perf_counter() - span.start,
            tid=span.tid, args=merged or None,
        )
        return True

    def open_count(self) -> int:
        """Spans begun but not yet ended (orphans, if it stays > 0)."""
        with self._open_lock:
            return len(self._open)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **args):
        """Duration span on the calling thread; nests naturally."""
        if not self.enabled():
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add_complete(
                name, cat, start, time.perf_counter() - start,
                args=args or None,
            )

    def stage(self, name: str, **args) -> Optional[StageTrace]:
        """A cross-thread request trace; None when disabled so call
        sites guard with `if trace is not None`."""
        if not self.enabled():
            return None
        return StageTrace(self, name, **args)

    def events(self) -> List[dict]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def export_chrome(self, path: str) -> int:
        """Write {"traceEvents": [...]} (chrome://tracing / Perfetto
        format). Returns the number of events written."""
        events = self.events()
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_time_at_ts_zero": self._wall_at_zero,
                "open_spans_dropped": self.open_count(),
            },
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)


# Process-wide tracer, gated with the metrics registry.
_GLOBAL = Tracer(gated=True)


def get_tracer() -> Tracer:
    return _GLOBAL
