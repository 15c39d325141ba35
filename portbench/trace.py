"""A torch.profiler trace of a few dispatches, reduced to what the
per-layer metrics read: the device operations, the traced window and the
card's busy time in it, the host's CUDA API calls inside each dispatch
span, and the breakdown of the device's time and of its idle gaps."""

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

from portbench import yardstick

SPAN = "portbench.dispatch"  # the span around each traced dispatch
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = API_CATS + ("cpu_op", "user_annotation", "python_function")
TOP = 10


class Trace(NamedTuple):
    updates: int
    device_ops: list  # [(name, start us, end us)]
    window_us: float
    busy_us: float
    api_calls_per_dispatch: float
    breakdown: dict


@contextlib.contextmanager
def profiled(on_device: bool):
    """A torch.profiler window of host operations and, on a card, device
    operations and CUDA API calls; yields a list that holds the chrome
    trace's events once the window has closed."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if on_device:
        activities.append(ProfilerActivity.CUDA)
    events = []
    with profile(activities=activities) as prof:
        yield events
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events.extend(json.load(f)["traceEvents"])


def _span(ev):
    return ev["ts"], ev["ts"] + ev.get("dur", 0)


def _gaps(ops, lo, hi):
    """The idle intervals of [lo, hi] between the device operations."""
    gaps, reach = [], lo
    for _, a, b in sorted(ops, key=lambda op: op[1]):
        if b <= lo:
            continue
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    if hi > reach:
        gaps.append((reach, hi))
    return gaps


def _host_at(host, t):
    """The innermost host operation running at time t, or None."""
    best = None
    for name, a, b in host:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return None if best is None else best[0]


def _dispatch_of(events, spans):
    """{correlation id: index of the dispatch span its API call lies in}."""
    out = {}
    for ev in events:
        corr = (ev.get("args") or {}).get("correlation")
        if ev.get("cat") in API_CATS and corr is not None:
            for i, (tid, a, b) in enumerate(spans):
                if ev["tid"] == tid and a <= ev["ts"] <= b:
                    out[corr] = i
    return out


def summarize(events, updates: int) -> Trace:
    """The trace of `updates` dispatches, each in a span named SPAN. The
    traced window runs from the completion on the card of the first
    dispatch's work to that of the last's, so it holds updates - 1 whole
    updates and starts with the card's queue full; where no device
    operation can be tied to its dispatch, it spans every operation."""
    spans = sorted(((ev["tid"], *_span(ev)) for ev in events
                    if ev.get("cat") == "user_annotation"
                    and ev.get("name") == SPAN), key=lambda s: s[1])
    dispatch = _dispatch_of(events, spans)
    ops = []
    for ev in events:
        if ev.get("cat") in DEVICE_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            ops.append((ev.get("name", ""), *_span(ev), dispatch.get(corr)))
    ends = {}
    for _, _, b, d in ops:
        if d is not None:
            ends[d] = max(ends.get(d, b), b)
    if len(spans) > 1 and {0, len(spans) - 1} <= set(ends):
        lo, hi = ends[0], ends[len(spans) - 1]
        ops = [op for op in ops if op[3] != 0 and op[2] > lo and op[1] < hi]
        updates = len(spans) - 1
    else:
        lo = min((a for _, a, _, _ in ops), default=0.0)
        hi = max((b for _, _, b, _ in ops), default=0.0)
    ops = [(name, a, b) for name, a, b, _ in ops]
    api = [(ev["tid"], *_span(ev)) for ev in events
           if ev.get("cat") in API_CATS]
    calls = sum(1 for tid, a, _ in api for stid, sa, sb in spans
                if tid == stid and sa <= a <= sb)
    busy = yardstick.union_us([(a, b) for _, a, b in ops], lo, hi)
    by_name = defaultdict(float)
    for name, a, b in ops:
        by_name[name] += min(b, hi) - max(a, lo)
    host = [(ev.get("name", ""), *_span(ev)) for ev in events
            if ev.get("cat") in HOST_CATS]
    gaps = sorted(_gaps(ops, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    breakdown = {
        "device_ops": [[name[:120], us / 1e6] for name, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[(_host_at(host, (a + b) / 2) or "host idle")[:120],
                       (b - a) / 1e6] for a, b in gaps],
    }
    return Trace(updates, ops, hi - lo, busy,
                 calls / len(spans) if spans else None, breakdown)


def device_ms_per_update(trace: Trace, match) -> float:
    """Device milliseconds an update in the operations whose names
    `match(name)` accepts, or None where none ran."""
    hits = [b - a for name, a, b in trace.device_ops if match(name)]
    if not hits:
        return None
    return sum(hits) / 1e3 / trace.updates
