"""Online per-section timing profiler — a thin shim over telemetry
histograms.

Same API and split-timer semantics as before (each `time(name)`
attributes the span since the previous mark to `name`, like lap times
on a stopwatch; `means`/`stds`/`summary` report exact running moments),
but each section is now a telemetry.metrics.Histogram: the moments are
tracked exactly (count/sum/sumsq per-thread shards), and the SAME
instruments additionally expose p50/p95/p99, land in telemetry
snapshots, and merge across threads.

By default every Timings owns a PRIVATE registry, so tests and
--no_telemetry runs behave exactly as the old class did. Drivers pass
`registry=telemetry.get_registry(), prefix="learner."` so their stage
latencies ("dequeue", "learn", "collect") become `learner.dequeue`
etc. in the exported snapshot — the stage-latency (p50/p95) series the
acceptance criteria name.

The port's copy of torchbeast_tpu/utils/prof.py, plus `DeviceTrace`:
the drivers' --profile_dir, where the reference starts jax.profiler.
"""

import json
import logging
import os
import time
import timeit
from typing import Dict, List, Optional, Tuple

from torchbeast_tpu_torch.telemetry.metrics import Histogram, MetricsRegistry
from torchbeast_tpu_torch.telemetry.trace import get_tracer


class Timings:
    """Split-timer over telemetry histograms."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        prefix: str = "",
    ):
        self._registry = (
            registry if registry is not None else MetricsRegistry()
        )
        self._prefix = prefix
        # name -> histogram, insertion-ordered; list(dict.items()) is a
        # single C call, so monitor threads can read while the timed
        # thread inserts a new section.
        self._sections: Dict[str, Histogram] = {}
        self.reset()

    def reset(self):
        """Start a fresh lap without attributing the elapsed span."""
        self._mark = timeit.default_timer()

    def time(self, name: str):
        """Record the time since the last reset()/time() call under `name`."""
        now = timeit.default_timer()
        section = self._sections.get(name)
        if section is None:
            section = self._sections[name] = self._registry.histogram(
                self._prefix + name
            )
        section.observe(now - self._mark)
        self._mark = now

    def histogram(self, name: str) -> Optional[Histogram]:
        """The backing histogram of a section (percentile access)."""
        return self._sections.get(name)

    def means(self) -> Dict[str, float]:
        return {name: h.mean for name, h in list(self._sections.items())}

    def stds(self) -> Dict[str, float]:
        return {name: h.std for name, h in list(self._sections.items())}

    def summary(self, prefix: str = "") -> str:
        means = self.means()
        stds = self.stds()
        total = sum(means.values()) or 1e-9
        rows = [
            f"  {k}: {1000 * means[k]:.2f}ms +- {1000 * stds[k]:.2f}ms "
            f"({100 * means[k] / total:.1f}%)"
            for k in sorted(means, key=means.get, reverse=True)
        ]
        return "\n".join(
            [f"{prefix}Mean duration of {len(means)} events "
             f"(total {1000 * total:.1f}ms):"] + rows
        )


# The profiler annotations that tie perf_counter to the profiler's clock.
CLOCK = "tbt.clock"
CLOCK_SAMPLES = 5


def clock_samples(tag: str) -> List[Tuple[str, float, float]]:
    """Open CLOCK_SAMPLES profiler annotations, each between two
    perf_counter reads: [(annotation name, before, after)]. In the trace,
    each annotation's start lies between its two reads."""
    from torch.profiler import record_function

    out = []
    for i in range(CLOCK_SAMPLES):
        name = f"{CLOCK}.{tag}.{i}"
        annotation = record_function(name)
        before = time.perf_counter()
        annotation.__enter__()
        after = time.perf_counter()
        annotation.__exit__(None, None, None)
        out.append((name, before, after))
    return out


def clock_map(trace_events, samples):
    """(a, b, pid): a profiler timestamp (us) is a + b x perf_counter (s)
    on the profiler's clock, and pid its host process, from the clock
    annotations of `samples` (clock_samples' of the start and of the
    stop) found among `trace_events`; None where none is found. The
    narrowest sample of each tag counts; with one tag found, b is 1e6."""
    found = {ev.get("name"): ev for ev in trace_events
             if str(ev.get("name", "")).startswith(CLOCK + ".")}
    best = {}
    for name, before, after in samples:
        ev = found.get(name)
        tag = name.split(".")[-2]
        if ev is not None and (tag not in best
                               or after - before < best[tag][2]):
            best[tag] = ((before + after) / 2, ev["ts"], after - before,
                         ev.get("pid"))
    points = sorted(best.values())
    if not points:
        return None
    t0, p0, _, pid = points[0]
    b = 1e6
    if len(points) > 1 and points[-1][0] > t0:
        b = (points[-1][1] - p0) / (points[-1][0] - t0)
    return p0 - b * t0, b, pid


def merge_host_events(trace_events, host_events, samples, native_tids,
                      window):
    """`trace_events` plus the telemetry Tracer's `host_events` (spans and
    StageTraces, perf_counter microseconds) mapped onto the profiler's
    clock (clock_map) and its host process, each on its OS thread's row
    (`native_tids`, Tracer.native_tids()). Only host events that start in
    `window` (perf_counter seconds, start and stop) are added. Without a
    clock annotation the trace comes back as it was."""
    mapping = clock_map(trace_events, samples)
    if mapping is None:
        return list(trace_events)
    a, b, pid = mapping
    lo, hi = window
    return list(trace_events) + [
        dict(ev, ts=a + b * ev["ts"] / 1e6, dur=b * ev["dur"] / 1e6,
             pid=pid, tid=native_tids.get(ev["tid"], ev["tid"]))
        for ev in host_events if lo <= ev["ts"] / 1e6 <= hi]


class DeviceTrace:
    """--profile_dir: a torch.profiler trace of the run (host and, on the
    card, CUDA activity), written at `stop()` as Chrome trace-event JSON
    to {profile_dir}/trace.json, which profile_update.py's
    `update_windows` reads. The telemetry Tracer's spans and StageTraces
    of the profiled window (`learner.dispatch`, `graph.replay`, ...) are
    merged into the same file on the profiler's clock (clock annotations
    at the start and at the stop, merge_host_events), so a host span and
    the device ops it launched share one timeline. A failure to start or
    to write degrades to a logged warning: profiling never aborts the
    run."""

    def __init__(self, profile_dir: Optional[str]):
        self.path = None
        self._prof = None
        if not profile_dir:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(os.path.expanduser(profile_dir), exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._samples = clock_samples("start")
            self.path = os.path.join(os.path.expanduser(profile_dir),
                                     "trace.json")
        except Exception:  # noqa: BLE001
            self._prof = None
            logging.getLogger(__name__).exception(
                "Could not start the profiler for %s", profile_dir)

    def stop(self) -> Optional[str]:
        """Stop tracing and write the trace; its path, or None."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        try:
            samples = self._samples + clock_samples("stop")
            prof.stop()
            prof.export_chrome_trace(self.path)
            with open(self.path) as f:
                doc = json.load(f)
            tracer = get_tracer()
            doc["traceEvents"] = merge_host_events(
                doc.get("traceEvents", []), tracer.events(), samples,
                tracer.native_tids(), (samples[0][1], samples[-1][2]))
            with open(self.path, "w") as f:
                json.dump(doc, f)
            logging.getLogger(__name__).info("Wrote a device trace to %s",
                                             self.path)
            return self.path
        except Exception:  # noqa: BLE001
            logging.getLogger(__name__).exception(
                "Could not write the trace to %s", self.path)
            return None
