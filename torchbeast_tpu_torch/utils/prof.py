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

import logging
import os
import timeit
from typing import Dict, Optional

from torchbeast_tpu_torch.telemetry.metrics import Histogram, MetricsRegistry


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


class DeviceTrace:
    """--profile_dir: a torch.profiler trace of the run (host and, on the
    card, CUDA activity), written at `stop()` as Chrome trace-event JSON
    to {profile_dir}/trace.json, which profile_update.py's
    `update_windows` reads. A failure to start or to write degrades to a
    logged warning: profiling never aborts the run."""

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
            prof.stop()
            prof.export_chrome_trace(self.path)
            logging.getLogger(__name__).info("Wrote a device trace to %s",
                                             self.path)
            return self.path
        except Exception:  # noqa: BLE001
            logging.getLogger(__name__).exception(
                "Could not write the trace to %s", self.path)
            return None
