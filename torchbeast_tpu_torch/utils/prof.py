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

The port's copy of torchbeast_tpu/utils/prof.py.
"""

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
