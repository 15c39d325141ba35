"""Process-wide metrics registry: Counter / Gauge / Histogram.

Design constraints:

- No hot-path locks. Counters and histograms write to PER-THREAD shards
  (a thread-local cell registered once per thread under a creation
  lock); `inc`/`observe` are plain dict/float ops on the calling
  thread's shard. Readers merge a snapshot of the shard list — the
  `list()` copy is a single C call, atomic under the GIL, so a monitor
  thread can merge while writers keep appending.
- Mergeable log-bucketed histograms. Bucket i >= 1 covers
  (LO*G^(i-1), LO*G^i] with G = 2**0.25 (~19% wide, so any bucket
  representative is within ~9% of every value it absorbed — p50/p95/p99
  read from merged buckets carry that bounded relative error). Bucket 0
  absorbs v <= LO (including 0 and negatives). Sparse dicts of
  index -> count add and subtract term-wise, which is what makes
  cross-shard merge and snapshot delta exact.
- stdlib only. This module must stay importable (and its ops runnable)
  without jax or numpy: instrumentation inside the acting hot path may
  never trigger a device sync or a heavyweight import
  (tests/test_telemetry.py pins both).

The GLOBAL registry (telemetry.get_registry()) is gated by
set_enabled(): with telemetry off its instruments become no-ops, so a
--no_telemetry run pays one attribute check per call site. Private
registries (MetricsRegistry()) ignore the gate — utils/prof.Timings
uses one by default so driver log lines keep working with telemetry
disabled.

The port's copy of torchbeast_tpu/telemetry/metrics.py.
"""

import logging
import math
import threading
from typing import Dict, Iterable, Optional

# Log-bucket geometry, shared by observe-side indexing and read-side
# percentile reconstruction (and by export.delta, which re-derives
# percentiles from subtracted bucket counts).
BUCKET_LO = 1e-9
BUCKET_GROWTH = 2.0 ** 0.25
_LOG_GROWTH = math.log(BUCKET_GROWTH)

# Global on/off gate, honored only by gated (global-registry) instruments.
_ENABLED = [True]


def set_enabled(on: bool) -> None:
    """Flip the global-registry gate (--no_telemetry). Private
    registries are unaffected."""
    _ENABLED[0] = bool(on)


def is_enabled() -> bool:
    return _ENABLED[0]


def bucket_index(value: float) -> int:
    """Log-bucket index of a sample (0 = underflow bucket, v <= LO)."""
    if value <= BUCKET_LO:
        return 0
    return 1 + int(math.log(value / BUCKET_LO) / _LOG_GROWTH)


def bucket_bounds(index: int):
    """(lower, upper] bounds of a bucket (lower is -inf for bucket 0)."""
    if index <= 0:
        return (float("-inf"), BUCKET_LO)
    return (
        BUCKET_LO * BUCKET_GROWTH ** (index - 1),
        BUCKET_LO * BUCKET_GROWTH ** index,
    )


def bucket_representative(index: int) -> float:
    """The value a bucket's samples are reported as (geometric middle;
    0.0 for the underflow bucket)."""
    if index <= 0:
        return 0.0
    return BUCKET_LO * BUCKET_GROWTH ** (index - 0.5)


def percentiles_from_buckets(
    buckets: Dict[int, int],
    qs: Iterable[float],
    lo: Optional[float] = None,
    hi: Optional[float] = None,
):
    """Percentile estimates from a (possibly merged or delta'd) sparse
    bucket dict. `lo`/`hi` clamp the estimates to the exactly-tracked
    min/max when the caller has them."""
    total = sum(buckets.values())
    out = []
    if total <= 0:
        return [0.0 for _ in qs]
    items = sorted(buckets.items())
    for q in qs:
        rank = q * total
        cum = 0
        value = bucket_representative(items[-1][0])
        for index, count in items:
            cum += count
            if cum >= rank:
                value = bucket_representative(index)
                break
        if lo is not None:
            value = max(value, lo)
        if hi is not None:
            value = min(value, hi)
        out.append(value)
    return out


def hist_stats(
    buckets: Dict[int, int],
    total: float,
    total_sq: float,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
) -> Dict:
    """THE constructor of the snapshot histogram-stats shape — live
    Histogram.stats(), export's delta/merge, and the schema validator
    all derive from this one function, so the schema cannot drift
    apart. Count derives from the bucket sums (keeps bucket-sum ==
    count true by construction). `lo`/`hi` are the exact min/max when
    the caller has them; otherwise the extreme buckets' representatives
    bound them within one bucket width."""
    buckets = {int(k): v for k, v in buckets.items() if v > 0}
    count = sum(buckets.values())
    if count <= 0:
        return {
            "count": 0, "total": 0.0, "total_sq": 0.0,
            "min": 0.0, "max": 0.0, "mean": 0.0, "std": 0.0,
            "p50": 0.0, "p95": 0.0, "p99": 0.0, "buckets": {},
        }
    if lo is None:
        lo = bucket_representative(min(buckets))
        hi = bucket_representative(max(buckets))
    mean = total / count
    std = max(total_sq / count - mean * mean, 0.0) ** 0.5
    p50, p95, p99 = percentiles_from_buckets(
        buckets, (0.5, 0.95, 0.99), lo=lo, hi=hi
    )
    return {
        "count": count,
        "total": total,
        "total_sq": total_sq,
        "min": lo,
        "max": hi,
        "mean": mean,
        "std": std,
        "p50": p50,
        "p95": p95,
        "p99": p99,
        "buckets": {str(k): v for k, v in sorted(buckets.items())},
    }


class Counter:
    """Monotonic float counter with per-thread shards.

    Shard lifecycle: registering a new shard (once per writer thread,
    under the creation lock) also FOLDS shards of dead threads into a
    retired total, so short-lived-thread churn (env-server connection
    threads, actor reconnects) can't grow the shard list unboundedly.
    The (shards, retired) pair is published as ONE tuple so readers
    never see a fold half-applied (which would double- or under-count).
    """

    def __init__(self, name: str, gated: bool = False):
        self.name = name
        self._gated = gated
        self._lock = threading.Lock()
        # (list of (thread, cell), retired_total) — replaced atomically.
        self._state = ([], 0.0)
        self._local = threading.local()

    def _cell(self):
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [0.0]
            with self._lock:
                shards, retired = self._state
                alive = []
                for thread, old in shards:
                    if thread.is_alive():
                        alive.append((thread, old))
                    else:
                        retired += old[0]
                alive.append((threading.current_thread(), cell))
                self._state = (alive, retired)
            self._local.cell = cell
        return cell

    def inc(self, n: float = 1.0) -> None:
        if self._gated and not _ENABLED[0]:
            return
        self._cell()[0] += n

    def value(self) -> float:
        shards, retired = self._state
        return retired + sum(cell[0] for _, cell in shards)

    def num_shards(self) -> int:
        return len(self._state[0])


class Gauge:
    """Last-write-wins instantaneous value (one float; the assignment
    is atomic under the GIL, so no shards are needed)."""

    def __init__(self, name: str, gated: bool = False):
        self.name = name
        self._gated = gated
        self._value = 0.0

    def set(self, value: float) -> None:
        if self._gated and not _ENABLED[0]:
            return
        self._value = float(value)

    def value(self) -> float:
        return self._value


class _HistShard:
    __slots__ = ("buckets", "count", "total", "total_sq", "min", "max")

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        # `count` is only maintained on AGGREGATES (derived from bucket
        # sums in _fold_into); live per-thread shards leave it 0 so a
        # racing reader can never observe bucket-sum != count.
        self.count = 0
        self.total = 0.0
        self.total_sq = 0.0
        self.min = float("inf")
        self.max = float("-inf")


def _fold_into(out: _HistShard, shard: _HistShard) -> None:
    """Accumulate `shard` into aggregate `out`. The bucket dict is
    copied first: the owning thread may be mid-increment, and a dict
    copy is atomic enough (counts may lag by the in-flight sample,
    never corrupt)."""
    for index, count in dict(shard.buckets).items():
        out.buckets[index] = out.buckets.get(index, 0) + count
    out.total += shard.total
    out.total_sq += shard.total_sq
    if shard.min < out.min:
        out.min = shard.min
    if shard.max > out.max:
        out.max = shard.max
    out.count = sum(out.buckets.values())


class Histogram:
    """Log-bucketed histogram with exact moments (count/sum/sumsq/
    min/max) and bounded-error percentiles, sharded per thread.

    Same shard lifecycle as Counter: new-shard registration folds
    dead threads' shards into a retired aggregate (published atomically
    with the live list), bounding memory and merge cost by the LIVE
    thread count. The merged count is derived from the bucket sums, so
    a snapshot racing an in-flight observe() can never report
    bucket-sum != count (the moments may lag by the one in-flight
    sample — a transient one-sample mean skew, never an inconsistent
    schema)."""

    def __init__(self, name: str, gated: bool = False):
        self.name = name
        self._gated = gated
        self._lock = threading.Lock()
        # (list of (thread, shard), retired _HistShard) — the retired
        # aggregate is never mutated after publication (folds build a
        # fresh one), so readers holding an old tuple stay consistent.
        self._state = ([], _HistShard())
        self._local = threading.local()

    def _shard(self) -> _HistShard:
        shard = getattr(self._local, "shard", None)
        if shard is None:
            shard = _HistShard()
            with self._lock:
                shards, retired = self._state
                dead = [s for t, s in shards if not t.is_alive()]
                if dead:
                    folded = _HistShard()
                    _fold_into(folded, retired)
                    for s in dead:
                        _fold_into(folded, s)
                    retired = folded
                    shards = [
                        (t, s) for t, s in shards if t.is_alive()
                    ]
                self._state = (
                    shards + [(threading.current_thread(), shard)],
                    retired,
                )
            self._local.shard = shard
        return shard

    def observe(self, value: float) -> None:
        if self._gated and not _ENABLED[0]:
            return
        value = float(value)
        shard = self._shard()
        shard.total += value
        shard.total_sq += value * value
        if value < shard.min:
            shard.min = value
        if value > shard.max:
            shard.max = value
        index = bucket_index(value)
        shard.buckets[index] = shard.buckets.get(index, 0) + 1

    def observe_aggregate(self, buckets: Dict[int, int], total: float,
                          total_sq: float, lo: float, hi: float) -> None:
        """Credit a pre-aggregated batch of observations — the native-
        runtime fold path (runtime/native.py): the C++ core accumulates
        per-request stage stamps into the SAME log-bucket geometry
        (csrc/queues.h telemetry_bucket_index) and the driver folds each
        monitor tick's interval here. Exact in buckets and moments;
        `lo`/`hi` are the interval's true min/max. No-op on an empty
        interval."""
        if self._gated and not _ENABLED[0]:
            return
        counts = {int(k): int(v) for k, v in buckets.items() if v > 0}
        if not counts:
            return
        shard = self._shard()
        for index, count in counts.items():
            shard.buckets[index] = shard.buckets.get(index, 0) + count
        shard.total += float(total)
        shard.total_sq += float(total_sq)
        if lo < shard.min:
            shard.min = float(lo)
        if hi > shard.max:
            shard.max = float(hi)

    def merged(self) -> _HistShard:
        """One shard-shaped aggregate over every thread's shard (plus
        the retired fold); count is derived from the bucket sums."""
        shards, retired = self._state
        out = _HistShard()
        _fold_into(out, retired)
        for _, shard in shards:
            _fold_into(out, shard)
        return out

    def num_shards(self) -> int:
        return len(self._state[0])

    @property
    def count(self) -> int:
        return self.merged().count

    @property
    def mean(self) -> float:
        m = self.merged()
        return m.total / m.count if m.count else 0.0

    @property
    def std(self) -> float:
        m = self.merged()
        if not m.count:
            return 0.0
        mean = m.total / m.count
        # Clamped: float cancellation can dip epsilon-negative.
        return max(m.total_sq / m.count - mean * mean, 0.0) ** 0.5

    def percentile(self, q: float) -> float:
        m = self.merged()
        if not m.count:
            return 0.0
        return percentiles_from_buckets(
            m.buckets, [q], lo=m.min, hi=m.max
        )[0]

    def stats(self) -> Dict:
        """Snapshot dict for the exporter: exact moments, estimated
        percentiles, and the raw sparse buckets (str-keyed for JSON)
        so snapshots stay mergeable/delta-able downstream."""
        m = self.merged()
        return hist_stats(
            m.buckets, m.total, m.total_sq,
            lo=m.min if m.count else None,
            hi=m.max if m.count else None,
        )


class MetricsRegistry:
    """Name -> instrument table with idempotent get-or-create (the
    creation lock is off the hot path; call sites keep the returned
    instrument)."""

    def __init__(self, gated: bool = False):
        self._gated = gated
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}  # guarded-by: self._lock
        self._collectors = []  # guarded-by: self._lock

    def _get_or_create(self, name: str, cls):
        # Double-checked locking: the lock-free first read is re-checked
        # under the lock before any mutation; dict reads are atomic
        # under the GIL, and instruments are never removed or replaced.
        # beastlint: disable=LOCK-DISCIPLINE  racy fast-path read is re-validated under self._lock below
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, gated=self._gated)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise ValueError(
                f"Instrument {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def add_collector(self, fn) -> None:
        """Run `fn(registry)` before every snapshot of this registry: a
        source that accumulates elsewhere (the learner's device marks,
        marks.py) merges what it gained since its last call."""
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> None:
        """Run every collector once. A failing collector is logged and
        skipped: a snapshot never fails for one."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:  # noqa: BLE001
                logging.getLogger(__name__).exception(
                    "Telemetry collector %r failed", fn)

    def instruments(self) -> Dict[str, object]:
        # Snapshot copy; same GIL-atomic read as the fast path above.
        # beastlint: disable=LOCK-DISCIPLINE  read-only snapshot of a grow-only dict; GIL-atomic
        return dict(self._instruments)


# The process-wide registry all runtime instrumentation writes to.
_GLOBAL = MetricsRegistry(gated=True)


def get_registry() -> MetricsRegistry:
    return _GLOBAL
