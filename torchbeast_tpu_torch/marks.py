"""Device marks: the boundaries of a learner update, stamped on the card
inside the update's CUDA graph and folded into telemetry.

A CUDA graph is one launch, so a host span around it says nothing of its
parts, and a kernel's name does not say which part of the model launched
it. The marks do: each boundary of the update launches `tbt_mark<i>`
(csrc/mark.cu), a one-thread kernel that writes the card's nanosecond
timer to slot i of a small device buffer. The boundaries, in order:

    START          the update's first op (learner.update_body)
    HEAD_IN        RecurrentPolicyHead's entry: the trunk is done
    CORE_OUT       the LSTM core's output: the core is done
    BACKWARD       just before torch.autograd.grad: the losses are done
    CORE_OUT_GRAD  the gradient reaches the core's output
    HEAD_IN_GRAD   the gradient reaches the head's entry: the core's
                   backward is done
    STEP           just after torch.autograd.grad
    END            the update's last op, after the optimizer

Each region runs from one mark to the next (REGIONS): trunk_fwd,
core_fwd, loss_fwd (the policy and baseline heads, V-trace, the losses),
loss_bwd, core_bwd, trunk_bwd and opt (the norm pass, the clip and the
RMSprop tail), so together they cover the update with no gap. A model
without an LSTM marks neither core boundary and has no core region. The
model's two boundaries are marked in the backward by an identity
autograd Function (`boundary`), whose backward launches the mark on the
stream autograd runs it on. A mark that runs again (a region recomputed
under a remat plan) keeps the first stamp.

END also folds, on the card: each region's duration, the update's span
and, on a dispatch's first update, the gap since the previous dispatch's
end (the card's idle time between learner dispatches) go into a device
Accumulator: a histogram in the telemetry registry's bucket geometry, and
the exact count, sum, min, max and sum of squares. The Accumulator
registers a collector on the telemetry registry; each
`telemetry.snapshot()` copies it to the host and merges what is new into
the histograms `learner.device.<region>_s`, `learner.device.update_s` and
`learner.device.gap_s`, except while a graph is being captured
(graphs.outside_capture). Nothing syncs per update.

Scope: marks run only while a Recorder is active (`recording`).
graphs.CapturedUpdate activates a DeviceRecorder for its capture alone,
when telemetry is enabled at capture time, so only replays stamp and
fold; everywhere else `stamp` and `boundary` do nothing. A HostRecorder
stamps `time.perf_counter_ns()` and folds in Python: an eager update on
the CPU, which runs synchronously, gives the same regions.

**Summed regions** repeat within an update: a model's layers each run one,
forward and back. `region_in(x, pair)` and `region_out(y, pair)` bound
one instance: in the forward they enter and leave region pair[0]
(`tbt_region<r, 1>` stamps slot entered_slot(r), `tbt_region<r, 0>` adds the
time since to slot summed_slot(r)); their identity autograd Function
leaves and enters region pair[1] in the backward (the gradient reaches
y, then x). END folds each region that ran into one observation an
update, the sum of its intervals: the series `learner.device.<name>_s`
of SUMMED (MLA and MOE, the DeepSeek-V2 family's attention and MoE
layers, models/deepseek_v2.py). A region must close before it opens
again; regions of two pairs may nest.

**Values**: `observe_max(name, x)` keeps the largest 0-d value an update
of VALUES (the MoE layers' peak expert load, models/moe.DroplessMoE) in
slot value_slot(name), with torch ops on the card (so no sync and nothing
in the mark kernels), as an integer of billionths; END folds it as one
observation into the series VALUES[name], read as the value itself.

The marks are not counted in `ops.launch_counts()` and add nothing to
`precision.count_bytes` (no capture counts bytes).
"""

import bisect
import contextlib
import ctypes
import logging
import threading
import time

import torch

from torchbeast_tpu_torch.telemetry import metrics

(START, HEAD_IN, CORE_OUT, BACKWARD, CORE_OUT_GRAD, HEAD_IN_GRAD, STEP,
 END) = range(8)
BOUNDARIES = ("start", "head_in", "core_out", "backward", "core_out_grad",
              "head_in_grad", "step", "end")

# Region names by (from, to) boundary. Without an LSTM the core's two
# boundaries are not marked, and the loss regions start at the head.
REGIONS = {
    (START, HEAD_IN): "trunk_fwd",
    (HEAD_IN, CORE_OUT): "core_fwd",
    (CORE_OUT, BACKWARD): "loss_fwd",
    (HEAD_IN, BACKWARD): "loss_fwd",
    (BACKWARD, CORE_OUT_GRAD): "loss_bwd",
    (BACKWARD, HEAD_IN_GRAD): "loss_bwd",
    (CORE_OUT_GRAD, HEAD_IN_GRAD): "core_bwd",
    (HEAD_IN_GRAD, STEP): "trunk_bwd",
    (STEP, END): "opt",
}
UPDATE, GAP = "update", "gap"
SERIES_PREFIX = "learner.device."

# Summed regions, in slot order, and the (forward, backward) pairs that
# region_in and region_out take.
SUMMED = ("mla_fwd", "mla_bwd", "moe_fwd", "moe_bwd")
MLA, MOE = (0, 1), (2, 3)
# Values: name -> series; observe_max keeps an update's largest.
VALUES = {"moe_peak_load": "learner.moe.peak_load"}

# The device buffers' layout (csrc/mark.cu keeps the same numbers).
SLOTS = 32
PREV_END = 15  # the slot of the previous update's end
REGION_BASE = 16  # slots 16..23: each summed region's entry, then its sum
VALUE_BASE = REGION_BASE + 2 * len(SUMMED)  # slot 24: the values
FROM_SLOT = -2  # a fold row's `from` that reads `to` as a summed slot
BUCKETS = 192  # up to 2^47.75 ns (2.6 days); longer counts in the last
COUNT, SUM, MIN, MAX, SUMSQ = range(BUCKETS, BUCKETS + 5)
ROW = BUCKETS + 5
ROWS = 16
INT64_MAX = 2 ** 63 - 1

log = logging.getLogger(__name__)


def entered_slot(r: int) -> int:
    """The slot of summed region r's last entry."""
    return REGION_BASE + 2 * r


def summed_slot(r: int) -> int:
    """The slot of summed region r's sum over the update."""
    return REGION_BASE + 2 * r + 1


def value_slot(name: str) -> int:
    """The slot of value `name` (VALUES)."""
    return VALUE_BASE + list(VALUES).index(name)


def thresholds() -> list:
    """thr[i]: the fewest whole nanoseconds n that the registry's
    bucket_index(n * 1e-9) puts in bucket i or above (thr[0] = 0). A
    duration of v ns falls in the largest bucket i with thr[i] <= v, the
    bucket Histogram.observe(v * 1e-9) gives it."""
    thr = [0]
    for i in range(1, BUCKETS):
        n = max(thr[-1], int(metrics.BUCKET_GROWTH ** (i - 1)) - 2)
        while metrics.bucket_index(n * 1e-9) < i:
            n += 1
        thr.append(n)
    return thr


class Accumulator:
    """The device tensors the marks write, and their collector.

    `slots` holds the current update's stamps (ns) and the previous
    update's end; `table` one row a series: BUCKETS bucket counts, then the
    count, the sum, min and max (ns) and the sum of squares (s^2, the
    bits of a double). Rows are given out by series name (`row`). The
    tensors outlive every graph that writes them, so the series can be
    read after the learner is gone."""

    def __init__(self, device, registry=None):
        device = torch.device(device)
        self.slots = torch.zeros(SLOTS, dtype=torch.int64, device=device)
        acc = torch.zeros(ROWS, ROW, dtype=torch.int64)
        acc[:, MIN] = INT64_MAX
        self.table = acc.to(device)
        self.thr = torch.tensor(thresholds(), dtype=torch.int64,
                                device=device)
        self._rows = {}  # guarded-by: self._lock
        self._series = {}  # guarded-by: self._lock
        self._seen = acc.clone()  # guarded-by: self._lock
        self._lock = threading.Lock()
        if registry is not None:
            registry.add_collector(self.collect)

    def row(self, name: str, series: str = None) -> int:
        """The row of `name`, given out at its first call; its series is
        `series`, or `learner.device.<name>_s`."""
        with self._lock:
            if name not in self._rows:
                if len(self._rows) == ROWS:
                    raise ValueError(f"no accumulator row left for {name}")
                self._rows[name] = len(self._rows)
                self._series[name] = series or (SERIES_PREFIX + name + "_s")
            return self._rows[name]

    def collect(self, registry) -> None:
        """Merge what the rows gained since the last call into the
        registry's `learner.device.<name>_s` histograms (one device to
        host copy of `table`). A snapshot may run on another thread (the
        /metrics server's) while a graph is being captured, where the copy
        would invalidate the capture: it then merges nothing, and the
        next snapshot takes what this one left."""
        from torchbeast_tpu_torch import graphs

        with graphs.outside_capture() as free, self._lock:
            if not free:
                return
            now = self.table.to("cpu", copy=True)
            seen, self._seen = self._seen, now
            rows = dict(self._rows)
            series = dict(self._series)
        sumsq = [t.view(torch.float64)[:, SUMSQ].tolist()
                 for t in (now, seen)]
        now, seen = now.tolist(), seen.tolist()
        for name, r in rows.items():
            new = [a - b for a, b in zip(now[r], seen[r])]
            if new[COUNT] <= 0:
                continue
            buckets = {i: c for i, c in enumerate(new[:BUCKETS]) if c}
            hist = registry.histogram(series[name])
            hist.observe_aggregate(
                buckets, new[SUM] * 1e-9, sumsq[0][r] - sumsq[1][r],
                now[r][MIN] * 1e-9, now[r][MAX] * 1e-9)


_accumulators = {}
_accumulators_lock = threading.Lock()


def accumulator(device) -> Accumulator:
    """The process's Accumulator on `device`, registered with the global
    telemetry registry at its creation."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _accumulators_lock:
        if device not in _accumulators:
            from torchbeast_tpu_torch import telemetry

            _accumulators[device] = Accumulator(device,
                                                telemetry.get_registry())
        return _accumulators[device]


class Recorder:
    """One dispatch's marks: which boundaries each update marked, in the
    order of their first stamps, and the fold the END mark runs.
    Subclasses write the stamps (`_launch`)."""

    def __init__(self, acc: Accumulator):
        self.acc = acc
        self.updates = 0
        self._marked = []
        self._summed = set()
        self._values = set()

    def begin_dispatch(self) -> None:
        self.updates = 0

    def mark(self, index: int) -> None:
        fold = None
        if index == START:
            self._marked = [START]
            self._summed, self._values = set(), set()
            self.updates += 1
        elif index not in self._marked:
            self._marked.append(index)
        if index == END:
            fold = self._fold_rows()
        self._launch(index, fold)

    def region(self, r: int, enter: bool) -> None:
        """Enter or leave summed region r."""
        self._summed.add(r)
        self._launch_region(r, enter)

    def value(self, name: str, x: torch.Tensor) -> None:
        """Keep the larger of x (0-d) and what value_slot(name) holds."""
        self._values.add(name)
        self._launch_value(value_slot(name), x)

    def _fold_rows(self):
        """[(from slot, to slot, accumulator row)]: each region between
        consecutive marks, the update's span, and on a dispatch's first
        update the gap since the last end (from -1)."""
        marked = self._marked
        rows = []
        for a, b in zip(marked, marked[1:]):
            name = REGIONS.get((a, b), f"{BOUNDARIES[a]}_{BOUNDARIES[b]}")
            rows.append((a, b, self.acc.row(name)))
        rows.append((START, END, self.acc.row(UPDATE)))
        if self.updates == 1:
            rows.append((-1, START, self.acc.row(GAP)))
        for r in sorted(self._summed):
            rows.append((FROM_SLOT, summed_slot(r), self.acc.row(SUMMED[r])))
        for name in sorted(self._values):
            rows.append((FROM_SLOT, value_slot(name),
                         self.acc.row(name, VALUES[name])))
        return rows

    def _launch(self, index, fold):
        raise NotImplementedError

    def _launch_region(self, r, enter):
        raise NotImplementedError

    def _launch_value(self, slot, x):
        """Keep max(slots[slot], x in billionths), with torch ops on the
        slots' device."""
        with torch.no_grad():
            v = torch.round(x.detach().double() * 1e9).to(torch.int64)
            cell = self.acc.slots.narrow(0, slot, 1)
            cell.copy_(torch.maximum(cell, v.reshape(1).to(cell.device)))


class DeviceRecorder(Recorder):
    """Marks as `tbt_mark<i>` launches on the current CUDA stream, for a
    graph capture: the capture records them, each replay runs them."""

    def __init__(self, acc: Accumulator, lib):
        super().__init__(acc)
        self._lib = lib

    def _launch(self, index, fold):
        from torchbeast_tpu_torch.ops import _build

        arg = table = None
        if fold is not None:
            # n, then every row's from, every row's to, every row's series.
            ints = [len(fold)] + [row[k] for k in range(3) for row in fold]
            table = (ctypes.c_int * len(ints))(*ints)
            arg = ctypes.cast(table, ctypes.c_void_p)
        status = self._lib.tbt_mark_launch(
            index, self.acc.slots.data_ptr(), self.acc.table.data_ptr(),
            self.acc.thr.data_ptr(), arg,
            torch.cuda.current_stream(self.acc.slots.device).cuda_stream)
        _build.check(status, f"tbt_mark<{index}>")

    def _launch_region(self, r, enter):
        from torchbeast_tpu_torch.ops import _build

        status = self._lib.tbt_region_launch(
            r, int(enter), self.acc.slots.data_ptr(),
            torch.cuda.current_stream(self.acc.slots.device).cuda_stream)
        _build.check(status, f"tbt_region<{r}, {int(enter)}>")


class HostRecorder(Recorder):
    """Marks stamped with the host's `time.perf_counter_ns()` into the
    Accumulator's CPU tensors, folded in Python as the kernel folds: for
    an eager update on the CPU, which runs synchronously. `stamps` lists
    every stamp written, as (dispatch, update in it, boundary, ns), each
    counted from 1."""

    def __init__(self, acc: Accumulator):
        super().__init__(acc)
        self.stamps = []
        self.dispatches = 0
        self._thr = acc.thr.tolist()

    def begin_dispatch(self) -> None:
        super().begin_dispatch()
        self.dispatches += 1

    def _launch(self, index, fold):
        slots = self.acc.slots
        now = time.perf_counter_ns()
        if index == START:
            slots[:END + 1] = 0
            slots[REGION_BASE:] = 0
        if int(slots[index]) == 0:
            slots[index] = now
            self.stamps.append((self.dispatches, self.updates, index, now))
        if fold is not None:
            for a, b, r in fold:
                if a == FROM_SLOT:
                    if int(slots[b]) > 0:
                        self.observe(r, int(slots[b]))
                    continue
                start = int(slots[PREV_END if a < 0 else a])
                end = int(slots[b])
                if start and end:
                    self.observe(r, max(end - start, 0))
            slots[PREV_END] = slots[END]

    def _launch_region(self, r, enter):
        """csrc/mark.cu's tbt_region<r, enter> on the host clock."""
        slots = self.acc.slots
        now = time.perf_counter_ns()
        if enter:
            slots[entered_slot(r)] = now
        elif int(slots[entered_slot(r)]):
            slots[summed_slot(r)] += max(now - int(slots[entered_slot(r)]), 0)

    def observe(self, r: int, d: int) -> None:
        """Add a duration of d ns to row r, as csrc/mark.cu's observe."""
        row = self.acc.table[r]
        row[bisect.bisect_right(self._thr, d) - 1] += 1
        row[COUNT] += 1
        row[SUM] += d
        row[MIN] = min(int(row[MIN]), d)
        row[MAX] = max(int(row[MAX]), d)
        row.view(torch.float64)[SUMSQ] += (d * 1e-9) ** 2


def device_recorder(device):
    """A DeviceRecorder on `device` (a CUDA device), or None where the
    kernel library cannot be loaded: telemetry never stops a run."""
    from torchbeast_tpu_torch.ops import _build

    try:
        lib = _build.library()
    except Exception:  # noqa: BLE001
        log.exception("No device marks: the kernel library did not load")
        return None
    return DeviceRecorder(accumulator(device), lib)


_active = [None]  # the Recorder of the dispatch being recorded


@contextlib.contextmanager
def recording(recorder):
    """Let `stamp` and `boundary` mark into `recorder` (None: they do
    nothing) for one dispatch."""
    if recorder is None:
        yield None
        return
    recorder.begin_dispatch()
    _active[0] = recorder
    try:
        yield recorder
    finally:
        _active[0] = None


def stamp(index: int) -> None:
    """Mark boundary `index`, when a dispatch is being recorded."""
    recorder = _active[0]
    if recorder is not None:
        recorder.mark(index)


class _Boundary(torch.autograd.Function):
    """The identity, marking `fwd` as it runs and `bwd` when its gradient
    comes back."""

    @staticmethod
    def forward(ctx, x, recorder, fwd, bwd):
        ctx.recorder, ctx.bwd = recorder, bwd
        recorder.mark(fwd)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.recorder.mark(ctx.bwd)
        return grad, None, None, None


def boundary(x: torch.Tensor, fwd: int, bwd: int) -> torch.Tensor:
    """`x`, with boundary `fwd` marked now and `bwd` when the backward
    reaches it, when a dispatch is being recorded; else `x` itself."""
    recorder = _active[0]
    if recorder is None:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        recorder.mark(fwd)
        return x
    return _Boundary.apply(x, recorder, fwd, bwd)


class _Region(torch.autograd.Function):
    """The identity, entering (or leaving) summed region `fwd` as it runs
    and leaving (or entering) region `bwd` when its gradient comes
    back."""

    @staticmethod
    def forward(ctx, x, recorder, fwd, bwd, enter):
        ctx.recorder, ctx.bwd, ctx.enter = recorder, bwd, enter
        recorder.region(fwd, enter)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.recorder.region(ctx.bwd, not ctx.enter)
        return grad, None, None, None, None


def _region(x, pair, enter):
    recorder = _active[0]
    if recorder is None:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        recorder.region(pair[0], enter)
        return x
    return _Region.apply(x, recorder, pair[0], pair[1], enter)


def region_in(x: torch.Tensor, pair) -> torch.Tensor:
    """`x` where a summed region's instance starts: pair[0] entered now,
    pair[1] left when the backward reaches x, when a dispatch is being
    recorded; else `x` itself."""
    return _region(x, pair, True)


def region_out(y: torch.Tensor, pair) -> torch.Tensor:
    """`y` where the instance ends: pair[0] left now, pair[1] entered when
    the backward reaches y."""
    return _region(y, pair, False)


def recording_now() -> bool:
    """Whether a dispatch is being recorded (marks and values land)."""
    return _active[0] is not None


def observe_max(name: str, x: torch.Tensor) -> None:
    """Keep the update's largest 0-d `x` of value `name` (VALUES), when a
    dispatch is being recorded."""
    recorder = _active[0]
    if recorder is not None:
        recorder.value(name, x)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def mark_index(name: str):
    """The boundary of a `tbt_mark<i>` kernel's name, or None."""
    head, sep, tail = name.partition("tbt_mark<")
    return int(tail.split(">", 1)[0]) if sep else None


def split_trace(events) -> list:
    """Each whole update of a chrome trace's device ops (torch.profiler's
    export), put down to its regions by the marks' kernels on the
    trace's own clock: [{region: {op name: device us}}], one dict an
    update from a START mark to its END mark, in time order. The marks
    and the summed regions' stamps count in no region."""
    ops = sorted((ev for ev in events if ev.get("cat") in DEVICE_CATS),
                 key=lambda ev: ev["ts"])
    updates, segment, at, current = [], [], None, None
    for ev in ops:
        index = mark_index(ev.get("name", ""))
        if index is None:
            if at is not None and "tbt_region<" not in ev.get("name", ""):
                segment.append(ev)
            continue
        if index == START:
            current, at, segment = {}, START, []
            continue
        if at is None:
            continue
        region = REGIONS.get((at, index),
                             f"{BOUNDARIES[at]}_{BOUNDARIES[index]}")
        by_name = current.setdefault(region, {})
        for op in segment:
            by_name[op["name"]] = by_name.get(op["name"], 0.0) + op["dur"]
        at, segment = index, []
        if index == END:
            updates.append(current)
            at = None
    return updates

