"""The program's own device time by region of the learner update: the
telemetry series `learner.device.<region>_s` that its device marks fold
on the card (torchbeast_tpu_torch/marks.py), read from one
`telemetry.snapshot()` after the run. The readers of trunk_ms, core_ms,
loss_ms and opt_ms take their numbers here."""

PREFIX = "learner.device."


def ms_per_update(regions, snapshot=None):
    """The mean device milliseconds an update in `regions`, each series'
    exact sum over its count, added; None where a series is missing or
    empty (a program without the marks, or a run on the CPU)."""
    if snapshot is None:
        from torchbeast_tpu_torch import telemetry

        snapshot = telemetry.snapshot()
    histograms = snapshot.get("histograms", {})
    total = 0.0
    for region in regions:
        h = histograms.get(PREFIX + region + "_s")
        if not h or not h.get("count"):
            return None
        total += h["total"] / h["count"]
    return total * 1e3
