"""Run one cell of BENCHMARK.json once and print its result as the last
line of standard output:

    python3 -m portbench.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer metrics (and the device's busy and traced seconds, and the
breakdown of the traced dispatches). Either way the run checks the
program's first updates against the plain reference and prints each
number compared beside its limit, as the last lines of standard error
and under "checks", the result's last key.

The run needs as many CUDA devices as the cell asks for: without them it
exits with code 2 and prints no result. It exits with code 3, and prints
no result, when a module of jax, jaxlib, flax or the JAX package
torchbeast_tpu is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

# Top-level module names that no run may load: JAX, its libraries and the
# JAX package the program was ported from (torchbeast_tpu_torch passes).
FORBIDDEN = ("jax", "jaxlib", "flax", "torchbeast_tpu")


def forbidden_modules(names):
    """The names among `names` whose top-level part (before the first
    dot) is one of FORBIDDEN, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def parse(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def _number(v):
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import cells

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {found}; no result", file=sys.stderr)
        return 2
    from portbench import harness

    device = torch.device("cuda", 0)
    result, ctx = harness.run(cell, args.seed, args.seconds,
                              bool(args.trace), device, T0)
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"portbench: the run loaded {loaded}; no result",
              file=sys.stderr)
        return 3
    metrics = {}
    for m in cell.metrics:
        if m.end_to_end != (args.trace == 0):
            continue
        value = m.read(ctx)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": result["peak_bytes"]}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": device_info}
    if args.trace:
        device_info["busy_s"] = ctx.trace.busy_us / 1e6
        device_info["window_s"] = ctx.trace.window_us / 1e6
        line["breakdown"] = ctx.trace.breakdown
    checks = {k: {"value": _number(c["value"]), "limit": c["limit"]}
              for k, c in result["checks"].items()}
    line["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
