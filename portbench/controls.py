"""The readings the output check's limits are set from, at a cell's own
size: the numbers of check.py for the program as configured
(`program`, the lower readings), for the control (`bf16_train`: the
program's own lower-precision path, --precision bf16_train) and for
faults planted under the timed path (faults.py: the dispatch wrapped,
an operation altered, or `lr_high`, the learning rate off by a
quarter), one seed after another in one process:

    python3 -m portbench.controls --workload deep_lstm.learn \\
        --seeds 101-112 --modes program bf16_train half_batch

Prints one JSON line a (mode, seed), then one with each number's largest
reading by mode. Needs a CUDA device."""

import argparse
import contextlib
import gc
import json
import sys
import time

import torch

from portbench import cells, check, faults, harness

MODES = ("program", "bf16_train", "lr_high", *faults.FAULTS, *faults.PLANTS)


def _mode(mode, config):
    """(extra flags, dispatch wrap, context over the build) of a mode."""
    if mode == "bf16_train":
        return ("--precision", "bf16_train"), None, contextlib.nullcontext()
    if mode == "lr_high":
        return faults.lr_high_argv(config), None, contextlib.nullcontext()
    if mode in faults.PLANTS:
        return (), None, faults.PLANTS[mode]()
    return (), faults.FAULTS.get(mode), contextlib.nullcontext()


def seeds(spec: str):
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def readings(cell, seed, mode, device, ref):
    config, traffic = cell.config, cell.traffic
    extra, wrap, planted = _mode(mode, config)
    with harness.configured(config), planted:
        program = harness.build(config, traffic, seed, device,
                                extra_argv=extra, wrap=wrap)
        found = harness.program_readings(program)
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return (check.gaps(found, ref, cell.config.get("leaf_groups")),
            check.per_leaf(found, ref))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="first-last")
    parser.add_argument("--modes", nargs="+", default=["program"],
                        choices=sorted(MODES))
    parser.add_argument("--mode_seeds", type=int, default=3,
                        help="Seeds for every mode but program.")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.controls needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.load(args.workload)
    worst = {}
    for n, seed in enumerate(seeds(args.seeds)):
        t = time.perf_counter()
        with harness.configured(cell.config):
            ref = check.reference_readings(cell.config, cell.traffic, seed,
                                           device)
        ref_s = time.perf_counter() - t
        for mode in args.modes:
            if mode != "program" and n >= args.mode_seeds:
                continue
            t = time.perf_counter()
            gaps, leaves = readings(cell, seed, mode, device, ref)
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed, "gaps": gaps, "leaves": leaves,
                              "reference_s": ref_s,
                              "program_s": time.perf_counter() - t}),
                  flush=True)
            for k, v in gaps.items():
                lo, hi = worst.setdefault(mode, {}).get(k, (v, v))
                worst[mode][k] = (min(lo, v), max(hi, v))
    print(json.dumps({"workload": args.workload,
                      "card": torch.cuda.get_device_name(0),
                      "range_by_mode": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
