"""A cell of BENCHMARK.json with everything that belongs to it, found by
name: its configuration's file, its traffic mix
(`traffic/<traffic>.json`) and the readers of its metrics
(`metrics/<metric>.py`)."""

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Metric(NamedTuple):
    name: str
    unit: str
    end_to_end: bool
    read: object  # read(ctx) -> a number, or None where nothing was read


class Cell(NamedTuple):
    workload: str
    chips: int
    config: dict
    traffic: dict
    metrics: tuple


# The knobs of a traffic mix, each read by the one learner loop there is
# (harness.py, generate.py, check.py): a mix that names another is
# refused, never run as if it said nothing.
TRAFFIC_KEYS = frozenset((
    "name", "about", "unroll_length", "batch_size", "superstep_k",
    "replay_reuse", "rollouts", "done_probability", "episode_step_high",
    "state_scale", "checked_updates", "warmup_updates", "trace_updates"))


def _applies(entry, workload):
    return "workloads" not in entry or workload in entry["workloads"]


def reader(name: str):
    """The `read` function of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_traffic(name: str, here: str = HERE) -> dict:
    """traffic/<name>.json, refused where it names a knob outside
    TRAFFIC_KEYS."""
    with open(os.path.join(here, "traffic", name + ".json")) as f:
        traffic = json.load(f)
    unknown = sorted(set(traffic) - TRAFFIC_KEYS)
    if unknown:
        raise ValueError(f"traffic {name!r} names {unknown}, which no "
                         "loop of the harness reads")
    return traffic


def load(workload: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, config["file"])) as f:
        config_file = json.load(f)
    traffic = read_traffic(cell["traffic"])
    metrics = tuple(
        Metric(m["name"], m["unit"], kind == "end_to_end", reader(m["name"]))
        for kind in ("end_to_end", "per_layer") for m in bench[kind]
        if _applies(m, workload))
    return Cell(workload, cell["chips"], config_file, traffic, metrics)
