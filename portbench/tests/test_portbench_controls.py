"""Whole runs of each cell at CPU-test sizes, the harness's look for a
card skipped: a sound run is correct; the control and every fault that a
learner cell can have make `correct` false."""

import time

import pytest
import torch

from portbench import check, faults, harness
from portbench.tests.tiny import WORKLOADS, tiny

CPU = torch.device("cpu")


def _run(cell, wrap=None):
    return harness.run(cell, 2 ** 31 + 5, 0.3, True, CPU,
                       time.perf_counter(), wrap=wrap)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    result, ctx = _run(tiny(workload))
    assert result["correct"], result["checks"]
    assert result["attempted"] == len(ctx.window.completions_ms) > 0
    assert result["failed"] == 0
    assert list(result["checks"]) == [*ctx.config["limits"],
                                      "failed_updates"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_makes_run_incorrect(workload, fault):
    result, _ = _run(tiny(workload), wrap=faults.FAULTS[fault])
    assert not result["correct"], result["checks"]


def test_misrouted_pool_backward_makes_deep_run_incorrect():
    with faults.pool_misrouted():
        result, _ = _run(tiny("deep_lstm.learn"))
    assert not result["correct"], result["checks"]
    trunk = result["checks"]["grad_err.trunk"]
    assert trunk["value"] > trunk["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_learning_rate_off_by_a_quarter_makes_run_incorrect(workload):
    cell = tiny(workload)
    config, traffic = cell.config, cell.traffic
    with harness.configured(config):
        found = harness.program_readings(harness.build(
            config, traffic, 17, CPU,
            extra_argv=faults.lr_high_argv(config)))
    ref = check.reference_readings(config, traffic, 17, CPU)
    ok, checks = check.verdict(check.gaps(found, ref, config["leaf_groups"]),
                               config["limits"])
    assert not ok, checks


@pytest.mark.parametrize("workload", WORKLOADS)
def test_bf16_control_fails(workload):
    cell = tiny(workload)
    config, traffic = cell.config, cell.traffic
    with harness.configured(config):
        found = harness.program_readings(harness.build(
            config, traffic, 17, CPU,
            extra_argv=("--precision", "bf16_train")))
    ref = check.reference_readings(config, traffic, 17, CPU)
    ok, checks = check.verdict(check.gaps(found, ref, config["leaf_groups"]),
                               config["limits"])
    assert not ok, checks


def test_verdict_needs_every_number_within_its_limit():
    assert check.verdict({"a": 0.1, "b": 0.2}, {"a": 0.2, "b": 0.3})[0]
    assert not check.verdict({"a": 0.1, "b": 0.4}, {"a": 0.2, "b": 0.3})[0]
    assert not check.verdict({"a": float("nan")}, {"a": 0.2})[0]
    assert not check.verdict({"a": 0.1}, {})[0]
