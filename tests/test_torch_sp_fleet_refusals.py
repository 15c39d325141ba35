"""The reference's refusals of sequence parallelism's and the fleet's flags
in the port's drivers and its chaos harness (the runs are tests/
test_torch_sp_drivers.py's and tests/test_torch_fleet_drivers.py's), on
the CPU's virtual devices under --disable_cuda, in one parametrized test
per tool:

- monobeast (monobeast.py:479-554, :752-767, :796-800, :810-835): the
  reference's own driver raises the same type and text on the same argv;
- polybeast (polybeast.py:568-615, :809-880, :908-916, the
  FleetCoordinator's floor): the reference's type and text, and where
  the reference raises before any side effect (the fleet's checks) its
  own driver on the same argv;
- chaos_run (scripts/chaos_run.py:600-620): the reference harness's exit
  code 2 and message, on the same argv.
"""

import importlib.util
import os

import pytest

from torchbeast_tpu import monobeast as jax_monobeast
from torchbeast_tpu import polybeast as jax_polybeast
from torchbeast_tpu_torch import chaos_run, monobeast, polybeast
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TF = ["--model", "transformer"]
SP2 = ["--sequence_parallel", "2"]

# case -> (argv beyond the common ones, error type, text)
MONO = {
    "ring_schedule_without_sp": (TF + ["--ring_schedule", "zigzag"],
                                 ValueError,
                                 "--ring_schedule only takes effect with "
                                 "--sequence_parallel > 1 (no ring "
                                 "attention runs without a seq mesh)"),
    "sp_strategy_without_sp": (TF + ["--sp_strategy", "ulysses"],
                               ValueError,
                               "--sp_strategy only takes effect with "
                               "--sequence_parallel > 1 (no sequence-"
                               "parallel attention runs without a seq "
                               "mesh)"),
    "sp_needs_transformer": (["--model", "deep"] + SP2, ValueError,
                             "--sequence_parallel needs --model "
                             "transformer (the conv+LSTM families have no "
                             "sequence-sharded formulation)"),
    "sp_with_fused_attention": (TF + SP2 + ["--attention_impl", "pallas"],
                                ValueError,
                                "--attention_impl pallas and "
                                "--sequence_parallel are mutually exclusive "
                                "(the ring path replaces the fused kernel "
                                "on the learner forward)"),
    "ulysses_with_zigzag": (TF + SP2 + ["--sp_strategy", "ulysses",
                                        "--ring_schedule", "zigzag"],
                            ValueError,
                            "--ring_schedule applies to --sp_strategy ring "
                            "only"),
    "unroll_divisible": (TF + SP2 + ["--ring_schedule", "zigzag",
                                     "--unroll_length", "5"], ValueError,
                         "--sequence_parallel 2 (zigzag) requires "
                         "unroll_length+1 divisible by 4 (got 6)"),
    "ulysses_heads": (TF + ["--sequence_parallel", "8", "--sp_strategy",
                            "ulysses", "--unroll_length", "7"], ValueError,
                      "--sp_strategy ulysses requires num_heads (4) "
                      "divisible by --sequence_parallel 8 (heads are the "
                      "sharded resource)"),
    "sp_visible": (TF + ["--sequence_parallel", "16", "--unroll_length",
                         "15"], ValueError,
                   "--sequence_parallel 16 but only 8 devices are "
                   "visible"),
    "sp_with_dp": (TF + SP2 + ["--num_learner_devices", "2"], ValueError,
                   "--num_learner_devices in the sync trainer is plain "
                   "DP; composing DP with SP/EP/PP needs the async "
                   "driver's composite meshes (polybeast)"),
    "fleet_needs_polybeast": (["--fleet", "host=0/2,coord=127.0.0.1:1"],
                              ValueError,
                              "--fleet needs the async driver (polybeast): "
                              "the sync trainer is single-host by design"),
}


def _common(tmp_path, xpid="bad"):
    argv = ["--env", "Mock", "--num_actors", "4", "--batch_size", "4",
            "--unroll_length", "4", "--total_steps", "8", "--savedir",
            str(tmp_path)]
    return argv + (["--xpid", xpid] if xpid else [])


@pytest.mark.parametrize("case", sorted(MONO))
def test_monobeast_refusals(tmp_path, case):
    extra, error, text = MONO[case]
    argv = _common(tmp_path) + ["--serial_envs"]
    with pytest.raises(error) as theirs:
        jax_monobeast.train(jax_monobeast.make_parser().parse_args(
            [*argv, "--no_telemetry", *extra]))
    assert str(theirs.value) == text
    with pytest.raises(error) as ours:
        monobeast.main(monobeast.make_parser().parse_args(
            ["--disable_cuda", *argv, *extra]))
    assert str(ours.value) == text


FLEET2 = ["--fleet", "host=0/2,coord=127.0.0.1:1"]
# case -> (argv beyond the common ones, --xpid or None, error type, text,
# whether the reference's polybeast raises it before any side effect)
POLY = {
    "sp_needs_transformer": (["--model", "deep"] + SP2, "bad", ValueError,
                             "--sequence_parallel needs --model "
                             "transformer (the conv+LSTM families have no "
                             "sequence-sharded formulation)", False),
    "composite_batch": (TF + SP2 + ["--num_learner_devices", "2",
                                    "--batch_size", "3", "--unroll_length",
                                    "3"], "bad", ValueError,
                        "batch_size 3 not divisible by the learner mesh's "
                        "data axis (2)", False),
    "composite_fused_tail": (TF + SP2 + ["--num_learner_devices", "2",
                                         "--unroll_length", "3",
                                         "--opt_impl", "pallas"], "bad",
                             ValueError,
                             "--opt_impl pallas does not compose with the "
                             "sharded learner meshes yet (the fused tail is "
                             "a per-chip kernel; its sharded-update story "
                             "is the Sebulba item's)", False),
    "fleet_malformed": (["--fleet", "host=0/2"], "bad", ValueError,
                        "--fleet needs both host=<rank>/<n> and coord=",
                        True),
    "fleet_with_coordinator": (FLEET2 + ["--coordinator_address",
                                         "127.0.0.1:2"], "bad", ValueError,
                               "--fleet and --coordinator_address are "
                               "exclusive: the fleet's coord= endpoint IS "
                               "the rendezvous address", True),
    "fleet_needs_xpid": (FLEET2, None, ValueError,
                         "multi-host runs need an explicit --xpid (the "
                         "timestamp default would differ per host and "
                         "break checkpoint resume)", True),
    "fleet_batch": (FLEET2 + ["--batch_size", "3"], "bad", ValueError,
                    "--batch_size 3 (global) must be divisible by the "
                    "fleet's 2 hosts", True),
    "fleet_data_only": (FLEET2 + TF + SP2, "bad", ValueError,
                        "--fleet composes a data-only learner mesh; it does "
                        "not compose with --expert_parallel/--sequence_"
                        "parallel/--tensor_parallel/--pipeline_parallel "
                        "yet", True),
}


@pytest.mark.parametrize("case", sorted(POLY))
def test_polybeast_refusals(tmp_path, case):
    extra, xpid, error, text, reference_first = POLY[case]
    argv = _common(tmp_path, xpid) + [
        "--num_servers", "2", "--pipes_basename", f"unix:{tmp_path}/pipes"]
    if reference_first:
        with pytest.raises(error) as theirs:
            jax_polybeast.train(jax_polybeast.make_parser().parse_args(
                [*argv, "--no_telemetry", *extra]))
        assert str(theirs.value) == text
    with pytest.raises(error) as ours:
        polybeast.main(polybeast.make_parser().parse_args(
            ["--disable_cuda", *argv, *extra]))
    assert str(ours.value) == text


@pytest.mark.parametrize("floor", [0, 3])
def test_fleet_floor_refusal(tmp_path, floor):
    """--min_live_hosts outside [1, hosts]: the FleetCoordinator's
    ValueError, the reference's text, before any env server starts."""
    from torchbeast_tpu.fleet import FleetCoordinator, FleetSpec
    from torchbeast_tpu.resilience.supervisor import PipelineHealth
    from torchbeast_tpu.telemetry import MetricsRegistry

    with pytest.raises(ValueError) as theirs:
        FleetCoordinator(FleetSpec(0, 2, "127.0.0.1:1"),
                         PipelineHealth(registry=MetricsRegistry()), "wire",
                         min_live_hosts=floor, registry=MetricsRegistry())
    argv = _common(tmp_path) + [
        "--num_servers", "2", "--pipes_basename", f"unix:{tmp_path}/pipes",
        *FLEET2, "--min_live_hosts", str(floor)]
    with pytest.raises(ValueError) as ours:
        polybeast.main(polybeast.make_parser().parse_args(
            ["--disable_cuda", *argv]))
    assert str(ours.value) == str(theirs.value)


def _reference_chaos_run():
    spec = importlib.util.spec_from_file_location(
        "reference_chaos_run", os.path.join(REPO, "scripts", "chaos_run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHAOS = {
    "fleet_set": ["--fleet", "host=0/2,coord=127.0.0.1:1"],
    "hosts_3": ["--hosts", "3"],
    "hosts_2_pressure": ["--hosts", "2", "--scheduler_pressure", "1"],
    "hosts_2_batch": ["--hosts", "2", "--batch_size", "3"],
}


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_chaos_run_refusals(capsys, case):
    argv = ["--savedir", "unused", *CHAOS[case]]
    assert _reference_chaos_run().main(argv) == 2
    theirs = capsys.readouterr().err
    assert chaos_run.main([*argv, "--disable_cuda"]) == 2
    ours = capsys.readouterr().err
    assert ours == theirs and ours.strip()
