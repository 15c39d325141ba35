"""The reference's refusals of tensor and pipeline parallelism's flags
in the port's drivers (the drivers' runs are tests/test_torch_tp_pp_
drivers.py's), on the CPU's virtual devices under --disable_cuda:

- every refusal the reference makes of --tensor_parallel,
  --pipeline_parallel, --pipeline_microbatches and --pipeline_stages
  (polybeast.py:605-616, :674-678, :815-830, :908-916, :999-1013;
  monobeast.py:557-664, :814-820), in one parametrized test: the
  reference's error type and text (for monobeast's, the reference's own
  driver raises the same text on the same argv);
- --sequence_parallel 2 and --fleet, once later items, raise the
  reference's errors or train (their refusals are tests/
  test_torch_sp_fleet_refusals.py's).
"""

import pytest

from torchbeast_tpu import monobeast as jax_monobeast
from torchbeast_tpu_torch import monobeast, polybeast
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401


# ---------------------------------------------------------- the refusals


TP_NEEDS_TRANSFORMER = (
    "--tensor_parallel needs --model transformer (the Megatron pairing "
    "targets its projection/FFN layout)")
TP_COMPOSES = (
    "--tensor_parallel composes with --num_learner_devices and "
    "--expert_parallel, not with --sequence_parallel or "
    "--pipeline_parallel (their shard_maps leave the `model` axis "
    "unmentioned, which would force gathers of the head-sharded "
    "projections every layer)")
STATE_TREES = (
    "--precision bf16_train / --factored_opt_state do not compose with "
    "--expert_parallel/--tensor_parallel yet (optimizer-state sharding "
    "rules need a params-mirroring state tree)")
MESH_TAIL = (
    "--opt_impl pallas does not compose with the sharded learner meshes "
    "yet (the fused tail is a per-chip kernel; its sharded-update story "
    "is the Sebulba item's)")
FLEET = (
    "--fleet composes a data-only learner mesh; it does not compose with "
    "--expert_parallel/--sequence_parallel/--tensor_parallel/"
    "--pipeline_parallel yet")
PP_COMBINE = (
    "--pipeline_parallel cannot combine with --sequence_parallel or "
    "--expert_parallel (the pipeline schedule owns its mesh; SP x EP do "
    "compose with each other and with data parallelism)")
PP_MODEL = (
    "--pipeline_parallel needs --model pipelined_mlp or "
    "pipelined_transformer (the other families have no stage-uniform "
    "tower to pipeline)")
TF = ["--model", "transformer"]
PT = ["--model", "pipelined_transformer"]

# (driver, argv, error type, text; monobeast's also from the reference)
REFUSALS = {
    "tp_needs_transformer": ("poly", ["--model", "deep",
                                      "--tensor_parallel", "2"],
                             ValueError, TP_NEEDS_TRANSFORMER),
    "tp_with_sp": ("poly", TF + ["--tensor_parallel", "2",
                                 "--sequence_parallel", "2"],
                   ValueError, TP_COMPOSES),
    "tp_with_pp": ("poly", TF + ["--tensor_parallel", "2",
                                 "--pipeline_parallel", "2"],
                   ValueError, TP_COMPOSES),
    "tp_bf16_train": ("poly", TF + ["--tensor_parallel", "2", "--precision",
                                    "bf16_train"], RuntimeError,
                      STATE_TREES),
    "tp_factored": ("poly", TF + ["--tensor_parallel", "2",
                                  "--factored_opt_state"], RuntimeError,
                    STATE_TREES),
    "tp_fused_tail": ("poly", TF + ["--tensor_parallel", "2", "--opt_impl",
                                    "pallas"], ValueError, MESH_TAIL),
    "tp_fleet": ("poly", TF + ["--tensor_parallel", "2", "--fleet",
                               "host=0/2,coord=127.0.0.1:1"], ValueError,
                 FLEET),
    "tp_split": ("poly", TF + ["--tensor_parallel", "2", "--device_split",
                               "inf=1,learn=2"], ValueError,
                 "--device_split does not compose with --tensor_parallel "
                 "yet (the split's learner mesh is plain DP over the "
                 "learner devices)"),
    "tp_visible": ("poly", TF + ["--tensor_parallel", "16"], ValueError,
                   "Requested a 16-device mesh but only 8 devices are "
                   "visible"),
    "pp_with_ep": ("mono", ["--model", "pipelined_mlp", "--num_experts",
                            "4", "--expert_parallel", "2",
                            "--pipeline_parallel", "2"], ValueError,
                   PP_COMBINE),
    "pp_with_sp": ("mono", TF + ["--sequence_parallel", "2",
                                 "--pipeline_parallel", "2",
                                 "--unroll_length", "3"], ValueError,
                   PP_COMBINE),
    "pp_needs_pipelined": ("mono", TF + ["--pipeline_parallel", "2"],
                           ValueError, PP_MODEL),
    "pp_stage_multiple": ("mono", PT + ["--pipeline_parallel", "2",
                                        "--pipeline_stages", "3"],
                          ValueError, "--pipeline_stages 3 must be a "
                          "multiple of --pipeline_parallel 2"),
    "pp_microbatches": ("mono", PT + ["--pipeline_parallel", "2",
                                      "--pipeline_microbatches", "-1"],
                        ValueError, "--pipeline_microbatches -1 must be "
                        ">= 0 (0 means the default: one microbatch per "
                        "pipeline device)"),
    "pp_can_pipeline": ("mono", PT + ["--pipeline_parallel", "2",
                                      "--batch_size", "3",
                                      "--num_actors", "3"], ValueError,
                        "--pipeline_parallel 2 requires batch_size (= 3) "
                        "divisible by the microbatch count (2; "
                        "--pipeline_microbatches overrides the "
                        "one-per-device default), and each microbatch's "
                        "rows by the data axis when composing with DP — "
                        "otherwise the learner step would silently run "
                        "the sequential fallback"),
    "pp_visible": ("mono", PT + ["--pipeline_parallel", "16",
                                 "--pipeline_stages", "16"], ValueError,
                   "--pipeline_parallel 16 but only 8 devices are "
                   "visible"),
    "pp_with_dp": ("mono", PT + ["--pipeline_parallel", "2",
                                 "--num_learner_devices", "2"], ValueError,
                   "--num_learner_devices in the sync trainer is plain "
                   "DP; composing DP with SP/EP/PP needs the async "
                   "driver's composite meshes (polybeast)"),
    "poly_pp_rows_over_data": ("poly", PT + [
        "--pipeline_parallel", "2", "--num_learner_devices", "2",
        "--batch_size", "2"], ValueError,
        "--pipeline_parallel 2 requires batch_size (= 2) divisible by the "
        "microbatch count (2; --pipeline_microbatches overrides the "
        "one-per-device default), and each microbatch's rows by the data "
        "axis when composing with DP — otherwise the learner step would "
        "silently run the sequential fallback"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_reference_refusals(tmp_path, case):
    driver, extra, error, text = REFUSALS[case]
    argv = ["--env", "Mock", "--num_actors", "4", "--batch_size", "4",
            "--unroll_length", "4", "--total_steps", "8", "--savedir",
            str(tmp_path), "--xpid", "bad"]
    if driver == "mono":
        argv.append("--serial_envs")
        with pytest.raises(error) as theirs:
            jax_monobeast.train(jax_monobeast.make_parser().parse_args(
                [*argv, "--no_telemetry", *extra]))
        assert str(theirs.value) == text
        with pytest.raises(error) as ours:
            monobeast.main(monobeast.make_parser().parse_args(
                ["--disable_cuda", *argv, *extra]))
    else:
        argv += ["--num_servers", "2", "--pipes_basename",
                 f"unix:{tmp_path}/pipes"]
        with pytest.raises(error) as ours:
            polybeast.main(polybeast.make_parser().parse_args(
                ["--disable_cuda", *argv, *extra]))
    assert str(ours.value) == text


@pytest.mark.parametrize("driver,extra,text", [
    ("mono", ["--sequence_parallel", "2"],
     "--sequence_parallel 2 (contiguous) requires unroll_length+1 "
     "divisible by 2 (got 81)"),
    ("poly", ["--sequence_parallel", "2"],
     "--sequence_parallel 2 (contiguous) requires unroll_length+1 "
     "divisible by 2 (got 81)"),
    ("poly", ["--fleet", "host=0/1,coord=127.0.0.1:1"], None),
], ids=["mono_sp", "poly_sp", "poly_fleet"])
def test_later_items_still_raise(tmp_path, driver, extra, text):
    """Sequence parallelism and the fleet, once later ROADMAP.md items,
    are in the port: --sequence_parallel 2 at the default unroll (T + 1
    = 81) raises the reference's ValueError in both drivers, and a
    one-host fleet on the CPU trains (the wire strategy, no control
    plane)."""
    argv = ["--disable_cuda", "--env", "Mock", "--model", "transformer",
            "--batch_size", "4", "--savedir", str(tmp_path), *extra]
    parser = (monobeast if driver == "mono" else polybeast).make_parser()
    main = (monobeast if driver == "mono" else polybeast).main
    if text is None:
        stats = main(parser.parse_args(argv + [
            "--num_servers", "2", "--unroll_length", "4", "--total_steps",
            "16", "--max_inference_batch_size", "4", "--pipes_basename",
            f"unix:{tmp_path}/pipes", "--xpid", "fleet"]))
        assert stats["step"] >= 16 and stats["health"] == "HEALTHY"
        return
    with pytest.raises(ValueError) as ours:
        main(parser.parse_args(argv))
    assert str(ours.value) == text
