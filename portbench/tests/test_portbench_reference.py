"""The plain reference against the program, at sizes a CPU test holds:
the forward of both networks, and the checked updates' readings."""

import ast
import os

import pytest
import torch

from portbench import check, generate, harness, reference
from portbench.tests.tiny import WORKLOADS, tiny

REFERENCE_DIR = os.path.dirname(reference.__file__)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _program_model(config, traffic, seed):
    from torchbeast_tpu_torch import monobeast

    flags = monobeast.make_parser().parse_args(
        harness._argv(config, traffic, seed, ()) + ["--disable_cuda"])
    model = monobeast.build_model(flags, config["num_actions"],
                                  tuple(config["frame_shape"]),
                                  torch.device("cpu"))
    return model


@pytest.mark.parametrize("workload", WORKLOADS)
def test_forward_matches_program(workload):
    cell = tiny(workload)
    config, traffic = cell.config, cell.traffic
    net = reference.network(config["reference"])
    cpu = torch.device("cpu")
    weights = generate.weights(
        net.param_shapes(config["net"], config["frame_shape"],
                         config["num_actions"]), 3, cpu)
    model = _program_model(config, traffic, 3)
    harness._load(model, weights)
    batch = generate.rollouts(traffic, config, 3, cpu)[0]
    state = generate.states(
        net.state_shapes(config["net"], config["num_actions"],
                         traffic["batch_size"]), traffic, 3, cpu)[0]
    with harness.configured(config), torch.no_grad():
        out, _ = model(batch, state, sample_action=False)
        logits, baseline = net.forward(weights, batch, state, config["net"],
                                       config["num_actions"])
    torch.testing.assert_close(out.policy_logits, logits, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(out.baseline, baseline, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_checked_updates_match_program(workload):
    """f32 on the CPU, both sides: every number far under its limit."""
    cell = tiny(workload)
    config, traffic = cell.config, cell.traffic
    cpu = torch.device("cpu")
    with harness.configured(config):
        found = harness.program_readings(
            harness.build(config, traffic, 11, cpu))
    ref = check.reference_readings(config, traffic, 11, cpu)
    gaps = check.gaps(found, ref, config["leaf_groups"])
    for number in ("loss_gap_any", "grad_gap", "grad_err", "step_gap",
                   "change_gap"):
        assert gaps[number] < 1e-4, (number, gaps)


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(REFERENCE_DIR) if f.endswith(".py")))
def test_reference_imports_only_torch(name):
    """The reference imports torch and its own package's yardstick and
    modules, and nothing of the program or of JAX."""
    with open(os.path.join(REFERENCE_DIR, name)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in ("torch", "contextlib", "importlib",
                                       "portbench"), n
            assert n in ("portbench", "portbench.yardstick") or not (
                n.startswith("portbench")) or n.startswith(
                    "portbench.reference"), n


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_size_control_fails_and_program_passes(card, workload):
    """At the cell's own size on the card: the configured program passes
    the check, the bf16_train control fails it."""
    from portbench import cells

    cell = cells.load(workload)
    config, traffic = cell.config, cell.traffic
    ref = None
    verdicts = {}
    for label, extra in (("program", ()),
                         ("control", ("--precision", "bf16_train"))):
        with harness.configured(config):
            program = harness.build(config, traffic, 909, card,
                                    extra_argv=extra)
            found = harness.program_readings(program)
        del program
        if ref is None:
            with harness.configured(config):
                ref = check.reference_readings(config, traffic, 909, card)
        verdicts[label] = check.verdict(
            check.gaps(found, ref, config["leaf_groups"]),
            config["limits"])[0]
    assert verdicts == {"program": True, "control": False}
