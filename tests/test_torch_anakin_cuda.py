"""The Anakin iteration graph (graphs.CapturedIteration, built by
anakin.make_iteration_dispatch) against the eager iteration it captures,
on the card, at small shapes. Every test needs a CUDA device and skips
without one; this module imports no jax, so on the GPU machine it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_anakin_cuda.py

TF32 off and cuDNN deterministic: a replay must then give the eager
iteration's bits.
"""

import copy

import pytest
import torch

from torchbeast_tpu_torch import anakin, nest, ops
from torchbeast_tpu_torch import learner as learner_lib

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the GPU")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _parts(dev, env_name, model_args, b, t):
    return anakin.setup(anakin.make_parser().parse_args([
        "--env", env_name, *model_args, "--batch_size", str(b),
        "--unroll_length", str(t), "--total_steps", str(20 * b * t),
        "--entropy_cost_final", "1e-4"]), dev)


@pytest.mark.parametrize("env_name,model_args,pools", [
    ("Catch", ["--model", "mlp"], 0),
    ("Memory", ["--model", "mlp", "--use_lstm"], 0),
    ("Catch", ["--model", "deep", "--use_lstm"], 3),
    ("Memory", ["--model", "transformer", "--num_experts", "4"], 0),
])
def test_iteration_graph_matches_eager_bitwise(cuda, monkeypatch, env_name,
                                               model_args, pools):
    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    env, model, opt, hp, gen, carry = _parts(cuda, env_name, model_args,
                                             8, 7)
    twin = copy.deepcopy(model)
    opt_e = learner_lib.make_optimizer(hp, list(twin.parameters()))
    gen_e = torch.Generator(device=cuda)
    gen_e.set_state(gen.get_state())
    carry_e = nest.map(torch.clone, carry)
    eager = anakin.make_train_step(env, twin, opt_e, hp, gen_e)
    dispatch = anakin.make_iteration_dispatch(env, model, opt, hp, gen,
                                              carry)
    dispatch.capture()
    ops.reset_launch_counts()
    got = [dispatch() for _ in range(3)]
    replayed = ops.launch_counts()["pool_bwd"]
    want = [eager(carry_e) for _ in range(3)]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert torch.equal(g[key], w[key].float()), key
    for p, q in zip(model.parameters(), twin.parameters()):
        assert torch.equal(p, q)
    for a, b in zip(opt.state.nu, opt_e.state.nu):
        assert torch.equal(a, b)
    for a, b in zip(nest.flatten(carry), nest.flatten(carry_e)):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), gen_e.get_state())
    assert opt.state.count == 3 and int(opt.device_count) == 3
    assert dispatch.launches_per_replay.get("pool_bwd", 0) == pools
    assert replayed == 3 * pools


def test_generator_draws_advance_across_replays(cuda):
    """Catch episodes last 9 steps and all envs start together, so an
    iteration of T=9 ends on a reset of every env: the columns drawn at
    the end of each replay must differ from the previous replay's, and
    the generator's state must move every replay."""
    env, model, opt, hp, gen, carry = _parts(cuda, "Catch",
                                             ["--model", "mlp"], 256, 9)
    dispatch = anakin.make_iteration_dispatch(env, model, opt, hp, gen,
                                              carry)
    columns, states = [], []
    for _ in range(4):
        dispatch()
        columns.append(carry.env_state.env_state.ball_col.clone())
        states.append(gen.get_state())
    torch.cuda.synchronize()
    assert bool(carry.env_state.env_state.ball_row.eq(0).all())
    for a, b in zip(columns, columns[1:]):
        assert not torch.equal(a, b)
    for a, b in zip(states, states[1:]):
        assert not torch.equal(a, b)
    for c in columns:
        assert set(c.tolist()) == set(range(env.env.cols))
