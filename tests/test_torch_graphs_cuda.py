"""The port's CUDA graphs (torchbeast_tpu_torch/graphs.py) against the
eager steps they capture, on the card, at small shapes. Every test needs
a CUDA device and skips without one; like tests/test_torch_kernels_cuda.py
this module imports no jax, so on the GPU machine it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py

TF32 off and cuDNN deterministic: a replay must then give the eager
step's bits.
"""

import copy

import numpy as np
import pytest
import torch

from torchbeast_tpu_torch import learner, nest, ops
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.ops import opt

pytestmark = pytest.mark.cuda

T, B, A, FRAME = 4, 2, 4, (12, 12, 4)


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


def _batch(seed, dev):
    rng = np.random.default_rng(seed)
    arrays = {
        "frame": rng.integers(0, 256, (T + 1, B) + FRAME, dtype=np.uint8),
        "reward": rng.standard_normal((T + 1, B)).astype(np.float32),
        "done": rng.random((T + 1, B)) < 0.2,
        "episode_return": rng.standard_normal((T + 1, B)).astype(np.float32),
        "episode_step": rng.integers(0, 100, (T + 1, B)).astype(np.int32),
        "last_action": rng.integers(0, A, (T + 1, B)).astype(np.int32),
        "action": rng.integers(0, A, (T + 1, B)).astype(np.int32),
        "policy_logits": rng.standard_normal((T + 1, B, A)).astype(
            np.float32),
        "baseline": rng.standard_normal((T + 1, B)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


@pytest.mark.parametrize("k", [1, 3])
def test_captured_update_matches_eager_bitwise(cuda, monkeypatch, k):
    """Two dispatches of the graph against 2k eager updates of a copy,
    with the LR decay and the entropy anneal moving every update."""
    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    torch.manual_seed(0)
    model = create_model("deep", A, use_lstm=True, frame_shape=FRAME).to(
        cuda)
    twin = copy.deepcopy(model)
    hp = learner.HParams(unroll_length=T, batch_size=B, total_steps=6 * T * B,
                         vtrace_impl="pallas", opt_impl="pallas",
                         entropy_cost_final=1e-4)
    opt_g = learner.make_optimizer(hp, list(model.parameters()))
    opt_e = learner.make_optimizer(hp, list(twin.parameters()))
    state = model.initial_state(B, cuda)
    batches = [_batch(i, cuda) for i in range(2 * k)]
    eager = learner.update_body(twin, opt_e, hp)
    want = [eager(b, state) for b in batches]
    dispatch = learner.make_update_dispatch(model, opt_g, hp, k)
    ops.reset_launch_counts()
    got = []
    for d in range(2):
        group = batches[d * k:(d + 1) * k]
        if k == 1:
            got.append(dispatch(group[0], state))
        else:
            got.append(dispatch(
                {key: torch.stack([b[key] for b in group])
                 for key in group[0]},
                nest.map(lambda s: torch.stack([s] * k), state)))
    torch.cuda.synchronize()
    assert opt_g.state.count == 2 * k == int(opt_g.device_count)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(opt_g.state.nu, opt_e.state.nu):
        assert torch.equal(a, b)
    for key in want[0]:
        g = torch.cat([x[key].reshape(-1) for x in got])
        assert torch.equal(g, torch.stack([w[key].float() for w in want]))
    # The capture's warm-up launched for real; then each replay adds what
    # the capture counted.
    counts = ops.launch_counts()
    per = dispatch.launches_per_replay
    assert per == {"vtrace_targets": k, "rmsprop_tail": k, "pool_bwd": 3 * k,
                   "lstm_layer": 2 * (T + 1) * k}
    warmup = 2 * k  # graphs.WARMUP_RUNS dispatches of k updates
    assert counts["rmsprop_tail"] == warmup + 2 * k


def test_captured_tail_reads_the_rate_from_device_memory(cuda):
    """A graph of the tail applies the rate in its lr tensor at replay,
    not the one at capture."""
    p = [torch.zeros(8, device=cuda)]
    g = [torch.ones(8, device=cuda)]
    nu = [torch.zeros(8, device=cuda)]
    lr = torch.tensor(0.0, device=cuda)
    kw = dict(lr=lr, alpha=0.5, eps=1.0)
    opt.rmsprop_tail(p, g, nu, None, **kw)  # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        opt.rmsprop_tail(p, g, nu, None, **kw)
    p[0].zero_()
    nu[0].zero_()
    lr.fill_(0.25)
    graph.replay()
    torch.cuda.synchronize()
    # nu = 0.5 * 1, upd = 1 / (sqrt(0.5) + 1), p = -0.25 * upd.
    upd = torch.tensor(1.0) / (torch.sqrt(torch.tensor(0.5)) + 1.0)
    assert torch.equal(p[0].cpu(), torch.full((8,), float(-0.25 * upd)))


def test_captured_act_matches_eager_bitwise(cuda):
    """Five chained acting steps of the graph against the eager forward
    from the same generator state: actions, logits, baseline and state
    equal."""
    torch.manual_seed(1)
    model = create_model("deep", A, use_lstm=True, frame_shape=FRAME).to(
        cuda)
    gens = [torch.Generator(device=cuda).manual_seed(3) for _ in range(2)]
    act = learner.make_act_step(model, cuda, gens[0])
    env = {k: v[0].cpu().numpy() for k, v in _batch(7, cuda).items()}
    s_g = s_e = model.initial_state(B, cuda)
    for _ in range(5):
        out_g, s_g = act(env, s_g)
        with torch.no_grad():
            out_e, s_e = learner.act_body(
                model, {k: torch.as_tensor(env[k]).to(cuda)
                        for k in learner.MODEL_INPUT_KEYS}, s_e, gens[1])
        for a, b in (*zip(out_g, out_e), *zip(s_g, s_e)):
            assert torch.equal(a, b)
