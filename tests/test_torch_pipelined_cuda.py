"""The pipelined families (models/pipelined.py, models/transformer_pp.py)
on the card, at small shapes: the learner's CUDA graph against the eager
update it captures, bit for bit, with V-trace and the RMSprop tail
launched once an update; the update with the kernels against the same
update with their plain versions; and the Anakin iteration graph of
pipelined_mlp against its eager twin. Every test needs a CUDA device and
skips without one; this module imports no jax, so on the GPU machine it
runs as
    python -m pytest --noconftest -m cuda tests/test_torch_pipelined_cuda.py

TF32 off and cuDNN deterministic: a replay must then give the eager
update's bits. Kernels against plain: f32 params and nu within rtol 1e-5
(atol 1e-8), as chip_smoke.py's parity phase holds them; bf16_train the
change of each f32 master leaf within 3e-2 in norm.
"""

import copy

import numpy as np
import pytest
import torch

from torchbeast_tpu_torch import anakin, learner, nest, ops, precision
from torchbeast_tpu_torch.models import create_model

pytestmark = pytest.mark.cuda

T, B, A, FRAME = 6, 4, 5, (12, 12, 4)
SIZES = {
    "pipelined_transformer": dict(num_layers=2, d_model=32, num_heads=4,
                                  memory_len=5),
    "pipelined_mlp": dict(num_stages=3, d_model=32, use_lstm=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the port's "
                    "kernels run only on the GPU")
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


def _state(model, dev, seed=0):
    """The initial state, the transformer's cache random and 70% valid."""
    state = model.initial_state(B, dev)
    if not state or not isinstance(state[0], tuple):
        return state
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(
        (torch.randn(k.shape, generator=gen, device=dev),
         torch.randn(v.shape, generator=gen, device=dev),
         (torch.rand(valid.shape, generator=gen, device=dev) < 0.7).float())
        for k, v, valid in state)


def _setup(dev, family, policy):
    pol = precision.get(policy)
    torch.manual_seed(0)
    model = create_model(family, A, frame_shape=FRAME,
                         dtype=pol.compute_dtype, head_dtype=pol.head_dtype,
                         **SIZES[family])
    model = precision.cast_params(model.to(dev), pol)
    hp = learner.HParams(unroll_length=T, batch_size=B,
                         total_steps=10 * T * B, vtrace_impl="pallas",
                         opt_impl="pallas", entropy_cost_final=1e-4,
                         param_dtype=pol.param_dtype,
                         opt_state_dtype=pol.opt_state_dtype)
    state = precision.cast_batch(_state(model, dev), pol.batch_dtype)
    batches = [precision.cast_batch(_batch(i, dev), pol.batch_dtype)
               for i in range(3)]
    return model, hp, state, batches


CASES = [("pipelined_transformer", "f32"),
         ("pipelined_transformer", "bf16_train"),
         ("pipelined_mlp", "f32")]


@pytest.mark.parametrize("family,policy", CASES)
def test_update_graph_matches_eager_bitwise(cuda, family, policy):
    model, hp, state, batches = _setup(cuda, family, policy)
    twin = copy.deepcopy(model)
    opt_g = learner.make_optimizer(hp, list(model.parameters()))
    opt_e = learner.make_optimizer(hp, list(twin.parameters()))
    eager = learner.update_body(twin, opt_e, hp)
    want = [eager(b, state) for b in batches]
    dispatch = learner.make_update_dispatch(model, opt_g, hp)
    got = [dispatch(b, state) for b in batches]
    torch.cuda.synchronize()
    assert opt_g.state.count == 3 == int(opt_g.device_count)
    pairs = [*zip(model.parameters(), twin.parameters()),
             *zip(opt_g.state.nu, opt_e.state.nu),
             *zip(opt_g.state.master or [], opt_e.state.master or [])]
    assert all(torch.equal(a, b) for a, b in pairs)
    for key in want[0]:
        assert torch.equal(torch.cat([g[key].reshape(-1) for g in got]),
                           torch.stack([w[key].float() for w in want])), key
    # The f32 LSTM head's layers: 2 (T + 1) recurrence kernels each.
    lstm = {"lstm_layer": 2 * (T + 1) * m.num_layers
            for m in model.modules() if getattr(m, "fused", False)}
    assert dispatch.launches_per_replay == {"vtrace_targets": 1,
                                            "rmsprop_tail": 1, **lstm}


@pytest.mark.parametrize("family,policy", CASES)
def test_update_kernels_match_their_plain_versions(cuda, family, policy):
    model, hp, state, batches = _setup(cuda, family, policy)
    plain_model = copy.deepcopy(model)
    start = [p.detach().float().clone() for p in model.parameters()]
    runs = []
    for m, plain in ((model, False), (plain_model, True)):
        opt = learner.make_optimizer(hp, list(m.parameters()))
        step = learner.update_body(m, opt, hp)
        ops.reset_launch_counts()
        if plain:
            with ops.plain_on_device():
                stats = step(batches[0], state)
        else:
            stats = step(batches[0], state)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        runs.append((m, opt, stats, counts))
    (mk, ok, sk, ck), (mp, op, sp, cp) = runs
    assert ck["vtrace_targets"] == 1 and ck["rmsprop_tail"] == 1
    assert cp["vtrace_targets"] == 0 and cp["rmsprop_tail"] == 0
    if policy == "f32":
        for a, b in zip([*mk.parameters(), *ok.state.nu],
                        [*mp.parameters(), *op.state.nu]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-8)
    else:
        for s, a, b in zip(start, ok.state.master, op.state.master):
            da, db = (a - s).double(), (b - s).double()
            assert float((da - db).norm()) <= 3e-2 * float(db.norm()) + 1e-12
    for key in sk:
        torch.testing.assert_close(sk[key].float(), sp[key].float(),
                                   rtol=1e-5 if policy == "f32" else 1e-2,
                                   atol=1e-6)


def test_anakin_pipelined_mlp_iteration_graph_matches_eager(cuda):
    env, model, opt, hp, gen, carry = anakin.setup(
        anakin.make_parser().parse_args([
            "--env", "Catch", "--model", "pipelined_mlp", "--batch_size",
            "8", "--unroll_length", "7", "--total_steps", "1120",
            "--entropy_cost_final", "1e-4"]), cuda)
    twin = copy.deepcopy(model)
    opt_e = learner.make_optimizer(hp, list(twin.parameters()))
    gen_e = torch.Generator(device=cuda)
    gen_e.set_state(gen.get_state())
    carry_e = nest.map(torch.clone, carry)
    eager = anakin.make_train_step(env, twin, opt_e, hp, gen_e)
    dispatch = anakin.make_iteration_dispatch(env, model, opt, hp, gen,
                                              carry)
    dispatch.capture()
    got = [dispatch() for _ in range(3)]
    want = [eager(carry_e) for _ in range(3)]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        for key in w:
            assert torch.equal(g[key], w[key].float()), key
    for p, q in zip(model.parameters(), twin.parameters()):
        assert torch.equal(p, q)
    for a, b in zip(nest.flatten(carry), nest.flatten(carry_e)):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), gen_e.get_state())
