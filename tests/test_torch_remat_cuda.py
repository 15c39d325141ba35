"""The port's remat plans on the card, at small shapes: checkpointed
regions inside a captured update (graphs.CapturedUpdate) against the
eager steps of a no-remat twin, and the planner's oracle running out of
memory. Every test needs a CUDA device and skips without one; like
tests/test_torch_graphs_cuda.py this module imports no jax, so on the GPU
machine it runs as
    python -m pytest --noconftest -m cuda tests/test_torch_remat_cuda.py

TF32 off and cuDNN deterministic: a replay, and a recomputed region,
must then give the eager no-remat step's bits.
"""

import contextlib

import numpy as np
import pytest
import torch

from torchbeast_tpu_torch import learner, ops
from torchbeast_tpu_torch.models import create_model
from torchbeast_tpu_torch.runtime import remat_plan

pytestmark = pytest.mark.cuda

T, B, A, FRAME = 4, 2, 4, (12, 12, 4)
TF_FRAME = (8, 8, 1)
TF_SIZE = dict(d_model=32, num_heads=4, memory_len=4,
               attention_impl="pallas")


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


def _batch(seed, dev, frame=FRAME):
    rng = np.random.default_rng(seed)
    arrays = {
        "frame": rng.integers(0, 256, (T + 1, B) + frame, dtype=np.uint8),
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


PLANS = [
    ("deep", dict(remat=True, core_remat=True)),
    ("deep", dict(remat="front")),
    ("transformer", dict(remat=True)),
]


@pytest.mark.parametrize("name,levers", PLANS,
                         ids=[f"{n}-{sorted(lv.items())}" for n, lv in PLANS])
def test_remat_graph_replays_equal_the_eager_no_remat_step(cuda, monkeypatch,
                                                           name, levers):
    """Two dispatches of a K=1 graph of the model under the plan against
    two eager updates of a no-remat twin from the same weights: params,
    nu and every stat bitwise; the port kernels per replay are the eager
    update's plus the recomputed forwards (pool_bwd 3, attention
    forwards 4 and backwards 2). A rematted LSTM core steps the plain
    cell, never the recurrence kernels, so its twin's core runs their
    plain version too."""
    monkeypatch.setenv("TBT_POOL_PALLAS", "1")
    frame = FRAME if name == "deep" else TF_FRAME
    kw = (dict(use_lstm=True) if name == "deep" else TF_SIZE)
    torch.manual_seed(0)
    model = create_model(name, A, frame_shape=frame, **kw, **levers).to(cuda)
    torch.manual_seed(0)
    twin = create_model(name, A, frame_shape=frame, **kw).to(cuda)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    hp = learner.HParams(unroll_length=T, batch_size=B, total_steps=6 * T * B,
                         vtrace_impl="pallas", opt_impl="pallas",
                         entropy_cost_final=1e-4)
    opt_g = learner.make_optimizer(hp, list(model.parameters()))
    opt_e = learner.make_optimizer(hp, list(twin.parameters()))
    state = model.initial_state(B, cuda)
    batches = [_batch(i, cuda, frame) for i in range(2)]
    eager = learner.update_body(twin, opt_e, hp)
    core_remat = levers.get("core_remat", False)
    with (ops.plain_on_device("lstm_layer") if core_remat
          else contextlib.nullcontext()):
        want = [eager(b, state) for b in batches]
    dispatch = learner.make_update_dispatch(model, opt_g, hp, 1)
    got = [dispatch(b, state) for b in batches]
    torch.cuda.synchronize()
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(opt_g.state.nu, opt_e.state.nu):
        assert torch.equal(a, b)
    for key in want[0]:
        assert torch.equal(torch.stack([g[key] for g in got]),
                           torch.stack([w[key].float() for w in want])), key
    per = dispatch.launches_per_replay
    if name == "deep":
        lstm = {} if core_remat else {"lstm_layer": 2 * (T + 1)}
        assert per == {"vtrace_targets": 1, "rmsprop_tail": 1, "pool_bwd": 3,
                       **lstm}
    else:
        assert per == {"vtrace_targets": 1, "rmsprop_tail": 1,
                       "transformer_attention": 4,
                       "transformer_attention_bwd": 2}
    assert dispatch.bytes_accessed > 0


def test_oracle_reports_an_out_of_memory_candidate_as_unmeasurable(cuda):
    """With the allocator capped at 1 MB every candidate runs out of
    memory: each reports (None, None), none is chosen, and the plan falls
    back to all-remat with its table showing every row unmeasured."""
    hp = learner.HParams(unroll_length=T, batch_size=B, vtrace_impl="pallas",
                         opt_impl="pallas")

    def build(kw):
        torch.manual_seed(0)
        return create_model("deep", A, use_lstm=True, frame_shape=FRAME,
                            **kw).to(cuda)

    cost_fn = remat_plan.superstep_cost_fn(
        build, hp, 1, remat_plan.learner_batch_structs(hp, A, FRAME), B,
        "deep")
    stages = remat_plan.stages_for("deep", True)
    total = torch.cuda.mem_get_info(cuda)[1]
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction((1 << 20) / total, cuda)
    try:
        plan = remat_plan.plan_remat(stages, cost_fn, float(1 << 20),
                                     max_evals=3)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, cuda)
    assert plan.source == "fallback"
    assert plan.assignment == remat_plan.all_remat(stages)
    assert len(plan.table) == 3
    for row in plan.table:
        assert row["peak_bytes"] is None and row["fits"] is False
    # Uncapped, the same oracle measures the candidate.
    peak, recompute = cost_fn(remat_plan.no_remat(stages))
    assert peak > 0 and recompute > 0


def test_oracle_peak_drops_with_remat_and_frees_its_candidates(cuda):
    """At 84x84 frames, T=4, B=2: all-remat peaks lower and reads more
    than no remat, and a candidate's buffers are all freed after it."""
    hp = learner.HParams(unroll_length=T, batch_size=B, vtrace_impl="pallas",
                         opt_impl="pallas")
    model_bytes = []

    def build(kw):
        torch.manual_seed(0)
        model = create_model("deep", A, use_lstm=True, frame_shape=(84, 84, 4),
                             **kw).to(cuda)
        model_bytes.append(sum(p.numel() * 4 for p in model.parameters()))
        return model

    cost_fn = remat_plan.superstep_cost_fn(
        build, hp, 1, remat_plan.learner_batch_structs(hp, A, (84, 84, 4)),
        B, "deep")
    stages = remat_plan.stages_for("deep", True)
    # The first run of each plan allocates what the libraries keep (their
    # workspaces, for the backward's thread and recomputed ops too).
    cost_fn(remat_plan.no_remat(stages))
    cost_fn(remat_plan.all_remat(stages))
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(cuda)
    none = cost_fn(remat_plan.no_remat(stages))
    full = cost_fn(remat_plan.all_remat(stages))
    assert full[0] < none[0] and full[1] > none[1]
    assert torch.cuda.memory_allocated(cuda) == before
    assert none[0] > model_bytes[0]
