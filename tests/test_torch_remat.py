"""The port's remat planning (torchbeast_tpu_torch/runtime/remat_plan.py,
the memory accounting of precision.py and the models' remat levers)
against the JAX package's, on the CPU.

- The planner: the lattice, the candidate order, spec parsing and every
  error text, and plan_remat over the same synthetic cost functions in
  both packages (the budget sweep, the nothing-fits fallback,
  unmeasurable candidates, the lazy walk): the same assignment, source
  and table. resolve_from_flags for all, none, a spec, the conflict and
  --transformer_remat, as the reference resolves them; the unset default
  is the port's own (ROADMAP.md Queue 3).
- The levers, numerically transparent: for each setting of each lever
  (every trunk stage at none/front/all, the LSTM core, the transformer
  blocks) the forward and the parameter gradients of a fixed loss equal
  the port's no-remat ones bit for bit, and the reference's under the
  same plan at rtol 1e-5, atol 1e-6 (the tolerance the reference's own
  remat test states); the state-dict keys do not change.
- One whole --remat all update and a K=2 superstep against the
  reference's, at eps 1.0: params at rtol 1e-5 (atol 2e-6), nu at rtol
  1e-5 with an atol of 1e-6 of each leaf's largest entry.
- The cost oracle on the CPU (its peak is an estimate there: the bytes
  autograd keeps, plus params, optimizer state and batch): more remat
  keeps less and reads more, and planning leaves the real params and
  optimizer state bitwise as they were. memory_stats and the
  learner.hbm_bytes_per_update gauge.
- Both drivers under --disable_cuda with --remat all and --remat auto
  (polybeast on both runtimes): they train, and telemetry.jsonl carries
  the learner.remat_plan static and the learner.hbm_bytes_per_update
  gauge.
"""

import functools
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from torchbeast_tpu import learner as jax_learner
from torchbeast_tpu import monobeast as jax_monobeast
from torchbeast_tpu import precision as jax_precision
from torchbeast_tpu.models import create_model as jax_create_model
from torchbeast_tpu.runtime import remat_plan as jrp
from torchbeast_tpu_torch import graphs, monobeast, nest, polybeast
from torchbeast_tpu_torch import learner as port_learner
from torchbeast_tpu_torch import precision, telemetry, weights
from torchbeast_tpu_torch.models import create_model as port_create_model
from torchbeast_tpu_torch.runtime import native_build
from torchbeast_tpu_torch.runtime import remat_plan as rp
from tests.torch_port_fixtures import few_torch_threads  # noqa: F401

T, B, A = 3, 2, 4
FRAME = (12, 12, 4)
TF_FRAME = (8, 8, 1)
TF_SIZE = dict(d_model=32, num_heads=4, memory_len=4)

# ---------------------------------------------------------------- planner

FAMILIES = [("deep", True), ("deep", False), ("resnet", True),
            ("transformer", False), ("mlp", True), ("mlp", False),
            ("shallow", True), ("shallow", False)]


@pytest.mark.parametrize("model,use_lstm", FAMILIES)
def test_stages_and_order_match_the_reference(model, use_lstm):
    ours, theirs = rp.stages_for(model, use_lstm), jrp.stages_for(
        model, use_lstm)
    assert [tuple(s) for s in ours] == [tuple(s) for s in theirs]
    assert rp.enumerate_assignments(ours) == jrp.enumerate_assignments(
        theirs)
    assert rp.all_remat(ours) == jrp.all_remat(theirs)
    assert rp.no_remat(ours) == jrp.no_remat(theirs)
    for assignment in rp.enumerate_assignments(ours):
        assert rp.spell(assignment) == jrp.spell(assignment)
        assert rp.model_kwargs(model, assignment) == jrp.model_kwargs(
            model, assignment)


@pytest.mark.parametrize("spec", [
    "stage0=front,stage1=all,stage2=none,core=all",
    "core=none,stage2=front,stage1=front,stage0=front",
    " stage0 = all , stage1=all,stage2=all,core=none",
])
def test_parse_spec_round_trip(spec):
    stages = rp.stages_for("deep", True)
    parsed = rp.parse_spec(spec, stages)
    assert parsed == jrp.parse_spec(spec, jrp.stages_for("deep", True))
    assert rp.parse_spec(rp.spell(parsed), stages) == parsed


@pytest.mark.parametrize("model,use_lstm,spec", [
    ("deep", True, "bogus=all"),
    ("deep", True, "stage0"),
    ("deep", True, "stage0=sometimes"),
    ("deep", True, "stage0=all"),
    ("deep", True, "stage0=all,stage0=none,stage1=all,stage2=all,core=all"),
    ("deep", True, "stage0=all,stage1=all,stage2=all,core=front"),
    ("mlp", False, "core=all"),
    ("transformer", False, "blocks=front"),
])
def test_parse_spec_errors_match_the_reference(model, use_lstm, spec):
    with pytest.raises(ValueError) as ours:
        rp.parse_spec(spec, rp.stages_for(model, use_lstm))
    with pytest.raises(ValueError) as theirs:
        jrp.parse_spec(spec, jrp.stages_for(model, use_lstm))
    assert str(ours.value) == str(theirs.value)


def _synthetic_cost(stages):
    """The reference test's headroom matrix: each remat level frees 10
    units of peak and costs 7 of recompute; no remat peaks at 100."""
    def cost(assignment):
        level = sum(s.options.index(assignment[s.name]) for s in stages)
        return float(100 - 10 * level), float(7 * level)
    return cost


def _same_plan(ours, theirs):
    assert ours.assignment == theirs.assignment
    assert ours.source == theirs.source
    assert ours.budget_bytes == theirs.budget_bytes
    assert ours.peak_bytes == theirs.peak_bytes
    assert ours.recompute_bytes == theirs.recompute_bytes
    assert ours.table == theirs.table
    assert ours.summary(include_table=True) == theirs.summary(
        include_table=True)


@pytest.mark.parametrize("budget", [25.0, 45.0, 65.0, 85.0, 100.0, 500.0])
@pytest.mark.parametrize("lazy", [False, True])
def test_plan_matches_the_reference(budget, lazy):
    ours = rp.plan_remat(rp.stages_for("deep", True),
                         _synthetic_cost(rp.stages_for("deep", True)),
                         budget, lazy=lazy)
    theirs = jrp.plan_remat(jrp.stages_for("deep", True),
                            _synthetic_cost(jrp.stages_for("deep", True)),
                            budget, lazy=lazy)
    _same_plan(ours, theirs)
    if ours.source == "auto":
        assert ours.peak_bytes <= budget


def test_fallback_when_nothing_fits_matches_the_reference():
    ours = rp.plan_remat(rp.stages_for("mlp", True),
                         _synthetic_cost(rp.stages_for("mlp", True)), 1.0)
    theirs = jrp.plan_remat(jrp.stages_for("mlp", True),
                            _synthetic_cost(jrp.stages_for("mlp", True)), 1.0)
    _same_plan(ours, theirs)
    assert ours.source == "fallback"
    assert ours.assignment == rp.all_remat(rp.stages_for("mlp", True))
    assert ours.peak_bytes is not None


def test_unmeasurable_candidates_never_chosen():
    def cost(assignment):
        if not assignment["core"]:
            return None, None  # the oracle failed on the tempting plan
        return 10.0, 7.0

    ours = rp.plan_remat(rp.stages_for("mlp", True), cost, 1000.0)
    _same_plan(ours, jrp.plan_remat(jrp.stages_for("mlp", True), cost,
                                    1000.0))
    assert ours.assignment == {"core": True}
    assert {r["assignment"]: r for r in ours.table}["core=none"]["fits"] \
        is False


@pytest.mark.parametrize("budget", [500.0, 75.0])
def test_lazy_walk_stops_at_the_first_fit(budget):
    calls = {}
    for name, lib in (("ours", rp), ("theirs", jrp)):
        stages = lib.stages_for("deep", False)
        cost = _synthetic_cost(stages)
        seen = calls[name] = []

        def counting(assignment, cost=cost, seen=seen):
            seen.append(lib.spell(assignment))
            return cost(assignment)

        plan = lib.plan_remat(stages, counting, budget, lazy=True)
    assert calls["ours"] == calls["theirs"]
    assert calls["ours"][-1] == rp.spell(plan.assignment)
    if budget == 500.0:
        assert len(calls["ours"]) == 1


def _port_flags(args):
    return monobeast.make_parser().parse_args(args + ["--disable_cuda"])


def _jax_flags(args):
    return jax_monobeast.make_parser().parse_args(args)


def _resolve_port(flags):
    return rp.resolve_from_flags(
        flags, monobeast.hparams_from_flags(flags), A, FRAME, torch.uint8,
        precision.resolve_flags(flags),
        build_model=lambda kw: monobeast._create_model(
            flags, A, FRAME, torch.device("cpu"), **kw))


def _resolve_jax(flags):
    policy = jax_precision.resolve_flags(flags)
    return jrp.resolve_from_flags(
        flags, jax_monobeast.hparams_from_flags(flags), A, FRAME, np.uint8,
        policy, build_model=lambda kw: jax_create_model(
            flags.model, num_actions=A, use_lstm=flags.use_lstm,
            dtype=policy.compute_dtype, **kw))


@pytest.mark.parametrize("args", [
    ["--model", "deep", "--use_lstm", "--remat", "all"],
    ["--model", "deep", "--remat", "none"],
    ["--model", "deep", "--use_lstm", "--remat",
     "stage0=front,stage1=all,stage2=none,core=all"],
    ["--model", "transformer", "--remat", "all"],
    ["--model", "transformer", "--transformer_remat"],
    ["--model", "transformer"],
    ["--model", "mlp", "--use_lstm", "--remat", "core=all"],
])
def test_resolve_explicit_values_match_the_reference(args):
    ours, theirs = _resolve_port(_port_flags(args)), _resolve_jax(
        _jax_flags(args))
    assert ours.assignment == theirs.assignment
    assert ours.source == theirs.source
    assert rp.last_plan() is ours
    assert ours.summary() == theirs.summary()


def test_resolve_conflict_raises_the_reference_text():
    args = ["--model", "transformer", "--transformer_remat", "--remat", "all"]
    with pytest.raises(ValueError) as ours:
        _resolve_port(_port_flags(args))
    with pytest.raises(ValueError) as theirs:
        _resolve_jax(_jax_flags(args))
    assert str(ours.value) == str(theirs.value)


def test_transformer_remat_off_the_transformer_raises():
    flags = _port_flags(["--model", "deep", "--transformer_remat"])
    with pytest.raises(ValueError, match="--transformer_remat applies to "
                                         "the transformer families only"):
        monobeast.build_model(flags, A, FRAME, torch.device("cpu"))
    with pytest.raises(ValueError, match="--transformer_remat applies to "
                                         "the transformer families only"):
        jax_monobeast._init_model_and_params(
            _jax_flags(["--model", "deep", "--transformer_remat"]), A, B,
            FRAME)


def test_default_plan_keeps_every_activation():
    # A deliberate difference (ROADMAP.md Queue 3's known differences):
    # the reference's default remats every trunk stage to fit a 16 GB
    # TPU; the port's keeps every activation.
    plan = _resolve_port(_port_flags(["--model", "deep", "--use_lstm"]))
    assert plan.source == "default"
    assert plan.assignment == {"stage0": False, "stage1": False,
                               "stage2": False, "core": False}
    theirs = _resolve_jax(_jax_flags(["--model", "deep", "--use_lstm"]))
    assert theirs.assignment == {"stage0": True, "stage1": True,
                                 "stage2": True, "core": False}
    model = monobeast.build_model(_port_flags(["--model", "deep",
                                               "--use_lstm"]),
                                  A, FRAME, torch.device("cpu"))
    assert model.trunk.remat == (False, False, False)
    assert model.head.core.remat is False


def test_resolve_auto_plans_once_and_builds_from_the_plan():
    """--remat auto on a tiny LSTM under the host's memory: the first
    candidate (no recompute) fits; the table is exported; a second
    resolution is served from the memo without running a candidate."""
    flags = _port_flags(["--model", "mlp", "--use_lstm", "--remat", "auto",
                         "--unroll_length", "4", "--batch_size", "2"])
    plan = _resolve_port(flags)
    assert plan.source == "auto"
    assert plan.assignment == {"core": False}
    assert plan.peak_bytes > 0 and plan.recompute_bytes > 0
    assert plan.budget_bytes == rp.default_budget_bytes()
    assert [r["assignment"] for r in plan.table] == ["core=none"]
    assert rp.last_plan() is plan
    assert _resolve_port(flags) is plan
    flags = _port_flags(["--model", "mlp", "--use_lstm", "--remat",
                         "core=all"])
    model = monobeast.build_model(flags, A, FRAME, torch.device("cpu"))
    assert model.head.core.remat is True


# ------------------------------------------------------------------ levers


def _inputs(seed, frame):
    rng = np.random.default_rng(seed)
    return {
        "frame": rng.integers(0, 256, (T, B) + frame, dtype=np.uint8),
        "reward": (3 * rng.standard_normal((T, B))).astype(np.float32),
        "done": rng.random((T, B)) < 0.3,
        "last_action": rng.integers(0, A, (T, B)).astype(np.int32),
    }


def _spec(name):
    if name == "transformer":
        return TF_FRAME, dict(attention_impl="dense", **TF_SIZE), False
    return FRAME, {}, True


@functools.lru_cache(maxsize=None)
def _jax_run(name, levers):
    """The reference's params, forward and parameter gradients of a fixed
    loss of the outputs, under the remat kwargs `levers` (a tuple of
    items)."""
    frame, kw, use_lstm = _spec(name)
    model = jax_create_model(name, num_actions=A, use_lstm=use_lstm,
                             **kw, **dict(levers))
    state = model.initial_state(B)
    params = model.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        _inputs(0, frame), state)
    rng = np.random.default_rng(1)
    w_logits = rng.standard_normal((T, B, A)).astype(np.float32)
    w_base = rng.standard_normal((T, B)).astype(np.float32)
    inputs = _inputs(2, frame)

    def loss(p):
        out, _ = model.apply(p, inputs, state, sample_action=False)
        return (jnp.sum(out.policy_logits * w_logits)
                + jnp.sum(out.baseline * w_base)), out

    (value, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return jax.device_get((params, w_logits, w_base, value, out, grads))


def _port_run(name, levers, params, w_logits, w_base):
    frame, kw, use_lstm = _spec(name)
    model = port_create_model(name, A, use_lstm=use_lstm, frame_shape=frame,
                              **kw, **dict(levers))
    weights.load_jax_params(model, params)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs(2, frame).items()}
    out, _ = model(inputs, model.initial_state(B), sample_action=False)
    value = (torch.sum(out.policy_logits * torch.from_numpy(w_logits))
             + torch.sum(out.baseline * torch.from_numpy(w_base)))
    grads = torch.autograd.grad(value, list(model.parameters()))
    return model, value, out, grads


def _trunk(stage, setting):
    flags = [False, False, False]
    flags[stage] = rp.SETTING_NAMES[setting]
    return (("remat", tuple(flags)),)


# (model, the remat kwargs under test, the reference's no-remat kwargs):
# every trunk stage at none/front/all, the LSTM core, the blocks.
NO_REMAT = {"deep": (("remat", (False, False, False)),), "mlp": (),
            "transformer": ()}
LEVERS = ([("deep", _trunk(stage, setting))
           for stage in range(3) for setting in ("none", "front", "all")]
          + [("deep", (("remat", (True, True, True)),
                       ("core_remat", True))),
             ("deep", (("remat", (False, False, False)),
                       ("core_remat", True))),
             ("mlp", (("core_remat", True),)),
             ("transformer", (("remat", True),))])


@pytest.mark.parametrize("name,levers", LEVERS,
                         ids=[f"{n}-{dict(lv)}" for n, lv in LEVERS])
def test_lever_is_numerically_transparent(name, levers):
    params, w_logits, w_base, value, out, grads = _jax_run(name, levers)
    model, got_value, got_out, got_grads = _port_run(
        name, levers, params, w_logits, w_base)
    plain, plain_value, plain_out, plain_grads = _port_run(
        name, NO_REMAT[name], params, w_logits, w_base)
    # The port under the plan against its own no-remat run: bit for bit.
    assert list(model.state_dict()) == list(plain.state_dict())
    assert torch.equal(got_value, plain_value)
    assert torch.equal(got_out.policy_logits, plain_out.policy_logits)
    assert all(torch.equal(g, p) for g, p in zip(got_grads, plain_grads))
    # Against the reference under the same plan.
    np.testing.assert_allclose(float(got_value.detach()), float(value),
                               rtol=1e-5)
    np.testing.assert_allclose(got_out.policy_logits.detach().numpy(),
                               np.asarray(out.policy_logits), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_out.baseline.detach().numpy(),
                               np.asarray(out.baseline), rtol=1e-5,
                               atol=1e-6)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=1e-6),
        weights.param_list_to_jax(model, list(got_grads)),
        grads)


def test_trunk_rejects_bad_levers_with_the_reference_texts():
    with pytest.raises(ValueError, match=r"must have one flag per stage "
                                         r"\(3\)"):
        port_create_model("deep", A, frame_shape=FRAME, remat=(True, True))
    with pytest.raises(ValueError, match="must be False, True, or 'front'"):
        port_create_model("deep", A, frame_shape=FRAME, remat="back")


def test_no_region_is_recomputed_without_a_gradient(monkeypatch):
    """Acting (torch.no_grad) runs the plain forward under every plan:
    the same outputs, and no checkpoint is entered; with a gradient,
    one per trunk stage and one per LSTM step."""
    from torchbeast_tpu_torch.models import layers

    inputs = {k: torch.from_numpy(v) for k, v in _inputs(3, FRAME).items()}
    outs = []
    for levers in ({}, {"remat": True, "core_remat": True}):
        torch.manual_seed(0)
        model = port_create_model("deep", A, use_lstm=True,
                                  frame_shape=FRAME, **levers)
        with torch.no_grad():
            outs.append(model(inputs, model.initial_state(B),
                              sample_action=False)[0])
    assert torch.equal(outs[0].policy_logits, outs[1].policy_logits)
    calls = []
    real = layers.checkpoint
    monkeypatch.setattr(layers, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        model(inputs, model.initial_state(B), sample_action=False)
    assert calls == []
    model(inputs, model.initial_state(B), sample_action=False)
    assert len(calls) == 3 + T


# ------------------------------------------------------------------ update


def _batch(seed, frame=FRAME):
    rng = np.random.default_rng(seed)
    return {
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


def _hp(**kw):
    return dict(unroll_length=T, batch_size=B, total_steps=T * B * 10,
                vtrace_impl="pallas", opt_impl="pallas",
                entropy_cost=0.01, rmsprop_eps=1.0, **kw)


ALL = dict(remat=(True, True, True), core_remat=True)


def _torch(tree):
    return nest.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("k", [1, 2])
def test_remat_all_update_matches_the_reference(k):
    """--remat all: one update (k=1) and a K=2 superstep of the deep +
    LSTM model against the reference's under the same plan."""
    jmodel = jax_create_model("deep", num_actions=A, use_lstm=True, **ALL)
    rng = np.random.default_rng(9)
    state = tuple((0.5 * rng.standard_normal(np.shape(s))).astype(
        np.float32) for s in jmodel.initial_state(B))
    params = jax.device_get(jmodel.init(
        {"params": jax.random.PRNGKey(0), "action": jax.random.PRNGKey(1)},
        {key: v[:1] for key, v in _batch(0).items()}, state))
    jhp = jax_learner.HParams(**_hp())
    optimizer = jax_learner.make_optimizer(jhp)
    batches = [_batch(10 + i) for i in range(k)]
    if k == 1:
        step = jax_learner.make_update_step(jmodel, optimizer, jhp,
                                            donate=False)
        batch, states = batches[0], state
    else:
        step = jax_learner.make_update_superstep(jmodel, optimizer, jhp, k,
                                                 donate=False)
        batch = {key: np.stack([b[key] for b in batches])
                 for key in batches[0]}
        states = tuple(np.stack([s] * k) for s in state)
    want_params, opt_state, _ = jax.device_get(step(
        params, optimizer.init(params), batch, states))
    want_nu = optax.tree_utils.tree_get(opt_state, "nu")

    model = port_create_model("deep", A, use_lstm=True, frame_shape=FRAME,
                              **ALL)
    weights.load_jax_params(model, params)
    hp = port_learner.HParams(**_hp())
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    port_step = (port_learner.update_body(model, opt, hp) if k == 1 else
                 port_learner.make_update_superstep(model, opt, hp, k))
    port_step(_torch(batch), _torch(states))
    assert opt.state.count == k
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5,
                                                atol=2e-6),
        weights.torch_to_jax(model.state_dict()), want_params)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), rtol=1e-5, atol=1e-6 * np.abs(w).max()),
        weights.param_list_to_jax(model, opt.state.nu),
        want_nu)


# ------------------------------------------------------------ cost oracle


def _deep(**levers):
    torch.manual_seed(0)
    return port_create_model("deep", A, use_lstm=True, frame_shape=FRAME,
                             **levers)


def _share(candidate, real):
    """`candidate` holding `real`'s parameter tensors themselves."""
    for (name, _), p in zip(list(candidate.named_parameters()),
                            real.parameters()):
        owner = candidate.get_submodule(name.rpartition(".")[0])
        setattr(owner, name.rpartition(".")[2], p)
    return candidate


def test_cost_oracle_orders_plans_and_leaves_the_state_bitwise():
    """Candidates share the real model's params and the real optimizer
    (nu moved by one real update first): peak(all) < peak(none),
    recompute(all) > recompute(none), the lazy walk under a budget that
    fits everything stops at no remat, and params, nu, moments, masters
    and both counts are bitwise as they were after planning."""
    hp = port_learner.HParams(**_hp())
    real = _deep()
    opt = port_learner.make_optimizer(hp, list(real.parameters()))
    state = real.initial_state(B)
    port_learner.update_body(real, opt, hp)(_torch(_batch(1)), state)
    before = [t.clone() for t in graphs.update_state_tensors(opt)]
    count = opt.state.count
    cost_fn = rp.superstep_cost_fn(
        lambda kw: _share(_deep(**kw), real), hp, 1,
        rp.learner_batch_structs(hp, A, FRAME), B, "deep",
        make_optimizer=lambda m: opt)
    stages = rp.stages_for("deep", True)
    none, full = (cost_fn(a) for a in (rp.no_remat(stages),
                                       rp.all_remat(stages)))
    assert full[0] < none[0]
    assert full[1] > none[1]
    plan = rp.plan_remat(stages, cost_fn, 1e12, lazy=True)
    assert plan.assignment == rp.no_remat(stages)
    assert plan.table[0]["peak_bytes"] == none[0]
    after = graphs.update_state_tensors(opt)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert opt.state.count == count and int(opt.device_count) == count


def test_cost_oracle_superstep_and_an_unmeasurable_candidate():
    hp = port_learner.HParams(**_hp())
    cost_fn = rp.superstep_cost_fn(
        lambda kw: _deep(**kw), hp, 2,
        rp.learner_batch_structs(hp, A, FRAME), B, "deep")
    peak1, rec1 = rp.superstep_cost_fn(
        lambda kw: _deep(**kw), hp, 1,
        rp.learner_batch_structs(hp, A, FRAME), B, "deep")(
            rp.no_remat(rp.stages_for("deep", True)))
    peak2, rec2 = cost_fn(rp.no_remat(rp.stages_for("deep", True)))
    assert peak2 > peak1 and 1.9 * rec1 < rec2 < 2.1 * rec1

    def failing(kw):
        raise RuntimeError("out of memory")

    bad = rp.superstep_cost_fn(failing, hp, 1,
                               rp.learner_batch_structs(hp, A, FRAME), B,
                               "deep")
    assert bad({"stage0": False}) == (None, None)


def _update_args(policy_name):
    pol = precision.get(policy_name)
    hp = port_learner.HParams(**_hp(param_dtype=pol.param_dtype,
                                    opt_state_dtype=pol.opt_state_dtype))
    torch.manual_seed(0)
    model = precision.cast_params(port_create_model(
        "deep", A, use_lstm=True, frame_shape=FRAME,
        dtype=pol.compute_dtype, head_dtype=pol.head_dtype), pol)
    opt = port_learner.make_optimizer(hp, list(model.parameters()))
    batch = precision.cast_batch(_torch(_batch(1)), pol.batch_dtype)
    state = precision.cast_batch(model.initial_state(B), pol.batch_dtype)
    return model, opt, hp, batch, state


def test_memory_stats_fields_and_bf16_reads_fewer_bytes():
    got = {}
    for name in ("f32", "bf16_train"):
        model, opt, hp, batch, state = _update_args(name)
        got[name] = precision.memory_stats(
            port_learner.update_body(model, opt, hp), batch, state,
            resident=graphs.update_state_tensors(opt))
    f32, bf16 = got["f32"], got["bf16_train"]
    for stats in (f32, bf16):
        assert stats.argument_bytes > 0 and stats.output_bytes > 0
        assert stats.temp_bytes > 0
        assert stats.peak_bytes == (stats.argument_bytes
                                    + stats.output_bytes + stats.temp_bytes)
    assert bf16.bytes_accessed < f32.bytes_accessed
    assert bf16.temp_bytes < f32.temp_bytes
    assert precision.bytes_accessed(lambda: 1 / 0) is None
    assert precision.memory_stats(lambda: 1 / 0).peak_bytes is None


def test_hbm_gauge_is_per_update_at_any_k():
    """learner.hbm_bytes_per_update from the first dispatch: at K=2 the
    dispatch's bytes over 2, within the staging bytes of K=1's figure."""
    gauges = {}
    for k in (1, 2):
        model, opt, hp, batch, state = _update_args("f32")
        reg = telemetry.MetricsRegistry()
        dispatch = port_learner.instrument_update_step(
            port_learner.make_update_dispatch(model, opt, hp, k),
            registry=reg, superstep_k=k)
        if k > 1:
            batch = {key: torch.stack([v] * k) for key, v in batch.items()}
            state = nest.map(lambda s: torch.stack([s] * k), state)
        dispatch(batch, state)
        gauges[k] = reg.gauge("learner.hbm_bytes_per_update").value()
        staging = precision.tensor_bytes((batch, state))
    assert gauges[1] > 0
    assert abs(gauges[2] - gauges[1]) <= staging


# ---------------------------------------------------------------- drivers


def _final_line(path):
    lines = telemetry.read_jsonl(path)
    assert lines and lines[-1]["final"]
    for line in lines:
        assert telemetry.validate_snapshot(line) == []
    return lines[-1]


def _check_telemetry(line, source):
    plan = line["learner.remat_plan"]
    assert plan["source"] == source
    assert set(plan) == {"assignment", "source", "budget_bytes",
                         "peak_bytes", "recompute_bytes", "evaluated"}
    if source == "auto":
        assert plan["evaluated"] >= 1 and plan["peak_bytes"] > 0
    assert line["gauges"]["learner.hbm_bytes_per_update"] > 0


@pytest.mark.parametrize("remat,source", [("all", "all"),
                                          ("auto", "auto")])
def test_monobeast_trains_under_a_plan(tmp_path, remat, source):
    flags = monobeast.make_parser().parse_args([
        "--env", "Mock", "--model", "deep", "--use_lstm", "--num_actors",
        "2", "--batch_size", "2", "--unroll_length", "4", "--total_steps",
        "16", "--serial_envs", "--vtrace_impl", "pallas", "--opt_impl",
        "pallas", "--disable_cuda", "--remat", remat, "--savedir",
        str(tmp_path), "--xpid", "m"])
    stats = monobeast.train(flags)
    assert stats["updates"] == 2 and np.isfinite(stats["total_loss"])
    _check_telemetry(_final_line(str(tmp_path / "m" / "telemetry.jsonl")),
                     source)


def _toolchain_gap():
    try:
        native_build.check_toolchain()
    except native_build.NativeBuildError as e:
        return str(e)
    return None


@pytest.mark.parametrize("runtime", ["python", "native"])
@pytest.mark.parametrize("remat,source", [("all", "all"),
                                          ("auto", "auto")])
def test_polybeast_trains_under_a_plan(tmp_path, runtime, remat, source):
    if runtime == "native" and _toolchain_gap():
        pytest.skip(_toolchain_gap())
    flags = polybeast.make_parser().parse_args([
        "--env", "Mock", "--use_lstm", "--num_servers", "2",
        "--batch_size", "2", "--unroll_length", "5", "--total_steps", "20",
        "--max_inference_batch_size", "4", "--disable_cuda",
        "--pipes_basename", f"unix:{tmp_path}/p", "--remat", remat,
        "--savedir", str(tmp_path), "--xpid", "p",
        "--no_native_runtime" if runtime == "python" else "--native_runtime"])
    if runtime == "native":
        flags.native_server = True
    stats = polybeast.train(flags)
    assert stats["updates"] == 2 and np.isfinite(stats["total_loss"])
    _check_telemetry(_final_line(str(tmp_path / "p" / "telemetry.jsonl")),
                     source)
    assert os.path.exists(tmp_path / "p" / "model.ckpt")
