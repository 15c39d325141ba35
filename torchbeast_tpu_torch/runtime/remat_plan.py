"""Remat planning: choose each remat lever of the learner's model as a
function of the card's memory and the dispatch (K, T, B, precision),
the counterpart of torchbeast_tpu/runtime/remat_plan.py.

The pure-Python parts are the port's own copy of the reference's, with
the same texts: `Stage`, `stages_for`, `model_kwargs`, `all_remat`,
`no_remat`, `enumerate_assignments`, `spell`, `parse_spec`, `PlanResult`,
`plan_remat`, the memo and `last_plan`. `resolve_from_flags` keeps the
reference's logic, errors and memo. Three parts are rewritten for torch:

- `default_budget_bytes`: the card's own total memory
  (`torch.cuda.mem_get_info`), or the host's physical memory on the CPU.
  The port keeps no default envelope of its own.
- `superstep_cost_fn`: the oracle RUNS each candidate once, where the
  reference compiles it without running: one eager forward, backward and
  step of the exact dispatch the driver will run (same K, T, B, precision
  and --opt_impl), on a candidate model built from the driver's seed (so
  it holds the real model's parameter values), through
  precision.memory_stats. The peak is the caching allocator's on the card
  (`torch.cuda.max_memory_allocated`, cuDNN's workspace included) and an
  estimate on the CPU (the bytes autograd keeps, plus params, optimizer
  state and batch); the recompute figure is precision.bytes_accessed of
  the same run. A candidate that runs out of memory reports (None, None):
  never chosen, and visible in the plan table. The run's updates are
  undone bitwise (graphs.update_state_restored), and every candidate's
  buffers are freed before the next.
- `learner_batch_structs`: `Struct`s (shape, torch dtype), not
  ShapeDtypeStructs.

Exposed on both drivers as `--remat {auto,all,none,<spec>}` +
`--hbm_budget_gb`; the chosen plan is logged and exported as the
`learner.remat_plan` telemetry static. `<spec>` pins stages by hand: a
comma list of `stage=setting` with settings {none,front,all}, e.g.
`--remat stage0=front,stage1=all,stage2=all,core=none`.

One deliberate difference (ROADMAP.md Queue 3): with --remat unset the
reference resolves to its pre-planner static plan, which remats every
trunk stage (chosen to fit a 16 GB TPU); the port's default keeps every
activation (`source` "default", every lever at its no-remat setting;
--transformer_remat still sets `blocks`). Every explicit --remat value
resolves as in the reference.
"""

import gc
import itertools
import logging
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

log = logging.getLogger(__name__)

# Flag-spelling <-> model-kwarg values, ordered nowhere (the ORDER
# lives in the per-stage option tuples below).
SETTING_NAMES = {"none": False, "front": "front", "all": True}
_SETTING_SPELLING = {False: "none", "front": "front", True: "all"}

class Stage(NamedTuple):
    """One remat lever: `options` ordered by INCREASING recompute
    (index 0 saves everything, the last entry remats the most)."""

    name: str
    options: Tuple[Any, ...]


def stages_for(model: str, use_lstm: bool) -> List[Stage]:
    """The remat lattice of one model family (empty = nothing to plan:
    the feed-forward MLP/AtariNet trunks are not remat-able levers)."""
    stages: List[Stage] = []
    if model in ("deep", "resnet"):
        for i in range(3):
            stages.append(Stage(f"stage{i}", (False, "front", True)))
    if model in ("transformer", "pipelined_transformer"):
        stages.append(Stage("blocks", (False, True)))
    if use_lstm:
        stages.append(Stage("core", (False, True)))
    return stages


def model_kwargs(model: str, assignment: Dict[str, Any]) -> Dict[str, Any]:
    """Assignment -> create_model(**kwargs) for the family's levers."""
    kwargs: Dict[str, Any] = {}
    if model in ("deep", "resnet"):
        kwargs["remat"] = tuple(
            assignment[f"stage{i}"] for i in range(3)
        )
    if model in ("transformer", "pipelined_transformer"):
        kwargs["remat"] = bool(assignment["blocks"])
    if "core" in assignment:
        kwargs["core_remat"] = bool(assignment["core"])
    return kwargs


def _level_assignment(stages: List[Stage], level: int) -> Dict[str, Any]:
    """Every stage at `level` clamped to its own option count."""
    return {
        s.name: s.options[min(level, len(s.options) - 1)] for s in stages
    }


def all_remat(stages: List[Stage]) -> Dict[str, Any]:
    """The remat-everything fallback (the reference's static default)."""
    return _level_assignment(stages, max(
        (len(s.options) for s in stages), default=1
    ))


def no_remat(stages: List[Stage]) -> Dict[str, Any]:
    return _level_assignment(stages, 0)


def enumerate_assignments(stages: List[Stage]) -> List[Dict[str, Any]]:
    """Every per-stage combination, ordered by ascending recompute RANK
    (sum of per-stage option indices, ties broken by the index tuple) —
    minimum recompute first, all-remat last. The rank is the lazy
    walk's evaluation order; the exhaustive planner re-orders by the
    cost model's measured recompute."""
    if not stages:
        return [{}]
    level_sets = [range(len(s.options)) for s in stages]
    combos = sorted(
        itertools.product(*level_sets),
        key=lambda levels: (sum(levels), levels),
    )
    return [
        {s.name: s.options[lv] for s, lv in zip(stages, levels)}
        for levels in combos
    ]


def spell(assignment: Dict[str, Any]) -> str:
    return ",".join(
        f"{name}={_SETTING_SPELLING[val]}"
        for name, val in sorted(assignment.items())
    )


def parse_spec(spec: str, stages: List[Stage]) -> Dict[str, Any]:
    """`stage0=front,core=all` -> assignment, validated against the
    family's stages and each stage's own option set."""
    by_name = {s.name: s for s in stages}
    assignment: Dict[str, Any] = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(
                f"--remat spec entry {part!r} is not stage=setting "
                f"(stages for this model: {sorted(by_name) or 'none'})"
            )
        name, _, setting = part.partition("=")
        name, setting = name.strip(), setting.strip()
        if name not in by_name:
            raise ValueError(
                f"--remat spec names unknown stage {name!r} "
                f"(stages for this model: {sorted(by_name) or 'none'})"
            )
        if setting not in SETTING_NAMES:
            raise ValueError(
                f"--remat spec setting {setting!r} for stage {name!r} "
                f"must be one of {sorted(SETTING_NAMES)}"
            )
        value = SETTING_NAMES[setting]
        if value not in by_name[name].options:
            raise ValueError(
                f"--remat stage {name!r} has no {setting!r} option "
                f"(choices: "
                f"{[_SETTING_SPELLING[o] for o in by_name[name].options]})"
            )
        if name in assignment:
            raise ValueError(f"--remat spec repeats stage {name!r}")
        assignment[name] = value
    missing = set(by_name) - set(assignment)
    if missing:
        raise ValueError(
            f"--remat spec misses stages {sorted(missing)} "
            "(every stage needs a setting)"
        )
    return assignment


class PlanResult(NamedTuple):
    """One planning outcome. `assignment` is the chosen per-stage
    setting; `source` records how it was chosen ("auto", "all",
    "none", "spec", "default", or "fallback" when no candidate fit the
    budget); `table` carries every evaluated candidate (assignment
    spelling, peak, recompute, fits) for the telemetry static."""

    assignment: Dict[str, Any]
    source: str
    budget_bytes: Optional[float]
    peak_bytes: Optional[float]
    recompute_bytes: Optional[float]
    table: Tuple[Dict[str, Any], ...]

    def summary(self, include_table: bool = False) -> Dict[str, Any]:
        """JSON-able form for the `learner.remat_plan` static + logs.
        The per-candidate table is opt-in: the static re-serializes
        into EVERY telemetry.jsonl line, and up to 64 identical table
        rows per 5-second snapshot is pure bloat — the table is logged
        once at resolution instead."""
        out = {
            "assignment": {
                k: _SETTING_SPELLING[v]
                for k, v in sorted(self.assignment.items())
            },
            "source": self.source,
            "budget_bytes": self.budget_bytes,
            "peak_bytes": self.peak_bytes,
            "recompute_bytes": self.recompute_bytes,
            "evaluated": len(self.table),
        }
        if include_table:
            out["table"] = list(self.table)
        return out


def plan_remat(
    stages: List[Stage],
    cost_fn: Callable[[Dict[str, Any]], Tuple[Optional[float],
                                              Optional[float]]],
    budget_bytes: float,
    lazy: bool = False,
    max_evals: int = 64,
) -> PlanResult:
    """Pick the minimum-recompute assignment whose peak fits the budget.

    `cost_fn(assignment) -> (peak_bytes, recompute_bytes)`; a None peak
    means the oracle could not measure that candidate (it is skipped —
    never chosen on faith). `lazy=True` walks candidates in ascending
    recompute-RANK order and stops at the first fit (the driver path,
    where each evaluation runs the real superstep once);
    `lazy=False` evaluates everything and picks the true measured
    minimum (tests and the bench). Nothing fits -> all-remat fallback,
    the one case whose peak may exceed the budget (it is also the
    reference's static default)."""
    candidates = enumerate_assignments(stages)[:max_evals]
    table: List[Dict[str, Any]] = []
    fitting: List[Tuple[float, int, Dict[str, Any], float]] = []
    for idx, assignment in enumerate(candidates):
        peak, recompute = cost_fn(assignment)
        fits = peak is not None and peak <= budget_bytes
        table.append({
            "assignment": spell(assignment),
            "peak_bytes": peak,
            "recompute_bytes": recompute,
            "fits": bool(fits),
        })
        if fits:
            rec = recompute if recompute is not None else float("inf")
            fitting.append((rec, idx, assignment, peak))
            if lazy:
                break
    if fitting:
        rec, _, assignment, peak = min(fitting, key=lambda t: t[:2])
        return PlanResult(
            assignment=assignment,
            source="auto",
            budget_bytes=float(budget_bytes),
            peak_bytes=peak,
            recompute_bytes=None if rec == float("inf") else rec,
            table=tuple(table),
        )
    fallback = all_remat(stages)
    peak = recompute = None
    for row in table:
        if row["assignment"] == spell(fallback):
            peak, recompute = row["peak_bytes"], row["recompute_bytes"]
            break
    return PlanResult(
        assignment=fallback,
        source="fallback",
        budget_bytes=float(budget_bytes),
        peak_bytes=peak,
        recompute_bytes=recompute,
        table=tuple(table),
    )


def default_budget_bytes(device=None) -> float:
    """--hbm_budget_gb unset: the card's total memory, or on the CPU the
    host's physical memory."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


class Struct(NamedTuple):
    """The shape and dtype of one learner batch leaf."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _materialize(structs: Dict[str, Struct], device) -> Dict[str, Any]:
    """Zero tensors of `structs` on `device` (the oracle's memory and
    byte figures do not depend on the values)."""
    return {key: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for key, s in structs.items()}


def superstep_cost_fn(
    build_model: Callable[[Dict[str, Any]], Any],
    hp,
    superstep_k: int,
    batch_structs: Dict[str, Struct],
    state_batch_size: int,
    model_name: str,
    make_optimizer: Optional[Callable[[Any], Any]] = None,
) -> Callable[[Dict[str, Any]], Tuple[Optional[float], Optional[float]]]:
    """The driver's cost oracle: assignment -> (peak_bytes,
    recompute_bytes) of one eager run of the (super)step the driver will
    dispatch, on `build_model(model_kwargs(...))` (a model on its device,
    its params in the policy's resident dtype) and the optimizer
    `make_optimizer(model)` (default: learner.make_optimizer over the
    model's params, fresh). The run's updates are undone bitwise
    (graphs.update_state_restored), so a `build_model` that hands out the
    real model's parameter tensors and a `make_optimizer` that hands out
    the real optimizer leave both as they were. Float leaves of the
    initial agent state take the batch's float dtype, as the drivers cast
    them. (None, None) when the run fails (out of memory included)."""
    from torchbeast_tpu_torch import graphs, nest, precision
    from torchbeast_tpu_torch import learner as learner_lib

    if make_optimizer is None:
        make_optimizer = lambda m: learner_lib.make_optimizer(  # noqa: E731
            hp, list(m.parameters()))
    batch_dtype = batch_structs["reward"].dtype

    def cost_fn(assignment):
        model = optimizer = None
        device = torch.device("cpu")
        try:
            model = build_model(model_kwargs(model_name, assignment))
            device = next(model.parameters()).device
            optimizer = make_optimizer(model)
            batch = _materialize(batch_structs, device)
            state = nest.map(
                lambda s: s.to(batch_dtype) if s.is_floating_point() else s,
                model.initial_state(state_batch_size, device))
            if superstep_k > 1:
                stack = lambda t: torch.stack(  # noqa: E731
                    [t] * superstep_k)
                batch = {k: stack(v) for k, v in batch.items()}
                state = nest.map(stack, state)
                step = learner_lib.make_update_superstep(
                    model, optimizer, hp, superstep_k)
            else:
                step = learner_lib.update_body(model, optimizer, hp)
            resident = graphs.update_state_tensors(optimizer)
            with graphs.update_state_restored(optimizer):
                stats = precision.memory_stats(step, batch, state,
                                               resident=resident)
            if stats.peak_bytes is None:
                return None, None
            return stats.peak_bytes, stats.bytes_accessed
        except Exception:
            log.debug(
                "remat cost evaluation failed for %s",
                spell(assignment), exc_info=True,
            )
            return None, None
        finally:
            # Free the candidate before the next one (and before the
            # real model's capture): nothing of it stays on the card.
            del model, optimizer
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

    return cost_fn


def learner_batch_structs(
    hp, num_actions: int, frame_shape, frame_dtype=torch.uint8,
    batch_dtype=None,
) -> Dict[str, Struct]:
    """Structs of one [T+1, B] learner batch in the actor-pool schema,
    float leaves in the precision policy's staging dtype."""
    t1 = hp.unroll_length + 1
    b = hp.batch_size
    f32 = batch_dtype if batch_dtype is not None else torch.float32
    return {
        "frame": Struct((t1, b) + tuple(frame_shape), frame_dtype),
        "reward": Struct((t1, b), f32),
        "done": Struct((t1, b), torch.bool),
        "episode_return": Struct((t1, b), f32),
        "episode_step": Struct((t1, b), torch.int32),
        "last_action": Struct((t1, b), torch.int32),
        "action": Struct((t1, b), torch.int32),
        "policy_logits": Struct((t1, b, num_actions), f32),
        "baseline": Struct((t1, b), f32),
    }


# Memoized driver-resolution results: polybeast builds the model twice
# (learner + unmeshed acting twin) from identical flags, and an auto
# plan runs candidates — the second resolution must be free. Also
# the hook the drivers read for the `learner.remat_plan` static.
_RESOLVED: Dict[Tuple, PlanResult] = {}
_LAST: List[Optional[PlanResult]] = [None]


def last_plan() -> Optional[PlanResult]:
    """The most recent resolution in this process (driver startup is
    single-threaded; the drivers read this right after model init to
    log + export the `learner.remat_plan` static)."""
    return _LAST[0]


def resolve_from_flags(
    flags, hp, num_actions: int, frame_shape, frame_dtype,
    policy, build_model: Callable[[Dict[str, Any]], Any],
) -> PlanResult:
    """Driver entry: flags.remat -> the plan + model kwargs.

    - None (flag unset): the port's default, every lever at its
      no-remat setting but the transformer blocks per
      --transformer_remat (source="default"; no planning cost). The
      reference remats its trunk here (module docstring).
    - "all" / "none": every stage at its most-remat / no-remat setting.
    - "auto": plan_remat over the family lattice with the superstep
      cost oracle against --hbm_budget_gb (0 = the card's total memory,
      or the host's on the CPU: default_budget_bytes). Lazy first-fit
      walk in recompute-rank order: big budgets evaluate ONE candidate.
    - anything else: a per-stage spec (parse_spec).
    """
    model_name = flags.model
    use_lstm = bool(getattr(flags, "use_lstm", False))
    stages = stages_for(model_name, use_lstm)
    remat_flag = getattr(flags, "remat", None)
    transformer_remat = bool(getattr(flags, "transformer_remat", False))
    if remat_flag is not None and transformer_remat:
        raise ValueError(
            "--transformer_remat is the deprecated spelling of "
            "--remat all (blocks stage); pass only --remat"
        )
    budget_gb = float(getattr(flags, "hbm_budget_gb", 0.0) or 0.0)
    superstep_k = int(getattr(flags, "superstep_k", 1) or 1)
    # hp rides the key WHOLE (a hashable NamedTuple): optimizer-shape
    # knobs (momentum adds a params-sized trace, factored/bf16 state
    # change opt_state bytes) move the measured peak, so an auto plan
    # is only reusable for an identical learner configuration; so does
    # the device the oracle measures on.
    key = (
        remat_flag, transformer_remat, budget_gb, model_name, use_lstm,
        policy.name, superstep_k, hp,
        num_actions, tuple(frame_shape), str(frame_dtype),
        bool(getattr(flags, "disable_cuda", False)),
    )
    cached = _RESOLVED.get(key)
    if cached is not None:
        _LAST[0] = cached
        return cached

    if remat_flag is None:
        # The port's default keeps every activation, where the
        # reference's remats the trunk (ROADMAP.md Queue 3's known
        # differences); --transformer_remat still sets the blocks.
        assignment = no_remat(stages)
        if "blocks" in assignment:
            assignment["blocks"] = transformer_remat
        plan = PlanResult(
            assignment=assignment, source="default",
            budget_bytes=None, peak_bytes=None, recompute_bytes=None,
            table=(),
        )
    elif remat_flag == "all":
        plan = PlanResult(
            assignment=all_remat(stages), source="all",
            budget_bytes=None, peak_bytes=None, recompute_bytes=None,
            table=(),
        )
    elif remat_flag == "none":
        plan = PlanResult(
            assignment=no_remat(stages), source="none",
            budget_bytes=None, peak_bytes=None, recompute_bytes=None,
            table=(),
        )
    elif remat_flag == "auto":
        device = (torch.device("cpu")
                  if getattr(flags, "disable_cuda", False)
                  else torch.device("cuda", 0))
        budget = (
            budget_gb * (1 << 30) if budget_gb > 0
            else default_budget_bytes(device)
        )
        cost_fn = superstep_cost_fn(
            build_model, hp, superstep_k,
            learner_batch_structs(
                hp, num_actions, frame_shape, frame_dtype,
                policy.batch_dtype,
            ),
            hp.batch_size, model_name,
        )
        plan = plan_remat(stages, cost_fn, budget, lazy=True)
    else:
        plan = PlanResult(
            assignment=parse_spec(remat_flag, stages), source="spec",
            budget_bytes=None, peak_bytes=None, recompute_bytes=None,
            table=(),
        )
    _RESOLVED[key] = plan
    _LAST[0] = plan
    if plan.source == "fallback":
        log.warning(
            "remat auto-tuning: no candidate fits the %.2f GB budget; "
            "falling back to all-remat (%s)",
            (plan.budget_bytes or 0) / (1 << 30),
            spell(plan.assignment),
        )
    elif remat_flag is not None:
        log.info(
            "remat plan (%s): %s", plan.source,
            spell(plan.assignment) or "<no remat-able stages>",
        )
    if plan.table:
        # The evaluation table is logged ONCE here; the telemetry
        # static carries only the compact summary (see summary()).
        log.info("remat plan candidates: %s", list(plan.table))
    return plan
