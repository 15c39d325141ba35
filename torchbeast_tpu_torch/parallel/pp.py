"""Pipeline parallelism over a `pipe` mesh axis (counterpart of
torchbeast_tpu/parallel/pp.py).

The reference runs a uniform tower of S stages as a GPipe schedule inside
one shard_map: the batch is cut into M microbatches, and at tick t stage
s processes microbatch t - s and hands its activations to stage s + 1 by
ppermute, S + M - 1 ticks in all; the bubbles compute on zeros that are
masked out, so autodiff through the scan gives the sequential gradients.

The port runs the same schedule from the host, in a fixed order: ticks
t = 0..S+M-2, and within a tick the active stages from the last to the
first (so stage s + 1 takes what stage s handed it at the tick before).
Stage s runs on pipe device s: its slice of each stacked `[S, ...]`
parameter leaf, which stays whole on the row's device, is copied there
once a call inside the forward (autograd carries the gradient back), and
activations move to the next stage's device with `.to()`. Bubbles
compute nothing. `stage_carry` (a layer's KV cache) is split into its
microbatches on its stage's device and stays there until the call
returns; `shared` inputs (masks, segment ids) are sliced per microbatch
and copied to the stage that reads them. On one device the result is the
sequential tower applied one microbatch at a time.

`batch_axis` names a data axis of the same mesh: each microbatch's rows
split over this process's data rows, and data row r runs its own GPipe
over its pipe devices (the reference's one GPipe per data group). The
learner's replicas (parallel/dp.py) each hold their row's mesh
(Mesh.row) and call without it.

A model holds its pipeline in four attributes, the reference's model
fields (set_pipeline): `mesh` (None: the sequential tower), `pipe_axis`,
`n_microbatches` (None: one per pipe device) and `batch_axis`.
"""

from typing import Any, Callable, Optional

import torch

from torchbeast_tpu_torch.parallel.ep import _flat, _map

_KEEP = object()


def default_n_microbatches(mesh, axis: str = "pipe",
                           n_microbatches: Optional[int] = None) -> int:
    """The microbatch count pipeline_apply will use: n_microbatches, or
    one per device of `axis`."""
    return (n_microbatches if n_microbatches is not None
            else mesh.shape[axis])


def can_pipeline(mesh, batch_rows: int, axis: str = "pipe",
                 n_microbatches: Optional[int] = None,
                 batch_axis: Optional[str] = None) -> bool:
    """Whether pipeline_apply accepts `batch_rows`: the rows divide into
    the microbatches and, with `batch_axis`, each microbatch's rows over
    that axis. The models' sequential fallback and the drivers' checks
    share it."""
    M = default_n_microbatches(mesh, axis, n_microbatches)
    if batch_rows % M != 0:
        return False
    if batch_axis is not None and (
            (batch_rows // M) % mesh.shape[batch_axis] != 0):
        return False
    return True


def stack_stages(per_stage_trees):
    """Stack a list of per-stage trees (dicts, lists or tuples of
    tensors) along a new leading stage axis."""
    first = per_stage_trees[0]
    leaves = [dict(_flat(t)) for t in per_stage_trees]
    return _map(lambda path, _: torch.stack([t[path] for t in leaves]),
                first)


def stage_param_shardings(mesh, stage_params: Any, axis: str = "pipe"):
    """One spec a leaf: the leading stage axis over `axis` (the
    reference's P("pipe"))."""
    return _map(lambda path, _: (axis,), stage_params)


def _leaves(tree):
    return [] if tree is None else [leaf for _, leaf in _flat(tree)]


def _check_leading(tree, what, S, axis):
    """The reference's leading-dim check, its leaves in its order (dict
    keys sorted, as jax flattens them)."""
    leaves = [] if tree is None else sorted(
        _flat(tree), key=lambda item: tuple(
            (isinstance(p, str), p) for p in item[0]))
    for path, leaf in leaves:
        if leaf.shape[0] != S:
            path_s = "".join(f"[{p!r}]" for p in path)
            raise ValueError(
                f"{what} leaf {path_s} has "
                f"leading dim {leaf.shape[0]}; the pipeline needs "
                f"exactly one stage per device on `{axis}` (= {S})"
            )


def _gpipe(stage_fn, params, xs, carries, shareds, devices):
    """The schedule over one row's devices. params[s]: stage s's params
    on devices[s]; xs[j]: microbatch j's input; carries[s][j]: stage s's
    carry of microbatch j on devices[s] (None without); shareds[j]: the
    shared inputs of microbatch j (None without). Returns (the last
    stage's outputs, in microbatch order, on xs' device; the new carries
    [s][j])."""
    S, M = len(devices), len(xs)
    home = xs[0].device
    outs = [None] * M
    new = [[None] * M for _ in range(S)]
    inbox = [None] * S
    for t in range(S + M - 1):
        for s in reversed(range(S)):
            j = t - s
            if not 0 <= j < M:
                continue
            dev = devices[s]
            inp = (xs[j] if s == 0 else inbox[s]).to(dev)
            shared = (None if shareds[j] is None
                      else _map(lambda _, v: v.to(dev), shareds[j]))
            out, new[s][j] = stage_fn(params[s], inp, carries[s][j], shared)
            if s == S - 1:
                outs[j] = out.to(home)
            else:
                inbox[s + 1] = out
    return outs, new


def _at(tree, index):
    return None if tree is None else _map(lambda _, v: v[index], tree)


def pipeline_apply(
    stage_fn: Callable,
    stage_params: Any,
    x: torch.Tensor,
    *,
    mesh,
    axis: str = "pipe",
    n_microbatches: Optional[int] = None,
    stage_carry: Any = None,
    shared: Any = None,
    batch_axis: Optional[str] = None,
):
    """Run a uniform tower of S stages as a pipeline over `axis`.

    stage_fn: (params, x_mb, carry_mb, shared_mb) -> (y_mb, new_carry_mb)
    applied per microbatch, y_mb of x_mb's shape. stage_params: a tree,
    every leaf [S, ...] (stage s's params at index s). x: [B, ...]
    entering stage 0. n_microbatches: M, default S; B % M == 0.
    stage_carry: a tree of [S, B, ...] leaves, per-stage per-example state
    resident on its stage. shared: a tree of [B, ...] leaves every stage
    reads for its microbatch. batch_axis: a data axis of `mesh` (module
    docstring); B/M must divide by it.

    Returns (y [B, ...] from the last stage on x's device, the new
    stage_carry [S, B, ...] on x's device, or None without one), with the
    reference's ValueErrors for a batch the microbatches or the data
    axis do not divide and for a leading dim other than S."""
    S = mesh.shape[axis]
    B = x.shape[0]
    M = default_n_microbatches(mesh, axis, n_microbatches)
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by n_microbatches={M}")
    if batch_axis is not None and (B // M) % mesh.shape[batch_axis] != 0:
        raise ValueError(
            f"microbatch rows {B // M} not divisible by the "
            f"`{batch_axis}` axis size {mesh.shape[batch_axis]}"
        )
    _check_leading(stage_params, "stage_params", S, axis)
    _check_leading(stage_carry, "stage_carry", S, axis)
    home = x.device
    rows = mesh.grid.shape[0] if batch_axis is not None else 1
    mb = B // M
    part = mb // rows
    outs = [[None] * rows for _ in range(M)]
    carry_parts = [[[None] * rows for _ in range(M)] for _ in range(S)]
    for r in range(rows):
        devices = mesh.pipe_devices(r)
        params = [_map(lambda _, v, s=s, d=d: v[s].to(d), stage_params)
                  for s, d in enumerate(devices)]

        def rows_of(j, r=r):
            return slice(j * mb + r * part, j * mb + (r + 1) * part)

        xs = [x[rows_of(j)] for j in range(M)]
        shareds = [_at(shared, rows_of(j)) for j in range(M)]
        carries = [[None if stage_carry is None else _map(
            lambda _, v, s=s, j=j, d=d: v[s, rows_of(j)].to(d),
            stage_carry) for j in range(M)]
            for s, d in enumerate(devices)]
        y, new = _gpipe(stage_fn, params, xs, carries, shareds, devices)
        for j in range(M):
            outs[j][r] = y[j]
            for s in range(S):
                carry_parts[s][j][r] = new[s][j]
    y = torch.cat([o for per_mb in outs for o in per_mb])
    if stage_carry is None:
        return y, None
    per_stage = []
    for s in range(S):
        pieces = [p for per_mb in carry_parts[s] for p in per_mb]
        flats = [dict(_flat(p)) for p in pieces]
        per_stage.append(_map(lambda path, _: torch.cat(
            [f[path].to(home) for f in flats]), pieces[0]))
    return y, stack_stages(per_stage)


def pipeline_apply_multi(
    stage_fn: Callable,
    stage_params: Any,
    x: torch.Tensor,
    *,
    mesh,
    axis: str = "pipe",
    n_microbatches: Optional[int] = None,
    stage_carry: Any = None,
    shared: Any = None,
    batch_axis: Optional[str] = None,
):
    """S = k * P stages over the P devices of `axis` as k passes of the
    P-stage schedule (device d runs global stages j * P + d, j = 0..k-1),
    each pass with its own fill and drain. The `[S, ...]` layout of
    pipeline_apply; S == P is pipeline_apply itself."""
    S_total = _leaves(stage_params)[0].shape[0]
    P_devices = mesh.shape[axis]
    kwargs = dict(mesh=mesh, axis=axis, n_microbatches=n_microbatches,
                  shared=shared, batch_axis=batch_axis)
    if S_total == P_devices:
        return pipeline_apply(stage_fn, stage_params, x,
                              stage_carry=stage_carry, **kwargs)
    if S_total % P_devices != 0:
        raise ValueError(
            f"{S_total} stages not divisible by the `{axis}` axis size "
            f"{P_devices}"
        )
    k = S_total // P_devices

    def pass_slice(tree, j):
        return _map(lambda _, v: v.reshape((k, P_devices) + v.shape[1:])[j],
                    tree)

    new_carries = []
    for j in range(k):
        carry_j = None if stage_carry is None else pass_slice(stage_carry,
                                                              j)
        x, new_c = pipeline_apply(stage_fn, pass_slice(stage_params, j), x,
                                  stage_carry=carry_j, **kwargs)
        new_carries.append(new_c)
    if stage_carry is None:
        return x, None
    flats = [dict(_flat(c)) for c in new_carries]
    return x, _map(lambda path, _: torch.cat([f[path] for f in flats]),
                   new_carries[0])


def set_pipeline(model, mesh, n_microbatches=_KEEP,
                 batch_axis: Optional[str] = None,
                 axis: str = "pipe") -> None:
    """Run `model`'s stage tower as a pipeline over `mesh` (None: the
    sequential tower), the reference's model fields: `n_microbatches`
    (None: one per pipe device; left as it is when not given) and
    `batch_axis`. Raises the reference's ValueError when the tower's
    depth is not a multiple of the axis size."""
    if not hasattr(model, "check_pipe_axis"):
        raise ValueError(
            f"{type(model).__name__} has no stage tower to pipeline")
    model.mesh = mesh
    model.pipe_axis = axis
    model.batch_axis = batch_axis
    if n_microbatches is not _KEEP:
        model.n_microbatches = n_microbatches
    if mesh is not None:
        model.check_pipe_axis()
