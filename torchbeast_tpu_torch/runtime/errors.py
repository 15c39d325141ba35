"""Runtime error types shared across jax-free and jax-bound modules.

`StateTablePoisonedError` is raised by the (jax-heavy) DeviceStateTable
but must be CAUGHT by the actor pool and the inference supervisor —
both importable without jax. Defining it here keeps the catch sites
free of a module-level jax import; `runtime.state_table` re-exports it
as the canonical public name.

The port's copy of torchbeast_tpu/runtime/errors.py.
"""


class StateTablePoisonedError(RuntimeError):
    """A table-mutating dispatch failed after its buffer was donated:
    the table may be consumed and must not serve another request. The
    inference supervisor (resilience/supervisor.py) catches exactly
    this type to rebuild the table and restart the serving thread, and
    the actor pool treats it as a budgeted rollout retry (the rebuild
    is in flight); anything else that escapes a serving loop is a real
    bug and stays fatal."""


class ShedError(RuntimeError):
    """The typed shed reply: the admission gate refused this
    inference request — either at enqueue (bounded queue depth, the
    serving tier is over capacity) or at dequeue (the request sat in
    the queue past its --request_deadline_ms budget and serving it
    would only return an answer nobody can use in time).

    A shed is FLOW CONTROL, never a failure: the actor pool catches
    exactly this type in its request path and re-submits the SAME env
    step after a jittered backoff, so a shed can never retire an actor
    or lose a rollout (the C++ pool carries the same contract in
    csrc/actor_pool.h; `_tbt_core.ShedError` subclasses this class).
    `expired` distinguishes the dequeue-side deadline expiry from the
    enqueue-side depth rejection."""

    def __init__(self, message: str, expired: bool = False):
        super().__init__(message)
        self.expired = expired
