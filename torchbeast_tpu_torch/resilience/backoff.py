"""Exponential backoff with decorrelated jitter and an optional deadline.

The repo had two retry loops and both were wrong in the same way: an
actor whose env server died re-dialed the dead address as fast as
`connect_transport` would fail (a tight loop against a refused socket),
and the env-server supervisor respawned a crash-looping child every
poll tick. Worse, a mass server restart woke every actor at once — a
thundering herd against the fresh listener. Decorrelated jitter
(`sleep = uniform(base, prev * 3)`, capped) spreads the herd and grows
the idle period geometrically, while the deadline turns "retry forever"
into a bounded budget that surfaces as a typed error.

Stdlib-only and side-effect-free except for `time.sleep`, so every
retry loop in runtime/ and polybeast_env can adopt it without new deps.

The port's copy of torchbeast_tpu/resilience/backoff.py.
"""

import random
import threading
import time
from typing import Optional


class BackoffDeadline(TimeoutError):
    """Raised by `Backoff.sleep()` once the total-elapsed deadline has
    passed: the caller's retry budget is exhausted."""


class Backoff:
    """Decorrelated-jitter exponential backoff.

    next_delay() draws `uniform(base_s, prev * 3)` clamped to
    [base_s, cap_s] — the AWS "decorrelated jitter" variant, which both
    spreads synchronized retriers apart and keeps the expected delay
    growing geometrically. `reset()` re-arms after proven recovery (the
    actor pool resets once a full unroll has streamed, mirroring its
    reconnect-budget refill).

    `deadline_s` bounds TOTAL time spent sleeping + waiting since the
    first `sleep()` after construction/reset; exceeding it raises
    BackoffDeadline instead of sleeping again.

    `rng`: pass a seeded `random.Random` for deterministic schedules
    (chaos harness / tests); default draws fresh entropy.
    """

    def __init__(
        self,
        base_s: float = 0.1,
        cap_s: float = 5.0,
        deadline_s: Optional[float] = None,
        rng: Optional[random.Random] = None,
    ):
        if base_s <= 0:
            raise ValueError(f"base_s must be > 0, got {base_s}")
        if cap_s < base_s:
            raise ValueError(
                f"cap_s {cap_s} must be >= base_s {base_s}"
            )
        self.base_s = base_s
        self.cap_s = cap_s
        self.deadline_s = deadline_s
        self._rng = rng if rng is not None else random.Random()
        self._prev = 0.0
        self._started = None  # first sleep() since reset
        self.attempts = 0

    def next_delay(self) -> float:
        """The next jittered delay (advances the schedule, no sleeping)."""
        hi = max(self.base_s, min(self.cap_s, self._prev * 3.0))
        delay = self._rng.uniform(self.base_s, hi)
        self._prev = delay
        self.attempts += 1
        return delay

    def sleep(self, wake: Optional[threading.Event] = None) -> float:
        """Sleep the next jittered delay; returns the delay slept.

        `wake`: an optional Event that cuts the sleep short (pipeline
        shutdown must not wait out a backoff). Raises BackoffDeadline
        when the cumulative elapsed time since the first sleep (after
        construction or reset()) exceeds deadline_s.
        """
        now = time.monotonic()
        if self._started is None:
            self._started = now
        if (
            self.deadline_s is not None
            and now - self._started > self.deadline_s
        ):
            raise BackoffDeadline(
                f"backoff deadline of {self.deadline_s}s exceeded after "
                f"{self.attempts} attempts"
            )
        delay = self.next_delay()
        if wake is not None:
            wake.wait(delay)
        else:
            time.sleep(delay)
        return delay

    def reset(self) -> None:
        """Re-arm after proven recovery: the next delay starts from
        base_s again and the deadline window restarts."""
        self._prev = 0.0
        self._started = None
        self.attempts = 0
