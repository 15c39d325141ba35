"""Admission control + deadline-aware load shedding (the port's copy
of torchbeast_tpu/serving/admission.py).

The central inference path had no overload story: a slow learner chip
or an actor burst grew the DynamicBatcher's queue without bound and
stalled every connection equally. The AdmissionController bounds it
with two gates, both returning the typed ShedError the actor retry
path re-submits (runtime/errors.py):

- enqueue gate (`admit`): reject a request outright while the queue
  already holds `max_queue_depth` pending requests — serving tail
  latency is already blown, so queueing deeper only converts overload
  into an unbounded stall. Counted as `serving.shed`.
- dequeue gate (`split_expired`): a request that sat in the queue past
  its deadline (`deadline_ms` from enqueue) is failed instead of
  served — its reply would arrive after the actor's patience budget
  and the env step will be re-submitted anyway. Counted as
  `serving.expired`.

`serving.admitted` counts requests ACCEPTED AT ENQUEUE (so requests
served = admitted - expired: an admitted request may still expire in
the queue); the actor-side twin counter `serving.resubmitted`
(runtime/actor_pool.py) increments once per ShedError received, so

    serving.resubmitted == serving.shed + serving.expired

holds exactly at any quiescent point — the invariant the chaos harness
asserts to prove a shed is never a lost rollout.

The queue-delay histogram (`serving.queue_delay_s`) is observed for
every dequeued request (served or expired) and feeds the p99-vs-SLO
gauges: `serving.queue_delay_p99_s` and `serving.slo_ratio`
(p99 / deadline — > 1.0 means the tier is breaching its own SLO even
for the requests it serves).

Time base is time.perf_counter() (the same clock the batcher's
request_wait_s series uses), carried as an ABSOLUTE deadline in the
request payload so clock reads happen once per request per side.
"""

import time
from typing import List, Optional, Tuple

from torchbeast_tpu_torch import telemetry
from torchbeast_tpu_torch.runtime.errors import ShedError


class AdmissionController:
    """The admission gate a DynamicBatcher consults when armed.

    `deadline_ms` <= 0 disables the dequeue-side expiry; a None
    `max_queue_depth` disables the enqueue-side depth gate. (Both off
    is legal but pointless — the driver only arms the controller when
    --request_deadline_ms is set.)

    Thread-safety: `admit` runs on every producer (actor) thread and
    `split_expired` on the consumer threads; all state lives in the
    sharded telemetry instruments, so there is no lock here.
    """

    def __init__(
        self,
        deadline_ms: float = 0.0,
        max_queue_depth: Optional[int] = None,
        registry=None,
        name: str = "serving",
        p99_update_every: int = 32,
    ):
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}"
            )
        self.deadline_s = (
            deadline_ms / 1000.0 if deadline_ms and deadline_ms > 0 else None
        )
        self.max_queue_depth = max_queue_depth
        reg = registry if registry is not None else telemetry.get_registry()
        self._c_admitted = reg.counter(f"{name}.admitted")
        self._c_shed = reg.counter(f"{name}.shed")
        self._c_expired = reg.counter(f"{name}.expired")
        self._h_delay = reg.histogram(f"{name}.queue_delay_s")
        self._g_p99 = reg.gauge(f"{name}.queue_delay_p99_s")
        self._g_slo = reg.gauge(f"{name}.slo_ratio")
        # p99 reconstruction merges the histogram's per-thread shards —
        # cheap, but not per-request cheap; refresh every N delays.
        self._p99_every = max(1, p99_update_every)
        self._delay_tick = 0

    def admit(self, queue_depth: int) -> Optional[float]:
        """Gate one enqueue. Returns the request's absolute deadline
        (perf_counter seconds; None when expiry is disarmed) or raises
        ShedError when the queue is at the depth bound."""
        if (
            self.max_queue_depth is not None
            and queue_depth >= self.max_queue_depth
        ):
            self._c_shed.inc()
            raise ShedError(
                f"admission gate: {queue_depth} requests already queued "
                f"(bound {self.max_queue_depth}); re-submit after backoff"
            )
        self._c_admitted.inc()
        if self.deadline_s is None:
            return None
        return time.perf_counter() + self.deadline_s

    def split_expired(
        self, deadlines: List[Optional[float]], enqueued_at: List[float]
    ) -> Tuple[List[int], List[int]]:
        """Partition a dequeued batch's request indices into (live,
        expired) by their absolute deadlines; observes every request's
        queue delay and refreshes the p99/SLO gauges. Called by the
        batcher consumer with parallel payload fields."""
        now = time.perf_counter()
        live, expired = [], []
        for i, deadline in enumerate(deadlines):
            self._h_delay.observe(now - enqueued_at[i])
            if deadline is not None and now > deadline:
                expired.append(i)
            else:
                live.append(i)
        if expired:
            self._c_expired.inc(len(expired))
        self._delay_tick += 1
        # Strictly every-N: refreshing on every expiry would defeat the
        # throttle exactly during overload, when the consumer thread is
        # the bottleneck and every batch carries expired requests.
        if self._delay_tick % self._p99_every == 0:
            self.refresh_gauges()
        return live, expired

    def refresh_gauges(self) -> None:
        p99 = self._h_delay.percentile(0.99)
        self._g_p99.set(p99)
        if self.deadline_s:
            self._g_slo.set(p99 / self.deadline_s)

    @staticmethod
    def expired_error() -> ShedError:
        return ShedError(
            "deadline expired in queue: the reply would land past the "
            "request's --request_deadline_ms budget; re-submit after "
            "backoff",
            expired=True,
        )

    def counts(self) -> dict:
        """Cumulative gate accounting (the chaos harness's audit view)."""
        return {
            "admitted": int(self._c_admitted.value()),
            "shed": int(self._c_shed.value()),
            "expired": int(self._c_expired.value()),
        }
