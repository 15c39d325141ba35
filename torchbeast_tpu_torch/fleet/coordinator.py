"""Fleet coordinator: rendezvous, health plane, snapshots, param sync
(counterpart of torchbeast_tpu/fleet/coordinator.py).

One `FleetCoordinator` per host composes the fleet out of the per-host
pieces:

- **Rendezvous.** `fleet_rendezvous` joins the hosts' torch.distributed
  process group (the strategy the reference calls "xla", whose name the
  port keeps: on CUDA, NCCL runs the learner's collectives across
  hosts) under a bounded-retry `resilience.Backoff`: hosts boot in any
  order, a failed join is a reason to back off and redial, and the
  deadline turns "retry forever" into a typed error. The "wire"
  strategy (the CPU) joins no process group; the coordinator's own
  control plane then carries the parameter composition too
  (`sync_params`). parallel/dp.fleet_strategy picks one from the device.

- **Control plane.** The lead (rank 0) listens one port above the
  rendezvous port (`FleetSpec.control_address`); remotes dial it with
  `dial_transport` (Backoff inside). Framed wire messages (runtime/
  wire.py) over `SocketTransport`s: heartbeats, health verdicts, policy
  snapshots (TAG_SNAPSHOT), parameter-sync rounds, the reference's
  messages key for key, so a reference host and a port host form one
  fleet. Transports are single-threaded per connection by design, so
  each connection gets a reader thread and a send lock.

- **Health plane.** Remote heartbeats carry the host's PipelineHealth
  state and its recovery counters; the lead folds them into one fleet
  verdict through its own PipelineHealth: any remote incident (a
  non-HEALTHY state, or env-server restarts / actor reconnects) becomes
  a sticky `fleet.host<r>` degradation on the lead. A host loss (its
  control connection dies) degrades, sticky `fleet.host<r>_lost`, while
  live hosts >= --min_live_hosts, and halts the whole fleet once the
  floor is crossed: the lead's monitor loop checkpoints and exits, and
  the broadcast verdict makes every surviving remote do the same.
  Remotes losing the lead halt at once (the lead owns checkpoints). A
  clean shutdown ("bye") is not a loss.

- **Snapshot plane.** `publish_snapshot` broadcasts the lead's
  versioned bf16 policy snapshot (fleet/snapshot_wire.py) to every
  remote; each remote's reader applies it into its attached
  `PolicySnapshotStore`, stale versions rejected and counted.

- **Parameter composition (wire strategy only).** `sync_params` runs a
  synchronous averaging round per learner dispatch: every host posts
  its freshly updated param leaves, the lead averages float leaves in
  f32 and broadcasts the mean, everyone adopts it. From equal params,
  averaging post-update params is gradient averaging for an SGD step;
  under RMSprop it is the reference's documented approximation (each
  host's second-moment state stays local). Timeouts degrade, never
  deadlock: the lead proceeds with whoever posted, a remote that misses
  the mean keeps its own params for a round.

The params of the port are lists aligned with a model's parameters();
the messages carry them as the reference's flat leaves
(snapshot_wire.param_leaves), so `publish_snapshot` and `sync_params`
take the model as their template.
"""

import logging
import socket
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from torchbeast_tpu_torch import telemetry
from torchbeast_tpu_torch.fleet import snapshot_wire
from torchbeast_tpu_torch.fleet.topology import FleetSpec
from torchbeast_tpu_torch.resilience import Backoff, BackoffDeadline
from torchbeast_tpu_torch.resilience.supervisor import HEALTHY, STATE_NAMES
from torchbeast_tpu_torch.runtime import transport as transport_mod
from torchbeast_tpu_torch.runtime import wire

log = logging.getLogger(__name__)

# Control-plane handshake / per-attempt dial timeouts. Rendezvous-scale
# patience lives in the caller-visible deadlines, not here.
_HELLO_TIMEOUT_S = 30.0
_DIAL_ATTEMPT_S = 2.0


def fleet_rendezvous(
    fleet: FleetSpec,
    strategy: str,
    deadline_s: float = 120.0,
    rng=None,
    _initialize=None,
    backend: Optional[str] = None,
) -> None:
    """Join the fleet's torch.distributed process group (the "xla"
    strategy) under a bounded-retry Backoff: world size the host count,
    rank the host rank, the rendezvous at the fleet's coord address, in
    `backend` (parallel.dp.initialize_distributed's default without
    one). A no-op for the wire strategy, which joins no group.

    `_initialize` is the test seam (default dp.initialize_distributed,
    called as (address, hosts, rank, backend=...)).
    """
    if strategy != "xla":
        log.info(
            "Fleet rendezvous: wire strategy — composing %d hosts over "
            "the control plane, no process group.",
            fleet.num_hosts,
        )
        return
    if _initialize is None:
        from torchbeast_tpu_torch.parallel import dp

        _initialize = dp.initialize_distributed
    backoff = Backoff(base_s=0.5, cap_s=5.0, deadline_s=deadline_s, rng=rng)
    while True:
        try:
            _initialize(
                fleet.coord_address, fleet.num_hosts, fleet.host_rank,
                backend=backend,
            )
            log.info(
                "Fleet rendezvous complete: host %d/%d via %s",
                fleet.host_rank, fleet.num_hosts, fleet.coord_address,
            )
            return
        except Exception as e:  # noqa: BLE001 — redial whatever failed
            try:
                backoff.sleep()
            except BackoffDeadline:
                raise RuntimeError(
                    f"fleet rendezvous at {fleet.coord_address} failed "
                    f"after {backoff.attempts} attempts over "
                    f"{deadline_s}s: {e}"
                ) from e
            log.warning(
                "Fleet rendezvous attempt %d failed (%s); redialing",
                backoff.attempts, e,
            )


class FleetCoordinator:
    """The per-host fleet control plane (see module docstring).

    Lifecycle: construct, `start()` (blocks until the control plane is
    connected fleet-wide), attach stores/sources, run, `shutdown()`.
    Lock order: `self._lock` (never held across a send or a wait on
    another lock) > per-connection send locks (leaf — nothing is
    acquired under them).
    """

    def __init__(
        self,
        fleet: FleetSpec,
        health,
        strategy: str,
        min_live_hosts: int = 1,
        heartbeat_s: float = 1.0,
        connect_timeout_s: float = 60.0,
        sync_timeout_s: float = 30.0,
        registry=None,
    ):
        if not 1 <= min_live_hosts <= fleet.num_hosts:
            raise ValueError(
                f"--min_live_hosts {min_live_hosts} outside "
                f"[1, {fleet.num_hosts}]"
            )
        self.fleet = fleet
        self.strategy = strategy
        self.min_live_hosts = min_live_hosts
        self.heartbeat_s = heartbeat_s
        self.connect_timeout_s = connect_timeout_s
        self.sync_timeout_s = sync_timeout_s
        self._health = health
        reg = registry if registry is not None else telemetry.get_registry()
        self._g_live = reg.gauge("fleet.live_hosts")
        self._c_hb_rx = reg.counter("fleet.heartbeats_received")
        self._c_hb_tx = reg.counter("fleet.heartbeats_sent")
        self._c_snap_tx = reg.counter("fleet.snapshots_sent")
        self._c_snap_bytes_tx = reg.counter("fleet.snapshot_bytes_sent")
        self._c_snap_rx = reg.counter("fleet.snapshots_received")
        self._c_snap_stale = reg.counter("fleet.snapshots_stale_dropped")
        self._c_syncs = reg.counter("fleet.param_syncs")
        self._c_sync_timeouts = reg.counter("fleet.param_sync_timeouts")
        # Hosts whose params the last fleet mean averaged (the lead
        # packs it as "n"; a degraded round shows up as n < fleet).
        self._g_sync_contribs = reg.gauge("fleet.param_sync_contribs")
        # Control-plane messages whose type no dispatch arm knows —
        # nonzero means a version-skewed peer, not just a log line.
        self._c_unknown = reg.counter("fleet.unknown_msgs")
        self._reg = reg

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closing = threading.Event()
        # Lead: rank -> transport / send lock. Remote: {0: lead}.
        self._conns: Dict[int, Any] = {}  # guarded-by: self._lock
        self._send_locks: Dict[int, threading.Lock] = {}  # guarded-by: self._lock
        self._host_states: Dict[int, int] = {
            fleet.host_rank: HEALTHY
        }  # guarded-by: self._lock
        self._remote_gauges: Dict[int, Dict[str, float]] = {}  # guarded-by: self._lock
        self._remote_stats: Dict[int, Dict[str, int]] = {}  # guarded-by: self._lock
        self._lost: set = set()  # guarded-by: self._lock
        self._done: set = set()  # ranks finished cleanly  # guarded-by: self._lock
        self._folded: set = set()  # incident already folded  # guarded-by: self._lock
        # Param-sync rendezvous state. Lead: newest unconsumed leaves
        # per rank; remote: the newest mean from the lead.
        self._pending: Dict[int, list] = {}  # guarded-by: self._lock
        self._mean_seq = 0  # guarded-by: self._lock
        self._mean_leaves = None  # guarded-by: self._lock
        self._applied_seq = 0  # guarded-by: self._lock
        self._lead_gone = False  # guarded-by: self._lock

        # Remote-side snapshot sink (attach_snapshot_store).
        self._store = None  # guarded-by: self._lock
        self._template = None  # guarded-by: self._lock
        # Heartbeat payload sources (driver-provided closures).
        self._stats_fn: Callable[[], Dict[str, int]] = lambda: {}  # guarded-by: self._lock
        self._gauges_fn: Callable[[], Dict[str, float]] = lambda: {}  # guarded-by: self._lock

        self._server_sock: Optional[socket.socket] = None
        self._threads: list = []

    # -- wiring ------------------------------------------------------------
    def attach_snapshot_store(self, store, template: Any) -> None:
        """Remote side: where wire-delivered snapshots land, plus the
        host's model, whose parameters they rebuild into."""
        with self._lock:
            self._store = store
            self._template = template

    def set_stats_source(self, fn: Callable[[], Dict[str, int]]) -> None:
        """Heartbeat recovery counters: a closure returning
        {"updates", "restarts", "reconnects"} cumulative ints."""
        with self._lock:
            self._stats_fn = fn

    def set_gauges_source(self, fn: Callable[[], Dict[str, float]]) -> None:
        """Heartbeat gauge snapshot: a closure returning {name: value}
        (the per-slice inference gauges — parallel.sebulba
        .slice_gauge_snapshot)."""
        with self._lock:
            self._gauges_fn = fn

    # -- startup -----------------------------------------------------------
    def start(self) -> None:
        """Connect the control plane (lead: accept num_hosts-1 hellos;
        remote: dial the lead under Backoff) and start the reader and
        heartbeat threads. Blocks until connected or raises."""
        if self.fleet.is_lead:
            self._start_lead()
        else:
            self._start_remote()
        self._g_live.set(self.live_hosts())
        t = threading.Thread(
            target=self._tick_loop, daemon=True, name="fleet-tick"
        )
        t.start()
        self._threads.append(t)

    def _start_lead(self) -> None:
        family, target = transport_mod.parse_address(
            self.fleet.control_address
        )
        srv = socket.socket(family, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(target)
        srv.listen(self.fleet.num_hosts)
        self._server_sock = srv
        deadline = time.monotonic() + self.connect_timeout_s
        expected = self.fleet.num_hosts - 1
        while True:
            with self._lock:
                if len(self._conns) >= expected:
                    break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                with self._lock:
                    have = sorted(self._conns)
                raise TimeoutError(
                    f"fleet control plane: {len(have)}/{expected} remote "
                    f"hosts connected within {self.connect_timeout_s}s "
                    f"(have ranks {have})"
                )
            srv.settimeout(max(0.1, remaining))
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            try:
                conn.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            except OSError:
                pass
            conn.settimeout(_HELLO_TIMEOUT_S)
            t = transport_mod.SocketTransport(conn)
            try:
                hello = t.recv()
            except (OSError, wire.WireError) as e:
                log.warning("fleet hello failed: %s", e)
                t.close()
                continue
            if (
                not isinstance(hello, dict)
                or hello.get("type") != "hello"
                or not 0 < int(hello.get("rank", -1)) < self.fleet.num_hosts
            ):
                log.warning("fleet: bad hello %r; dropping", hello)
                t.close()
                continue
            rank = int(hello["rank"])
            # Reader sockets idle for unbounded stretches between
            # control messages; a per-recv deadline would fault
            # idle-but-healthy hosts.
            # unbounded-by-design: loss detection is reader-EOF plus the heartbeat plane, not a recv deadline
            conn.settimeout(None)
            with self._lock:
                if rank in self._conns:
                    dup = True
                else:
                    dup = False
                    self._conns[rank] = t
                    self._send_locks[rank] = threading.Lock()
                    self._host_states[rank] = int(
                        hello.get("state", HEALTHY)
                    )
            if dup:
                log.warning("fleet: duplicate hello from rank %d", rank)
                t.close()
                continue
            log.info("fleet: host %d connected", rank)
            rt = threading.Thread(
                target=self._reader, args=(rank, t), daemon=True,
                name=f"fleet-reader-{rank}",
            )
            rt.start()
            self._threads.append(rt)

    def _start_remote(self) -> None:
        # Jittered-backoff dial (transport.dial_transport): remote
        # hosts may start seconds apart, and the lead's accept loop
        # must not face a lockstep thundering herd.
        try:
            t = transport_mod.dial_transport(
                self.fleet.control_address,
                deadline_s=self.connect_timeout_s,
                attempt_timeout_s=_DIAL_ATTEMPT_S,
            )
        except TimeoutError as e:
            raise TimeoutError(
                "fleet control plane: could not reach lead at "
                f"{self.fleet.control_address} within "
                f"{self.connect_timeout_s}s: {e}"
            ) from e
        with self._lock:
            self._conns[0] = t
            self._send_locks[0] = threading.Lock()
        self._send(0, {
            "type": "hello",
            "rank": self.fleet.host_rank,
            "state": int(self._health.state),
        })
        rt = threading.Thread(
            target=self._reader, args=(0, t), daemon=True,
            name="fleet-reader-lead",
        )
        rt.start()
        self._threads.append(rt)

    # -- sending -----------------------------------------------------------
    def _send(self, rank: int, msg: Any) -> bool:
        """Send under the connection's lock; False (never a raise) when
        the connection is gone — loss accounting belongs to the reader."""
        with self._lock:
            t = self._conns.get(rank)
            sl = self._send_locks.get(rank)
        if t is None or sl is None:
            return False
        try:
            with sl:
                t.send(msg)
            return True
        except (OSError, wire.WireError) as e:
            log.debug("fleet send to host %d failed: %s", rank, e)
            return False

    def _broadcast(self, msg: Any) -> int:
        with self._lock:
            ranks = list(self._conns)
        return sum(1 for r in ranks if self._send(r, msg))

    # -- readers -----------------------------------------------------------
    def _reader(self, rank: int, t) -> None:
        clean = False
        why = "connection closed"
        try:
            while not self._closing.is_set():
                # unbounded-by-design: this blocking recv IS the loss detector — EOF/error here drives _on_host_lost/_on_lead_lost
                msg = t.recv()
                if msg is None:
                    break  # EOF at a frame boundary
                if isinstance(msg, dict) and msg.get("type") == "bye":
                    clean = True
                    break
                self._handle(rank, msg)
        except (OSError, ConnectionError, wire.WireError) as e:
            why = str(e) or type(e).__name__
        if self._closing.is_set() or clean:
            with self._lock:
                self._done.add(rank)
                if not self.fleet.is_lead and rank == 0:
                    # A clean lead departure (its run finished) is not a
                    # fault — health stays untouched — but no more means
                    # or snapshots will come, so sync rounds must stop
                    # waiting instead of burning sync_timeout_s each.
                    self._lead_gone = True
                self._cv.notify_all()
            if clean:
                log.info("fleet: host %d finished cleanly", rank)
            return
        if self.fleet.is_lead:
            self._on_host_lost(rank, why)
        else:
            self._on_lead_lost(why)

    def _handle(self, rank: int, msg: Any) -> None:
        if isinstance(msg, wire.PolicySnapshot):
            self._on_snapshot(msg)
            return
        if not isinstance(msg, dict):
            log.warning("fleet: unexpected message %r", type(msg))
            return
        kind = msg.get("type")
        if kind == "hb":
            self._on_heartbeat(rank, msg)
        elif kind == "verdict":
            self._on_verdict(msg)
        elif kind == "params":
            self._on_params(rank, msg)
        elif kind == "params_mean":
            self._on_params_mean(msg)
        elif kind == "done":
            with self._lock:
                self._done.add(rank)
                self._cv.notify_all()
        else:
            self._c_unknown.inc()
            log.warning("fleet: unknown message type %r", kind)

    # -- health plane ------------------------------------------------------
    def _on_heartbeat(self, rank: int, msg: dict) -> None:
        self._c_hb_rx.inc()
        state = int(msg.get("state", HEALTHY))
        restarts = int(msg.get("restarts", 0))
        reconnects = int(msg.get("reconnects", 0))
        gauges = msg.get("gauges") or {}
        with self._lock:
            self._host_states[rank] = state
            # Heartbeat gauges are scalar floats (materialized by the
            # decoder, nothing aliases the recv buffer) — safe to hold.
            self._remote_gauges[rank] = {
                str(k): float(v) for k, v in gauges.items()
            }
            self._remote_stats[rank] = {
                "updates": int(msg.get("updates", 0)),
                "restarts": restarts,
                "reconnects": reconnects,
            }
            fold = (
                state != HEALTHY or restarts > 0 or reconnects > 0
            ) and rank not in self._folded
            if fold:
                self._folded.add(rank)
        self._reg.gauge(f"fleet.host{rank}.state").set(state)
        if fold:
            # STICKY by fleet policy: a remote incident (degradation OR
            # a supervised recovery — restarts mean the host lost and
            # re-reached its env fleet) leaves the fleet operator a
            # permanent mark on the lead, even after the remote itself
            # recovers to HEALTHY.
            self._health.degrade(
                f"fleet.host{rank}: remote reported "
                f"{STATE_NAMES.get(state, state)} "
                f"(server_restarts={restarts}, "
                f"actor_reconnects={reconnects})",
                key=f"fleet.host{rank}",
                sticky=True,
            )

    def _on_verdict(self, msg: dict) -> None:
        live = msg.get("live")
        if live is not None:
            # The lead's fleet-wide live count: fold it into this
            # host's gauge so remote dashboards agree with the lead
            # (locally a remote only knows lead-reachable yes/no).
            self._g_live.set(int(live))
        states = msg.get("states") or {}
        folds = []
        with self._lock:
            for r_s, st in states.items():
                r = int(r_s)
                self._host_states[r] = int(st)
                if (
                    r != self.fleet.host_rank
                    and int(st) != HEALTHY
                    and r not in self._folded
                ):
                    self._folded.add(r)
                    folds.append((r, int(st)))
        for r, st in folds:
            self._health.degrade(
                f"fleet.host{r}: fleet verdict reports "
                f"{STATE_NAMES.get(st, st)}",
                key=f"fleet.host{r}",
                sticky=True,
            )
        if msg.get("halt"):
            self._health.halt(
                f"fleet verdict: {msg.get('reason', 'halt')}"
            )
            with self._lock:
                self._cv.notify_all()

    def _on_host_lost(self, rank: int, why: str) -> None:
        with self._lock:
            if rank in self._lost:
                return
            self._lost.add(rank)
            self._conns.pop(rank, None)
            self._send_locks.pop(rank, None)
            self._pending.pop(rank, None)
            live = self.fleet.num_hosts - len(self._lost)
            self._cv.notify_all()
        self._g_live.set(live)
        log.error(
            "fleet: host %d LOST (%s); %d/%d live (floor %d)",
            rank, why, live, self.fleet.num_hosts, self.min_live_hosts,
        )
        if live < self.min_live_hosts:
            self._health.halt(
                f"fleet: host {rank} lost ({why}); {live} live hosts "
                f"< --min_live_hosts {self.min_live_hosts} — "
                "checkpoint-and-exit"
            )
            self._broadcast_verdict()
        else:
            self._health.degrade(
                f"fleet.host{rank}_lost: host {rank} lost ({why}); "
                f"{live}/{self.fleet.num_hosts} live hosts "
                f"(floor {self.min_live_hosts})",
                key=f"fleet.host{rank}_lost",
                sticky=True,
            )

    def _on_lead_lost(self, why: str) -> None:
        with self._lock:
            self._lead_gone = True
            self._conns.pop(0, None)
            self._send_locks.pop(0, None)
            self._cv.notify_all()
        self._g_live.set(self.live_hosts())
        # The lead owns checkpoints and the fleet verdict; a remote
        # without a lead halts (its monitor loop exits cleanly) rather
        # than train on into an unobservable, unsyncable state.
        self._health.halt(f"fleet: lead connection lost ({why})")

    def _broadcast_verdict(self) -> None:
        with self._lock:
            states = {str(r): int(s) for r, s in self._host_states.items()}
            live = self.fleet.num_hosts - len(self._lost)
        halted = self._health.is_halted
        reason = ""
        if halted:
            reasons = self._health.reasons()
            reason = reasons[-1][1] if reasons else "halted"
        self._broadcast({
            "type": "verdict",
            "halt": bool(halted),
            "reason": reason,
            "live": live,
            "states": states,
        })

    def _tick_loop(self) -> None:
        while not self._closing.wait(self.heartbeat_s):
            if self.fleet.is_lead:
                self._g_live.set(self.live_hosts())
                self._broadcast_verdict()
            else:
                with self._lock:
                    stats_fn = self._stats_fn
                    gauges_fn = self._gauges_fn
                stats = {}
                try:
                    stats = dict(stats_fn())
                except Exception:  # noqa: BLE001 — never kill the ticker
                    log.exception("fleet heartbeat stats source failed")
                gauges = {}
                try:
                    gauges = dict(gauges_fn())
                except Exception:  # noqa: BLE001
                    log.exception("fleet heartbeat gauge source failed")
                sent = self._send(0, {
                    "type": "hb",
                    "rank": self.fleet.host_rank,
                    "state": int(self._health.state),
                    "updates": int(stats.get("updates", 0)),
                    "restarts": int(stats.get("restarts", 0)),
                    "reconnects": int(stats.get("reconnects", 0)),
                    "gauges": gauges,
                })
                if sent:
                    self._c_hb_tx.inc()

    # -- snapshot plane ----------------------------------------------------
    def publish_snapshot(self, version: int, params, template) -> int:
        """Lead: broadcast a policy snapshot of `params` (aligned with
        `template.parameters()`); returns hosts reached."""
        snap = snapshot_wire.build_snapshot(version, template, params)
        n = self._broadcast(snap)
        if n:
            self._c_snap_tx.inc()
            # Bytes this fanout moved (payload x hosts reached).
            self._c_snap_bytes_tx.inc(
                n * sum(int(leaf.nbytes) for leaf in snap.params)
            )
        return n

    def _on_snapshot(self, snap) -> None:
        self._c_snap_rx.inc()
        with self._lock:
            store, template = self._store, self._template
        if store is None:
            log.warning(
                "fleet: snapshot v%d received with no store attached",
                snap.version,
            )
            return
        try:
            snapshot_wire.apply_snapshot(
                store, snap, template,
                stale_counter=self._c_snap_stale,
            )
        except wire.WireError:
            log.exception("fleet: snapshot v%d rejected", snap.version)

    # -- parameter composition (wire strategy) ----------------------------
    def sync_params(self, params, template) -> Optional[list]:
        """One synchronous fleet averaging round (wire strategy; both
        sides call once per learner dispatch) over `params`, a list
        aligned with `template.parameters()`. Returns the fleet-mean
        list (each tensor in its param's dtype and device), or None when
        the round degraded (timeout / fleet shutting down) and the
        caller should keep its own params."""
        params = list(params)
        leaves = snapshot_wire.param_leaves(template, params)
        if self.fleet.is_lead:
            mean = self._sync_lead(leaves)
        else:
            mean = self._sync_remote(leaves)
        if mean is None:
            self._c_sync_timeouts.inc()
            return None
        self._c_syncs.inc()
        return snapshot_wire.params_from_leaves(template, mean, params)

    def _sync_lead(self, leaves) -> Optional[list]:
        deadline = time.monotonic() + self.sync_timeout_s
        with self._lock:
            while True:
                # The rendezvous set: connected ranks whose learner has
                # not finished (done ranks stop contributing).
                expected = set(self._conns) - self._done
                if expected <= set(self._pending):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closing.is_set() or (
                    self._health.is_halted
                ):
                    break
                self._cv.wait(min(remaining, 0.5))
            contribs = {
                r: self._pending.pop(r)
                for r in list(self._pending)
            }
        trees = [leaves] + list(contribs.values())
        mean = _mean_leaves(trees)
        if mean is None:
            return None
        self._broadcast({
            "type": "params_mean",
            "n": len(trees),
            "params": mean,
        })
        return mean

    def _sync_remote(self, leaves) -> Optional[list]:
        with self._lock:
            if self._lead_gone or self._closing.is_set():
                return None
            waiting_for = self._mean_seq + 1
        self._send(0, {
            "type": "params",
            "rank": self.fleet.host_rank,
            "params": leaves,
        })
        deadline = time.monotonic() + self.sync_timeout_s
        with self._lock:
            while self._mean_seq < waiting_for:
                if self._lead_gone or self._closing.is_set() or (
                    self._health.is_halted
                ):
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(min(remaining, 0.5))
            return self._mean_leaves

    def _on_params(self, rank: int, msg: dict) -> None:
        leaves = msg.get("params")
        if not isinstance(leaves, list):
            log.warning("fleet: bad params message from host %d", rank)
            return
        # Decoded arrays alias the transport recv buffer: copy before
        # the reader's next recv can overwrite them.
        copied = [np.array(a, copy=True) for a in leaves]
        with self._lock:
            self._pending[rank] = copied
            self._cv.notify_all()

    def _on_params_mean(self, msg: dict) -> None:
        leaves = msg.get("params")
        if not isinstance(leaves, list):
            log.warning("fleet: bad params_mean message")
            return
        # How many hosts the round actually averaged: n < fleet size
        # means the barrier degraded (timeout / loss) on the lead.
        self._g_sync_contribs.set(int(msg.get("n", 0)))
        copied = [np.array(a, copy=True) for a in leaves]
        with self._lock:
            self._mean_leaves = copied
            self._mean_seq += 1
            self._cv.notify_all()

    # -- observation -------------------------------------------------------
    def live_hosts(self) -> int:
        with self._lock:
            if self.fleet.is_lead:
                return self.fleet.num_hosts - len(self._lost)
            return 1 if not self._lead_gone else 0

    def host_states(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._host_states)

    def remote_gauges(self) -> Dict[int, Dict[str, float]]:
        """Lead: {rank: {gauge name: value}} from the latest heartbeats,
        what runtime/native.NativeTelemetryFolder folds as
        host<r>.<name>."""
        with self._lock:
            return {r: dict(g) for r, g in self._remote_gauges.items()}

    def remote_stats(self) -> Dict[int, Dict[str, int]]:
        with self._lock:
            return {r: dict(s) for r, s in self._remote_stats.items()}

    def learner_done(self) -> None:
        """This host's learner loop finished its steps: tell the lead
        to stop expecting sync contributions from it."""
        if not self.fleet.is_lead:
            self._send(0, {
                "type": "done", "rank": self.fleet.host_rank,
            })

    # -- teardown ----------------------------------------------------------
    def shutdown(self) -> None:
        if self._closing.is_set():
            return
        self._closing.set()
        with self._lock:
            conns = dict(self._conns)
            self._cv.notify_all()
        bye = {"type": "bye", "rank": self.fleet.host_rank}
        for rank in conns:
            self._send(rank, bye)
        if self._server_sock is not None:
            try:
                self._server_sock.close()
            except OSError:
                pass
        for t in conns.values():
            t.close()
        for th in self._threads:
            th.join(timeout=2.0)


def _mean_leaves(trees) -> Optional[list]:
    """Leaf-wise mean over same-structure leaves lists: float leaves
    average in f32 and cast back, non-float leaves take the first
    tree's value. None on a structural mismatch."""
    if not trees:
        return None
    width = len(trees[0])
    if any(len(t) != width for t in trees):
        log.error(
            "fleet: param sync leaf-count mismatch (%s)",
            [len(t) for t in trees],
        )
        return None
    out = []
    for i in range(width):
        leaf0 = np.asarray(trees[0][i])
        if not np.issubdtype(leaf0.dtype, np.floating):
            out.append(leaf0)
            continue
        acc = np.zeros(leaf0.shape, dtype=np.float32)
        for t in trees:
            acc += np.asarray(t[i], dtype=np.float32)
        out.append((acc / len(trees)).astype(leaf0.dtype))
    return out
