"""Env-server process group driver (the reference's polybeast_env.py role,
torchbeast's torchbeast/polybeast_env.py:61-89): start `num_servers`
processes, each serving environments on `{pipes_basename}.{i}` over the
framed-socket protocol.

Run:  python -m torchbeast_tpu_torch.polybeast_env --num_servers 4 --env Mock

The port's copy of torchbeast_tpu/polybeast_env.py, with two changes: each
server is a fresh interpreter (`ServerProcess`) instead of a spawn-context
multiprocessing child, which would import the parent's main module again
(the learner driver, and with it torch and the kernel wrappers); and the
C++ server of `--native_server` (the port's core, runtime/native.py) runs
on a thread of its own, so SIGTERM reaches the main thread, which stops
it.
"""

import argparse
import atexit
import functools
import itertools
import json
import logging
import os
import subprocess
import sys
import threading
import time
import weakref

from torchbeast_tpu_torch import telemetry
from torchbeast_tpu_torch.resilience.backoff import Backoff

log = logging.getLogger("torchbeast_tpu_torch.polybeast_env")


def _configure_logging():
    """Called from main(), NOT at import: importing this module (as the
    learner driver and every test does) must not mutate global logging
    state."""
    logging.basicConfig(
        format=(
            "[%(levelname)s:%(process)d %(module)s:%(lineno)d "
            "%(asctime)s] %(message)s"
        ),
        level=logging.INFO,
    )


def make_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pipes_basename", default="unix:/tmp/torchbeast_tpu",
                        help="Basename for the env-server addresses "
                             "(unix:/path, host:baseport, or shm:/path "
                             "for shared-memory rings when the servers "
                             "are co-located with the learner host).")
    parser.add_argument("--num_servers", type=int, default=4)
    parser.add_argument("--env", type=str, default="PongNoFrameskip-v4",
                        help="Gym environment (or Mock / Counting).")
    parser.add_argument("--env_seed", type=int, default=None,
                        help="Base seed for stochastic envs. Server i "
                             "seeds its streams from env_seed + i*1000 "
                             "+ stream index: every env instance draws a "
                             "distinct deterministic stream. Default: OS "
                             "entropy per env.")
    parser.add_argument("--max_server_restarts", type=int, default=10,
                        help="Supervision budget: dead env servers are "
                             "respawned on their address up to this many "
                             "times per group (actors bridge the gap "
                             "with their reconnect budget). 0 disables "
                             "restarts.")
    parser.add_argument("--native_server", action="store_true",
                        help="Serve with the C++ EnvServer (the port's "
                             "core, built at first use): socket I/O and "
                             "wire codec run GIL-free, the GIL is taken "
                             "only around env calls.")
    return parser


def server_address(pipes_basename: str, index: int) -> str:
    """unix:/tmp/x and shm:/tmp/x -> {base}.{i};  host:port ->
    host:{port+i}."""
    if pipes_basename.startswith(("unix:", "shm:")):
        return f"{pipes_basename}.{index}"
    host, _, port = pipes_basename.rpartition(":")
    return f"{host}:{int(port) + index}"


def free_tcp_basename(n: int, host: str = "127.0.0.1") -> str:
    """A `host:port` basename whose `n` consecutive ports (port, port+1,
    ...) are free on `host` now: addresses for a local server group
    that need no socket files."""
    import random
    import socket

    for _ in range(100):
        base = random.randint(20000, 60000 - n)
        socks = []
        try:
            for i in range(n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind((host, base + i))
            return f"{host}:{base}"
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise RuntimeError(f"no {n} consecutive free ports on {host}")


def host_scoped_basename(pipes_basename: str, process_id: int,
                         num_servers: int) -> str:
    """Multi-host fan-out: each learner host gets its own address range so
    its actors connect to its OWN env servers (the reference's per-machine
    topology, polybeast_learner.py:436-444). unix paths get a -h{pid}
    suffix; host:port bases step by num_servers per host."""
    if process_id == 0:
        return pipes_basename
    if pipes_basename.startswith(("unix:", "shm:")):
        return f"{pipes_basename}-h{process_id}"
    host, _, port = pipes_basename.rpartition(":")
    return f"{host}:{int(port) + process_id * num_servers}"


def _serve(env_name: str, address: str, native: bool = False,
           seed_base=None):
    # Server process body (ServerProcess). The process never runs
    # main(), so it configures its own logging (INFO lines like
    # "EnvServer listening" would otherwise be lost: import does not
    # call basicConfig).
    _configure_logging()
    # SIGTERM (reap_group's terminate, a k8s preemption) must run this
    # child's teardown — for shm servers that is the owner-side ring
    # unlink sweep (EnvServer.stop). The default handler kills the
    # process without finally blocks, stranding /dev/shm segments.
    from torchbeast_tpu_torch.utils import install_preemption_handler

    install_preemption_handler()
    # Import here: workers must never inherit JAX state.
    from torchbeast_tpu_torch.envs import create_env

    if seed_base is None:
        env_init = functools.partial(create_env, env_name)
    else:
        # Fresh env per actor stream (both server impls call env_init
        # once per connection): stream s draws seed_base + s. The
        # counter is GIL-guarded — the native server, too, invokes
        # env_init holding the GIL. Reproducible seed SET; which stream
        # gets which seed follows connection order.
        counter = itertools.count()

        def env_init():
            return create_env(env_name, seed=seed_base + next(counter))
    if native:
        server = native_env_server(env_init, address)
    else:
        from torchbeast_tpu_torch.runtime.env_server import EnvServer

        server = EnvServer(env_init, address)
    try:
        server.run()
    except KeyboardInterrupt:
        log.info("Env server on %s preempted; cleaning up.", address)
    finally:
        # stop() severs live streams and runs the owner-side shm
        # unlink sweep — the difference between a preempted shm server
        # and a /dev/shm leak.
        server.stop()


class _NativeServer:
    """The core's EnvServer behind the Python server's run()/stop(): its
    blocking run() goes to a thread, so the main thread stays in the
    interpreter, where SIGTERM's KeyboardInterrupt can reach it."""

    def __init__(self, server):
        self._server = server
        self._thread = threading.Thread(target=server.run, daemon=True,
                                        name="native-env-server")

    def run(self):
        self._thread.start()
        while self._thread.is_alive():
            self._thread.join(0.5)

    def stop(self):
        self._server.stop()
        if self._thread.is_alive():
            self._thread.join(5)


def native_env_server(env_init, address):
    """The core's EnvServer on `address`; raises when the core cannot be
    built."""
    from torchbeast_tpu_torch.runtime import native

    core = native.require("--native_server")
    return _NativeServer(core.EnvServer(env_init, address))


# The body of a server process: it imports this module and what _serve
# needs (the envs, the runtime, numpy), and nothing of the parent's.
_SERVE = ("import json, sys\n"
          "from torchbeast_tpu_torch.polybeast_env import _serve\n"
          "_serve(*json.loads(sys.argv[1]))\n")
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIVE = weakref.WeakSet()  # servers started by this process, not yet reaped
# The pid of every server this process started, in order (the leak
# checks of chaos_run.py count the ring segments those pids created).
SPAWNED_PIDS = []


class ServerProcess:
    """One env server, `_serve(env_name, address, native, seed_base)`, in
    a new interpreter. It has the part of multiprocessing.Process's
    interface that ServerSupervisor and reap_group use (pid, exitcode,
    is_alive, terminate, kill, join), and like a daemonic Process it is
    reaped when this process exits."""

    def __init__(self, env_name, address, native=False, seed_base=None):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
        self._popen = subprocess.Popen(
            [sys.executable, "-c", _SERVE,
             json.dumps([env_name, address, native, seed_base])],
            env=env, stdin=subprocess.DEVNULL,
        )
        self.pid = self._popen.pid
        _LIVE.add(self)
        SPAWNED_PIDS.append(self.pid)

    @property
    def exitcode(self):
        """None while running, else the exit code (-N: killed by N)."""
        return self._popen.poll()

    def is_alive(self) -> bool:
        return self._popen.poll() is None

    def terminate(self):
        self._popen.terminate()  # a no-op once the process has exited

    def kill(self):
        self._popen.kill()

    def join(self, timeout=None):
        try:
            self._popen.wait(timeout)
        except subprocess.TimeoutExpired:
            pass


@atexit.register
def _reap_at_exit():
    reap_group(list(_LIVE))


def reap_group(procs):
    """Terminate, join (bounded), then kill an env-server group: a server
    that ignores SIGTERM mid-start-up is killed, and none is left a
    zombie."""
    for p in procs:
        p.terminate()
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join(timeout=5)


class ServerSupervisor:
    """Owns an env-server process group and restarts members that die.

    The actor side has elastic reconnects (ActorPool's max_reconnects
    budget, runtime/actor_pool.py); this is the missing other half —
    someone to bring a dead server BACK. A member is respawned on its
    original address with its original seed base, so in-flight actors
    resume through their reconnect budget instead of exhausting it
    against a dead socket. `max_restarts` (per group, cumulative) caps
    crash-looping a deterministically broken env. The reference has no
    supervision at all: its env driver only LOGS a death
    (torchbeast's torchbeast/polybeast_env.py:61-75 serve loop; the
    gRPC server dying takes the slot down for good).
    """

    def __init__(self, flags, pipes_basename=None, env_seed=None, max_restarts=10,
                 poll_interval_s=1.0, backoff_factory=None,
                 stable_s=30.0):
        self._env_name = flags.env
        self._native = getattr(flags, "native_server", False)
        self._basename = pipes_basename or flags.pipes_basename
        if env_seed is None:
            env_seed = getattr(flags, "env_seed", None)
        self._env_seed = env_seed
        self.max_restarts = max_restarts
        self.restarts = 0
        self._poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread = None
        self._budget_logged = set()  # indices already error-logged
        # Jittered exponential backoff per slot: a crash-looping env
        # must not be respawned every poll tick (and N servers dying
        # together must not restart in lockstep). A member that stayed
        # up for `stable_s` earns its slot's backoff reset.
        self._backoff_factory = backoff_factory or (
            lambda: Backoff(base_s=0.25, cap_s=10.0)
        )
        self._stable_s = stable_s
        self._backoffs = {}  # slot -> Backoff
        self._respawn_at = {}  # slot -> monotonic time respawn is due
        self._spawned_at = {}  # slot -> monotonic time of last spawn
        self._tm_restarts = telemetry.get_registry().counter(
            "recovery.server_restarts"
        )
        # The group list is MUTATED IN PLACE on restart so callers that
        # captured it (the driver's reap paths) always see the current
        # members.
        self.processes = []
        try:
            for i in range(flags.num_servers):
                self.processes.append(self._spawn(i))
        except BaseException:
            # A partial group must not outlive a failed construction —
            # the caller never gets a handle to reap.
            reap_group(self.processes)
            raise
        log.info("Starting %d supervised env servers on %s",
                 len(self.processes), self._basename)

    def _spawn(self, i):
        address = server_address(self._basename, i)
        seed_base = (
            None if self._env_seed is None else self._env_seed + i * 1000
        )
        p = ServerProcess(self._env_name, address, self._native, seed_base)
        # beastlint: disable=RACE  single-writer map: the constructor fills every slot before start_watch() creates the watcher (Thread.start publishes); afterwards _spawn runs only on the watcher thread
        self._spawned_at[i] = time.monotonic()
        return p

    def start_watch(self):
        self._thread = threading.Thread(
            target=self._watch, daemon=True, name="server-supervisor"
        )
        self._thread.start()

    def _watch(self):
        while not self._stop.wait(self._poll_interval_s):
            for i, p in enumerate(self.processes):
                if p.is_alive() or self._stop.is_set():
                    continue
                if self.restarts >= self.max_restarts:
                    if i not in self._budget_logged:
                        log.error(
                            "Env server %d died (exit %s) and the "
                            "restart budget (%d) is exhausted; leaving "
                            "this slot down.",
                            i, p.exitcode, self.max_restarts,
                        )
                        self._budget_logged.add(i)
                    continue
                now = time.monotonic()
                due = self._respawn_at.get(i)
                if due is None:
                    # First poll to see this death: schedule the
                    # respawn through jittered backoff, not
                    # immediately — a crash-looping env must not be
                    # respawned every tick, and simultaneous deaths
                    # must not restart in lockstep.
                    bo = self._backoffs.setdefault(
                        i, self._backoff_factory()
                    )
                    if now - self._spawned_at.get(i, now) >= self._stable_s:
                        bo.reset()  # the last incarnation was healthy
                    delay = bo.next_delay()
                    self._respawn_at[i] = now + delay
                    log.warning(
                        "Env server %d died (exit %s); respawning on "
                        "its address in %.2fs (jittered backoff).",
                        i, p.exitcode, delay,
                    )
                    continue
                if now < due:
                    continue
                # beastlint: disable=RACE  watcher-only read-modify-write; the driver's monitor reads an int that is torn-free under the GIL and only informational (stats line / chaos accounting)
                self.restarts += 1
                log.warning(
                    "Env server %d: restarting on its address "
                    "(restart %d/%d).",
                    i, self.restarts, self.max_restarts,
                )
                try:
                    replacement = self._spawn(i)
                except Exception:
                    # Spawn failure (fd/pid pressure is exactly when
                    # servers die) must not kill the watcher thread —
                    # that would END supervision silently. Refund the
                    # attempt and retry after another backoff step.
                    self.restarts -= 1
                    self._respawn_at[i] = (
                        time.monotonic() + self._backoffs[i].next_delay()
                    )
                    log.exception(
                        "Respawn of env server %d failed; backing off.",
                        i,
                    )
                    continue
                del self._respawn_at[i]
                self._tm_restarts.inc()
                if self._stop.is_set():
                    # stop() landed while we were spawning: the reap may
                    # already have iterated the group, so this member
                    # must die here, not serve forever unreaped.
                    reap_group([replacement])
                    return
                # beastlint: disable=RACE  single-reference slot store under the GIL; readers (driver reap, chaos injector) tolerate a momentarily stale member and re-check is_alive()/pid before acting on it
                self.processes[i] = replacement

    def stop(self):
        """Stop restarting. Call BEFORE terminating the group, or the
        watcher resurrects members mid-reap."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                log.error(
                    "server-supervisor watcher did not stop within 10s "
                    "(a respawn may still be in flight); its in-flight "
                    "member reaps itself on insert."
                )


def main(flags):
    _configure_logging()
    if flags.native_server:
        # Built once here, before the servers start and import it.
        from torchbeast_tpu_torch.runtime import native

        native.require("--native_server")
    # SIGTERM must run the finally below: Python's default handler kills
    # the process without atexit/finally, orphaning the daemonic server
    # children (ppid 1, still serving their ports) — exactly what
    # `kill <group-launcher>` or a supervisor teardown sends. Observed:
    # every split-deployment test run leaked its server pair this way.
    import signal

    def _graceful_term(signum, frame):
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, _graceful_term)

    supervisor = ServerSupervisor(
        flags, max_restarts=getattr(flags, "max_server_restarts", 10)
    )
    supervisor.start_watch()
    try:
        while True:
            time.sleep(10)
    except KeyboardInterrupt:
        pass
    finally:
        supervisor.stop()
        reap_group(supervisor.processes)


def cli():
    main(make_parser().parse_args())


if __name__ == "__main__":
    cli()
