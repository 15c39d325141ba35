"""Graceful preemption: SIGTERM flows through the drivers' interrupt path.

TPU fleets preempt: k8s sends SIGTERM before SIGKILL, maintenance events
likewise. The drivers already turn KeyboardInterrupt into a clean
shutdown (final checkpoint, FileWriter close, env-server teardown); this
maps SIGTERM onto that same path so a preempted run resumes from its
last step instead of losing everything since the last periodic
checkpoint. (The reference only handles Ctrl-C.)

The port's copy of torchbeast_tpu/utils/preempt.py.
"""

import logging
import signal
import threading

from torchbeast_tpu_torch import telemetry

log = logging.getLogger(__name__)


def install_preemption_handler() -> bool:
    """Raise KeyboardInterrupt in the main thread on SIGTERM.

    Returns True if installed; no-ops (False) off the main thread, where
    CPython forbids signal handler installation (e.g. library use inside
    a larger process that owns signal handling).

    The preemption is RECORDED: the handler bumps the
    `preempt.sigterm_received` counter before unwinding, so the final
    telemetry line of a preempted run says it was preempted (the resume
    test pins this) instead of looking like a voluntary exit.
    """
    if threading.current_thread() is not threading.main_thread():
        return False

    # Resolve the counter at install time: the handler itself must do
    # as little as possible (it runs between two bytecodes of whatever
    # the main thread was executing).
    tm_preempt = telemetry.get_registry().counter(
        "preempt.sigterm_received"
    )

    def handler(signum, frame):
        # Disarm first: a SECOND SIGTERM during the checkpoint/cleanup
        # path must not abort the very shutdown this handler protects
        # (escalating supervisors send repeats before SIGKILL).
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        tm_preempt.inc()
        log.info("Received signal %d; shutting down gracefully.", signum)
        raise KeyboardInterrupt(f"signal {signum}")

    signal.signal(signal.SIGTERM, handler)
    return True
