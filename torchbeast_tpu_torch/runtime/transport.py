"""Transports: framed wire messages over sockets or shared-memory rings.

One abstraction, two data planes:

- `SocketTransport` — the classic framed stream (tcp/unix), upgraded with
  per-connection SendBuffer/RecvBuffer so steady-state sends are
  scatter-gather (`socket.sendmsg` straight from numpy buffers) and
  receives are allocation-free (`recv_into` into a grow-only buffer).

- `ShmTransport` — for co-located env servers (`shm://` addresses): obs
  and action frames are written *in place* into a single-producer/
  single-consumer ring over `multiprocessing.shared_memory`, with the
  same payload encoding as the socket framing. A lightweight socket
  doorbell (1 control byte per frame) provides blocking flow control and
  crash detection: the peer dying closes the socket, which surfaces as
  the same ConnectionError/WireError teardown contract the socket
  transport has. Frames too large for the ring ride the doorbell socket
  inline (escape hatch, same framing), so correctness never depends on
  the ring capacity.

Address schemes (parse_address): "unix:/path", "host:port", and
"shm:/path" (also "shm:///path") — for shm the path names the unix
doorbell socket; the ring segments are created by the server per
connection with kernel-generated names exchanged in a handshake.

Both transports share the wire module's frame format and the
buffer-reuse lifetime rule: a decoded nest must be consumed before the
next recv on the same transport (ring frames are released, and the
RecvBuffer is overwritten, at the next recv call).

The port's copy of torchbeast_tpu/runtime/transport.py.
"""

# beastlint: hot-module — send/recv run per env step per connection.
# (No locks here by design: each transport is single-threaded per
# connection, so LOCK-DISCIPLINE has nothing to guard.)

import logging
import os
import re
import secrets
import socket
import struct
import time
from typing import Any, Optional, Tuple

from torchbeast_tpu_torch.runtime import wire

log = logging.getLogger(__name__)

# Per-direction ring capacities. Obs frames (server -> client) are the
# big ones (Atari-sized frames + scalars); actions are tiny. Capacity
# must hold >= 2 frames for the alternating env protocol to never block
# on ring space; oversized frames fall back to the doorbell socket.
DEFAULT_OBS_RING_BYTES = 4 * 1024 * 1024
DEFAULT_ACT_RING_BYTES = 256 * 1024

# Doorbell control bytes (client and server only ever *read* doorbells
# for their incoming direction, so there is no demux state). Doorbells
# are WAKEUPS, not per-frame tokens: the sender rings only when the
# ring-header waiting flag says the reader is blocked (futex-style), so
# a busy reader consumes frames with no syscalls on either side. All
# frame ORDERING lives in the ring — an oversized message leaves an
# inline marker at its ring position and its bytes follow the 0x02 byte
# on the socket, so mixed ring/inline traffic still arrives in order.
_DOORBELL_WAKE = b"\x01"  # stale ones are skipped wherever they appear
_DOORBELL_INLINE = b"\x02"  # one framed message follows on the socket

# The reader's blocking wait re-checks the ring at this period: the
# waiting-flag handshake has a (tiny) lost-wakeup window — CPython emits
# no store-load fence between the sender's head publish and its
# waiting-flag load — and the periodic re-check bounds that stall.
# 20ms (not the original 500ms): on an oversubscribed box the
# doorbell hop itself can be late or lost under scheduler pressure, and
# e2e runs showed the system settling into a degraded mode where a
# visible fraction of waits ride the recheck — a tight bound caps each
# such stall at one scheduling quantum instead of half a second, while
# an idle connection still costs only 50 wakeups/s.
# This is the INITIAL bound: per connection, AdaptiveRecheck walks it
# within [_RECHECK_MIN_MS, _RECHECK_MAX_MS] below.
_WAKE_RECHECK_S = 0.02

# Adaptive recheck policy: the fixed bound trades idle
# wakeup cost against lost-wakeup stall cost at ONE operating point,
# but the ring.doorbell_waits / ring.recheck_wakeups counters
# measure which regime a connection is actually in. Per window of
# _RECHECK_WINDOW armed waits: >= _RECHECK_TIGHTEN ended by the
# timeout (doorbells being lost/late — the ROADMAP metastability
# signature) HALVES the bound, floor _RECHECK_MIN_MS, so each stall
# costs less exactly when stalls are frequent; <= _RECHECK_RELAX
# (healthy byte-woken pair) DOUBLES it, cap _RECHECK_MAX_MS, back
# toward idle cheapness. All five constants are pinned cross-language
# against csrc/shm.h AND analysis/protocol.py by the ATOMIC-ORDER
# recheck check; the model checker's timeout transition covers any
# bound in the range (no-wedge only needs the recheck to stay FINITE,
# i.e. _RECHECK_MIN_MS > 0).
_RECHECK_MIN_MS = 5
_RECHECK_MAX_MS = 100
_RECHECK_WINDOW = 32
_RECHECK_TIGHTEN = 16
_RECHECK_RELAX = 4


class AdaptiveRecheck:
    """Per-connection adaptive recheck bound (single-threaded, like the
    transport that owns it). `record(True)` = a wait ended by the
    bounded timeout instead of a doorbell byte."""

    __slots__ = ("_bound_ms", "_waits", "_rechecks")

    def __init__(self):
        self._bound_ms = int(_WAKE_RECHECK_S * 1000)
        self._waits = 0
        self._rechecks = 0

    @property
    def bound_ms(self) -> int:
        return self._bound_ms

    def timeout_s(self) -> float:
        return self._bound_ms / 1000.0

    def record(self, recheck: bool) -> None:
        self._waits += 1
        if recheck:
            self._rechecks += 1
        if self._waits < _RECHECK_WINDOW:
            return
        if self._rechecks >= _RECHECK_TIGHTEN:
            self._bound_ms = max(_RECHECK_MIN_MS, self._bound_ms // 2)
        elif self._rechecks <= _RECHECK_RELAX:
            self._bound_ms = min(_RECHECK_MAX_MS, self._bound_ms * 2)
        self._waits = self._rechecks = 0

# Doorbell-wait observability (same lazy-resolve idiom as
# wire._instruments so --no_telemetry runs get no-ops):
# ring.doorbell_waits counts every armed+blocked doorbell wait,
# ring.recheck_wakeups the subset ended by the bounded recheck instead
# of a doorbell byte. The ratio is the ROADMAP metastability hunt's
# signal — a healthy pair wakes on bytes, a degraded one rides the
# recheck.
_tm_doorbell_waits = None
_tm_recheck_wakeups = None


def _ring_instruments():
    global _tm_doorbell_waits, _tm_recheck_wakeups
    if _tm_doorbell_waits is None:
        from torchbeast_tpu_torch import telemetry

        reg = telemetry.get_registry()
        # beastlint: disable=RACE  benign double-init: the registry's get-or-create is idempotent, so racing threads store the SAME instrument object; each store is GIL-atomic
        _tm_doorbell_waits = reg.counter("ring.doorbell_waits")
        # beastlint: disable=RACE  same idempotent lazy-init as _tm_doorbell_waits above
        _tm_recheck_wakeups = reg.counter("ring.recheck_wakeups")
    return _tm_doorbell_waits, _tm_recheck_wakeups

# Before arming the waiting flag, the reader spins on the head counter
# for this long: a producer running at a similar cadence lands its next
# frame inside the spin window, keeping BOTH sides syscall-free. Without
# it, a matched producer/consumer pair oscillates around an empty ring
# and pays wake+block syscalls per frame (measured: halves large-frame
# throughput on a host whose emulated syscalls cost ~20-70us).
_EMPTY_SPIN_S = 100e-6


def parse_address(address: str):
    """Address -> (socket family, connect/bind target). shm addresses
    resolve to their unix doorbell socket."""
    if address.startswith("unix:"):
        return socket.AF_UNIX, address[len("unix:") :]
    if address.startswith("shm:"):
        return socket.AF_UNIX, shm_socket_path(address)
    host, _, port = address.rpartition(":")
    return socket.AF_INET, (host or "127.0.0.1", int(port))


def is_shm_address(address: str) -> bool:
    return address.startswith("shm:")


def shm_socket_path(address: str) -> str:
    """shm:/tmp/x and shm:///tmp/x -> /tmp/x (the doorbell socket path)."""
    path = address[len("shm:") :]
    if path.startswith("//"):
        path = path[2:]
    if not path:
        raise ValueError(f"Empty shm address: {address!r}")
    return path


def _tracker(action: str, shm) -> None:
    """register/unregister a SharedMemory segment with this process's
    multiprocessing.resource_tracker (best-effort: tracker internals are
    private and have moved between Python versions)."""
    try:
        from multiprocessing import resource_tracker

        getattr(resource_tracker, action)(
            getattr(shm, "_name", shm.name), "shared_memory"
        )
    except Exception:  # pragma: no cover
        log.debug("resource_tracker %s failed", action, exc_info=True)


_OWNED_SEGMENT = re.compile(r"^(?:psm|tbtring)_(\d+)_")


def segment_owner_pid(name: str) -> Optional[int]:
    """The pid of the process that created a ring segment, read from its
    name: the port's rings are "psm_<pid>_<hex>" (ShmRing.create) and
    the C++ core's "tbtring_<pid>_<n>" (csrc/native/shm.h); None for
    any other name. Leak checks use it to count only the segments of
    the processes they started."""
    match = _OWNED_SEGMENT.match(name)
    return int(match.group(1)) if match else None


def unlink_segment(name: str) -> bool:
    """Best-effort unlink of a SharedMemory segment by name — the crash
    sweep for segments whose owner died without cleanup (a SIGKILL'd
    env server). Returns True when this call removed the segment; False
    when it was already gone (the owner, or another sweeper, got there
    first)."""
    from multiprocessing import shared_memory

    try:
        seg = shared_memory.SharedMemory(name=name)
    except (FileNotFoundError, OSError):
        return False
    try:
        seg.unlink()  # unregisters the attach's tracker entry too
        return True
    except FileNotFoundError:
        _tracker("unregister", seg)  # nothing unlinked: rebalance
        return False
    finally:
        try:
            seg.close()
        except BufferError:  # pragma: no cover
            log.debug("sweep close of %s kept a view alive", name)


class SocketTransport:
    """Framed messages over a connected stream socket, with reusable
    per-connection encode/receive buffers."""

    def __init__(self, sock: socket.socket,
                 max_frame_bytes: Optional[int] = None,
                 recv_timeout_s: Optional[float] = None):
        self._sock = sock
        self._max_frame_bytes = max_frame_bytes
        if recv_timeout_s is not None:
            # Bounded receives (spec probes): a peer that accepts but
            # never sends surfaces as socket.timeout (an OSError), not
            # a hang.
            sock.settimeout(recv_timeout_s)
        self._send_buf = wire.SendBuffer()
        self._recv_buf = wire.RecvBuffer()

    def send(self, value: Any) -> int:
        return wire.send_message(self._sock, value, buf=self._send_buf)

    def recv_sized(self) -> Tuple[Any, int]:
        return wire.recv_message_sized(
            self._sock, buf=self._recv_buf,
            max_frame_bytes=self._max_frame_bytes,
        )

    def recv(self) -> Any:
        return self.recv_sized()[0]

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class ShmRing:
    """Single-producer single-consumer byte ring over a SharedMemory
    segment.

    Layout: [0:8) head, [8:16) tail, [16:24) capacity, [24:32) the
    consumer's waiting flag (all u64le), data at [64, 64+capacity).
    head/tail are monotonic byte counters (head producer-owned, tail
    consumer-owned); free = capacity-(head-tail). Frames are contiguous
    [u32 length][payload]; when a frame would straddle the end, a u32
    0xFFFFFFFF wrap marker (or <4 bytes of tail room) skips the
    remainder; a u32 0xFFFFFFFE entry marks a message that rides the
    doorbell socket inline instead (too big for the ring). Aligned
    8-byte counter stores through a cast memoryview are single stores;
    x86 store ordering makes the data-then-head publish safe without
    fences.
    """

    HEADER_BYTES = 64
    _WRAP = 0xFFFFFFFF
    _INLINE = 0xFFFFFFFE
    _HEAD, _TAIL, _CAP, _WAITING = 0, 1, 2, 3

    def __init__(self, shm, capacity: int, owner: bool,
                 close_shm: bool = True):
        self._shm = shm
        self._owner = owner
        # False for in-process ring pairs sharing one mapping (shm_pipe):
        # only one end may unmap/unlink.
        self._close_shm = close_shm
        self._capacity = capacity
        self._publish_head = 0
        self._u64 = shm.buf[:32].cast("Q")
        self._data = shm.buf[self.HEADER_BYTES : self.HEADER_BYTES + capacity]

    # -- construction -----------------------------------------------------
    @classmethod
    def create(cls, capacity: int) -> "ShmRing":
        from multiprocessing import shared_memory

        # Named after the creating process (segment_owner_pid), as the
        # C++ core names its rings; a name clash draws again.
        while True:
            try:
                shm = shared_memory.SharedMemory(
                    name=f"psm_{os.getpid()}_{secrets.token_hex(4)}",
                    create=True, size=cls.HEADER_BYTES + capacity,
                )
                break
            except FileExistsError:
                continue
        ring = cls(shm, capacity, owner=True)
        ring._u64[cls._HEAD] = 0
        ring._u64[cls._TAIL] = 0
        ring._u64[cls._CAP] = capacity
        ring._u64[cls._WAITING] = 0
        return ring

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        # The creator owns the unlink; detach this process's
        # resource_tracker registration so client exit doesn't try to
        # unlink (and warn about) segments it merely attached to. (The
        # owner re-registers before its unlink, so the create+attach-in-
        # one-process case stays balanced too — see close().)
        _tracker("unregister", shm)
        capacity = shm.buf[:32].cast("Q")[cls._CAP]
        if capacity <= 0 or cls.HEADER_BYTES + capacity > shm.size:
            shm.close()
            raise wire.WireError(
                f"shm ring {name}: bad capacity {capacity}"
            )
        return cls(shm, int(capacity), owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    @property
    def capacity(self) -> int:
        return self._capacity

    def max_frame_bytes(self) -> int:
        """Largest frame the transport routes through the ring. Frames
        never wrap mid-frame, so placing one at position `pos` may
        require skipping `capacity - pos` tail bytes first; only frames
        <= capacity/2 are placeable at EVERY position (skip + frame <=
        capacity, the most free space a drained ring can offer). Bigger
        frames would be position-dependently unplaceable — a permanent
        _wait_free stall — so they ride the inline socket path instead."""
        return self._capacity // 2 - 4

    # -- producer ---------------------------------------------------------
    def write_frame(self, views, total: int,
                    timeout_s: float = 120.0, peer_check=None) -> None:
        """Write one frame ([u32 total][views...]) into the ring. Blocks
        (polling) while the ring lacks space; a stalled reader surfaces
        as WireError after timeout_s, and a DEAD one promptly via
        peer_check (called periodically during the wait — ShmTransport
        passes a doorbell-socket probe so crash detection stays fast
        even for a writer that never touches the socket)."""
        cap = self._capacity
        need = 4 + total
        if need > cap:
            raise wire.WireError(
                f"Frame of {total} bytes exceeds ring capacity {cap}"
            )
        pos = self._reserve(need, timeout_s, peer_check)
        data = self._data
        struct.pack_into("<I", data, pos, total)
        off = pos + 4
        for v in views:
            n = len(v)
            data[off : off + n] = v
            off += n
        # Publish after the payload bytes are in place.
        self._u64[self._HEAD] = self._publish_head

    def write_inline_marker(self, timeout_s: float = 120.0,
                            peer_check=None) -> None:
        """Reserve this message's ORDER SLOT in the ring while its bytes
        ride the doorbell socket (too big for the ring): the reader hits
        the marker at the right position in the stream and switches to
        the socket for one message."""
        pos = self._reserve(4, timeout_s, peer_check)
        struct.pack_into("<I", self._data, pos, self._INLINE)
        self._u64[self._HEAD] = self._publish_head

    def _reserve(self, need: int, timeout_s: float, peer_check=None) -> int:
        """Wait for `need` contiguous bytes at head (writing a wrap
        marker if the tail room is short); returns the data offset to
        write at and stages the post-publish head in _publish_head."""
        cap = self._capacity
        head = self._u64[self._HEAD]
        pos = head % cap
        tail_room = cap - pos
        if need > tail_room:
            self._wait_free(head, tail_room + need, timeout_s, peer_check)
            if tail_room >= 4:
                struct.pack_into("<I", self._data, pos, self._WRAP)
            head += tail_room
            pos = 0
        else:
            self._wait_free(head, need, timeout_s, peer_check)
        self._publish_head = head + need
        return pos

    def _wait_free(self, head: int, need: int, timeout_s: float,
                   peer_check=None) -> None:
        deadline = None
        ticks = 0
        while self._capacity - (head - self._u64[self._TAIL]) < need:
            if deadline is None:
                deadline = time.monotonic() + timeout_s
            elif time.monotonic() > deadline:
                raise wire.WireError(
                    f"shm ring full for {timeout_s}s (reader stalled?)"
                )
            ticks += 1
            if peer_check is not None and ticks % 200 == 0:  # ~every 20ms
                peer_check()
            time.sleep(0.0001)

    def reader_waiting(self) -> bool:
        return self._u64[self._WAITING] != 0

    def poke(self, pos: int, data: bytes) -> None:
        """Write raw bytes into the DATA region at offset `pos` — the
        chaos-injection/corruption-test hook (resilience/chaos.py,
        tests/test_shm_transport.py). Never called on a healthy path."""
        self._data[pos : pos + len(data)] = data

    def unlink(self) -> None:
        """Best-effort unlink regardless of ownership — the crash sweep
        for a dead owner. Safe against a live peer: segments are
        per-connection and never re-attached, so unlinking early only
        turns the owner's own later unlink into a FileNotFoundError
        no-op (existing mappings stay valid until unmapped)."""
        _tracker("register", self._shm)  # balance unlink's unregister
        try:
            self._shm.unlink()
        except FileNotFoundError:
            _tracker("unregister", self._shm)  # nothing was unlinked

    # -- consumer ---------------------------------------------------------
    def has_frame(self) -> bool:
        return self._u64[self._HEAD] != self._u64[self._TAIL]

    def set_waiting(self, value: bool) -> None:
        self._u64[self._WAITING] = 1 if value else 0

    def read_frame(self) -> Tuple[Optional[memoryview], int]:
        """(read-only payload view, advance) for the frame at tail — the
        view is None for an inline marker (the message bytes follow on
        the doorbell socket). The caller must know a frame is available
        (has_frame()) and call release(advance) once the frame is
        consumed. Corrupt ring state surfaces as WireError."""
        cap = self._capacity
        tail = self._u64[self._TAIL]
        head = self._u64[self._HEAD]
        if head - tail < 4:
            raise wire.WireError("shm ring: read without a frame")
        pos = tail % cap
        skipped = 0
        tail_room = cap - pos
        if tail_room < 4:
            skipped = tail_room
            pos = 0
        else:
            (length,) = struct.unpack_from("<I", self._data, pos)
            if length == self._WRAP:
                skipped = tail_room
                pos = 0
        if skipped:
            (length,) = struct.unpack_from("<I", self._data, pos)
        if length == self._INLINE:
            return None, skipped + 4
        if length > cap - 4 or skipped + 4 + length > head - tail:
            raise wire.WireError(
                f"shm ring: bad frame length {length} at {pos}"
            )
        view = self._data[pos + 4 : pos + 4 + length].toreadonly()
        return view, skipped + 4 + length

    def release(self, advance: int) -> None:
        self._u64[self._TAIL] = self._u64[self._TAIL] + advance

    # -- teardown ---------------------------------------------------------
    def close(self):
        """Unmap (and unlink, if this end created the segment). Decoded
        views must be dropped first; a racing lingering view only skips
        the unmap, never crashes teardown."""
        for mv in (self._u64, self._data):
            try:
                mv.release()
            except (BufferError, ValueError):  # caller kept a frame view
                pass
        if not self._close_shm:
            return
        try:
            self._shm.close()
        except BufferError:  # pragma: no cover
            pass
        if self._owner:
            # Balance the tracker set before unlink's unregister: if an
            # in-process client attach()ed this segment, its unregister
            # already removed the creation entry (registration is a set,
            # so this is a no-op otherwise).
            _tracker("register", self._shm)
            try:
                self._shm.unlink()
            except FileNotFoundError:
                # A crash sweep (unlink_segment / ring.unlink) got here
                # first: rebalance so the tracker doesn't warn about a
                # "leaked" segment at process exit.
                _tracker("unregister", self._shm)


class ShmTransport:
    """Framed messages over a pair of shm rings with a socket doorbell.

    The socket is the blocking primitive, the crash detector (peer death
    closes it), and the carrier for oversized messages; the rings are
    the data plane AND the ordering authority. Doorbell wakeups are
    coalesced futex-style: the sender rings only when the ring header's
    waiting flag says the reader is blocked, so a busy reader (frames
    already queued) moves messages with zero syscalls on both sides,
    while a sleeping reader costs one 1-byte send. Payload bytes never
    cross the socket in the common case — `send` encodes scatter-gather
    straight into the ring; `recv_sized` decodes zero-copy views out of
    it.

    Lifetime: the previous frame's ring space is released at the next
    recv_sized call — consume (copy out of) a decoded nest before
    receiving the next message, same rule as wire.RecvBuffer.
    """

    def __init__(self, sock: socket.socket, send_ring: ShmRing,
                 recv_ring: ShmRing,
                 max_frame_bytes: Optional[int] = None,
                 recv_timeout_s: Optional[float] = None):
        self._sock = sock
        self._send_ring = send_ring
        self._recv_ring = recv_ring
        self._max_frame_bytes = max_frame_bytes
        self._recv_timeout_s = recv_timeout_s
        self._send_buf = wire.SendBuffer()
        self._recv_buf = wire.RecvBuffer()  # inline-fallback receives
        self._pending_release = 0
        self._inline_consumed = False
        self._doorbell = bytearray(1)
        self._doorbell_mv = memoryview(self._doorbell)
        self._recheck = AdaptiveRecheck()

    def send(self, value: Any) -> int:
        views, total = wire._timed_encode_into(value, self._send_buf)
        ring = self._send_ring
        if total <= ring.max_frame_bytes():
            ring.write_frame(views, total, peer_check=self._peer_check)
            if ring.reader_waiting():
                self._sock.sendall(_DOORBELL_WAKE)
        else:
            ring.write_inline_marker(peer_check=self._peer_check)
            if ring.reader_waiting():
                self._sock.sendall(_DOORBELL_WAKE)
            self._sock.sendall(_DOORBELL_INLINE)
            wire._sendmsg_all(self._sock, views, total)
        return total

    def _peer_check(self):
        """Probe the doorbell socket while a send is blocked on ring
        space: a peer that DIED (vs merely stalled) must fail the send
        promptly, like a socket send would, instead of burning the full
        ring-wait timeout. Queued stale WAKE bytes are consumed so they
        can't mask the EOF behind them — safe because wakeups are only
        *needed* while this end is blocked inside _wait_for_frame (the
        transport is single-threaded per connection, so any 0x01 queued
        during a send is stale by definition); an inline 0x02 is never
        consumed (it belongs to recv_sized)."""
        # A consumed 0x02 whose frame bytes are still queued proves the
        # peer alive AND makes the socket head payload, not doorbell —
        # probing now could eat a payload byte that happens to be 0x01.
        if self._inline_consumed:
            return
        while True:
            try:
                data = self._sock.recv(
                    1, socket.MSG_PEEK | socket.MSG_DONTWAIT
                )
            except (BlockingIOError, InterruptedError):
                return  # alive; nothing queued
            except OSError as e:
                raise ConnectionError(
                    f"shm peer connection lost during ring wait: {e}"
                ) from e
            if data == b"":
                raise ConnectionError("shm peer closed during ring wait")
            if data == _DOORBELL_WAKE:
                try:
                    self._sock.recv(1, socket.MSG_DONTWAIT)
                except OSError:
                    pass
                continue  # re-probe: EOF may hide behind stale wakeups
            return  # inline traffic queued: peer alive, leave it alone

    def _wait_for_frame(self) -> bool:
        """Block until the recv ring has a frame; False on clean EOF.
        The waiting-flag dance makes the sender ring the doorbell only
        when we are actually asleep; the periodic re-check bounds the
        (fence-less) lost-wakeup race."""
        ring = self._recv_ring
        sock = self._sock
        mv = self._doorbell_mv
        waits, rechecks = _ring_instruments()
        deadline = (
            None if self._recv_timeout_s is None
            else time.monotonic() + self._recv_timeout_s
        )
        while True:
            if ring.has_frame():
                return True
            spin_until = time.perf_counter() + _EMPTY_SPIN_S
            while time.perf_counter() < spin_until:
                if ring.has_frame():
                    return True
            if deadline is not None and time.monotonic() > deadline:
                raise socket.timeout(
                    f"shm recv timed out after {self._recv_timeout_s}s"
                )
            ring.set_waiting(True)
            try:
                if ring.has_frame():
                    continue
                waits.inc()
                # Adaptive bound: recheck-heavy windows
                # tighten it, quiescent ones relax it (AdaptiveRecheck).
                sock.settimeout(self._recheck.timeout_s())
                try:
                    n = sock.recv_into(mv, 1)
                except socket.timeout:
                    rechecks.inc()
                    self._recheck.record(True)
                    continue  # re-check the ring (lost-wakeup guard)
                finally:
                    sock.settimeout(None)
                if n == 0:
                    # Peer closed. Frames already in the ring are still
                    # deliverable; EOF surfaces once it drains.
                    return ring.has_frame()
                self._recheck.record(False)  # a byte ended this wait
                kind = bytes(mv)
                if kind == _DOORBELL_INLINE:
                    # Normally the inline marker is consumed from the
                    # ring before this byte is read — but the fence-less
                    # waiting-flag race can skip the WAKE byte (sender
                    # saw waiting=0) and land the inline byte on a
                    # blocked reader. The sendmsg syscall fences the
                    # sender's marker publish, so the marker must be
                    # visible by now; remember the byte is consumed and
                    # deliver through the marker path.
                    if not ring.has_frame():
                        raise wire.WireError(
                            "shm: inline byte with an empty ring"
                        )
                    self._inline_consumed = True
                    return True
                if kind != _DOORBELL_WAKE:
                    raise wire.WireError(f"Bad doorbell byte {kind!r}")
                # Stale wakeup: loop and re-check the ring.
            finally:
                ring.set_waiting(False)

    def _recv_inline_frame(self):
        """The ring said the next message rides the socket: skip stale
        wakeup bytes up to the 0x02 byte (unless _wait_for_frame already
        consumed it), then read one framed message. recv_timeout_s
        bounds these socket reads too (a peer that stalls mid-inline
        must surface as socket.timeout, keeping connect_transport's
        'bounds every receive' contract)."""
        mv = self._doorbell_mv
        if self._recv_timeout_s is not None:
            self._sock.settimeout(self._recv_timeout_s)
        try:
            while not self._inline_consumed:
                if not wire._recv_into_exact(
                    self._sock, mv, 1, eof_ok=True
                ):
                    raise wire.WireError(
                        "Connection closed before inline frame"
                    )
                kind = bytes(mv)
                if kind == _DOORBELL_INLINE:
                    break
                if kind != _DOORBELL_WAKE:
                    raise wire.WireError(f"Bad doorbell byte {kind!r}")
            self._inline_consumed = False
            value, nbytes = wire.recv_message_sized(
                self._sock, buf=self._recv_buf,
                max_frame_bytes=self._max_frame_bytes,
            )
        finally:
            if self._recv_timeout_s is not None:
                self._sock.settimeout(None)
        if value is None:
            raise wire.WireError("Connection closed mid-frame")
        return value, nbytes

    def recv_sized(self) -> Tuple[Any, int]:
        ring = self._recv_ring
        if self._pending_release:
            ring.release(self._pending_release)
            self._pending_release = 0
        if not self._wait_for_frame():
            return None, 0  # clean EOF at a frame boundary
        view, advance = ring.read_frame()
        self._pending_release = advance
        if view is None:  # inline marker: the bytes ride the socket
            return self._recv_inline_frame()
        if len(view) < 4:
            raise wire.WireError("shm ring: truncated frame header")
        (payload_len,) = struct.unpack_from("<I", view, 0)
        if payload_len != len(view) - 4:
            raise wire.WireError(
                f"shm ring: header says {payload_len}, "
                f"frame has {len(view) - 4}"
            )
        limit = wire._frame_limit(self._max_frame_bytes)
        if payload_len > limit:
            raise wire.WireError(
                f"Frame length {payload_len} exceeds max_frame_bytes "
                f"{limit}"
            )
        return wire._timed_decode(view[4:]), len(view)

    def recv(self) -> Any:
        return self.recv_sized()[0]

    @property
    def segment_names(self) -> Tuple[str, str]:
        """(send ring, recv ring) SharedMemory names — what a teardown
        sweep needs to unlink if this connection's owner is gone."""
        return self._send_ring.name, self._recv_ring.name

    def unlink_segments(self) -> None:
        """Crash sweep: unlink both ring segments regardless of which
        end owns them. The actor pool calls this on every shm
        connection teardown — a SIGKILL'd env server can't clean up its
        own segments, and for a live server the sweep only pre-empts
        the unlink its stream teardown would do anyway."""
        self._send_ring.unlink()
        self._recv_ring.unlink()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
        self._send_ring.close()
        self._recv_ring.close()


def server_transport(conn: socket.socket, shm: bool = False,
                     obs_ring_bytes: int = DEFAULT_OBS_RING_BYTES,
                     act_ring_bytes: int = DEFAULT_ACT_RING_BYTES,
                     max_frame_bytes: Optional[int] = None,
                     handshake_timeout_s: float = 30.0):
    """Wrap a server-accepted connection. For shm, creates the per-
    connection rings (server->client sized obs_ring_bytes, client->server
    act_ring_bytes), sends the handshake, and waits for the client's ack
    so segment ownership is never ambiguous."""
    if not shm:
        return SocketTransport(conn, max_frame_bytes=max_frame_bytes)
    s2c = ShmRing.create(obs_ring_bytes)
    try:
        c2s = ShmRing.create(act_ring_bytes)
    except BaseException:
        s2c.close()
        raise
    try:
        prev_timeout = conn.gettimeout()
        conn.settimeout(handshake_timeout_s)
        wire.send_message(conn, {
            "type": "shm_handshake", "version": 1,
            "s2c": s2c.name, "c2s": c2s.name,
        })
        reply = wire.recv_message(conn)
        if not isinstance(reply, dict) or reply.get("type") != "shm_ok":
            raise wire.WireError(f"Bad shm handshake ack: {reply!r}")
        conn.settimeout(prev_timeout)
    except BaseException:
        s2c.close()
        c2s.close()
        raise
    return ShmTransport(conn, send_ring=s2c, recv_ring=c2s,
                        max_frame_bytes=max_frame_bytes)


def _client_handshake(sock: socket.socket, address: str,
                      max_frame_bytes: Optional[int],
                      recv_timeout_s: Optional[float] = None):
    hs = wire.recv_message(sock)
    if not isinstance(hs, dict) or hs.get("type") != "shm_handshake":
        raise wire.WireError(
            f"Expected shm handshake from {address}, got {hs!r}"
        )
    s2c = ShmRing.attach(hs["s2c"])
    try:
        c2s = ShmRing.attach(hs["c2s"])
    except BaseException:
        s2c.close()
        raise
    try:
        wire.send_message(sock, {"type": "shm_ok"})
    except BaseException:
        s2c.close()
        c2s.close()
        raise
    return ShmTransport(sock, send_ring=c2s, recv_ring=s2c,
                        max_frame_bytes=max_frame_bytes,
                        recv_timeout_s=recv_timeout_s)


def connect_transport(address: str, timeout_s: float = 600,
                      max_frame_bytes: Optional[int] = None,
                      recv_timeout_s: Optional[float] = None):
    """Connect with retries until the deadline (the reference's 10-minute
    WaitForConnected semantics, actorpool.cc:354-372): env servers may
    still be starting up — a refused/missing socket is a reason to retry,
    not to die. Returns a SocketTransport or, for shm:// addresses, a
    fully handshaken ShmTransport. recv_timeout_s bounds every receive
    on the returned transport (spec probes: a server that accepts but
    never sends must raise socket.timeout, not hang)."""
    family, target = parse_address(address)
    deadline = time.monotonic() + timeout_s
    last_error = None
    while time.monotonic() < deadline:
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.settimeout(max(0.1, deadline - time.monotonic()))
        try:
            sock.connect(target)
        except OSError as e:
            sock.close()
            last_error = e
            time.sleep(0.1)
            continue
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # unix sockets
        if is_shm_address(address):
            try:
                transport = _client_handshake(
                    sock, address, max_frame_bytes,
                    recv_timeout_s=recv_timeout_s,
                )
            except BaseException:
                sock.close()
                raise
            sock.settimeout(None)
            return transport
        sock.settimeout(None)
        return SocketTransport(sock, max_frame_bytes=max_frame_bytes,
                               recv_timeout_s=recv_timeout_s)
    raise TimeoutError(
        f"WaitForConnected() timed out for {address}: {last_error}"
    )


def dial_transport(address: str, deadline_s: float,
                   attempt_timeout_s: float = 2.0,
                   base_s: float = 0.2, cap_s: float = 2.0,
                   rng=None, **transport_kwargs):
    """Bounded-retry dial under jittered exponential backoff (the fleet
    control plane's rendezvous discipline, fleet/coordinator.py).

    `connect_transport` already retries on a FIXED 0.1s cadence — right
    for an env server known to be coming up on the same box, wrong for
    a peer HOST that may be seconds behind in its own startup: a fleet
    of remotes hammering the lead's listen queue in lockstep is exactly
    the thundering herd `Backoff`'s jitter exists to break up. Each
    attempt gets `attempt_timeout_s`; attempts repeat under backoff
    until `deadline_s` total, then the last error surfaces as
    TimeoutError. `transport_kwargs` pass through to the per-attempt
    `connect_transport` (max_frame_bytes, recv_timeout_s).
    """
    from torchbeast_tpu_torch.resilience.backoff import Backoff, BackoffDeadline

    backoff = Backoff(
        base_s=base_s, cap_s=cap_s, deadline_s=deadline_s, rng=rng
    )
    while True:
        try:
            return connect_transport(
                address, timeout_s=attempt_timeout_s, **transport_kwargs
            )
        except (OSError, TimeoutError) as e:
            try:
                backoff.sleep()
            except BackoffDeadline:
                raise TimeoutError(
                    f"dial_transport: could not reach {address} within "
                    f"{deadline_s}s ({backoff.attempts} attempts): {e}"
                ) from e


def shm_pipe(obs_ring_bytes: int = DEFAULT_OBS_RING_BYTES,
             act_ring_bytes: int = DEFAULT_ACT_RING_BYTES,
             max_frame_bytes: Optional[int] = None):
    """In-process ShmTransport pair over a socketpair — the test/bench
    harness for the ring data plane without a listening server.
    Returns (server_end, client_end)."""
    a, b = socket.socketpair()
    try:
        s2c = ShmRing.create(obs_ring_bytes)
    except BaseException:
        a.close()
        b.close()
        raise
    try:
        c2s = ShmRing.create(act_ring_bytes)
    except BaseException:  # don't leak the first segment (/dev/shm full)
        s2c.close()
        a.close()
        b.close()
        raise
    server = ShmTransport(a, send_ring=s2c, recv_ring=c2s,
                          max_frame_bytes=max_frame_bytes)
    # The client end shares the in-process mapping (attaching by name
    # would double-book this process's resource_tracker registration);
    # only the server end unmaps/unlinks.
    client = ShmTransport(
        b,
        send_ring=ShmRing(c2s._shm, c2s.capacity, owner=False,
                          close_shm=False),
        recv_ring=ShmRing(s2c._shm, s2c.capacity, owner=False,
                          close_shm=False),
        max_frame_bytes=max_frame_bytes,
    )
    return server, client
