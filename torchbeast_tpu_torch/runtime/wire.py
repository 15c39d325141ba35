"""Wire protocol: framed binary nest-of-arrays messages over sockets.

Plays the role of the reference's proto2 `ArrayNest`/`Step`/`Action` messages
over gRPC bidi streams (torchbeast's src/proto/rpcenv.proto:21-48,
nest_serialize.h:22-69). This image has no C++ gRPC, so the transport is a
deliberately simple length-prefixed framing that is trivial to implement
identically in C++ (csrc/wire.h) and Python — no IDL, no codegen, zero-copy
reads on the receiving side where possible.

Frame:   [u32le payload_length][payload]
Payload (recursive value encoding, little-endian):
  0x01 ARRAY  : u8 dtype_code, u8 ndim, ndim * i64 shape, C-order raw bytes
  0x02 LIST   : u32 count, then count values
  0x03 DICT   : u32 count, then count * (u16 keylen, utf8 key, value)
  0x04 NONE
  0x05 INT    : i64
  0x06 FLOAT  : f64
  0x07 BOOL   : u8
  0x08 STRING : u32 len, utf8 bytes

Arrays are always serialized C-contiguous (the reference had a regression
around non-contiguous numpy arrays, rpcenv.cc:166-170 /
tests/contiguous_arrays_test.py — here np.ascontiguousarray normalizes on
encode, and the property is pinned by tests/test_wire.py).

Zero-copy hot path: the legacy `encode()` paid 3-4 full host
copies per message (BytesIO growth + `arr.tobytes()` + frame assembly +
`sendall`'s kernel copy). The scatter-gather path replaces all of that:

- `encode_into(value, SendBuffer)` writes every scalar/structural byte
  into one reusable per-connection bytearray (sized on the fly: scratch
  segments are tracked as offsets, so grow-on-demand never invalidates
  them, and the length header is patched last) and emits a list of
  memoryviews in which large array payloads are referenced *directly
  from the numpy buffer*. `send_message(sock, value, buf=...)` hands
  that list to `socket.sendmsg`, so array bytes go numpy -> kernel with
  zero intermediate copies. The frame bytes on the wire are
  bit-identical to `encode_legacy()` (pinned by tests/test_wire.py
  fuzz).
- `recv_message_sized(sock, buf=RecvBuffer())` reads header and payload
  with `recv_into` into a grow-only per-connection buffer: steady-state
  per-step receives do zero payload-sized allocations (no chunk lists,
  no `b"".join`).

BUFFER-REUSE LIFETIME: with a `RecvBuffer`, decoded nests are zero-copy
views into the buffer, and the *next* `recv_message_sized` on the same
buffer overwrites them. The caller must consume (copy out of) a decoded
nest before receiving the next message — ActorPool copies env outputs
into its rollout storage per step for exactly this reason. Symmetrically,
the memoryviews returned by `encode_into` alias `SendBuffer.scratch` and
the source arrays: send them before the next `encode_into` on the same
buffer and do not mutate the arrays until the send completes.

Frames are bounded by `max_frame_bytes` (default 256 MiB): a corrupt
4-byte header must surface as WireError, not as a multi-GiB allocation
(mirrored in csrc/wire.h's kMaxFrameBytes).

The port's copy of torchbeast_tpu/runtime/wire.py, without the policy
snapshot frame (tag 0x09, PolicySnapshot): only the fleet's control
plane sends it (ROADMAP.md Queue 1 item 'the fleet'),
so the port refuses it as an unknown tag. Every frame of actor and env-server
traffic is the reference's byte for byte.
"""

# beastlint: hot-module — the codec runs per message on the acting path.

import io
import socket
import struct
import time
from typing import Any, List, Optional, Tuple

import numpy as np

TAG_ARRAY = 0x01
TAG_LIST = 0x02
TAG_DICT = 0x03
TAG_NONE = 0x04
TAG_INT = 0x05
TAG_FLOAT = 0x06
TAG_BOOL = 0x07
TAG_STRING = 0x08

# Reject frames whose header demands more than this before allocating
# (csrc/wire.h kMaxFrameBytes must match).
DEFAULT_MAX_FRAME_BYTES = 256 * 1024 * 1024

# Arrays at least this big ride their own sendmsg iovec straight from the
# numpy buffer; smaller ones are cheaper to copy into the scratch segment
# than to pay a separate iovec entry for.
_GATHER_MIN_BYTES = 1024

# Stay under typical IOV_MAX (1024): messages with absurd array counts
# fall back to a single joined send.
_IOV_MAX = 512

# Stable dtype codes shared with the C++ implementation (csrc/array.h).
_DTYPE_CODES = {
    np.dtype(np.uint8): 0,
    np.dtype(np.int8): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.float32): 4,
    np.dtype(np.float64): 5,
    np.dtype(np.bool_): 6,
    np.dtype(np.uint16): 7,
    np.dtype(np.int16): 8,
    np.dtype(np.uint32): 9,
    np.dtype(np.uint64): 10,
    np.dtype(np.float16): 11,
}

# bfloat16 (code 12): TPU-native models emit bf16 outputs; without the
# wire code they had to be upcast host-side before encoding. numpy has no
# native bf16 — ml_dtypes (a jax dependency) provides it; decoding a
# code-12 array without ml_dtypes installed fails as WireError ("Unknown
# dtype code"), the standard teardown path.
try:
    from ml_dtypes import bfloat16 as _bfloat16

    _DTYPE_CODES[np.dtype(_bfloat16)] = 12
except ImportError:  # pragma: no cover - ml_dtypes ships with jax here
    _bfloat16 = None

_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


class WireError(Exception):
    pass


# wire.encode_s / wire.decode_s histograms: resolved
# lazily so importing wire never drags telemetry in at module-import time
# (and so --no_telemetry runs get the registry's no-op instruments).
_tm_encode = None
_tm_decode = None


def _instruments():
    global _tm_encode, _tm_decode
    if _tm_encode is None:
        from torchbeast_tpu_torch import telemetry

        reg = telemetry.get_registry()
        # beastlint: disable=RACE  benign double-init: the registry's get-or-create is idempotent, so racing encoder threads store the SAME instrument object; each store is GIL-atomic
        _tm_encode = reg.histogram("wire.encode_s")
        # beastlint: disable=RACE  same idempotent lazy-init as _tm_encode above
        _tm_decode = reg.histogram("wire.decode_s")
    return _tm_encode, _tm_decode


def _encode_value(buf: io.BytesIO, value: Any) -> None:
    if value is None:
        buf.write(bytes([TAG_NONE]))
    elif isinstance(value, bool) or isinstance(value, np.bool_):
        buf.write(bytes([TAG_BOOL]))
        buf.write(struct.pack("<B", 1 if value else 0))
    elif isinstance(value, (int, np.integer)) and not isinstance(
        value, np.ndarray
    ):
        buf.write(bytes([TAG_INT]))
        buf.write(struct.pack("<q", int(value)))
    elif isinstance(value, (float, np.floating)):
        buf.write(bytes([TAG_FLOAT]))
        buf.write(struct.pack("<d", float(value)))
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        buf.write(bytes([TAG_STRING]))
        buf.write(struct.pack("<I", len(raw)))
        buf.write(raw)
    elif isinstance(value, np.ndarray):
        # NB: np.ascontiguousarray promotes 0-d to 1-d, so only normalize
        # when actually needed (0-d arrays are always contiguous).
        arr = value
        if not arr.flags["C_CONTIGUOUS"]:
            arr = np.ascontiguousarray(arr)
        code = _DTYPE_CODES.get(arr.dtype)
        if code is None:
            raise WireError(f"Unsupported array dtype {arr.dtype}")
        buf.write(bytes([TAG_ARRAY]))
        buf.write(struct.pack("<BB", code, arr.ndim))
        buf.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
        buf.write(arr.tobytes())
    elif isinstance(value, (list, tuple)):
        buf.write(bytes([TAG_LIST]))
        buf.write(struct.pack("<I", len(value)))
        for v in value:
            _encode_value(buf, v)
    elif isinstance(value, dict):
        buf.write(bytes([TAG_DICT]))
        buf.write(struct.pack("<I", len(value)))
        for k, v in value.items():
            raw = str(k).encode("utf-8")
            buf.write(struct.pack("<H", len(raw)))
            buf.write(raw)
            _encode_value(buf, v)
    else:
        raise WireError(f"Cannot serialize {type(value)!r}")


class SendBuffer:
    """Reusable per-connection scatter-gather encode state: one grow-only
    bytearray holding the frame header plus all scalar/structural bytes.
    Steady state (message sizes stabilized) performs zero allocations
    beyond the returned memoryview objects."""

    __slots__ = ("scratch",)

    def __init__(self, initial_bytes: int = 8192):
        self.scratch = bytearray(max(int(initial_bytes), 64))


class _Encoder:
    """Single-pass scatter-gather writer. Scratch segments are recorded
    as (start, end) OFFSETS — not memoryviews — so mid-encode growth
    (fresh bytearray + content copy) cannot invalidate them; the iovec
    list materializes once, at the end, against the final buffer. The
    frame-length header is patched last (the sizing pass this replaces
    cost as much as the writing pass on small-leaf messages)."""

    __slots__ = ("scratch", "pos", "seg_start", "parts", "gathered")

    def __init__(self, scratch: bytearray):
        self.scratch = scratch
        self.pos = 0
        self.seg_start = 0
        # (start, end) offset pairs into scratch, interleaved (in frame
        # order) with direct array memoryviews.
        self.parts: List[Any] = []
        self.gathered = 0  # total bytes riding direct array views

    def need(self, n: int):
        if self.pos + n > len(self.scratch):
            grown = bytearray(max(self.pos + n, 2 * len(self.scratch)))
            grown[: self.pos] = self.scratch[: self.pos]
            self.scratch = grown

    def flush(self):
        if self.pos > self.seg_start:
            self.parts.append((self.seg_start, self.pos))
            self.seg_start = self.pos

    def gather(self, view: memoryview):
        """Append an out-of-scratch segment (a direct array view)."""
        self.flush()
        self.parts.append(view)
        self.gathered += view.nbytes


def _byte_view(arr: np.ndarray) -> memoryview:
    """Flat byte view of a C-contiguous array. User dtypes (bfloat16)
    don't export the buffer protocol — reinterpret as uint8 (a view, not
    a copy) for those."""
    try:
        return memoryview(arr).cast("B")
    except (ValueError, TypeError, BufferError):
        return memoryview(arr.view(np.uint8).reshape(-1))


def _write_array(enc: _Encoder, value: np.ndarray) -> None:
    arr = value
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise WireError(f"Unsupported array dtype {arr.dtype}")
    ndim = arr.ndim
    nbytes = arr.nbytes
    gathering = nbytes >= _GATHER_MIN_BYTES
    enc.need(3 + 8 * ndim + (0 if gathering else nbytes))
    s = enc.scratch
    pos = enc.pos
    s[pos] = TAG_ARRAY
    s[pos + 1] = code
    s[pos + 2] = ndim
    pos += 3
    if ndim:
        struct.pack_into(f"<{ndim}q", s, pos, *arr.shape)
        pos += 8 * ndim
    if gathering:
        enc.pos = pos
        # memoryview keeps `arr` (and thus any ascontiguousarray
        # temporary) alive until the send consumes the view.
        enc.gather(_byte_view(arr))
    else:
        s[pos : pos + nbytes] = (
            _byte_view(arr) if ndim else arr.tobytes()
        )
        enc.pos = pos + nbytes


def _write_str(enc: _Encoder, value: str) -> None:
    raw = value.encode("utf-8")
    enc.need(5 + len(raw))
    s = enc.scratch
    pos = enc.pos
    s[pos] = TAG_STRING
    struct.pack_into("<I", s, pos + 1, len(raw))
    s[pos + 5 : pos + 5 + len(raw)] = raw
    enc.pos = pos + 5 + len(raw)


def _write_bool(enc: _Encoder, value) -> None:
    enc.need(2)
    s = enc.scratch
    pos = enc.pos
    s[pos] = TAG_BOOL
    s[pos + 1] = 1 if value else 0
    enc.pos = pos + 2


def _write_int(enc: _Encoder, value) -> None:
    enc.need(9)
    pos = enc.pos
    enc.scratch[pos] = TAG_INT
    struct.pack_into("<q", enc.scratch, pos + 1, int(value))
    enc.pos = pos + 9


def _write_float(enc: _Encoder, value) -> None:
    enc.need(9)
    pos = enc.pos
    enc.scratch[pos] = TAG_FLOAT
    struct.pack_into("<d", enc.scratch, pos + 1, float(value))
    enc.pos = pos + 9


def _write_dict(enc: _Encoder, value: dict) -> None:
    enc.need(5)
    s = enc.scratch
    pos = enc.pos
    s[pos] = TAG_DICT
    struct.pack_into("<I", s, pos + 1, len(value))
    enc.pos = pos + 5
    for k, v in value.items():
        raw = str(k).encode("utf-8")
        enc.need(2 + len(raw))
        s = enc.scratch
        pos = enc.pos
        struct.pack_into("<H", s, pos, len(raw))
        s[pos + 2 : pos + 2 + len(raw)] = raw
        enc.pos = pos + 2 + len(raw)
        _write_value(enc, v)


def _write_list(enc: _Encoder, value) -> None:
    enc.need(5)
    pos = enc.pos
    enc.scratch[pos] = TAG_LIST
    struct.pack_into("<I", enc.scratch, pos + 1, len(value))
    enc.pos = pos + 5
    for v in value:
        _write_value(enc, v)


def _write_value(enc: _Encoder, value: Any) -> None:
    # Exact-type dispatch first (isinstance chains dominated the encode
    # profile); numpy scalars and subclasses fall through to an
    # isinstance chain ordered exactly like the legacy _encode_value so
    # semantics can't drift (pinned by test_encode_matches_legacy_fuzz).
    t = type(value)
    if t is np.ndarray:
        _write_array(enc, value)
    elif t is dict:
        _write_dict(enc, value)
    elif t is str:
        _write_str(enc, value)
    elif t is bool:
        _write_bool(enc, value)
    elif t is int:
        _write_int(enc, value)
    elif t is float:
        _write_float(enc, value)
    elif value is None:
        enc.need(1)
        enc.scratch[enc.pos] = TAG_NONE
        enc.pos += 1
    elif t is list or t is tuple:
        _write_list(enc, value)
    elif isinstance(value, (bool, np.bool_)):
        _write_bool(enc, value)
    elif isinstance(value, (int, np.integer)) and not isinstance(
        value, np.ndarray
    ):
        _write_int(enc, value)
    elif isinstance(value, (float, np.floating)):
        _write_float(enc, value)
    elif isinstance(value, str):
        _write_str(enc, value)
    elif isinstance(value, np.ndarray):
        _write_array(enc, value)
    elif isinstance(value, (list, tuple)):
        _write_list(enc, value)
    elif isinstance(value, dict):
        _write_dict(enc, value)
    else:
        raise WireError(f"Cannot serialize {type(value)!r}")


def encode_into(value: Any, buf: SendBuffer) -> Tuple[List[memoryview], int]:
    """Scatter-gather encode: (iovec list, framed byte count). The first
    view starts with the u32 frame header; concatenated, the views are
    bit-identical to `encode_legacy(value)`. Single pass: scalar bytes
    land in buf.scratch (grow-only; growth allocates fresh so previous
    messages' outstanding views stay alive), large array payloads become
    direct views of the numpy buffers, and the length header is patched
    at the end. See the module docstring for lifetime rules."""
    enc = _Encoder(buf.scratch)
    enc.pos = 4  # leave room for the u32 frame header
    _write_value(enc, value)
    enc.flush()
    buf.scratch = enc.scratch  # may have grown
    payload_len = (enc.pos - 4) + enc.gathered
    if payload_len > 0xFFFFFFFF:
        raise WireError(f"Message too large for u32 framing: {payload_len}")
    struct.pack_into("<I", enc.scratch, 0, payload_len)
    mv = memoryview(enc.scratch)
    views = [
        mv[part[0] : part[1]] if type(part) is tuple else part
        for part in enc.parts
    ]
    return views, 4 + payload_len


def encode(value: Any) -> bytes:
    """Value -> framed message bytes (length prefix included)."""
    views, _ = encode_into(value, SendBuffer(initial_bytes=256))
    return b"".join(views)


def encode_legacy(value: Any) -> bytes:
    """The original copy-heavy encoder (BytesIO growth + tobytes).
    Kept as the format pin — tests assert encode()/encode_into() match it
    byte-for-byte — and as the baseline leg of benchmarks/wire_bench.py."""
    buf = io.BytesIO()
    _encode_value(buf, value)
    payload = buf.getvalue()
    return struct.pack("<I", len(payload)) + payload


def _decode_value(view: memoryview, offset: int):
    tag = view[offset]
    offset += 1
    if tag == TAG_NONE:
        return None, offset
    if tag == TAG_BOOL:
        return bool(view[offset]), offset + 1
    if tag == TAG_INT:
        (v,) = struct.unpack_from("<q", view, offset)
        return v, offset + 8
    if tag == TAG_FLOAT:
        (v,) = struct.unpack_from("<d", view, offset)
        return v, offset + 8
    if tag == TAG_STRING:
        (n,) = struct.unpack_from("<I", view, offset)
        offset += 4
        return bytes(view[offset : offset + n]).decode("utf-8"), offset + n
    if tag == TAG_ARRAY:
        code, ndim = struct.unpack_from("<BB", view, offset)
        offset += 2
        shape = struct.unpack_from(f"<{ndim}q", view, offset)
        offset += 8 * ndim
        dtype = _CODE_DTYPES.get(code)
        if dtype is None:
            raise WireError(f"Unknown dtype code {code}")
        # Untrusted dims off the socket: reject negatives, and bound the
        # byte count by the remaining payload before multiplying so a
        # wrapping product can't pass (mirrors csrc/wire.h). Any zero dim
        # makes the whole array empty regardless of the other dims.
        if any(d < 0 for d in shape):
            raise WireError(f"Negative array dim in {shape}")
        if 0 in shape:
            nbytes = 0
        else:
            remaining = len(view) - offset
            nbytes = dtype.itemsize
            for d in shape:
                if nbytes > remaining // d:
                    raise WireError("Array size exceeds payload")
                nbytes *= d
        arr = np.frombuffer(
            view[offset : offset + nbytes], dtype=dtype
        ).reshape(shape)
        return arr, offset + nbytes
    if tag == TAG_LIST:
        (n,) = struct.unpack_from("<I", view, offset)
        offset += 4
        out = []
        for _ in range(n):
            v, offset = _decode_value(view, offset)
            out.append(v)
        return out, offset
    if tag == TAG_DICT:
        (n,) = struct.unpack_from("<I", view, offset)
        offset += 4
        out = {}
        for _ in range(n):
            (klen,) = struct.unpack_from("<H", view, offset)
            offset += 2
            key = bytes(view[offset : offset + klen]).decode("utf-8")
            offset += klen
            v, offset = _decode_value(view, offset)
            out[key] = v
        return out, offset
    raise WireError(f"Unknown tag {tag:#x}")


def decode(payload) -> Any:
    """Payload bytes (no length prefix) -> value. Arrays are zero-copy
    views into `payload` (read-only). Accepts bytes or a memoryview (the
    RecvBuffer path passes a read-only view of the reusable buffer).

    Every malformed-frame failure surfaces as WireError: the actor/server
    recovery paths catch WireError to tear down one connection, so a
    corrupt frame must never escape as struct.error/ValueError and kill
    the whole thread instead.
    """
    try:
        value, offset = _decode_value(memoryview(payload), 0)
    except WireError:
        raise
    except (struct.error, ValueError, IndexError, UnicodeDecodeError,
            OverflowError) as e:
        raise WireError(f"Malformed frame: {e}") from e
    if offset != len(payload):
        raise WireError(
            f"Trailing garbage: decoded {offset} of {len(payload)} bytes"
        )
    return value


def _sendmsg_all(sock: socket.socket, views: List[memoryview],
                 total: int) -> None:
    """sendmsg the full iovec list, looping on partial sends. A single
    view goes through sendall directly (same zero-copy, and plain send
    is measurably cheaper than sendmsg under syscall emulation)."""
    if len(views) == 1:
        sock.sendall(views[0])
        return
    if len(views) > _IOV_MAX:
        sock.sendall(b"".join(views))
        return
    sent = sock.sendmsg(views)
    while sent < total:
        total -= sent
        rest: List[memoryview] = []
        for v in views:
            if not rest:
                n = len(v)
                if sent >= n:
                    sent -= n
                    continue
                rest.append(v[sent:] if sent else v)
                sent = 0
            else:
                rest.append(v)
        views = rest
        sent = sock.sendmsg(views)


def _timed_encode_into(value: Any, buf: SendBuffer):
    """encode_into + the wire.encode_s histogram (shared by the socket
    and shm transports so the instrumentation can't diverge)."""
    enc_h, _ = _instruments()
    t0 = time.perf_counter()
    out = encode_into(value, buf)
    enc_h.observe(time.perf_counter() - t0)
    return out


def _timed_decode(payload) -> Any:
    """decode + the wire.decode_s histogram (shared across transports)."""
    _, dec_h = _instruments()
    t0 = time.perf_counter()
    value = decode(payload)
    dec_h.observe(time.perf_counter() - t0)
    return value


def _frame_limit(max_frame_bytes: Optional[int]) -> int:
    return (
        DEFAULT_MAX_FRAME_BYTES if max_frame_bytes is None
        else int(max_frame_bytes)
    )


def send_message(sock: socket.socket, value: Any,
                 buf: Optional[SendBuffer] = None) -> int:
    """Send one framed message; returns the framed byte count (header
    included) so callers can feed wire-byte telemetry counters.

    With a per-connection SendBuffer, large array payloads are handed to
    socket.sendmsg directly from the numpy buffers (zero host copies);
    without one, falls back to a joined sendall."""
    if buf is None:
        enc_h, _ = _instruments()
        t0 = time.perf_counter()
        frame = encode(value)
        enc_h.observe(time.perf_counter() - t0)
        sock.sendall(frame)
        return len(frame)
    views, total = _timed_encode_into(value, buf)
    _sendmsg_all(sock, views, total)
    return total


def recv_message(sock: socket.socket) -> Optional[Any]:
    """Read one framed message; None on clean EOF at a frame boundary."""
    return recv_message_sized(sock)[0]


def recv_message_sized(sock: socket.socket, buf: "Optional[RecvBuffer]" = None,
                       max_frame_bytes: Optional[int] = None):
    """(value, framed byte count) — (None, 0) on clean EOF. The sized
    variant exists for per-connection byte accounting (telemetry
    wire.bytes_* counters) without re-encoding the message.

    With a per-connection RecvBuffer, header and payload are read via
    recv_into into the reusable buffer (zero steady-state allocations);
    the decoded nest is a view into it and must be consumed before the
    next recv on the same buffer. Frames longer than max_frame_bytes
    (default DEFAULT_MAX_FRAME_BYTES) raise WireError before any payload
    allocation."""
    limit = _frame_limit(max_frame_bytes)
    if buf is None:
        header = _recv_exact(sock, 4)
        if header is None:
            return None, 0
        (length,) = struct.unpack("<I", header)
        if length > limit:
            raise WireError(
                f"Frame length {length} exceeds max_frame_bytes {limit}"
            )
        payload = _recv_exact(sock, length)
        if payload is None:
            raise WireError("Connection closed mid-frame")
        return _timed_decode(payload), 4 + length
    mv = buf.view(4)
    if not _recv_into_exact(sock, mv, 4, eof_ok=True):
        return None, 0
    (length,) = struct.unpack_from("<I", mv, 0)
    if length > limit:
        raise WireError(
            f"Frame length {length} exceeds max_frame_bytes {limit}"
        )
    mv = buf.view(length)  # may swap buffers; the header is already parsed
    _recv_into_exact(sock, mv, length, eof_ok=False)
    return _timed_decode(mv[:length].toreadonly()), 4 + length


class RecvBuffer:
    """Grow-only per-connection receive buffer for recv_message_sized.

    Steady state does zero allocations: the bytearray grows to the
    largest frame seen and is reused for every subsequent receive.
    LIFETIME: a nest decoded from this buffer aliases it — consume or
    copy it before the next recv into the same buffer (growth allocates
    a fresh bytearray, so views from the message that *caused* growth
    stay valid; same-size successors overwrite)."""

    __slots__ = ("_buf", "_mv")

    def __init__(self, initial_bytes: int = 65536):
        self._buf = bytearray(max(int(initial_bytes), 4096))
        self._mv = memoryview(self._buf)

    @property
    def capacity(self) -> int:
        return len(self._buf)

    def view(self, n: int) -> memoryview:
        """A writable view of at least n bytes, growing if needed."""
        if len(self._buf) < n:
            self._mv.release()
            # Fresh allocation, not resize: decoded views from previous
            # frames keep the old bytearray alive independently.
            self._buf = bytearray(max(n, 2 * len(self._buf)))
            self._mv = memoryview(self._buf)
        return self._mv


def _recv_into_exact(sock: socket.socket, mv: memoryview, n: int,
                     eof_ok: bool) -> bool:
    """Fill mv[:n] from the socket. False on clean EOF before any byte
    (only when eof_ok); WireError on EOF mid-read."""
    got = 0
    while got < n:
        r = sock.recv_into(mv[got:n])
        if r == 0:
            if got == 0 and eof_ok:
                return False
            raise WireError("Connection closed mid-frame")
        got += r
    return True


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes. None on clean EOF before any byte; WireError
    on EOF mid-read."""
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(remaining)
        if not chunk:
            if remaining == n:
                return None
            raise WireError("Connection closed mid-frame")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)
