"""flax's msgpack checkpoint format, without flax or msgpack.

The reference writes its checkpoints with `flax.serialization`
(`msgpack_serialize`, `to_bytes`), which loads jax; the port writes and
reads the same bytes with this module alone, so a checkpoint of either
package resumes in the other.

The codec covers what flax writes:

- maps (str keys), arrays (lists and tuples), nil, bool, int, float
  (float64), str and bin, each in the smallest msgpack form, as
  msgpack-python packs them;
- ext 1: an ndarray, packed as the msgpack array (shape, dtype name, raw
  C-order bytes); ext 3: a numpy scalar, packed the same way.

Leaves may be numpy arrays, numpy scalars or torch tensors (written as
ext 1 with their dtype's numpy name). numpy has no bfloat16 of its own,
so a "bfloat16" leaf decodes to a torch.bfloat16 tensor: its raw bytes
are read as 16-bit integers and viewed as bfloat16, bit for bit, and
written back the same way. flax splits a leaf over 1 GiB into chunks;
such a leaf, and any other ext code, raises.

`to_state_dict` and `msgpack_serialize`/`msgpack_restore` follow flax's
functions of the same names: lists and tuples become {"0": ...} maps, and
the outer serialize orders every map's keys as jax's tree_map does
(sorted), so the bytes match flax's.
"""

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

_TORCH_DTYPE_NAMES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}


class CheckpointFormatError(ValueError):
    """Bytes outside the subset of msgpack that flax checkpoints use."""


# ------------------------------------------------------------- encoding


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"),
                                 (1 << 64, 0xCF, ">Q")):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"),
                                 (1 << 63, 0xD3, ">q")):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              codes) -> None:
    """A length header: the fix form below fix_max, else 8/16/32-bit
    (codes[0] may be None where the type has no 8-bit form)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for limit, code, fmt in zip((1 << 8, 1 << 16, 1 << 32), codes,
                                (">B", ">H", ">I")):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack's 32 bits")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _array_bytes(leaf) -> bytes:
    """flax's _ndarray_to_bytes: msgpack (shape, dtype name, raw bytes)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype not in _TORCH_DTYPE_NAMES:
            raise TypeError(f"no checkpoint dtype for {t.dtype}")
        name = _TORCH_DTYPE_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        shape, raw = tuple(t.shape), t.numpy().tobytes()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise TypeError(f"no checkpoint dtype for {arr.dtype}")
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    return packb([list(shape), name, raw])


def _pack(out: bytearray, obj: Any) -> None:
    kind = type(obj)
    if obj is None:
        out.append(0xC0)
    elif kind is bool:
        out.append(0xC3 if obj else 0xC2)
    elif kind is int:
        _pack_int(out, obj)
    elif kind is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif kind is str:
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif kind in (bytes, bytearray, memoryview):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif kind in (list, tuple):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif kind is dict:
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_bytes(np.asarray(obj)))
    elif isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        _pack_ext(out, EXT_NDARRAY, _array_bytes(obj))
    else:
        raise TypeError(f"cannot write {kind.__name__} to a checkpoint")


def packb(obj: Any) -> bytes:
    """One msgpack object."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# ------------------------------------------------------------- decoding


def _array_from_bytes(data: bytes):
    shape, name, raw = unpackb(data, raw_str=True)
    name = name.decode("ascii") if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(raw), dtype=torch.int16)
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    def __init__(self, data: bytes, raw_str: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise CheckpointFormatError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = self.take(n)
        return raw if self.raw_str else raw.decode("utf-8")

    def array(self, n: int):
        return [self.read() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_bytes(data)
            return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
        raise CheckpointFormatError(
            f"msgpack ext code {code} is not one that flax checkpoints use "
            f"(ndarray {EXT_NDARRAY}, numpy scalar {EXT_NPSCALAR})")

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return self.take(self.unpack(lengths[b]))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H",
                                         0xC9: ">I"}[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H",
                                          0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise CheckpointFormatError(f"msgpack type byte 0x{b:02x} is not "
                                    "one that flax checkpoints use")


def unpackb(data: bytes, raw_str: bool = False) -> Any:
    """One msgpack object; extra bytes after it raise."""
    reader = _Reader(data, raw_str)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise CheckpointFormatError(
            f"{len(reader.data) - reader.pos} bytes after the msgpack object")
    return out


# ----------------------------------------------- flax's tree functions


def to_state_dict(tree: Any) -> Any:
    """flax.serialization.to_state_dict over dicts, lists and tuples:
    str keys, sequences as {"0": ...} maps; other values are leaves."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def _sorted(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """flax.serialization.msgpack_serialize (not in place): maps in
    sorted key order."""
    return packb(_sorted(tree))


def to_bytes(tree: Any) -> bytes:
    """flax.serialization.to_bytes of a nested dict/list/tuple tree: its
    state dict in the tree's own key order."""
    return packb(to_state_dict(tree))


def _check_unchunked(tree: Any, path=()) -> None:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            raise CheckpointFormatError(
                f"leaf {'/'.join(path) or '.'} is chunked (flax's form for a "
                "leaf over 1 GiB), which this codec does not read")
        for k, v in tree.items():
            _check_unchunked(v, path + (str(k),))


def msgpack_restore(data: bytes) -> Any:
    """flax.serialization.msgpack_restore: the tree, numpy leaves (and
    torch.bfloat16 tensors for bfloat16 leaves)."""
    tree = unpackb(data)
    _check_unchunked(tree)
    return tree


# ------------------------------------------------ numpy <-> tensors


def to_tensors(tree: Any) -> Any:
    """Every array leaf of a nested dict as a tensor (a copy, writable)."""
    if isinstance(tree, dict):
        return {k: to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if torch.is_tensor(tree):
        return tree.clone()
    return tree


def to_numpy(tree: Any) -> Any:
    """Every tensor leaf of a nested dict as a numpy array on the host;
    bfloat16 tensors widen to float32 (exactly), since numpy has no
    bfloat16."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree
