"""The msgpack subset of flax checkpoints, read and written in pure Python.

``flax.serialization.to_bytes`` writes a state dict as msgpack: maps with
str keys, and each numpy array as ext type 1 whose payload is itself the
msgpack triple (shape, dtype name, C-order bytes) (flax 0.12.3's
``_ndarray_to_bytes``).  ``dumps`` writes that subset byte for byte as
flax does for the same tree (maps in their dict order); ``loads`` reads
it back, so the port's CLIs read the JAX package's ``final.msgpack`` and
the JAX package reads the port's, with neither ``flax`` nor ``msgpack``
installed.  Only that subset: maps, arrays, str, bin, non-negative ints
(an array's shape) and ext type 1; arrays flax splits into chunks (above
1 GiB) are not read.
"""

import struct

import numpy as np

__all__ = ["dumps", "loads"]

_NDARRAY = 1       # flax's _MsgpackExtType.ndarray
# (fix-format base, its exclusive limit) and the sized codes of each kind
_HEADS = {"map": ((0x80, 16), ((0xde, ">H"), (0xdf, ">I"))),
          "array": ((0x90, 16), ((0xdc, ">H"), (0xdd, ">I"))),
          "str": ((0xa0, 32), ((0xd9, ">B"), (0xda, ">H"), (0xdb, ">I"))),
          "bin": (None, ((0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I"))),
          "ext": (None, ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I"))),
          "uint": ((0x00, 0x80), ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                                  (0xcf, ">Q")))}
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _head(out, kind, value):
    """The shortest header of ``kind`` for ``value`` (a length or an int)."""
    fix, sized = _HEADS[kind]
    if fix is not None and 0 <= value < fix[1]:
        out.append(fix[0] | value)
        return
    for code, fmt in sized:
        if 0 <= value < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, value)
            return
    raise ValueError(f"msgpack: {kind} {value} out of range")


def _pack(out, obj):
    if isinstance(obj, dict):
        _head(out, "map", len(obj))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise TypeError(f"msgpack: map key {key!r} is not a str")
            _pack(out, key)
            _pack(out, value)
    elif isinstance(obj, str):
        data = obj.encode()
        _head(out, "str", len(data))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, "bin", len(obj))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, "array", len(obj))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _head(out, "uint", obj)
    elif isinstance(obj, np.ndarray):
        payload = bytearray()
        _pack(payload, (tuple(int(n) for n in obj.shape), obj.dtype.name,
                        obj.tobytes("C")))
        if len(payload) in _FIXEXT:
            out.append(_FIXEXT[len(payload)])
        else:
            _head(out, "ext", len(payload))
        out.append(_NDARRAY)
        out += payload
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def dumps(tree) -> bytes:
    """A tree of str-keyed dicts with numpy array leaves -> flax's bytes."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# the type byte of each sized kind, for reading
_SIZED = {code: (kind, fmt) for kind, (_, sized) in _HEADS.items()
          for code, fmt in sized}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        code = self.unpack(">B")
        if code < 0x80:
            return code
        if code < 0xc0:
            kind, n = ("map", "array", "str", "str")[(code - 0x80) >> 4], \
                code & (0x1f if code >= 0xa0 else 0x0f)
        elif code in _SIZED:
            kind, fmt = _SIZED[code]
            n = self.unpack(fmt)
            if kind == "uint":
                return n
        elif code in _FIXEXT.values():
            kind = "ext"
            n = next(k for k, v in _FIXEXT.items() if v == code)
        else:
            raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")
        if kind == "map":
            return {self.read(): self.read() for _ in range(n)}
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        ext = self.unpack(">b")
        if ext != _NDARRAY:
            raise ValueError(f"msgpack: unsupported ext type {ext}")
        shape, dtype, data = _Reader(self.take(n)).read()
        return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(
            shape).copy()


def loads(data: bytes):
    """flax's bytes -> a tree of dicts with numpy array leaves."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes")
    return tree
