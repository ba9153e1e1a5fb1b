"""The "exraw" self-contained binary archive format.

Byte-compatible with the reference's dependent-free codec
(reference scripts/sptk/libs/exraw.py:13-64): records are
``<key> <dtype-char><v|m><int32 dims...><raw bytes>`` where dtype-char is
one of f/d/i/q.

The port's own copy of setk_tpu/io/exraw.py (numpy only).
"""

import struct

import numpy as np

__all__ = ["serialize", "deserialize", "read_exraw", "parse_exraw_scp"]

_DTYPE_CHAR = {
    np.dtype(np.float32): b"f",
    np.dtype(np.float64): b"d",
    np.dtype(np.int32): b"i",
    np.dtype(np.int64): b"q",
}
_CHAR_DTYPE = {
    b"f": np.float32,
    b"d": np.float64,
    b"i": np.int32,
    b"q": np.int64,
}


def serialize(fd, arr: np.ndarray):
    if arr.dtype not in _DTYPE_CHAR:
        raise TypeError(f"Unsupported dtype: {arr.dtype}")
    if arr.ndim > 2:
        raise RuntimeError(f"Accept only 1/2D ndarray, got {arr.ndim}")
    fd.write(_DTYPE_CHAR[arr.dtype])
    if arr.ndim == 1:
        fd.write(b"v")
        fd.write(struct.pack("<i", arr.size))
    else:
        fd.write(b"m")
        fd.write(struct.pack("<ii", *arr.shape))
    fd.write(np.ascontiguousarray(arr).tobytes())


def deserialize(fd, addr=None) -> np.ndarray:
    if addr is not None:
        fd.seek(addr)
    dchar = fd.read(1)
    if dchar not in _CHAR_DTYPE:
        raise TypeError(f"Unsupported dtype flag: {dchar}")
    dtype = np.dtype(_CHAR_DTYPE[dchar])
    atype = fd.read(1)
    if atype == b"v":
        dim = struct.unpack("<i", fd.read(4))[0]
        return np.frombuffer(fd.read(dim * dtype.itemsize), dtype=dtype)
    if atype == b"m":
        rows, cols = struct.unpack("<ii", fd.read(8))
        data = fd.read(rows * cols * dtype.itemsize)
        return np.frombuffer(data, dtype=dtype).reshape(rows, cols)
    raise TypeError(f"Unsupported array flag: {atype}")


def _read_key(fd):
    chars = []
    while True:
        c = fd.read(1)
        if c in (b" ", b""):
            break
        chars.append(c)
    return b"".join(chars).decode() if chars else None


def read_exraw(fd):
    """Yield (key, ndarray) over a sequential exraw stream."""
    while True:
        key = _read_key(fd)
        if not key:
            break
        yield key, deserialize(fd)


def parse_exraw_scp(scp_path):
    """Parse ``key\\tpath:offset`` index lines -> {key: (path, offset)}."""
    index = {}
    with open(scp_path) as f:
        for lineno, raw in enumerate(f, 1):
            toks = raw.strip().split()
            if len(toks) != 2:
                raise RuntimeError(
                    f"Format error in {scp_path}:{lineno}: {raw}")
            key, value = toks
            obj, _, shift = value.rpartition(":")
            if not obj:
                raise RuntimeError(
                    f"Value format error in {scp_path}:{lineno}: {raw}")
            if key in index:
                raise ValueError(f"Duplicated key '{key}' in {scp_path}")
            index[key] = (obj, int(shift))
    return index
