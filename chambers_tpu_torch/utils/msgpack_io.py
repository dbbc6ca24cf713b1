"""Flax's msgpack weight files, read and written in pure Python.

``chambers_tpu``'s ``Model.save_weights`` writes
``flax.serialization.to_bytes(variables)``: a msgpack map of maps with
string keys whose leaves are arrays. This module reads and writes the
subset of msgpack that format uses, with no ``msgpack`` package:

- maps, arrays, strings, binary, integers, floats, booleans and nil;
- ext type 1, an ndarray: the msgpack of ``(shape, dtype name, C-order
  bytes)``; ext type 3, a numpy scalar, the same encoding;
- arrays above Flax's chunk size, which it stores as
  ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``.

:func:`loads` gives nested dicts of numpy arrays. A ``bfloat16`` array
(which numpy has no type for) comes back as float32 holding the same
values exactly. :func:`dumps` writes msgpack's shortest encodings, as the
``msgpack`` package does, keeping each map's key order, so a state dict
of arrays comes out as the bytes Flax's ``to_bytes`` writes; torch tensors
are written as arrays of their dtype (``bfloat16`` included).
"""

import struct

import numpy as np

_NDARRAY, _NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data, raw=False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n):
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(out)

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def string(self, n):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n):
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        ext_sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext_sized:
            return self.ext(self.unpack(ext_sized[b]))
        str_sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in str_sized:
            return self.string(self.unpack(str_sized[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ndarray(data):
    shape, name, buffer = _Reader(data, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, "<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape)


def _ext(code, data):
    if code == _NDARRAY:
        return _ndarray(data)
    if code == _NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(node):
    if isinstance(node, dict):
        if _CHUNKED in node:
            shape = tuple(node["shape"][str(i)]
                          for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)]
                      for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def loads(data: bytes):
    """The object a Flax msgpack file holds: nested dicts of numpy arrays
    (Flax's ``msgpack_restore``)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)


def load(path):
    with open(path, "rb") as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _int(n):
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return bytes([n & 0xFF])
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _sized(n, fix, fix_max, codes):
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError("msgpack object too large")


def _ext_header(code, n):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n]]) + struct.pack(">b", code)
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9)) + struct.pack(">b", code)


def _array_bytes(shape, name, buffer):
    return _pack((tuple(int(d) for d in shape), name, buffer))


def _tensor_ext(value):
    import torch

    t = value.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, buffer = "bfloat16", t.view(torch.int16).numpy().tobytes()
    else:
        arr = t.numpy()
        name, buffer = arr.dtype.name, arr.tobytes("C")
    return _NDARRAY, _array_bytes(t.shape, name, buffer)


def _pack(obj):
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, int) and not isinstance(obj, np.integer):
        return _int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b
    if isinstance(obj, (bytes, bytearray)):
        return _sized(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return (_sized(len(obj), 0x90, 15, (None, 0xDC, 0xDD))
                + b"".join(_pack(v) for v in obj))
    if isinstance(obj, dict):
        return (_sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF))
                + b"".join(_pack(str(k)) + _pack(v) for k, v in obj.items()))
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        code, body = _NDARRAY, _array_bytes(arr.shape, arr.dtype.name,
                                            arr.tobytes("C"))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        code, body = _NPSCALAR, _array_bytes(arr.shape, arr.dtype.name,
                                             arr.tobytes("C"))
    elif hasattr(obj, "detach"):
        code, body = _tensor_ext(obj)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to msgpack")
    return _ext_header(code, len(body)) + body


def dumps(obj) -> bytes:
    """``obj`` (nested dicts of numpy arrays or torch tensors, and Python
    scalars) in Flax's msgpack encoding."""
    return _pack(obj)


def dump(obj, path):
    with open(path, "wb") as f:
        f.write(dumps(obj))
