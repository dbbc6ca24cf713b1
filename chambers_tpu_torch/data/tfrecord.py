"""TFRecord / ``tf.train.Example`` interop — no TensorFlow required (port of
``chambers_tpu/data/tfrecord.py``; both packages read each other's files).

Arbitrary tensor tuples serialize into ``tf.train.Example`` records — per
tensor ``t{i}_raw`` (a serialized ``TensorProto``, as
``tf.io.serialize_tensor`` writes it), ``t{i}_dtype`` (TF datatype enum)
and ``t{i}_shape`` — framed in the TFRecord container, and the
deserialization spec is derived from the first sample
(``make_dataset_deserialize_fn``).

This module speaks those bytes with a hand-rolled minimal protobuf codec
and the TFRecord framing (little-endian u64 length + masked CRC32C of the
length + payload + masked CRC32C of the payload). The CRC32C is the native
one of ``native_crc.py`` where ``g++`` is present, the pure-Python table
loop otherwise; the framing and the varint helpers are also what
``chambers_tpu_torch.utils.tensorboard`` writes event files with. The
sibling ``data/records.py`` remains the simpler native container for new
data.

Supported dtypes: the numeric set ``tf.io.serialize_tensor`` stores as raw
``tensor_content`` (f16/f32/f64, u8..u64, i8..i64, bool, bfloat16 pass-through
as raw u16 payloads) plus DT_STRING (bytes elements). Decoding also accepts
the typed repeated fields (``float_val`` etc.) protos may use instead.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from chambers_tpu_torch.data.core import Dataset

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) + TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


_CRC32C = None  # the implementation, chosen at first use


def _crc32c(data: bytes) -> int:
    """CRC32C of ``data``: the native function where it builds (the
    pure-Python loop is ~25 MB/s), else the loop."""
    global _CRC32C
    if _CRC32C is None:
        from chambers_tpu_torch.data import native_crc

        _CRC32C = native_crc.crc32c if native_crc.available() else _crc32c_py
    return _CRC32C(data)


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire codec
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value); skips nothing (caller
    filters). Length-delimited values are returned as bytes slices."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:  # pragma: no cover - groups are not used by these protos
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _packed_varints(buf: bytes) -> List[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zigzag_to_signed(v: int) -> int:
    """int64 fields are two's-complement varints (NOT zigzag); map the
    unsigned reading back to signed 64-bit."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _signed_varint(n: int) -> bytes:
    return _varint(n & 0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# TensorProto <-> numpy
# ---------------------------------------------------------------------------

# TF DataType enum (tensorflow/core/framework/types.proto)
_NP_TO_ENUM = {
    "float32": 1, "float64": 2, "int32": 3, "uint8": 4, "int16": 5,
    "int8": 6, "complex64": 8, "int64": 9, "bool": 10,
    "bfloat16": 14, "uint16": 17, "complex128": 18, "float16": 19,
    "uint32": 22, "uint64": 23,
}
_DT_STRING = 7
_ENUM_TO_NP = {v: np.dtype(k) for k, v in _NP_TO_ENUM.items()
               if k != "bfloat16"}
# typed repeated fields a TensorProto may carry instead of tensor_content:
# field number -> (enum values it serves, element reader)
_TYPED_FIELDS = {
    5: (1,), 6: (2,), 7: (3, 4, 5, 6), 10: (9,), 11: (10,),
    13: (19, 14), 16: (22,), 17: (23,),
}


def _np_enum(arr: np.ndarray) -> int:
    name = arr.dtype.name
    if name not in _NP_TO_ENUM:
        raise TypeError(f"unsupported dtype for TFRecord interop: {name}")
    return _NP_TO_ENUM[name]


def _shape_proto(shape: Sequence[int]) -> bytes:
    out = b"".join(
        _len_delim(2, _tag(1, 0) + _varint(int(d))) for d in shape)
    return out


def _parse_shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, _, val in _iter_fields(buf):
        if field == 2:  # Dim message
            size = 0
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(int(size))
    return tuple(dims)


def tensor_to_proto(value) -> bytes:
    """Serialize an array (or bytes/str (nested) list) exactly as
    ``tf.io.serialize_tensor`` does: dtype enum (field 1), shape (field 2),
    and raw little-endian ``tensor_content`` (field 4) — or per-element
    ``string_val`` (field 8) for DT_STRING."""
    if isinstance(value, np.ndarray) and value.dtype.kind in "SUO" \
            or isinstance(value, (bytes, str)) \
            or (isinstance(value, (list, tuple))
                and np.asarray(value).dtype.kind in "SUO"):
        arr = np.asarray(value)
        flat = [x.encode() if isinstance(x, str) else bytes(x)
                for x in arr.reshape(-1)]
        body = _tag(1, 0) + _varint(_DT_STRING)
        body += _len_delim(2, _shape_proto(arr.shape))
        body += b"".join(_len_delim(8, s) for s in flat)
        return body
    arr = np.asarray(value)
    body = _tag(1, 0) + _varint(_np_enum(arr))
    body += _len_delim(2, _shape_proto(arr.shape))
    content = np.ascontiguousarray(arr).astype(
        arr.dtype.newbyteorder("<"), copy=False).tobytes()
    body += _len_delim(4, content)
    return body


def proto_to_tensor(buf: bytes) -> np.ndarray:
    """Parse a serialized TensorProto back to numpy (the
    ``tf.io.parse_tensor`` counterpart). Accepts ``tensor_content`` or the
    typed repeated fields."""
    dtype_enum = None
    shape: Tuple[int, ...] = ()
    content: Optional[bytes] = None
    strings: List[bytes] = []
    typed: List[Tuple[int, object, int]] = []  # (field, val, wire)
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            dtype_enum = int(val)
        elif field == 2:
            shape = _parse_shape(val)
        elif field == 4:
            content = bytes(val)
        elif field == 8:
            strings.append(bytes(val))
        elif field in _TYPED_FIELDS:
            typed.append((field, val, wire))
    if dtype_enum is None:
        raise ValueError("TensorProto without dtype")
    if dtype_enum == _DT_STRING:
        out = np.empty(len(strings), dtype=object)
        out[:] = strings
        return out.reshape(shape)
    np_dtype = _ENUM_TO_NP.get(dtype_enum)
    if np_dtype is None:
        if dtype_enum == 14:  # bfloat16: surface the raw u16 payload
            np_dtype = np.dtype("uint16")
        else:
            raise TypeError(f"unsupported TensorProto dtype {dtype_enum}")
    if content is not None:
        return np.frombuffer(content, dtype=np_dtype.newbyteorder("<")) \
            .astype(np_dtype, copy=False).reshape(shape)
    # typed repeated fields (packed or unpacked)
    values: List = []
    for field, val, wire in typed:
        if dtype_enum not in _TYPED_FIELDS[field]:
            continue
        if wire == 2:  # packed
            if field == 5:  # float_val: packed 32-bit
                values.extend(struct.unpack(f"<{len(val) // 4}f", val))
            elif field == 6:  # double_val: packed 64-bit
                values.extend(struct.unpack(f"<{len(val) // 8}d", val))
            else:
                vs = _packed_varints(val)
                if field == 10:
                    vs = [_zigzag_to_signed(v) for v in vs]
                values.extend(vs)
        elif wire == 5:
            values.append(struct.unpack("<f", val)[0])
        elif wire == 1:
            values.append(struct.unpack("<d", val)[0])
        else:
            v = int(val)
            if field == 10:
                v = _zigzag_to_signed(v)
            values.append(v)
    arr = np.asarray(values, dtype=np_dtype)
    if shape and int(np.prod(shape)) != arr.size and arr.size == 1:
        arr = np.broadcast_to(arr, shape).copy()  # proto scalar fill
        return arr
    return arr.reshape(shape)


# ---------------------------------------------------------------------------
# tf.train.Example
# ---------------------------------------------------------------------------

def _bytes_list(values: Sequence[bytes]) -> bytes:
    return b"".join(_len_delim(1, v) for v in values)


def _int64_list(values: Sequence[int]) -> bytes:
    if not values:
        return b""
    packed = b"".join(_signed_varint(int(v)) for v in values)
    return _len_delim(1, packed)


def _feature_bytes(bytes_list: Optional[Sequence[bytes]] = None,
                   int64_list: Optional[Sequence[int]] = None) -> bytes:
    if bytes_list is not None:
        return _len_delim(1, _bytes_list(bytes_list))
    return _len_delim(3, _int64_list(int64_list or []))


def _example_bytes(features: Sequence[Tuple[str, bytes]]) -> bytes:
    entries = b"".join(
        _len_delim(1, _len_delim(1, name.encode()) + _len_delim(2, feat))
        for name, feat in features)
    return _len_delim(1, entries)


def serialize_to_example(*tensors) -> bytes:
    """Encode tensors as a serialized ``tf.train.Example`` with the
    feature naming contract of the JAX package's files:
    ``t{i}_raw`` = serialized TensorProto, ``t{i}_dtype`` = TF enum,
    ``t{i}_shape`` = dims."""
    feats: List[Tuple[str, bytes]] = []
    for i, t in enumerate(tensors):
        arr = np.asarray(t)
        proto = tensor_to_proto(t)
        enum = _DT_STRING if arr.dtype.kind in "SUO" else _np_enum(arr)
        name = f"t{i}"
        feats.append((name + "_raw", _feature_bytes(bytes_list=[proto])))
        feats.append((name + "_dtype", _feature_bytes(int64_list=[enum])))
        feats.append((name + "_shape",
                      _feature_bytes(int64_list=list(arr.shape))))
    return _example_bytes(feats)


def parse_example_features(serialized: bytes) -> dict:
    """Parse a serialized Example into ``{name: (kind, values)}`` where kind
    is ``"bytes"``/``"float"``/``"int64"``."""
    out = {}
    for field, _, val in _iter_fields(serialized):
        if field != 1:  # Features
            continue
        for f2, _, entry in _iter_fields(val):
            if f2 != 1:  # map entry
                continue
            name = None
            feature = b""
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    name = v3.decode()
                elif f3 == 2:
                    feature = v3
            kind, values = None, []
            for f4, wire, v4 in _iter_fields(feature):
                if f4 == 1:  # BytesList
                    kind = "bytes"
                    values = [bytes(b) for _, __, b in _iter_fields(v4)]
                elif f4 == 2:  # FloatList
                    kind = "float"
                    for f5, w5, v5 in _iter_fields(v4):
                        if w5 == 2:
                            values.extend(struct.unpack(
                                f"<{len(v5) // 4}f", v5))
                        else:
                            values.append(struct.unpack("<f", v5)[0])
                elif f4 == 3:  # Int64List
                    kind = "int64"
                    for f5, w5, v5 in _iter_fields(v4):
                        if w5 == 2:
                            values.extend(_zigzag_to_signed(x)
                                          for x in _packed_varints(v5))
                        else:
                            values.append(_zigzag_to_signed(v5))
            if name is not None:
                out[name] = (kind, values)
    return out


# ---------------------------------------------------------------------------
# TFRecord container
# ---------------------------------------------------------------------------

def write_tfrecord(path: str, payloads: Iterable[bytes]) -> int:
    """Write serialized payloads in TFRecord framing; returns the count."""
    n = 0
    with open(path, "wb") as f:
        for data in payloads:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
            n += 1
    return n


def read_tfrecord(path: str, verify: bool = True) -> Iterator[bytes]:
    """Iterate the serialized payloads of a TFRecord file (CRC-checked)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify and (hcrc != _masked_crc(header)
                           or dcrc != _masked_crc(data)):
                raise ValueError(f"TFRecord CRC mismatch in {path}")
            yield data


# ---------------------------------------------------------------------------
# dataset-level API
# ---------------------------------------------------------------------------

def make_dataset_deserialize_fn(dataset, set_shape: bool = False,
                                set_dimension: bool = False):
    """Derive a ``serialized bytes -> tensor tuple`` function from the first
    sample of a dataset of serialized Examples.
    ``set_shape``/``set_dimension`` are accepted for API parity; numpy
    outputs always carry their concrete shape."""
    sample = next(iter(dataset))
    feats = parse_example_features(bytes(sample))
    ids = sorted({k.split("_")[0] for k in feats})  # lexical, as tf.data's

    def deserialize_fn(serialized):
        f = parse_example_features(bytes(serialized))
        tensors = tuple(proto_to_tensor(f[tid + "_raw"][1][0])
                        for tid in ids)
        return tensors[0] if len(tensors) == 1 else tensors

    return deserialize_fn


def dataset_to_tfrecord(dataset, path: str) -> int:
    """Serialize every dataset element to ``path``; returns the record
    count."""
    def payloads():
        for el in dataset:
            if not isinstance(el, tuple):
                el = (el,)
            yield serialize_to_example(*el)

    return write_tfrecord(path, payloads())


def tfrecord_to_dataset(paths, set_shape: bool = True,
                        set_dimension: bool = False) -> Dataset:
    """Stream TFRecord file(s) back as a deserialized ``Dataset``."""
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    paths = list(paths)

    def raw_gen():
        for p in paths:
            yield from read_tfrecord(p)

    deserialize = make_dataset_deserialize_fn(
        raw_gen(), set_shape=set_shape, set_dimension=set_dimension)

    def gen():
        for record in raw_gen():
            yield deserialize(record)

    return Dataset(gen)
