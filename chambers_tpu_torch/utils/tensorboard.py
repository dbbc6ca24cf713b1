"""TensorBoard event files, written and read without TensorFlow (port of
``chambers_tpu/utils/tensorboard.py``).

``Event`` protos (tensorflow/core/util/event.proto) in TFRecord framing:
each record is ``uint64 length, masked crc32c(length), data, masked
crc32c(data)``, little-endian. The port keeps its own pure-Python copy of
the framing, the CRC32C (Castagnoli, one 256-entry table: event files are
small) and the few protobuf fields it needs, so it imports nothing of the
JAX package. Apart from the wall time, a file written here holds the bytes
the JAX package writes for the same calls, and each package reads the
other's.

Summary kinds: scalars (``simple_value``), histograms (``HistogramProto``
with TF's exponential buckets or explicit ``bins``) and text (a
``DT_STRING`` tensor with the ``text`` plugin's metadata).
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from typing import Iterator, Optional, Sequence, Union

import numpy as np

__all__ = ["SummaryWriter", "read_events", "default_histogram_buckets",
           "masked_crc32c"]


# ---------------------------------------------------------------------------
# CRC32C and the TFRecord framing
# ---------------------------------------------------------------------------

def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: the CRC32C rotated right by 15 bits plus
    ``0xa282ead8``, modulo 2**32."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """The payloads of a TFRecord file, CRC-checked."""
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
            if verify and (hcrc != masked_crc32c(header)
                           or dcrc != masked_crc32c(data)):
                raise ValueError(f"TFRecord CRC mismatch in {path}")
            yield data


# ---------------------------------------------------------------------------
# protobuf wire format: the fields the Event protos use
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


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
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


def _signed_varint(n: int) -> bytes:
    return _varint(n & 0xFFFFFFFFFFFFFFFF)


def _to_signed(v: int) -> int:
    """int64 fields are two's-complement varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _iter_fields(buf: bytes):
    """``(field, wire type, value)``; length-delimited values as bytes."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", float(value))


def _float32(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


def _packed_doubles(field: int, values: Sequence[float]) -> bytes:
    return _len_delim(field, b"".join(struct.pack("<d", float(v))
                                      for v in values))


# TF DataType enum values (tensorflow/core/framework/types.proto)
_DT_STRING = 7
_DTYPES = {1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16",
           6: "int8", 9: "int64", 10: "bool", 17: "uint16", 19: "float16",
           22: "uint32", 23: "uint64"}


def _string_tensor(text: str) -> bytes:
    """A scalar ``DT_STRING`` TensorProto, as ``tf.io.serialize_tensor``
    writes it: dtype (1), an empty shape (2), ``string_val`` (8)."""
    return (_tag(1, 0) + _varint(_DT_STRING) + _len_delim(2, b"")
            + _len_delim(8, text.encode("utf-8")))


def _parse_tensor(buf: bytes) -> np.ndarray:
    """A TensorProto as numpy: ``DT_STRING`` (an object array of bytes) or
    ``tensor_content`` of the numeric types."""
    dtype, shape, content, strings = None, [], None, []
    for field, _, val in _iter_fields(buf):
        if field == 1:
            dtype = int(val)
        elif field == 2:
            for f2, _, dim in _iter_fields(val):
                if f2 == 2:
                    size = 0
                    for f3, _, v3 in _iter_fields(dim):
                        if f3 == 1:
                            size = v3
                    shape.append(int(size))
        elif field == 4:
            content = bytes(val)
        elif field == 8:
            strings.append(bytes(val))
    if dtype == _DT_STRING:
        out = np.empty(len(strings), dtype=object)
        out[:] = strings
        return out.reshape(shape)
    if dtype not in _DTYPES or content is None:
        raise TypeError(f"unsupported TensorProto dtype {dtype}")
    return np.frombuffer(content, np.dtype(_DTYPES[dtype]).newbyteorder(
        "<")).reshape(shape)


# ---------------------------------------------------------------------------
# Event and Summary protos
# ---------------------------------------------------------------------------

def _event_bytes(wall_time: float, step: Optional[int] = None,
                 file_version: Optional[str] = None,
                 summary: Optional[bytes] = None) -> bytes:
    # Event: 1 wall_time (double), 2 step (int64), 3 file_version, 5 summary
    out = _double(1, wall_time)
    if step:
        out += _tag(2, 0) + _signed_varint(int(step))
    if file_version is not None:
        out += _len_delim(3, file_version.encode("utf-8"))
    if summary is not None:
        out += _len_delim(5, summary)
    return out


def _value_common(tag: str) -> bytes:
    return _len_delim(1, tag.encode("utf-8"))  # Summary.Value.tag = 1


def _scalar_summary(tag: str, value: float) -> bytes:
    return _len_delim(1, _value_common(tag) + _float32(2, value))


def _histo_summary(tag: str, histo: bytes) -> bytes:
    return _len_delim(1, _value_common(tag) + _len_delim(5, histo))


def _text_summary(tag: str, text: str) -> bytes:
    # Value{tag, tensor=8 (DT_STRING), metadata=9 {plugin_data{name:"text"},
    # data_class: DATA_CLASS_TENSOR}}
    plugin = _len_delim(1, b"text")
    metadata = _len_delim(1, plugin) + _tag(4, 0) + b"\x02"
    return _len_delim(1, _value_common(tag)
                      + _len_delim(8, _string_tensor(text))
                      + _len_delim(9, metadata))


def default_histogram_buckets() -> np.ndarray:
    """TF's default histogram bucket limits: ±1e-12·1.1^k edges, ascending."""
    pos = []
    v = 1e-12
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    return np.asarray([-x for x in reversed(pos)] + [0.0] + pos
                      + [np.finfo(np.float64).max])


def _histogram_proto(values: np.ndarray,
                     bins: Optional[Union[int, Sequence[float]]] = None
                     ) -> bytes:
    """HistogramProto: 1 min, 2 max, 3 num, 4 sum, 5 sum_squares, 6
    bucket_limit (packed upper edges), 7 bucket (packed counts)."""
    values = np.asarray(values, np.float64).ravel()
    if values.size == 0:
        raise ValueError("cannot histogram an empty array")
    if bins is None:
        edges = default_histogram_buckets()
        # bucket i counts values in (edge[i-1], edge[i]]; the leading and
        # trailing empty buckets are dropped
        counts, _ = np.histogram(values, np.concatenate(([-np.inf], edges)))
        nz = np.flatnonzero(counts)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 1)
        limits, counts = edges[lo:hi], counts[lo:hi]
    elif isinstance(bins, int):
        counts, edges = np.histogram(values, bins=bins)
        limits = edges[1:]
    else:
        edges = np.asarray(bins, np.float64)
        counts, _ = np.histogram(values, bins=edges)
        limits = edges[1:]
    return (_double(1, values.min()) + _double(2, values.max())
            + _double(3, values.size) + _double(4, values.sum())
            + _double(5, np.square(values).sum())
            + _packed_doubles(6, limits) + _packed_doubles(7, counts))


def _numpy(values) -> np.ndarray:
    if hasattr(values, "detach"):
        values = values.detach().float().cpu().numpy()
    return np.asarray(values)


class SummaryWriter:
    """Append-only event-file writer (one file per instance); every record
    is flushed unless ``flush_each=False``. A context manager."""

    _uid = itertools.count()  # distinct files within one second

    def __init__(self, log_dir: str, filename_suffix: str = "",
                 flush_each: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}."
                f"{next(SummaryWriter._uid)}{filename_suffix}")
        self.path = os.path.join(log_dir, name)
        self._flush_each = flush_each
        self._file = open(self.path, "wb")
        # the version record TensorBoard requires as record 0
        self._write_record(_event_bytes(time.time(),
                                        file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        if self._file is None:
            raise ValueError("SummaryWriter is closed")
        header = struct.pack("<Q", len(data))
        self._file.write(header)
        self._file.write(struct.pack("<I", masked_crc32c(header)))
        self._file.write(data)
        self._file.write(struct.pack("<I", masked_crc32c(data)))
        if self._flush_each:
            self._file.flush()

    def add_scalar(self, tag: str, value, step: int,
                   wall_time: Optional[float] = None) -> None:
        self._write_record(_event_bytes(
            wall_time if wall_time is not None else time.time(), step,
            summary=_scalar_summary(tag, float(value))))

    def add_histogram(self, tag: str, values, step: int,
                      bins: Optional[Union[int, Sequence[float]]] = None,
                      wall_time: Optional[float] = None) -> None:
        """``bins=None`` uses TF's exponential buckets; an int or explicit
        edges use ``np.histogram``'s."""
        self._write_record(_event_bytes(
            wall_time if wall_time is not None else time.time(), step,
            summary=_histo_summary(tag, _histogram_proto(_numpy(values),
                                                         bins))))

    def add_text(self, tag: str, text: str, step: int,
                 wall_time: Optional[float] = None) -> None:
        self._write_record(_event_bytes(
            wall_time if wall_time is not None else time.time(), step,
            summary=_text_summary(tag, text)))

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _parse_histo(buf: bytes) -> dict:
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    out: dict = {"bucket_limit": [], "bucket": []}
    for field, wire, val in _iter_fields(buf):
        if field in names:
            out[names[field]] = struct.unpack("<d", val)[0]
        elif field in (6, 7):
            key = "bucket_limit" if field == 6 else "bucket"
            out[key] = (np.frombuffer(val, "<f8") if wire == 2
                        else list(out[key]) + [struct.unpack("<d", val)[0]])
    out["bucket_limit"] = np.asarray(out["bucket_limit"], np.float64)
    out["bucket"] = np.asarray(out["bucket"], np.float64)
    return out


def _parse_value(buf: bytes) -> dict:
    out: dict = {}
    for field, _, val in _iter_fields(buf):
        if field == 1:
            out["tag"] = val.decode("utf-8")
        elif field == 2:
            out["simple_value"] = struct.unpack("<f", val)[0]
        elif field == 5:
            out["histo"] = _parse_histo(val)
        elif field == 8:
            out["tensor"] = _parse_tensor(val)
    return out


def read_events(path: str) -> Iterator[dict]:
    """The events of an event file as dicts: ``wall_time``, ``step`` and
    one of ``file_version`` | ``values`` (parsed ``Summary.Value`` dicts:
    ``tag`` with ``simple_value``, ``histo`` or ``tensor``). CRC-checked;
    reads files of this module, of the JAX package and of TensorFlow."""
    for record in read_records(path):
        event: dict = {"wall_time": 0.0, "step": 0}
        for field, _, val in _iter_fields(record):
            if field == 1:
                event["wall_time"] = struct.unpack("<d", val)[0]
            elif field == 2:
                event["step"] = _to_signed(val)
            elif field == 3:
                event["file_version"] = val.decode("utf-8")
            elif field == 5:
                event.setdefault("values", []).extend(
                    _parse_value(v) for f, _, v in _iter_fields(val)
                    if f == 1)
        yield event
