"""TensorBoard event files, written and read without TensorFlow (port of
``chambers_tpu/utils/tensorboard.py``).

``Event`` protos (tensorflow/core/util/event.proto) in TFRecord framing:
each record is ``uint64 length, masked crc32c(length), data, masked
crc32c(data)``, little-endian. The framing, the CRC32C and the protobuf
helpers are the host data pipeline's (``chambers_tpu_torch.data.tfrecord``),
as the JAX package's module takes them from its own. Apart from the wall
time, a file written here holds the bytes the JAX package writes for the
same calls, and each package reads the other's.

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

from chambers_tpu_torch.data.tfrecord import (
    _crc32c as crc32c,
    _iter_fields,
    _len_delim,
    _masked_crc as masked_crc32c,
    _signed_varint,
    _tag,
    _varint,
    _zigzag_to_signed as _to_signed,
    read_tfrecord as read_records,
)

__all__ = ["SummaryWriter", "read_events", "default_histogram_buckets",
           "masked_crc32c"]


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
