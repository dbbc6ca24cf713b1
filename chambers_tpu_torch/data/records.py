"""Binary record serialization for tensor-tuple datasets (port of
``chambers_tpu/data/records.py``; both packages read each other's files).

Arbitrary tensor tuples serialize as (raw bytes, dtype, shape) triplets per
tensor, and the deserialization spec is *derived from the first sample* of
the dataset, with ``set_shape`` / ``set_dimension`` modes controlling how
much shape is pinned.

The container here is a simple length-prefixed binary format (no TF
dependency):

    file    := record*
    record  := u32 n_tensors, tensor*
    tensor  := u16 dtype_len, dtype_utf8, u8 ndim, u64 shape[ndim],
               u64 data_len, raw_bytes

Strings serialize as dtype "str" with utf-8 payloads.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional

import numpy as np

from chambers_tpu_torch.data.core import Dataset

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_U8 = struct.Struct("<B")


def _normalize_element(element):
    if not isinstance(element, tuple):
        element = (element,)
    return element


def serialize_element(element) -> bytes:
    """Serialize one dataset element (tensor or tuple of tensors)."""
    element = _normalize_element(element)
    out = [_U32.pack(len(element))]
    for tensor in element:
        if isinstance(tensor, (str, bytes)):
            if isinstance(tensor, str):
                data = tensor.encode()
                dtype_name = b"str"
            else:
                data = tensor
                dtype_name = b"bytes"
            shape = ()
        else:
            arr = np.asarray(tensor)
            data = arr.tobytes()
            dtype_name = arr.dtype.str.encode()
            shape = arr.shape
        out.append(_U16.pack(len(dtype_name)))
        out.append(dtype_name)
        out.append(_U8.pack(len(shape)))
        for dim in shape:
            out.append(_U64.pack(dim))
        out.append(_U64.pack(len(data)))
        out.append(data)
    return b"".join(out)


def deserialize_element(f: BinaryIO):
    """Read one element from a binary stream; None at EOF."""
    head = f.read(_U32.size)
    if not head:
        return None
    (n_tensors,) = _U32.unpack(head)
    tensors = []
    for _ in range(n_tensors):
        (dtype_len,) = _U16.unpack(f.read(_U16.size))
        dtype_name = f.read(dtype_len)
        (ndim,) = _U8.unpack(f.read(_U8.size))
        shape = tuple(_U64.unpack(f.read(_U64.size))[0] for _ in range(ndim))
        (data_len,) = _U64.unpack(f.read(_U64.size))
        data = f.read(data_len)
        if dtype_name == b"str":
            tensors.append(data.decode())
        elif dtype_name == b"bytes":
            tensors.append(data)
        else:
            arr = np.frombuffer(data, dtype=np.dtype(dtype_name.decode()))
            tensors.append(arr.reshape(shape))
    return tensors[0] if len(tensors) == 1 else tuple(tensors)


def element_spec(element, set_shape: bool = True,
                 set_dimension: Optional[int] = None):
    """Spec (shape, dtype) tuples for an element, in the
    set_shape/set_dimension modes:

    - ``set_shape=True``: full static shapes from the sample.
    - ``set_dimension=d``: the rank ``d`` kept, every axis unknown (None).
    - neither: shape fully unknown (None).
    """
    element = _normalize_element(element)
    specs = []
    for tensor in element:
        if isinstance(tensor, (str, bytes)):
            specs.append(((), "bytes" if isinstance(tensor, bytes) else "str"))
            continue
        arr = np.asarray(tensor)
        if set_shape:
            shape = arr.shape
        elif set_dimension is not None:
            shape = tuple([None] * set_dimension)
        else:
            shape = None
        specs.append((shape, arr.dtype.str))
    return tuple(specs)


def check_spec(element, spec):
    """Validate an element against a spec (returns the element unchanged);
    raises ValueError on mismatch."""
    original = element
    element = _normalize_element(element)
    if len(element) != len(spec):
        raise ValueError(
            f"Element arity {len(element)} does not match spec {len(spec)}"
        )
    for tensor, (shape, dtype) in zip(element, spec):
        if dtype in ("str", "bytes"):
            continue
        arr = np.asarray(tensor)
        if shape is None:
            continue
        if len(arr.shape) != len(shape):
            raise ValueError(
                f"Rank mismatch: element {arr.shape} vs spec {shape}"
            )
        for have, want in zip(arr.shape, shape):
            if want is not None and have != want:
                raise ValueError(
                    f"Shape mismatch: element {arr.shape} vs spec {shape}"
                )
    return original


def dataset_to_records(dataset, path: str):
    """Write every element of a dataset to a record file."""
    with open(path, "wb") as f:
        for element in dataset:
            f.write(serialize_element(element))


def records_to_dataset(path: str, set_shape: bool = True,
                       set_dimension: Optional[int] = None) -> Dataset:
    """Load a record file as a Dataset; the element spec is derived from the
    first record and enforced on every element."""
    with open(path, "rb") as f:
        first = deserialize_element(f)
    if first is None:
        raise ValueError(f"Record file {path} is empty.")
    spec = element_spec(first, set_shape=set_shape, set_dimension=set_dimension)

    def gen():
        with open(path, "rb") as f:
            while True:
                element = deserialize_element(f)
                if element is None:
                    return
                yield check_spec(element, spec)

    ds = Dataset(gen)
    ds.element_spec = spec
    return ds


# the JAX package's aliases
dataset_to_tfrecord = dataset_to_records
tfrecord_to_dataset = records_to_dataset
