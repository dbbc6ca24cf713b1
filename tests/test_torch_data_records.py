"""The port's record formats (``chambers_tpu_torch/data/records.py``,
``persist.py``, ``tfrecord.py``, ``native_crc.py``) against the JAX
package's: a file written by either package holds the same bytes and is
read back by the other, element for element (exact); the CRC32C is the
same in pure Python, natively and in JAX."""

import os

import numpy as np
import pytest

from chambers_tpu.data import persist as jpersist
from chambers_tpu.data import records as jrecords
from chambers_tpu.data import tfrecord as jtf
from chambers_tpu.data.core import Dataset as JDataset
from chambers_tpu_torch.data import native_crc
from chambers_tpu_torch.data import persist as tpersist
from chambers_tpu_torch.data import records as trecords
from chambers_tpu_torch.data import tfrecord as ttf
from chambers_tpu_torch.data.core import Dataset


def assert_same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, (str, bytes)):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == object:
            assert a.tolist() == b.tolist()
        else:
            assert np.array_equal(a, b)


def _elements(kind):
    rng = np.random.RandomState(0)
    if kind == "images":
        return [(rng.randint(0, 256, (8, 8, 3), np.uint8), np.int64(i % 3))
                for i in range(7)]
    if kind == "mixed":
        return [(rng.randn(2, 3).astype(np.float32), rng.randint(0, 9, 4),
                 np.float64(i) / 3, np.bool_(i % 2)) for i in range(5)]
    if kind == "single":
        return [rng.randn(3).astype(np.float16) for _ in range(4)]
    if kind == "strings":
        return [("hello", np.int32(1)), ("wörld", np.int32(2))]
    raise ValueError(kind)


PACKAGES = {"jax": (jrecords, jpersist, jtf, JDataset),
            "port": (trecords, tpersist, ttf, Dataset)}


@pytest.mark.parametrize("kind", ["images", "mixed", "single", "strings"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_records_files_cross_read(tmp_path, kind, writer, reader):
    elements = _elements(kind)
    wrec, _, _, WD = PACKAGES[writer]
    rrec = PACKAGES[reader][0]
    path = str(tmp_path / "data.records")
    wrec.dataset_to_records(WD.from_generator(lambda: iter(elements)), path)
    other = str(tmp_path / "other.records")
    rrec.dataset_to_records(PACKAGES[reader][3].from_generator(
        lambda: iter(elements)), other)
    assert open(path, "rb").read() == open(other, "rb").read()
    got = list(rrec.records_to_dataset(path))
    assert len(got) == len(elements)
    for a, b in zip(got, elements):
        assert_same(a, b)
    assert rrec.records_to_dataset(path).element_spec == \
        wrec.records_to_dataset(path).element_spec


def test_record_spec_modes_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    elements = [rng.randn(i + 2, 3).astype(np.float32) for i in range(4)]
    path = str(tmp_path / "var.records")
    trecords.dataset_to_records(
        Dataset.from_generator(lambda: iter(elements)), path)
    with pytest.raises(ValueError, match="mismatch"):
        list(trecords.records_to_dataset(path, set_shape=True))
    for kwargs in (dict(set_shape=False, set_dimension=2),
                   dict(set_shape=False)):
        got = list(trecords.records_to_dataset(path, **kwargs))
        for a, b in zip(got, jrecords.records_to_dataset(path, **kwargs)):
            assert_same(a, b)
    el = (np.zeros((3, 4), np.float32), np.int64(1))
    for kwargs in (dict(set_shape=True), dict(set_shape=False,
                                              set_dimension=2),
                   dict(set_shape=False)):
        assert trecords.element_spec(el, **kwargs) == jrecords.element_spec(
            el, **kwargs)
    empty = str(tmp_path / "empty.records")
    open(empty, "wb").close()
    with pytest.raises(ValueError, match="empty"):
        trecords.records_to_dataset(empty)


@pytest.mark.parametrize("n_files", [1, 3])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_snapshots_cross_read(tmp_path, n_files, writer, reader):
    elements = _elements("images")
    _, wp, _, WD = PACKAGES[writer]
    rp = PACKAGES[reader][1]
    path = str(tmp_path / "snap")
    wp.save_dataset(WD.from_generator(lambda: iter(elements)), path,
                    n_files=n_files)
    other = str(tmp_path / "other")
    PACKAGES[reader][1].save_dataset(PACKAGES[reader][3].from_generator(
        lambda: iter(elements)), other, n_files=n_files)
    for name in sorted(os.listdir(path)):
        assert open(os.path.join(path, name), "rb").read() == open(
            os.path.join(other, name), "rb").read(), name
    restored = rp.load_dataset(path)
    assert restored.element_spec == (((8, 8, 3), "|u1"), ((), "<i8"))
    got = list(restored)
    assert len(got) == len(elements)
    for a, b in zip(got, elements):
        assert_same(a, b)


@pytest.mark.parametrize("kind", ["images", "mixed", "single"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_tfrecord_files_cross_read(tmp_path, kind, writer, reader):
    elements = _elements(kind)
    _, _, wtf, WD = PACKAGES[writer]
    rtf = PACKAGES[reader][2]
    path = str(tmp_path / "data.tfrecord")
    assert wtf.dataset_to_tfrecord(
        WD.from_generator(lambda: iter(elements)), path) == len(elements)
    other = str(tmp_path / "other.tfrecord")
    rtf.dataset_to_tfrecord(PACKAGES[reader][3].from_generator(
        lambda: iter(elements)), other)
    assert open(path, "rb").read() == open(other, "rb").read()
    got = list(rtf.tfrecord_to_dataset(path))
    assert len(got) == len(elements)
    for a, b in zip(got, elements):
        assert_same(a, b)


def test_tfrecord_codec_equals_jax():
    rng = np.random.RandomState(0)
    values = [rng.randn(2, 3).astype(np.float32), rng.randn(4),
              rng.randint(-5, 5, (3,)).astype(np.int32),
              rng.randint(0, 256, (2, 2)).astype(np.uint8),
              np.array([True, False]), np.float16(1.5), np.int64(-7),
              np.array([b"ab", b"c"], dtype=object), b"raw", "text"]
    for v in values:
        proto = ttf.tensor_to_proto(v)
        assert proto == jtf.tensor_to_proto(v)
        assert_same(ttf.proto_to_tensor(proto), jtf.proto_to_tensor(proto))
    example = ttf.serialize_to_example(values[0], values[6])
    assert example == jtf.serialize_to_example(values[0], values[6])
    assert ttf.parse_example_features(example) == \
        jtf.parse_example_features(example)
    for n in (0, 1, 127, 128, 2 ** 40, 2 ** 64 - 1):
        assert ttf._varint(n) == jtf._varint(n)
        assert ttf._read_varint(ttf._varint(n), 0) == (n, len(ttf._varint(n)))
    with pytest.raises(TypeError, match="unsupported"):
        ttf.tensor_to_proto(np.zeros(2, "datetime64[s]"))


def test_deserialize_fn_equals_jax(tmp_path):
    elements = _elements("mixed")
    path = str(tmp_path / "d.tfrecord")
    ttf.dataset_to_tfrecord(Dataset.from_generator(lambda: iter(elements)),
                            path)
    raw = list(ttf.read_tfrecord(path))
    assert raw == list(jtf.read_tfrecord(path))
    got_fn = ttf.make_dataset_deserialize_fn(raw)
    want_fn = jtf.make_dataset_deserialize_fn(raw)
    for r in raw:
        assert_same(got_fn(r), want_fn(r))


def test_tfrecord_crc_rejects_corruption(tmp_path):
    path = str(tmp_path / "c.tfrecord")
    ttf.write_tfrecord(path, [b"payload-one", b"payload-two"])
    data = bytearray(open(path, "rb").read())
    data[20] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        list(ttf.read_tfrecord(path))
    assert len(list(ttf.read_tfrecord(path, verify=False))) == 2


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 63, 4096, 150537])
def test_crc32c_equals_jax_in_python_and_natively(size):
    data = np.random.RandomState(size).randint(
        0, 256, size, np.uint8).tobytes()
    want = jtf._crc32c_py(data)
    assert ttf._crc32c_py(data) == want == jtf._crc32c(data)
    assert ttf._crc32c(data) == want
    assert ttf._masked_crc(data) == jtf._masked_crc(data)
    if native_crc.available():
        assert native_crc.crc32c(data) == want
    assert ttf._crc32c_py(b"123456789") == 0xE3069283
