"""TensorBoard event files of the port (``chambers_tpu_torch.utils.
tensorboard``) against the JAX package's (``chambers_tpu.utils.
tensorboard``): the masked CRC32C on random bytes, the bytes written for
the same calls (the wall times given), and each package reading the
other's files."""

import numpy as np
import pytest
import torch

from chambers_tpu.data.tfrecord import _masked_crc as jax_masked_crc
from chambers_tpu.utils import tensorboard as J
from chambers_tpu_torch.utils import tensorboard as T
from test_torch_package import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1000])
def test_masked_crc_equals_jax_on_random_bytes(n):
    data = np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()
    assert T.masked_crc32c(data) == jax_masked_crc(data)


def test_crc32c_check_value():
    # the CRC-32C (Castagnoli) check value of "123456789"
    assert T.crc32c(b"123456789") == 0xE3069283


def _write(module, directory, calls):
    with module.SummaryWriter(str(directory)) as w:
        for kind, args in calls:
            getattr(w, kind)(*args, wall_time=1234.5)
        return w.path


_CALLS = {
    "scalar": [("add_scalar", ("loss", 0.5, 1)),
               ("add_scalar", ("loss", 0.25, 2)),
               ("add_scalar", ("epoch/acc", 1e-9, 0)),
               ("add_scalar", ("neg", -3.0, -5))],
    "histogram_bins": [("add_histogram", ("h", np.random.RandomState(0)
                                          .randn(500), 3, 20))],
    "histogram_edges": [("add_histogram", ("h", np.arange(10.0), 1,
                                           [0.0, 2.5, 5.0, 10.0]))],
    "histogram_default": [("add_histogram", ("w", np.random.RandomState(1)
                                             .randn(200) * 100, 0))],
    "text": [("add_text", ("note", "hello **world**", 0)),
             ("add_text", ("cfg", "ünïcode", 4))],
}


def _records_after_version(path):
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 8], "little")
        out.append(data[pos:pos + 16 + n])
        pos += 16 + n
    return out[1:]


@pytest.mark.parametrize("kind", sorted(_CALLS))
def test_bytes_equal_jax(tmp_path, kind):
    """Every record after the version record (whose wall time is the
    clock's) holds the JAX package's bytes."""
    mine = _write(T, tmp_path / "port", _CALLS[kind])
    theirs = _write(J, tmp_path / "jax", _CALLS[kind])
    assert _records_after_version(mine) == _records_after_version(theirs)


@pytest.mark.parametrize("kind", sorted(_CALLS))
@pytest.mark.parametrize("direction", ["port_reads_jax", "jax_reads_port"])
def test_each_package_reads_the_others_file(tmp_path, kind, direction):
    writer, reader = (J, T) if direction == "port_reads_jax" else (T, J)
    path = _write(writer, tmp_path, _CALLS[kind])
    got = list(reader.read_events(path))
    want = list(writer.read_events(path))
    assert len(got) == len(want)
    assert got[0]["file_version"] == "brain.Event:2"
    for a, b in zip(got, want):
        assert a["step"] == b["step"] and a["wall_time"] == b["wall_time"]
        for va, vb in zip(a.get("values", []), b.get("values", [])):
            assert va["tag"] == vb["tag"]
            if "simple_value" in vb:
                assert va["simple_value"] == vb["simple_value"]
            if "histo" in vb:
                for key in ("min", "max", "num", "sum", "sum_squares"):
                    assert va["histo"][key] == vb["histo"][key]
                for key in ("bucket", "bucket_limit"):
                    np.testing.assert_array_equal(va["histo"][key],
                                                  vb["histo"][key])
            if "tensor" in vb:
                assert bytes(np.asarray(va["tensor"]).reshape(-1)[0]) == \
                    bytes(np.asarray(vb["tensor"]).reshape(-1)[0])


def test_histogram_of_a_tensor_and_default_buckets(tmp_path):
    values = torch.randn(300, generator=torch.Generator().manual_seed(0))
    with T.SummaryWriter(str(tmp_path)) as w:
        w.add_histogram("t", values, step=2)
        path = w.path
    (event,) = [e for e in T.read_events(path) if "values" in e]
    histo = event["values"][0]["histo"]
    assert histo["num"] == 300 and histo["bucket"].sum() == 300
    np.testing.assert_array_equal(T.default_histogram_buckets(),
                                  J.default_histogram_buckets())
    with pytest.raises(ValueError, match="empty"):
        T._histogram_proto(np.zeros(0))


def test_closed_writer_raises_and_files_are_distinct(tmp_path):
    w = T.SummaryWriter(str(tmp_path))
    w2 = T.SummaryWriter(str(tmp_path))
    assert w.path != w2.path
    w.close()
    w2.close()
    with pytest.raises(ValueError, match="closed"):
        w.add_scalar("x", 1.0, step=0)


def test_a_corrupted_record_fails_its_crc(tmp_path):
    path = _write(T, tmp_path, _CALLS["scalar"])
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        list(T.read_events(path))
