"""``chambers_tpu_torch.data.device_prefetch`` on the CPU: the batches of
the JAX package's ``device_prefetch``, in order, as tensors on the asked
device, at most ``size`` placed ahead; the CUDA default raises without a
card; ``size=0`` raises and ``sharding=`` yields ``DTensor`` batches. On
the card the copy stream and its events are the Trainer's prefetcher's,
which ``tests/test_torch_cuda_trainer.py`` holds there."""

import numpy as np
import pytest
import torch

from chambers_tpu.data.loader import device_prefetch as jax_device_prefetch
from chambers_tpu_torch.data import Dataset, device_prefetch
from chambers_tpu_torch.data import loader
from test_torch_package import one_torch_thread  # noqa: F401


def _batches(n=7):
    return [({"x": np.full((2, 2), i, np.float32)}, np.full(2, i),
             [np.float64(i) / 4]) for i in range(n)]


@pytest.mark.parametrize("size", [1, 2, 3, 10])
def test_order_and_placement_equal_jax(size):
    batches = _batches()
    got = list(device_prefetch(batches, size=size, device="cpu"))
    want = list(jax_device_prefetch(batches, size=size))
    assert len(got) == len(want) == 7
    for (gd, gy, gl), (wd, wy, wl) in zip(got, want):
        assert isinstance(gd["x"], torch.Tensor) and gd["x"].device.type == \
            "cpu"
        assert np.array_equal(gd["x"].numpy(), np.asarray(wd["x"]))
        assert np.array_equal(gy.numpy(), np.asarray(wy))
        # numpy float64 becomes float32, as JAX's 32-bit default does
        assert gl[0].dtype == torch.float32 == getattr(
            torch, str(np.asarray(wl[0]).dtype))


def test_places_at_most_size_ahead_and_lazily(monkeypatch):
    placed = []
    real = loader._to_device

    def counting(x, device):
        placed.append(int(np.asarray(x).ravel()[0]))
        return real(x, device)

    monkeypatch.setattr(loader, "_to_device", counting)
    it = device_prefetch((np.full(1, i) for i in range(6)), size=2,
                         device="cpu")
    assert placed == []
    assert int(next(it)) == 0
    assert placed == [0, 1, 2]
    assert [int(b) for b in it] == [1, 2, 3, 4, 5]


def test_feeds_a_dataset_pipeline():
    ds = Dataset.range(10).batch(4).prefetch(2)
    out = [b.tolist() for b in device_prefetch(ds, device="cpu")]
    assert out == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_arguments_are_checked():
    with pytest.raises(ValueError, match="size"):
        device_prefetch([1], size=0, device="cpu")
    from torch.distributed.tensor import DTensor

    from chambers_tpu_torch.parallel import batch_sharding, create_mesh

    # a one-device mesh: every batch comes out as a DTensor holding it all
    mesh = create_mesh({"data": 1}, device="cpu")
    batch = np.arange(6, dtype=np.float32).reshape(3, 2)
    (out,) = list(device_prefetch([batch], sharding=batch_sharding(mesh)))
    assert isinstance(out, DTensor) and out.shape == (3, 2)
    np.testing.assert_array_equal(out.to_local().numpy(), batch)


def test_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_prefetch([np.zeros(2)])
