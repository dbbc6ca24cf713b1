"""The training harness on the card: the prefetcher's copy stream, the
windowed fit, and a checkpoint's resume with the state on the card. Marked
``cuda``: they skip on a machine without a card. On the card:

    python -m pytest --noconftest tests/test_torch_cuda_trainer.py -q
"""

import functools

import numpy as np
import pytest
import torch

from chambers_tpu_torch.optimizers import AdamW
from chambers_tpu_torch.quantization import QuantDense
from chambers_tpu_torch.training import Trainer
from chambers_tpu_torch.training.checkpoint import CheckpointManager
from chambers_tpu_torch.training.trainer import _DevicePrefetcher

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU path is held to the JAX "
                    "package in test_torch_trainer.py")
    return torch.device("cuda")


def _trainer(dev, **kwargs):
    net = torch.nn.Sequential()
    net.add_module("Dense_0", QuantDense(64, 256, device=dev))
    net.add_module("relu", torch.nn.ReLU())
    net.add_module("Dense_1", QuantDense(256, 1, device=dev))
    g = torch.Generator(device=dev).manual_seed(0)
    for m in (net.Dense_0, net.Dense_1):
        m.reset_parameters(g)
    return Trainer(net, loss=lambda a, b: torch.mean((a - b) ** 2),
                   optimizer=functools.partial(AdamW, weight_decay=1e-3,
                                               learning_rate=1e-3),
                   **kwargs)


def _data(n=8, batch=4096):
    rng = np.random.RandomState(0)
    return [(rng.randn(batch, 64).astype(np.float32),
             rng.randn(batch, 1).astype(np.float32)) for _ in range(n)]


def test_prefetcher_copies_on_its_stream_and_delivers_the_bytes(dev):
    trainer = _trainer(dev)
    data = _data(6)
    pf = _DevicePrefetcher(iter([(x, y, None) for x, y in data]),
                           trainer._place_batch,
                           stream=trainer._copy_stream)
    for (x, y), (px, py, sw) in zip(data, pf):
        assert px.is_cuda and sw is None
        # the consumer's stream waited for the copy: the values are there
        assert torch.equal(px.cpu(), torch.from_numpy(x))
        assert torch.equal(py.cpu(), torch.from_numpy(y))
        # and no more than two batches were placed ahead
        assert len(pf._queue) <= 2


@pytest.mark.parametrize("spe", [2, 4])
def test_windowed_fit_is_bit_equal_on_the_card(dev, spe):
    one, many = _trainer(dev, ema_decay=0.9), _trainer(
        dev, ema_decay=0.9, steps_per_execution=spe)
    data = _data()
    assert one.fit(data, epochs=2, verbose=False) == many.fit(
        data, epochs=2, verbose=False)
    for k, v in one.state.params.items():
        assert torch.equal(v, many.state.params[k])
    for k, v in one.ema_variables.items():
        assert torch.equal(v, many.ema_variables[k])


def test_resume_from_a_checkpoint_on_the_card(dev, tmp_path):
    data = _data()
    full = _trainer(dev, gradient_accumulation_steps=3)
    full.fit(data, epochs=2, verbose=False)
    part = _trainer(dev, gradient_accumulation_steps=3)
    part.fit(data[:5], epochs=1, verbose=False)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(part.step, part.state.as_dict())
    resumed = _trainer(dev, gradient_accumulation_steps=3)
    resumed.state = ckpt.restore_latest(resumed)
    # the rest of epoch 0, then epoch 1: 16 steps in all, as the full run
    resumed.fit(data, epochs=2, skip_batches=5, verbose=False)
    assert resumed.step == full.step == 16
    for k, v in full.state.params.items():
        assert torch.equal(v, resumed.state.params[k])
