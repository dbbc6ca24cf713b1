"""Checkpoints of the port (``chambers_tpu_torch.training.checkpoint``):
one ``torch.save`` file a step, atomic, holding everything that sets the
next step, so a resumed run is bit-equal to an uninterrupted one (the
JAX package's ``tests/test_checkpoint.py`` cases, on the port)."""

import functools
import os
import signal

import numpy as np
import pytest
import torch

from chambers_tpu_torch import callbacks as tcb
from chambers_tpu_torch.optimizers import SGDW, AdamW
from chambers_tpu_torch.quantization import QuantDense
from chambers_tpu_torch.schedules import LinearWarmup
from chambers_tpu_torch.training import Trainer
from chambers_tpu_torch.training.checkpoint import (
    CheckpointCallback,
    CheckpointManager,
    PreemptionCheckpoint,
)
from chambers_tpu_torch.utils.profiling import benchmark, device_memory_stats
from test_torch_package import one_torch_thread  # noqa: F401


class _Net(torch.nn.Module):
    """Dense -> dropout -> Dense: the dropout draws from the Trainer's
    generator, whose state a checkpoint must carry."""

    def __init__(self, seed=0, rate=0.0):
        super().__init__()
        self.Dense_0 = QuantDense(4, 16, device="cpu")
        self.Dense_1 = QuantDense(16, 1, device="cpu")
        self.rate = rate
        g = torch.Generator().manual_seed(seed)
        for m in (self.Dense_0, self.Dense_1):
            m.reset_parameters(g)

    def forward(self, x, deterministic=None, generator=None):
        h = torch.relu(self.Dense_0(x))
        if self.rate and not deterministic:
            keep = torch.empty_like(h).bernoulli_(1 - self.rate,
                                                  generator=generator)
            h = h * keep / (1 - self.rate)
        return self.Dense_1(h)


def _mse(y_true, y_pred):
    return torch.mean((y_true - y_pred) ** 2)


def _trainer(seed=0, rate=0.0, **kwargs):
    return Trainer(_Net(seed, rate), loss=_mse, optimizer=functools.partial(
        AdamW, weight_decay=1e-2, learning_rate=LinearWarmup(1e-2, 3)),
        seed=3, **kwargs)


def _data(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 4).astype(np.float32),
             rng.randn(8, 1).astype(np.float32)) for _ in range(n)]


def _assert_same_state(a, b):
    sa, sb = a.state, b.state
    assert sa.step == sb.step
    for kind in ("params", "extra_vars"):
        for k, v in getattr(sa, kind).items():
            assert torch.equal(v, getattr(sb, kind)[k]), k
    assert torch.equal(sa.rng, sb.rng)
    oa, ob = sa.opt_state, sb.opt_state
    assert oa["param_groups"] == ob["param_groups"]
    for i, state in oa["state"].items():
        for key, v in state.items():
            assert torch.equal(v, ob["state"][i][key]), (i, key)
    if sa.ema_params is not None:
        for k, v in sa.ema_params.items():
            assert torch.equal(v, sb.ema_params[k]), k


def test_save_restore_roundtrip(tmp_path):
    trainer = _trainer()
    trainer.fit(_data(), epochs=1, verbose=False)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.save(trainer.step, trainer.state.as_dict())
    ckpt.wait()
    assert ckpt.latest_step() == 4
    fresh = _trainer(seed=1)
    fresh.state = ckpt.restore(4)
    _assert_same_state(trainer, fresh)
    ckpt.close()


def test_restore_latest_none_when_empty(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "empty"))
    assert ckpt.restore_latest() is None and ckpt.latest_step() is None
    assert not CheckpointCallback(str(tmp_path / "e2"), _trainer()) \
        .restore_into(_trainer())


def test_max_to_keep_and_interval(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "keep"), max_to_keep=2,
                             save_interval_steps=2)
    saved = [ckpt.save(step, {"step": step}) for step in range(1, 8)]
    assert saved == [False, True, False, True, False, True, False]
    assert ckpt.all_steps() == [4, 6]
    assert ckpt.save(7, {"step": 7}, force=True)
    assert ckpt.all_steps() == [6, 7]
    assert not ckpt.save(7, {"step": 7})       # not newer than the latest
    assert ckpt.restore_latest() == {"step": 7}
    # no temporary file is left behind
    assert sorted(os.listdir(ckpt.directory)) == ["6.pt", "7.pt"]


def test_checkpoint_callback_resume_is_bit_equal(tmp_path):
    data = _data(4)
    full = _trainer(ema_decay=0.9)
    full.fit(data, epochs=3, verbose=False)

    first = _trainer(ema_decay=0.9)
    cb = CheckpointCallback(str(tmp_path / "cb"), first)
    first.fit(data, epochs=1, verbose=False, callbacks=[cb])
    assert cb.manager.latest_step() == 4
    resumed = _trainer(seed=9, ema_decay=0.9)
    assert cb.restore_into(resumed)
    resumed.fit(data, epochs=3, initial_epoch=1, verbose=False)
    _assert_same_state(full, resumed)


@pytest.mark.parametrize("accum,spe,rate", [(1, 1, 0.5), (2, 1, 0.0),
                                            (3, 2, 0.5)])
def test_mid_epoch_resume_is_bit_equal(tmp_path, accum, spe, rate):
    """The state carries the generator (dropout), the accumulator and its
    counter, the EMA and the optimizer's count: ``skip_batches`` resumes
    the exact run, mid-accumulation included."""
    data = _data(6)
    kwargs = dict(rate=rate, ema_decay=0.5,
                  gradient_accumulation_steps=accum,
                  steps_per_execution=spe)
    full = _trainer(**kwargs)
    full.fit(data, epochs=2, verbose=False)

    class Stop(tcb.Callback):
        def on_train_batch_end(self, batch, logs=None):
            if self.model._trainer.step >= 7:
                self.model.stop_training = True

    part = _trainer(**kwargs)
    cb = CheckpointCallback(str(tmp_path / "mid"), part)
    part.fit(data, epochs=2, verbose=False, callbacks=[Stop(), cb])
    stopped = part.step
    assert stopped in (7, 8) and cb.manager.latest_step() == stopped
    resumed = _trainer(seed=5, **kwargs)
    assert cb.restore_into(resumed)
    resumed.fit(data, epochs=2, initial_epoch=stopped // 6,
                skip_batches=stopped % 6, verbose=False)
    _assert_same_state(full, resumed)


def test_restore_seeds_ema_when_the_checkpoint_has_none(tmp_path):
    plain = _trainer()
    pc = PreemptionCheckpoint(str(tmp_path / "ckpt"), plain)
    plain.fit(_data(2), epochs=1, callbacks=[pc], verbose=False)
    ema = _trainer(ema_decay=0.9)
    assert PreemptionCheckpoint(str(tmp_path / "ckpt"), ema).restore_into(ema)
    for k, p in ema.state.params.items():
        assert torch.equal(ema.ema_variables[k], p)
    ema.fit(_data(2), epochs=1, verbose=False)
    # and a shadow the Trainer does not keep is dropped
    keep = _trainer(ema_decay=0.9)
    keep.fit(_data(2), epochs=1, verbose=False)
    CheckpointManager(str(tmp_path / "ema")).save(keep.step,
                                                  keep.state.as_dict())
    fresh = _trainer()
    fresh.state = CheckpointManager(str(tmp_path / "ema")).restore_latest()
    assert fresh.state.ema_params is None


class TestPreemption:
    def test_stop_training_ends_fit_early(self):
        class StopAtEpoch0(tcb.Callback):
            def on_epoch_end(self, epoch, logs=None):
                self.model.stop_training = True

        history = _trainer().fit(_data(), epochs=5, verbose=False,
                                 callbacks=[StopAtEpoch0()])
        assert len(history) == 1

    def test_sigterm_saves_and_stops(self, tmp_path):
        class SendSigterm(tcb.Callback):
            def __init__(self):
                self.sent = False

            def on_train_batch_begin(self, batch, logs=None):
                if batch == 1 and not self.sent:
                    self.sent = True
                    os.kill(os.getpid(), signal.SIGTERM)

        trainer = _trainer()
        pc = PreemptionCheckpoint(str(tmp_path / "pc"), trainer)
        prev = signal.getsignal(signal.SIGTERM)
        history = trainer.fit(_data(8), epochs=3, verbose=False,
                              callbacks=[SendSigterm(), pc])
        assert len(history) == 1 and trainer.step == 2 and pc.preempted
        assert pc.manager.latest_step() == 2
        assert signal.getsignal(signal.SIGTERM) is prev
        fresh = _trainer(seed=1)
        assert pc.restore_into(fresh)
        _assert_same_state(trainer, fresh)

    def test_save_every_steps_cadence(self, tmp_path):
        trainer = _trainer()
        pc = PreemptionCheckpoint(str(tmp_path / "cadence"), trainer,
                                  max_to_keep=10, save_every_steps=2)
        trainer.fit(_data(5), epochs=1, verbose=False, callbacks=[pc])
        # steps 2 and 4 from the cadence, 5 at the epoch's end
        assert pc.manager.all_steps() == [2, 4, 5]

    def test_stop_without_signal_is_not_a_preemption(self, tmp_path):
        class StopNow(tcb.Callback):
            def on_epoch_end(self, epoch, logs=None):
                self.model.stop_training = True

        trainer = _trainer()
        pc = PreemptionCheckpoint(str(tmp_path / "p3"), trainer)
        trainer.fit(_data(2), epochs=3, callbacks=[pc, StopNow()],
                    verbose=False)
        assert trainer.stop_training and not pc.preempted


def test_sgdw_momentum_state_round_trips(tmp_path):
    """SGDW's trace and the optimizer count survive a checkpoint."""
    def make():
        return Trainer(_Net(), loss=_mse, optimizer=functools.partial(
            SGDW, weight_decay=1e-3, learning_rate=0.05, momentum=0.9))

    data = _data(4)
    full = make()
    full.fit(data, epochs=2, verbose=False)
    part = make()
    part.fit(data, epochs=1, verbose=False)
    CheckpointManager(str(tmp_path / "s")).save(part.step,
                                                part.state.as_dict())
    resumed = make()
    resumed.state = CheckpointManager(str(tmp_path / "s")).restore_latest()
    assert resumed.optimizer.param_groups[0]["count"] == 4
    resumed.fit(data, epochs=2, initial_epoch=1, verbose=False)
    _assert_same_state(full, resumed)


def test_benchmark_helper_and_memory_stats():
    out = benchmark(lambda: torch.ones(8).sum(), warmup=1, iters=3)
    assert set(out) == {"p50_s", "mean_s", "min_s", "max_s", "times_s"}
    assert len(out["times_s"]) == 3 and out["min_s"] <= out["max_s"]
    if not torch.cuda.is_available():
        assert device_memory_stats() is None
