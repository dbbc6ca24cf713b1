"""The port's callbacks (``chambers_tpu_torch.callbacks``) against the JAX
package's: the same decisions on the same epoch logs, the same files, and
the experiment directory's layout, read back by both packages."""

import csv
import glob
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from chambers_tpu import callbacks as jcb
from chambers_tpu import optimizers as jopt
from chambers_tpu.models import Model as JModel
from chambers_tpu.training import Trainer as JTrainer
from chambers_tpu_torch import callbacks as tcb
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from chambers_tpu_torch.optimizers import AdamW
from chambers_tpu_torch.quantization import QuantDense
from chambers_tpu_torch.training import Trainer
from chambers_tpu_torch.utils.tensorboard import read_events
from test_torch_package import one_torch_thread  # noqa: F401


class _JNet(nn.Module):
    @nn.compact
    def __call__(self, x, deterministic=True):
        return nn.Dense(1)(nn.relu(nn.Dense(8)(x)))


class _TNet(torch.nn.Module):
    # Flax creates the outer Dense(1) first: it is Dense_0
    def __init__(self):
        super().__init__()
        self.Dense_0 = QuantDense(8, 1, device="cpu")
        self.Dense_1 = QuantDense(4, 8, device="cpu")

    def forward(self, x, deterministic=None):
        return self.Dense_0(torch.relu(self.Dense_1(x)))


def _pair():
    module = _JNet()
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    net = _TNet()
    net.load_state_dict(state_dict_from_jax(jax.device_get(
        variables["params"])))
    return JModel(module, variables), net


def _trainers():
    jmodel, net = _pair()
    jt = JTrainer(jmodel, loss=lambda a, b: jnp.mean((a - b) ** 2),
                  optimizer=jopt.AdamW(weight_decay=0.0, learning_rate=1e-2,
                                       epsilon=1e-8))
    tt = Trainer(net, loss=lambda a, b: torch.mean((a - b) ** 2),
                 optimizer=lambda named: AdamW(named, weight_decay=0.0,
                                               learning_rate=1e-2,
                                               epsilon=1e-8))
    return jt, tt


def _data(n=3, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 4).astype(np.float32),
             rng.randn(8, 1).astype(np.float32)) for _ in range(n)]


def _scalars(path):
    return [(e["step"], v["tag"], v["simple_value"])
            for e in read_events(path) for v in e.get("values", [])
            if "simple_value" in v]


def test_callback_list_dispatch():
    calls = []

    class A(tcb.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            calls.append(("a", epoch))

    class B(tcb.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            calls.append(("b", epoch))

    cl = tcb.CallbackList([A(), B()])
    cl.set_params({"epochs": 3})
    cl.on_epoch_begin(3)
    assert calls == [("a", 3), ("b", 3)]
    assert cl.callbacks[0].params == {"epochs": 3}


def test_csv_logger_writes_the_jax_packages_text(tmp_path):
    texts = []
    for mod, name in ((jcb, "jax.csv"), (tcb, "port.csv")):
        path = str(tmp_path / name)
        logger = mod.CSVLogger(path)
        logger.on_train_begin()
        logger.on_epoch_end(0, {"loss": 1.5, "acc": 0.5})
        logger.on_epoch_end(1, {"loss": torch.tensor(1.0), "acc": 0.7})
        logger.on_train_end()
        texts.append(open(path).read())
    assert texts[0] == texts[1]
    assert texts[1].splitlines()[:2] == ["epoch,acc,loss", "0,0.5,1.5"]


def test_scalar_logger_writes_the_jax_packages_lines(tmp_path):
    texts = []
    for mod in (jcb, tcb):
        d = tmp_path / mod.__name__
        logger = mod.ScalarLogger(str(d), update_freq="batch")
        logger.on_train_begin()
        logger.on_train_batch_end(0, {"loss": 2.0, "skip": [1, 2]})
        logger.on_epoch_end(0, {"loss": 1.5, "val_loss": 1.7})
        logger.on_train_end()
        texts.append((d / "events.jsonl").read_text())
    assert texts[0] == texts[1]
    assert json.loads(texts[1].splitlines()[0]) == {"step": 1,
                                                    "batch_loss": 2.0}


@pytest.mark.parametrize("mode,values,saved", [
    ("min", [1.0, 2.0, 0.5], ["01-1.00000", "03-0.50000"]),
    ("max", [1.0, 2.0, 0.5], ["01-1.00000", "02-2.00000"]),
])
def test_model_checkpoint_save_best_only(tmp_path, mode, values, saved):
    results = []
    for mod in (jcb, tcb):
        class FakeModel:
            saves = []

            def save_weights(self, path):
                FakeModel.saves.append(os.path.basename(path))

        ckpt = mod.ModelCheckpoint(
            str(tmp_path / "{epoch:02d}-{val_loss:.5f}.msgpack"),
            monitor="val_loss", mode=mode, save_best_only=True)
        ckpt.set_model(FakeModel())
        for epoch, v in enumerate(values):
            ckpt.on_epoch_end(epoch, {"val_loss": v})
        results.append(FakeModel.saves)
    assert results[0] == results[1] == [s + ".msgpack" for s in saved]


class _Stub:
    def __init__(self):
        self.stop_training = False
        self.weights = {"params": {"w": torch.zeros(1)}, "extra_vars": {}}
        self.restored = None

    def get_weights(self):
        return self.weights

    def set_weights(self, w):
        self.restored = w


@pytest.mark.parametrize("kwargs,values", [
    (dict(monitor="val_loss", patience=1), [1.0, 0.5, 0.6, 0.7]),
    (dict(monitor="val_loss", patience=0), [1.0, 0.5, 0.4]),
    (dict(monitor="val_loss", patience=2, min_delta=0.1),
     [1.0, 0.95, 0.93, 0.5, 0.49, 0.48]),
    (dict(monitor="val_acc", patience=1), [0.5, 0.6, 0.55, 0.54]),
    (dict(monitor="loss", patience=1, baseline=0.3), [1.0, 0.5, 0.2]),
])
def test_early_stopping_stops_where_jax_does(kwargs, values):
    stops = []
    for mod in (jcb, tcb):
        es = mod.EarlyStopping(restore_best_weights=True, **kwargs)
        stub = _Stub()
        es.set_model(stub)
        es.on_train_begin()
        for epoch, v in enumerate(values):
            stub.weights = {"params": {"w": torch.full((1,), float(epoch))},
                            "extra_vars": {}}
            es.on_epoch_end(epoch, {kwargs["monitor"]: v})
            if stub.stop_training:
                break
        es.on_train_end()
        restored = (None if stub.restored is None
                    else float(stub.restored["params"]["w"][0]))
        stops.append((es.stopped_epoch, es.mode, restored))
    assert stops[0] == stops[1]


def test_early_stopping_warns_on_a_missing_monitor():
    es = tcb.EarlyStopping(monitor="val_acc", patience=0)
    assert es.mode == "max"
    es.set_model(_Stub())
    es.on_train_begin()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        es.on_epoch_end(0, {"loss": 1.0})
    assert any("val_acc" in str(w.message) for w in caught)
    with pytest.raises(ValueError, match="mode"):
        tcb.EarlyStopping(mode="sideways")


def test_early_stopping_integration_restores_best():
    _, tt = _trainers()
    snap = {}

    class Snap(tcb.Callback):
        def on_epoch_end(self, epoch, logs=None):
            if epoch == 0:
                snap.update(self.model.get_weights()["params"])

    es = tcb.EarlyStopping(monitor="loss", mode="max", patience=1,
                           restore_best_weights=True)
    history = tt.fit(_data(4), epochs=10, verbose=False,
                     callbacks=[Snap(), es])
    assert len(history) == 2
    for k, v in tt.state.params.items():
        assert torch.equal(v, snap[k])


@pytest.mark.parametrize("check", ["epoch", "batch"])
def test_terminate_on_nan_decides_as_jax(check):
    for mod in (jcb, tcb):
        stub = _Stub()
        cb = mod.TerminateOnNaN(check=check)
        cb.set_model(stub)
        cb.on_train_batch_end(0, {"loss": torch.tensor(float("nan"))})
        assert stub.stop_training == (check == "batch")
        cb.on_epoch_end(0, {"loss": float("inf")})
        assert stub.stop_training
    with pytest.raises(ValueError, match="check"):
        tcb.TerminateOnNaN(check="never")


@pytest.mark.parametrize("kwargs", [dict(factor=1.0), dict(mode="up")])
def test_reduce_lr_argument_errors(kwargs):
    with pytest.raises(ValueError):
        tcb.ReduceLROnPlateau(**kwargs)


def test_experiment_callback_layout_and_files_both_packages_read(tmp_path):
    jt, tt = _trainers()
    runs = {}
    for name, trainer, mod in (("jax", jt, jcb), ("port", tt, tcb)):
        exp = mod.ExperimentCallback(str(tmp_path / name / "experiments"),
                                     checkpoint_monitor="loss",
                                     config_dump={"lr": 0.01})
        trainer.fit(_data(2), epochs=2, callbacks=[exp], verbose=False)
        runs[name] = exp
    layouts = {}
    for name, exp in runs.items():
        root = exp.experiment_dir
        layouts[name] = sorted(
            os.path.relpath(os.path.join(d, f), root)
            .replace(os.sep, "/").split(".tfevents")[0]
            for d, _, fs in os.walk(root) for f in fs
            if not f.endswith(".msgpack") or "checkpoints" not in d
            or f == "init.msgpack")
        ckpts = os.listdir(os.path.join(root, "model", "checkpoints"))
        assert "init.msgpack" in ckpts
        assert any(c.startswith("01-") for c in ckpts)
        assert any(c.startswith("02-") for c in ckpts)
        with open(os.path.join(root, "logs", "epoch_results.txt")) as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["epoch", "loss", "lr"] and len(rows) == 3
        assert json.load(open(os.path.join(root, "config_dump.json"))) == {
            "lr": 0.01}
    # the port exports the optimizer as torch.save (not Flax's msgpack)
    assert layouts["port"] == [
        p.replace("opt_state.msgpack", "opt_state.pt")
        for p in layouts["jax"]]
    # the port's checkpoint files load into the JAX model and back
    port_root = runs["port"].experiment_dir
    final = os.path.join(port_root, "model", "export", "model.msgpack")
    jmodel, net = _pair()
    jmodel.load_weights(final)
    for k, v in state_dict_from_jax(jax.device_get(
            jmodel.variables["params"])).items():
        np.testing.assert_array_equal(v.numpy(),
                                      tt.state.params[k].detach().numpy())
    from chambers_tpu_torch.models import Model

    init = os.path.join(runs["jax"].experiment_dir, "model", "checkpoints",
                        "init.msgpack")
    Model(net).load_weights(init)
    for k, v in state_dict_from_jax(jax.device_get(
            _pair()[0].variables["params"])).items():
        assert torch.equal(net.state_dict()[k], v)


def test_experiment_callback_serving_export_raises_naming_item_8(tmp_path):
    # the export came with item 8: train end writes model/export/model.pt2
    # beside model.msgpack, the live module's forward, and it serves any
    # batch (exact: the same float32 program)
    from chambers_tpu_torch.serving import load_serving_artifact

    _, net = _pair()
    trainer = Trainer(net, loss=lambda a, b: torch.mean((a - b) ** 2),
                      optimizer=lambda named: torch.optim.SGD(
                          [p for _, p in named], lr=1e-2))
    data = [(np.ones((8, 4), np.float32), np.ones((8, 1), np.float32))] * 2
    cb = tcb.ExperimentCallback(str(tmp_path), serving_input_shape=(4,))
    trainer.fit(data, epochs=1, callbacks=[cb], verbose=False)
    export = os.path.join(cb.export_dir)
    assert os.path.exists(os.path.join(export, "model.msgpack"))
    serve = load_serving_artifact(os.path.join(export, "model.pt2"))
    for b in (1, 5):
        x = torch.from_numpy(np.random.RandomState(b).rand(b, 4).astype(
            np.float32))
        with torch.no_grad():
            assert torch.equal(serve(x), net(x))


class TestTensorBoard:
    def test_epoch_scalars_split_train_validation_as_jax(self, tmp_path):
        jt, tt = _trainers()
        files = {}
        for name, trainer, mod in (("jax", jt, jcb), ("port", tt, tcb)):
            cb = mod.TensorBoard(str(tmp_path / name))
            trainer.fit(_data(), epochs=2, callbacks=[cb],
                        validation_data=_data(seed=1), verbose=False)
            files[name] = {
                sub: _scalars(glob.glob(str(tmp_path / name / sub
                                            / "*tfevents*"))[0])
                for sub in ("train", "validation")}
        for sub in ("train", "validation"):
            j, t = files["jax"][sub], files["port"][sub]
            assert [(s, tag) for s, tag, _ in j] == [(s, tag)
                                                    for s, tag, _ in t]
            np.testing.assert_allclose([v for *_, v in t],
                                       [v for *_, v in j], rtol=1e-5)

    def test_batch_freq_and_histograms(self, tmp_path):
        _, tt = _trainers()
        cb = tcb.TensorBoard(str(tmp_path), update_freq="batch",
                             histogram_freq=1)
        tt.fit(_data(n=3), epochs=2, callbacks=[cb], verbose=False)
        (train_file,) = glob.glob(str(tmp_path / "train" / "*tfevents*"))
        tags = [t for _, t, _ in _scalars(train_file)]
        assert tags.count("batch_loss") == 6
        histo = {v["tag"]: v["histo"] for e in read_events(train_file)
                 for v in e.get("values", []) if "histo" in v}
        assert set(histo) == {"Dense_0/kernel", "Dense_0/bias",
                              "Dense_1/kernel", "Dense_1/bias"}
        assert histo["Dense_1/kernel"]["num"] == 32

    def test_bad_update_freq_raises(self, tmp_path):
        with pytest.raises(ValueError, match="update_freq"):
            tcb.TensorBoard(str(tmp_path), update_freq="step")
