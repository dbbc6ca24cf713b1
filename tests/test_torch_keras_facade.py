"""The port's Keras front door (``chambers_tpu_torch.models.Model``):
``compile``/``fit``/``evaluate``/``predict`` against the JAX package's
``Model`` on the same data and init, string resolution, the array form
(the same seeded shuffles as the JAX package's ``_ArrayBatcher``), the
Keras return contract, ``save_weights``/``load_weights`` across the two
packages, and the three faults of the JAX wrapper that the port does not
carry over (each case fails under the JAX package's behaviour)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from chambers_tpu import losses as jlosses
from chambers_tpu import metrics as jmetrics
from chambers_tpu.models import Model as JModel
from chambers_tpu.models.model import _ArrayBatcher as JBatcher
from chambers_tpu_torch import losses as tlosses
from chambers_tpu_torch import metrics as tmetrics
from chambers_tpu_torch.models import Model
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from chambers_tpu_torch.models.model import _ArrayBatcher
from chambers_tpu_torch.quantization import QuantDense
from test_torch_package import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


class _JNet(nn.Module):
    classes: int = 4

    @nn.compact
    def __call__(self, x, deterministic=True):
        x = nn.Dense(32)(x)
        x = nn.relu(x)
        return nn.Dense(self.classes)(x)


class _TNet(torch.nn.Module):
    def __init__(self, classes=4):
        super().__init__()
        self.Dense_0 = QuantDense(8, 32, device="cpu")
        self.Dense_1 = QuantDense(32, classes, device="cpu")

    def forward(self, x, deterministic=None):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _pair(classes=4, seed=0):
    module = _JNet(classes=classes)
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8)))
    net = _TNet(classes)
    net.load_state_dict(state_dict_from_jax(jax.device_get(
        variables["params"])))
    return JModel(module, variables), Model(net)


def _data(n=64, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    y = rng.randint(0, classes, size=(n,)).astype(np.int32)
    return [(x[i:i + 16], y[i:i + 16]) for i in range(0, n, 16)]


def _arrays(n=80, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    y = np.argmax(x[:, :4] + 0.1 * rng.randn(n, 4), axis=1).astype(np.int32)
    return x, y


def _assert_history(jh, th):
    assert len(jh) == len(th)
    for je, te in zip(jh, th):
        for k, v in je.items():
            np.testing.assert_allclose(te[k], v, **TOL, err_msg=k)


def _assert_params(jm, tm):
    want = state_dict_from_jax(jax.device_get(jm.variables["params"]))
    for k, v in want.items():
        np.testing.assert_allclose(
            tm.module.state_dict()[k].numpy(), v.numpy(), **TOL, err_msg=k)


# --- compile / fit / evaluate against the JAX Model --------------------------------

@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd", "sgdw"])
def test_compile_fit_with_string_optimizer_matches_jax(optimizer):
    jm, tm = _pair()
    jm.compile(optimizer, "sparse_categorical_crossentropy",
               metrics=["accuracy"])
    tm.compile(optimizer, "sparse_categorical_crossentropy",
               metrics=["accuracy"])
    jh = jm.fit(_data(), epochs=2, verbose=False)
    th = tm.fit(_data(), epochs=2, verbose=False)
    _assert_history(jh, th)
    _assert_params(jm, tm)
    x = _data()[0][0]
    np.testing.assert_allclose(tm.predict(x, batch_size=5),
                               np.asarray(jm.predict(x, batch_size=5)),
                               **TOL)


def test_compile_fit_trains_and_predict_equals_call():
    _, tm = _pair()
    before = {k: v.clone() for k, v in tm.module.state_dict().items()}
    tm.compile("adam", tlosses.SparseCategoricalCrossentropy(
        from_logits=True), metrics=[tmetrics.SparseCategoricalAccuracy(
            device="cpu")])
    hist = tm.fit(_data(), epochs=3, verbose=False)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert "sparse_categorical_accuracy" in hist[0]
    assert any(not torch.equal(v, tm.module.state_dict()[k])
               for k, v in before.items())
    x = _data()[0][0]
    with torch.no_grad():
        np.testing.assert_allclose(tm.predict(x, batch_size=16),
                                   tm(torch.from_numpy(x)).numpy(),
                                   atol=1e-6)


def test_evaluate_returns_logs_and_kwargs_pass_through():
    jm, tm = _pair()
    for m, M in ((jm, jmetrics), (tm, tmetrics)):
        extra = {} if m is jm else {"device": "cpu"}
        m.compile("adamw", "sparse_categorical_crossentropy",
                  metrics={"acc": M.SparseCategoricalAccuracy(**extra)},
                  steps_per_execution=2, ema_decay=0.9,
                  gradient_accumulation_steps=2)
    assert tm.trainer._spe == 2 and tm.trainer.ema_decay == 0.9
    assert tm.trainer._accum == 2
    jh = jm.fit(_data(), epochs=2, verbose=False)
    th = tm.fit(_data(), epochs=2, verbose=False)
    for je, te in zip(jh, th):
        np.testing.assert_allclose(te["loss"], je["loss"], **TOL)
        np.testing.assert_allclose(te["acc"], je["acc"], **TOL)
    logs_j = jm.evaluate(_data(), verbose=False, return_dict=True)
    logs_t = tm.evaluate(_data(), verbose=False, return_dict=True)
    assert set(logs_t) == set(logs_j) == {"loss", "acc"}
    for k in logs_j:
        np.testing.assert_allclose(logs_t[k], logs_j[k], **TOL)


def test_mse_string_regression_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x @ rng.randn(8, 2)).astype(np.float32)
    jm, tm = _pair(classes=2)
    jm.compile("adam", "mse")
    tm.compile("adam", "mse")
    jh = jm.fit(x, y, batch_size=16, epochs=3, shuffle=True, seed=3,
                verbose=False)
    th = tm.fit(x, y, batch_size=16, epochs=3, shuffle=True, seed=3,
                verbose=False)
    assert th[-1]["loss"] < th[0]["loss"]
    _assert_history(jh, [{k: v for k, v in h.items() if k != "lr"}
                         for h in th])
    _assert_params(jm, tm)


@pytest.mark.parametrize("loss,metric,flavour", [
    ("sparse_categorical_crossentropy", "accuracy",
     "SparseCategoricalAccuracy"),
    ("categorical_crossentropy", "acc", "CategoricalAccuracy"),
    ("binary_crossentropy", "accuracy", "BinaryAccuracy"),
    ("bce", "acc", "BinaryAccuracy"),
])
def test_accuracy_string_takes_its_flavour_from_the_loss(loss, metric,
                                                        flavour):
    for m in _pair():
        m.compile("adam", loss, metrics=[metric])
        got = m.trainer.metrics[metric]
        assert type(got).__name__ == flavour


@pytest.mark.parametrize("name", [
    "categorical_accuracy", "sparse_categorical_accuracy", "binary_accuracy",
    "top_k_categorical_accuracy", "sparse_top_k_categorical_accuracy", "auc",
    "precision", "recall", "f1", "dsc"])
def test_explicit_metric_strings_resolve_as_jax(name):
    classes = []
    for m in _pair():
        m.compile("adam", "mse", metrics=[name])
        (metric,) = m.trainer.metrics.values()
        classes.append(type(metric).__name__)
    assert classes[0] == classes[1]


@pytest.mark.parametrize("args,match", [
    (("nope", "mse"), "optimizer string"),
    (("adam", "nope"), "loss string"),
    (("adam", "mse", ["nope"]), "metric string"),
    (("adam", "mse", ["accuracy"]), "cannot infer"),
    (("adam", "mse", [functools.partial(lambda y, p: p)]), "has no name"),
    (("adam", "mse", ["f1", "f1"]), "duplicate"),
])
def test_compile_errors(args, match):
    _, tm = _pair()
    with pytest.raises(ValueError, match=match):
        tm.compile(*args)


def test_uncompiled_model_raises():
    _, tm = _pair()
    with pytest.raises(ValueError, match="not compiled"):
        tm.fit(_data())


# --- the array form ------------------------------------------------------------------

def test_fit_arrays_trains_and_splits_as_jax():
    x, y = _arrays()
    jm, tm = _pair()
    jm.compile("adam", "sparse_categorical_crossentropy",
               metrics=["accuracy"])
    tm.compile("adam", "sparse_categorical_crossentropy",
               metrics=["accuracy"])
    jh = jm.fit(x, y, batch_size=16, epochs=3, validation_split=0.25,
                verbose=False)
    th = tm.fit(x, y, batch_size=16, epochs=3, validation_split=0.25,
                verbose=False)
    assert "val_loss" in th[-1] and "val_accuracy" in th[-1]
    assert th[-1]["loss"] < th[0]["loss"]
    # the port's "adam" is its AdamW, which logs "lr" (optax.adam does not)
    _assert_history(jh, th)
    _assert_params(jm, tm)


@pytest.mark.parametrize("split", [1.5, -0.5, 0.999])
def test_validation_split_bounds_checked(split):
    _, tm = _pair()
    tm.compile("adam", "sparse_categorical_crossentropy")
    x, y = np.zeros((8, 8), np.float32), np.zeros((8,), np.int32)
    with pytest.raises(ValueError, match="validation_split"):
        tm.fit(x, y, validation_split=split)


def test_fit_arrays_requires_targets_and_sample_weight_rules():
    _, tm = _pair()
    tm.compile("adam", "mse")
    with pytest.raises(ValueError, match="needs targets"):
        tm.fit(np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError, match="needs targets"):
        tm.evaluate(np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError, match="sample_weight"):
        tm.fit(_data(), sample_weight=np.ones(16))


@pytest.mark.parametrize("seed", [0, 7])
def test_shuffle_draws_the_jax_packages_batches(seed):
    x = np.arange(12, dtype=np.float32)[:, None]
    y = np.arange(12, dtype=np.int32)
    mine = _ArrayBatcher([x, y], batch_size=5, shuffle=True, seed=seed)
    theirs = JBatcher([x, y], batch_size=5, shuffle=True, seed=seed)
    for _ in range(3):
        a = [yy for _, yy in mine]
        b = [yy for _, yy in theirs]
        assert [list(v) for v in a] == [list(v) for v in b]
    assert len(mine) == 3


def test_evaluate_arrays_matches_iterable_form_and_sample_weight():
    rng = np.random.RandomState(2)
    x = rng.randn(48, 8).astype(np.float32)
    y = rng.randint(0, 4, size=(48,)).astype(np.int32)
    _, tm = _pair()
    tm.compile("adam", "sparse_categorical_crossentropy",
               metrics=["accuracy"])
    a = tm.evaluate(x, y, batch_size=16, verbose=False, return_dict=True)
    b = tm.evaluate([(x[i:i + 16], y[i:i + 16]) for i in range(0, 48, 16)],
                    verbose=False, return_dict=True)
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
    w = np.zeros((48,), np.float32)
    w[:16] = 1.0
    weighted = tm.evaluate(x, y, batch_size=48, sample_weight=w,
                           verbose=False, return_dict=True)
    half = tm.evaluate(x[:16], y[:16], batch_size=16, verbose=False,
                       return_dict=True)
    assert weighted["loss"] == pytest.approx(half["loss"] * 16 / 48,
                                             rel=1e-5)


def test_array_fit_windowed_equals_unwindowed():
    x, y = _arrays()
    runs = []
    for spe in (1, 3):
        _, tm = _pair()
        tm.compile("adam", "sparse_categorical_crossentropy",
                   steps_per_execution=spe)
        runs.append((tm.fit(x, y, batch_size=16, epochs=2, seed=4,
                            verbose=False), tm.module.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k])


def test_validation_data_tuple_of_arrays_as_jax():
    x, y = _arrays()
    jm, tm = _pair()
    for m in (jm, tm):
        m.compile("sgd", "sparse_categorical_crossentropy")
    jh = jm.fit(x[:64], y[:64], batch_size=16, epochs=2, shuffle=False,
                validation_data=(x[64:], y[64:]), verbose=False)
    th = tm.fit(x[:64], y[:64], batch_size=16, epochs=2, shuffle=False,
                validation_data=(x[64:], y[64:]), verbose=False)
    _assert_history(jh, th)


# --- the Keras return contract --------------------------------------------------------

def test_evaluate_returns_list_in_compile_order_or_scalar():
    jm, tm = _pair(classes=8)
    for m in (jm, tm):
        m.compile("adam", "sparse_categorical_crossentropy",
                  metrics=["accuracy", "sparse_top_k_categorical_accuracy"])
    data = _data(classes=8)
    got, want = tm.evaluate(data, verbose=False), jm.evaluate(
        data, verbose=False)
    assert isinstance(got, list) and len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, **TOL)
    _, plain = _pair()
    plain.compile("adam", "sparse_categorical_crossentropy")
    assert isinstance(plain.evaluate(_data(), verbose=False), float)


# --- weights across the packages -------------------------------------------------------

def test_save_weights_round_trips_across_packages(tmp_path):
    jm, tm = _pair(seed=3)
    path = str(tmp_path / "jax.msgpack")
    jm.save_weights(path)
    _, fresh = _pair(seed=4)
    fresh.load_weights(path)
    x = _data()[0][0]
    np.testing.assert_allclose(fresh.predict(x),
                               np.asarray(jm.predict(x)), **TOL)
    # the port's file, read by the JAX Model
    out = str(tmp_path / "port.msgpack")
    fresh.compile("adam", "mse")
    fresh.trainer.fit([(x, np.zeros((16, 4), np.float32))], verbose=False)
    fresh.save_weights(out)
    jfresh = _pair(seed=5)[0]
    jfresh.load_weights(out)
    np.testing.assert_allclose(np.asarray(jfresh.predict(x)),
                               fresh.predict(x), **TOL)


def test_count_params_summary_and_export(tmp_path):
    jm, tm = _pair()
    assert tm.count_params() == jm.count_params() == 8 * 32 + 32 + 32 * 4 + 4
    lines = []
    text = tm.summary(print_fn=lines.append)
    assert lines == [text]
    assert "Dense_0" in text and f"Total params: {tm.count_params():,}" \
        in text
    tm.export(str(tmp_path / "export"))
    import json

    config = json.load(open(tmp_path / "export" / "config.json"))
    assert config == {"name": "_TNet", "module": "_TNet"}
    jm2 = _pair(seed=9)[0]
    jm2.load_weights(str(tmp_path / "export" / "model.msgpack"))
    assert jm2.count_params() == tm.count_params()


# --- ADVICE r5's faults, not carried over --------------------------------------------

class _TPairNet(torch.nn.Module):
    """Two inputs, ``(a, b)``: the shape of the seq2seq's ``(src,
    tgt_in)``."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = QuantDense(8, 4, device="cpu")

    def forward(self, x, deterministic=None):
        a, b = x
        return self.Dense_0(a + b)


def test_array_fit_batches_every_leaf_of_a_pytree_x():
    rng = np.random.RandomState(0)
    a = rng.randn(40, 8).astype(np.float32)
    b = rng.randn(40, 8).astype(np.float32)
    y = rng.randint(0, 4, 40).astype(np.int32)
    # the JAX batcher turns the pair into one array and indexes its first
    # axis: the pair's axis, not the samples'
    with pytest.raises(Exception):
        list(JBatcher([(a, b), y], batch_size=16))
    batches = list(_ArrayBatcher([(a, b), y], batch_size=16))
    assert [tuple(t.shape[0] for t in xb) for xb, _ in batches] == [
        (16, 16), (16, 16), (8, 8)]
    model = Model(_TPairNet())
    model.compile("adam", "sparse_categorical_crossentropy")
    history = model.fit((a, b), y, batch_size=16, epochs=2,
                        validation_split=0.2, verbose=False)
    assert "val_loss" in history[-1]
    assert model.predict((a, b), batch_size=16).shape == (40, 4)


def test_dict_form_metric_strings_are_resolved():
    jm, tm = _pair()
    # the JAX Model hands the string itself to its Trainer, which fails
    with pytest.raises(Exception):
        jm.compile("adam", "sparse_categorical_crossentropy",
                   metrics={"acc": "accuracy"})
        jm.fit(_data(), epochs=1, verbose=False)
    tm.compile("adam", "sparse_categorical_crossentropy",
               metrics={"acc": "accuracy"})
    assert isinstance(tm.trainer.metrics["acc"],
                      tmetrics.SparseCategoricalAccuracy)
    history = tm.fit(_data(), epochs=1, verbose=False)
    assert 0.0 <= history[0]["acc"] <= 1.0


def test_evaluate_on_an_empty_dataset_says_so():
    jm, tm = _pair()
    jm.compile("adam", "sparse_categorical_crossentropy")
    with pytest.raises(KeyError):
        jm.evaluate([], verbose=False)
    tm.compile("adam", "sparse_categorical_crossentropy")
    with pytest.raises(ValueError, match="empty"):
        tm.evaluate([], verbose=False)


def test_export_of_a_serving_artifact_is_left_to_item_8(tmp_path):
    from chambers_tpu_torch.training.trainer import _CallbackModel

    _, tm = _pair()
    tm.compile("adam", "mse")
    facade = _CallbackModel(tm.trainer)
    assert facade.module is tm.module
    assert facade.base_learning_rate == 1e-3
    # serving came with item 8: the facade's forward exports and serves
    from chambers_tpu_torch.serving import (
        export_serving_artifact,
        load_serving_artifact,
    )

    path = str(tmp_path / "facade.pt2")
    export_serving_artifact(facade, path, (8,), batch_size=4)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 8).astype(
        np.float32))
    with torch.no_grad():
        assert torch.equal(load_serving_artifact(path)(x),
                           facade.apply_fn(x))
