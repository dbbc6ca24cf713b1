"""The port's ``Trainer`` (``chambers_tpu_torch.training``) held to the JAX
package's (``chambers_tpu.training``) on the same batches and init.

The models are a Dense(16)-relu-Dense regression net (and its BatchNorm
and MoE variants), built in Flax, converted with ``state_dict_from_jax``
into port modules of the same parameter names. Per-step losses and epoch
logs agree within 1e-5, parameters after 4-16 steps within 1e-5. The port
runs ``steps_per_execution`` windows as the same steps in the same order,
so its own ``spe=N`` runs are held bit-equal to ``spe=1``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from chambers_tpu import optimizers as jopt
from chambers_tpu import schedules as jsched
from chambers_tpu.callbacks import Callback as JCallback
from chambers_tpu.losses import Loss as JLoss
from chambers_tpu.models import Model as JModel
from chambers_tpu.training import Trainer as JTrainer
from chambers_tpu_torch import callbacks as tcb
from chambers_tpu_torch import optimizers as topt
from chambers_tpu_torch import schedules as tsched
from chambers_tpu_torch.losses import Loss as TLoss
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from chambers_tpu_torch.quantization import QuantDense
from chambers_tpu_torch.training import Trainer
from chambers_tpu_torch.training.trainer import _DevicePrefetcher
from test_torch_package import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


class _JNet(nn.Module):
    out: int = 1

    @nn.compact
    def __call__(self, x, deterministic=True):
        x = nn.Dense(16)(x)
        x = nn.relu(x)
        return nn.Dense(self.out)(x)


class _TNet(torch.nn.Module):
    def __init__(self, out=1):
        super().__init__()
        self.Dense_0 = QuantDense(4, 16, device="cpu")
        self.Dense_1 = QuantDense(16, out, device="cpu")

    def forward(self, x, deterministic=None):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _pair(out=1, seed=0):
    """A JAX ``Model`` and a port module with the same init."""
    module = _JNet(out=out)
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4)))
    net = _TNet(out)
    net.load_state_dict(state_dict_from_jax(jax.device_get(
        variables["params"])))
    return JModel(module, variables), net


def _batches(n_batches=8, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 1).astype(np.float32)
    data = []
    for _ in range(n_batches):
        x = rng.randn(batch, 4).astype(np.float32)
        y = x @ w + 0.01 * rng.randn(batch, 1).astype(np.float32)
        data.append((x, y))
    return data


def _jmse(y_true, y_pred):
    return jnp.mean((y_true - y_pred) ** 2)


def _tmse(y_true, y_pred):
    return torch.mean((y_true - y_pred) ** 2)


def _jmae(yt, yp):
    return jnp.mean(jnp.abs(yt - yp))


def _tmae(yt, yp):
    return torch.mean(torch.abs(yt - yp))


def _optimizers(kind):
    """The same optimizer in both packages: the JAX transform and the
    port's factory."""
    J, T = jopt, topt
    table = {
        "adamw": (J.AdamW(weight_decay=1e-2, learning_rate=1e-2),
                  functools.partial(T.AdamW, weight_decay=1e-2,
                                    learning_rate=1e-2)),
        "adamw_decay_exclude": (
            J.AdamW(weight_decay=1e-2, learning_rate=1e-2,
                    decay_exclude=["bias"]),
            functools.partial(T.AdamW, weight_decay=1e-2, learning_rate=1e-2,
                              decay_exclude=["bias"])),
        "adamw_cosine": (
            J.AdamW(weight_decay=0.0, learning_rate=jsched.CosineDecay(
                0.05, decay_steps=10)),
            functools.partial(T.AdamW, weight_decay=0.0,
                              learning_rate=tsched.CosineDecay(
                                  0.05, decay_steps=10))),
        "adamw_clipnorm": (
            J.AdamW(weight_decay=0.0, learning_rate=1e-2, clipnorm=0.5),
            functools.partial(T.AdamW, weight_decay=0.0, learning_rate=1e-2,
                              clipnorm=0.5)),
        "sgdw_momentum": (
            J.SGDW(weight_decay=1e-3, learning_rate=0.05, momentum=0.9),
            functools.partial(T.SGDW, weight_decay=1e-3, learning_rate=0.05,
                              momentum=0.9)),
        "sgdw_nesterov": (
            J.SGDW(weight_decay=0.0, learning_rate=0.05, momentum=0.9,
                   nesterov=True),
            functools.partial(T.SGDW, weight_decay=0.0, learning_rate=0.05,
                              momentum=0.9, nesterov=True)),
        "sgd": (optax.sgd(0.1),
                functools.partial(T.SGDW, weight_decay=0.0,
                                  learning_rate=0.1)),
        "adam": (optax.adam(1e-2),
                 functools.partial(T.AdamW, weight_decay=0.0,
                                   learning_rate=1e-2, epsilon=1e-8)),
    }
    return table[kind]


def _trainers(kind="adamw", out=1, seed=0, metrics=None, **kwargs):
    jopt_, topt_ = _optimizers(kind)
    jmodel, net = _pair(out, seed)
    jmetrics, tmetrics = metrics or ({}, {})
    jloss, tloss = kwargs.pop("jloss", _jmse), kwargs.pop("tloss", _tmse)
    jt = JTrainer(jmodel, loss=jloss, optimizer=jopt_, metrics=jmetrics,
                  **kwargs)
    tt = Trainer(net, loss=tloss, optimizer=topt_, metrics=tmetrics,
                 **kwargs)
    return jt, tt


def _jparams(jt, ema=False):
    tree = jt.state.ema_params if ema else jt.state.params
    return state_dict_from_jax(jax.device_get(tree))


def _assert_params(jt, tt, ema=False):
    want = _jparams(jt, ema)
    got = tt.ema_variables if ema else tt.state.params
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), **TOL,
                                   err_msg=k)


def _assert_history(jh, th, skip=()):
    assert len(jh) == len(th)
    for je, te in zip(jh, th):
        for k, v in je.items():
            if k in skip:
                continue
            np.testing.assert_allclose(te[k], v, **TOL, err_msg=k)


def _bit_equal_state(a, b):
    for k, v in a.state.params.items():
        assert torch.equal(v, b.state.params[k]), k


# --- fit against the JAX Trainer -----------------------------------------------

@pytest.mark.parametrize("kind", ["adamw", "adamw_decay_exclude",
                                  "adamw_cosine", "adamw_clipnorm",
                                  "sgdw_momentum", "sgdw_nesterov", "sgd",
                                  "adam"])
def test_fit_matches_jax(kind):
    jt, tt = _trainers(kind)
    data = _batches(4)
    _assert_history(jt.fit(data, epochs=2, verbose=False),
                    tt.fit(data, epochs=2, verbose=False))
    _assert_params(jt, tt)


def test_fit_reduces_loss_and_metrics_match_jax():
    jt, tt = _trainers("adam", metrics=({"mae": _jmae}, {"mae": _tmae}))
    data = _batches()
    jh = jt.fit(data, epochs=3, validation_data=data, verbose=False)
    th = tt.fit(data, epochs=3, validation_data=data, verbose=False)
    assert "mae" in th[-1] and "val_mae" in th[-1]
    assert th[-1]["mae"] < th[0]["mae"]
    _assert_history(jh, th)
    logs_j = jt.evaluate(data, verbose=False)
    logs_t = tt.evaluate(data, verbose=False)
    assert set(logs_j) == set(logs_t)
    for k in logs_j:
        np.testing.assert_allclose(logs_t[k], logs_j[k], **TOL)


def test_streaming_metric_matches_one_shot_and_jax():
    from chambers_tpu.metrics import F1 as JF1
    from chambers_tpu_torch.metrics import F1 as TF1

    jt, tt = _trainers("sgd", metrics=({"f1": JF1(thresholds=0.0)},
                                       {"f1": TF1(thresholds=0.0,
                                                  device="cpu")}))
    data = _batches(4)
    ref = TF1(thresholds=0.0, device="cpu")
    with torch.no_grad():
        preds = [tt.module(torch.from_numpy(x)) for x, _ in data]
    ref.update_state(torch.from_numpy(np.concatenate([y for _, y in data])),
                     torch.cat(preds))
    logs = tt.evaluate(data, verbose=False)
    np.testing.assert_allclose(logs["f1"], ref.result(), rtol=1e-6)
    np.testing.assert_allclose(logs["f1"],
                               jt.evaluate(data, verbose=False)["f1"], **TOL)


# --- steps_per_execution ---------------------------------------------------------

class _StreamingMAE:
    """An init/update/compute metric, generic over the array module."""

    def __init__(self, xp):
        self.xp = xp

    def init(self):
        zero = (self.xp.zeros(()) if self.xp is jnp
                else torch.zeros((), dtype=torch.float32))
        return {"sum": zero, "count": zero}

    def update(self, state, y_true, y_pred):
        return {"sum": state["sum"] + (abs(y_true - y_pred)).sum(),
                "count": state["count"] + y_true.size
                if self.xp is jnp else state["count"] + y_true.numel()}

    def compute(self, state):
        return state["sum"] / state["count"]


def _spe_metrics():
    return ({"mae": _jmae, "smae": _StreamingMAE(jnp)},
            {"mae": _tmae, "smae": _StreamingMAE(torch)})


@pytest.mark.parametrize("spe,n_batches,kwargs", [
    (4, 8, {}),
    (4, 7, {}),                 # partial trailing window
    (16, 5, {}),                # window larger than the epoch
    (4, 8, dict(ema_decay=0.9, gradient_accumulation_steps=2,
                trainable=[r"Dense_1"])),
], ids=["n4", "partial_tail", "window_over_epoch", "ema_accum_frozen"])
def test_steps_per_execution_equals_n1_and_jax(spe, n_batches, kwargs):
    data = _batches(n_batches)
    jt, one = _trainers("adam", metrics=_spe_metrics(), **kwargs)
    _, many = _trainers("adam", metrics=_spe_metrics(),
                        steps_per_execution=spe, **kwargs)
    jh = jt.fit(data, epochs=2, verbose=False)
    h1 = one.fit(data, epochs=2, verbose=False)
    hn = many.fit(data, epochs=2, verbose=False)
    assert h1 == hn
    _bit_equal_state(one, many)
    assert one.step == many.step == 2 * n_batches
    _assert_history(jh, hn, skip=("lr",))
    _assert_params(jt, many)
    if "ema_decay" in kwargs:
        for k, v in one.ema_variables.items():
            assert torch.equal(v, many.ema_variables[k])
        _assert_params(jt, many, ema=True)


def test_steps_per_epoch_windows_do_not_cross_epochs():
    data = _batches(12)
    _, one = _trainers("adam", metrics=_spe_metrics())
    h1 = one.fit(data, epochs=2, steps_per_epoch=6, verbose=False)
    _, tt = _trainers("adam", metrics=_spe_metrics(), steps_per_execution=4)
    windows = []

    class Spy(tcb.Callback):
        def on_train_batch_begin(self, batch, logs=None):
            windows.append(batch)

    h = tt.fit(data, epochs=2, steps_per_epoch=6, verbose=False,
               callbacks=[Spy()])
    assert windows == [0, 4, 0, 4]
    assert h == h1
    _bit_equal_state(one, tt)


def test_callbacks_fire_per_window_with_last_step_logs():
    _, tt = _trainers("adam", steps_per_execution=4)
    begins, ends, end_losses = [], [], []

    class Spy(tcb.Callback):
        def on_train_batch_begin(self, batch, logs=None):
            begins.append(batch)

        def on_train_batch_end(self, batch, logs=None):
            ends.append(batch)
            end_losses.append(float(logs["loss"]))

    tt.fit(_batches(8), epochs=1, verbose=False, callbacks=[Spy()])
    assert begins == [0, 4] and ends == [3, 7]
    _, one = _trainers("adam")
    losses = []

    class Spy1(tcb.Callback):
        def on_train_batch_end(self, batch, logs=None):
            losses.append(float(logs["loss"]))

    one.fit(_batches(8), epochs=1, verbose=False, callbacks=[Spy1()])
    assert end_losses == [losses[3], losses[7]]


def test_evaluate_windows_match():
    data = _batches(7)
    jt, one = _trainers("adam", metrics=_spe_metrics())
    _, four = _trainers("adam", metrics=_spe_metrics(), steps_per_execution=4)
    r1, r4 = one.evaluate(data, verbose=False), four.evaluate(data,
                                                                verbose=False)
    assert r1 == r4
    rj = jt.evaluate(data, verbose=False)
    for k in rj:
        np.testing.assert_allclose(r4[k], rj[k], **TOL)


@pytest.mark.parametrize("spe,check,epochs_run,steps_run", [
    (4, "batch", 1, 4),     # stops at the window boundary
    (1, "batch", 1, 1),
    (1, "epoch", 1, 4),
])
def test_terminate_on_nan(spe, check, epochs_run, steps_run):
    _, tt = _trainers("adam", steps_per_execution=spe)
    tt.loss = lambda yt, yp: torch.mean(yp) * float("nan")
    history = tt.fit(_batches(4 if spe == 1 else 8), epochs=3,
                     verbose=False,
                     callbacks=[tcb.TerminateOnNaN(check=check)])
    assert len(history) == epochs_run
    assert tt.step == steps_run


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(steps_per_execution=0), ValueError, "steps_per_execution"),
    (dict(gradient_accumulation_steps=0), ValueError,
     "gradient_accumulation_steps"),
    (dict(ema_decay=1.0), ValueError, "ema_decay"),
    (dict(trainable=r"does_not_exist_xyz"), ValueError,
     "matches no parameters"),
    (dict(mesh=object()), TypeError, "DeviceMesh"),
    (dict(param_sharding_rules=[("kernel", None)]), ValueError, "mesh="),
])
def test_invalid_arguments_raise(kwargs, error, match):
    _, net = _pair()
    with pytest.raises(error, match=match):
        Trainer(net, loss=_tmse, optimizer=_optimizers("adam")[1], **kwargs)


def test_built_optimizer_must_cover_the_trainable_parameters():
    _, net = _pair()
    head = [p for n, p in net.named_parameters() if n.startswith("Dense_1")]
    with pytest.raises(ValueError, match="trainable"):
        Trainer(net, loss=_tmse, optimizer=torch.optim.SGD(head, lr=0.1))
    t = Trainer(net, loss=_tmse, optimizer=torch.optim.SGD(head, lr=0.1),
                trainable=r"Dense_1")
    before = net.Dense_0.kernel.detach().clone()
    t.fit(_batches(2), epochs=1, verbose=False)
    assert torch.equal(before, net.Dense_0.kernel)
    with pytest.raises(TypeError, match="factory"):
        Trainer(net, loss=_tmse, optimizer=0.1)


# --- the prefetcher, the loop, callbacks ----------------------------------------

def test_device_prefetcher_places_lazily_and_ahead():
    placed = []

    def place(x, y):
        placed.append(x)
        return x, y

    pf = _DevicePrefetcher(iter([(i, i) for i in range(5)]), place, depth=2)
    assert placed == []
    assert next(pf) == (0, 0)
    assert placed == [0, 1, 2]
    assert list(pf) == [(1, 1), (2, 2), (3, 3), (4, 4)]
    with pytest.raises(StopIteration):
        next(pf)


def test_validation_steps_consumes_exactly():
    seen = []

    class CountingData:
        def __iter__(self):
            for i, b in enumerate(_batches(n_batches=8)):
                seen.append(i)
                yield b

    _, tt = _trainers("adam")
    tt.fit(_batches(2), epochs=1, validation_data=CountingData(),
           validation_steps=3, verbose=False)
    # the prefetcher reads up to two batches ahead of the last step
    assert max(seen) <= 4
    _, t1 = _trainers("adam")
    logs = t1.evaluate(CountingData(), steps=3, verbose=False)
    assert np.isfinite(logs["loss"])


def test_callbacks_fire_and_logs_keys():
    _, tt = _trainers("adam")
    events = []

    class Recorder(tcb.Callback):
        def on_train_begin(self, logs=None):
            events.append("train_begin")

        def on_epoch_end(self, epoch, logs=None):
            events.append(("epoch_end", epoch, sorted(logs)))

        def on_train_end(self, logs=None):
            events.append("train_end")

    before = tt.module.Dense_0.kernel.detach().clone()
    tt.fit(_batches(2), epochs=2, callbacks=[Recorder()], verbose=False)
    assert events[0] == "train_begin" and events[-1] == "train_end"
    assert ("epoch_end", 0, ["loss", "lr"]) in events
    assert not torch.equal(before, tt.module.Dense_0.kernel)
    assert tt.sync_model() is tt.model


def test_empty_dataset_raises_on_a_later_epoch_and_in_evaluate():
    _, tt = _trainers("adam")
    with pytest.raises(ValueError, match="no batches"):
        tt.fit(iter(_batches(2)), epochs=2, verbose=False)
    with pytest.raises(ValueError, match="empty"):
        tt.evaluate([], verbose=False)


# --- gradient accumulation and EMA ------------------------------------------------

def test_gradient_accumulation_matches_big_batch_and_jax():
    data = _batches(n_batches=4, batch=8)
    big = [(np.concatenate([x for x, _ in data]),
            np.concatenate([y for _, y in data]))]
    jt, acc = _trainers("sgd", gradient_accumulation_steps=4)
    _, ref = _trainers("sgd")
    jt.fit(data, epochs=1, verbose=False)
    acc.fit(data, epochs=1, verbose=False)
    ref.fit(big, epochs=1, verbose=False)
    for k, v in ref.state.params.items():
        np.testing.assert_allclose(acc.state.params[k].detach().numpy(),
                                   v.detach().numpy(), rtol=2e-5, atol=2e-6)
    _assert_params(jt, acc)


def test_gradient_accumulation_carries_over_fit_boundaries():
    """Three microbatches, then three more in a second fit: with N=2 the
    third and fourth form one update, as optax.MultiSteps does."""
    data = _batches(n_batches=6)
    jt, tt = _trainers("adam", gradient_accumulation_steps=2)
    _, whole = _trainers("adam", gradient_accumulation_steps=2)
    for t in (jt, tt):
        t.fit(data[:3], epochs=1, verbose=False)
        t.fit(data[3:], epochs=1, verbose=False)
    whole.fit(data, epochs=1, verbose=False)
    _bit_equal_state(tt, whole)
    _assert_params(jt, tt)
    assert tt.optimizer.param_groups[0]["count"] == 3


def test_gradient_accumulation_reduces_loss():
    _, tt = _trainers("adam", gradient_accumulation_steps=2)
    history = tt.fit(_batches(), epochs=20, verbose=False)
    assert history[-1]["loss"] < history[0]["loss"] * 0.2


class TestEMA:
    def test_one_step_closed_form(self):
        _, tt = _trainers("sgd", ema_decay=0.9)
        init = {k: v.detach().clone() for k, v in tt.state.params.items()}
        tt.fit(_batches(1), epochs=1, verbose=False)
        for k, p in tt.state.params.items():
            np.testing.assert_allclose(
                tt.ema_variables[k].numpy(),
                (0.9 * init[k] + 0.1 * p.detach()).numpy(), rtol=1e-6)

    def test_decay_zero_tracks_params_exactly(self):
        _, tt = _trainers("adam", ema_decay=0.0)
        tt.fit(_batches(4), epochs=2, verbose=False)
        for k, p in tt.state.params.items():
            assert torch.equal(tt.ema_variables[k], p.detach())

    @pytest.mark.parametrize("accum", [1, 2])
    def test_matches_jax(self, accum):
        data = _batches(4)
        jt, tt = _trainers("sgd", ema_decay=0.9,
                           gradient_accumulation_steps=accum, seed=5)
        jt.fit(data, epochs=2, verbose=False)
        tt.fit(data, epochs=2, verbose=False)
        _assert_params(jt, tt, ema=True)

    def test_disabled_raises_and_the_shadow_loads_into_a_twin(self):
        _, tt = _trainers("adam")
        with pytest.raises(ValueError, match="ema_decay"):
            _ = tt.ema_variables
        assert tt.state.ema_params is None
        _, te = _trainers("adam", ema_decay=0.99)
        te.fit(_batches(4), epochs=1, verbose=False)
        twin = _TNet()
        twin.load_state_dict(te.ema_variables)
        assert torch.equal(twin.Dense_0.kernel, te.ema_variables[
            "Dense_0.kernel"])
        diff = max(float((te.ema_variables[k] - p.detach()).abs().max())
                   for k, p in te.state.params.items())
        assert diff > 0


# --- learning rate logs and resume --------------------------------------------------

def test_lr_logs_match_jax():
    jt, tt = _trainers("adamw_cosine")
    jh = jt.fit(_batches(2), epochs=2, verbose=False)
    th = tt.fit(_batches(2), epochs=2, verbose=False)
    np.testing.assert_allclose([h["lr"] for h in th], [h["lr"] for h in jh],
                               rtol=1e-6)
    assert th[1]["lr"] < th[0]["lr"]
    _, plain = _trainers("adam")
    plain.optimizer = torch.optim.SGD(plain.module.parameters(), lr=0.1)
    assert "lr" not in plain.fit(_batches(1), epochs=1, verbose=False)[0]


def test_fit_skip_batches_mid_epoch_resume():
    data = _batches(n_batches=6)
    _, full = _trainers("adamw", seed=7)
    full.fit(data, epochs=1, verbose=False)
    _, resumed = _trainers("adamw", seed=7)
    resumed.fit(data[:4], epochs=1, verbose=False)
    snapshot = resumed.state
    resumed.state = snapshot
    assert resumed.state.step == 4
    resumed.fit(data, epochs=1, verbose=False, skip_batches=4)
    _bit_equal_state(full, resumed)


# --- trainable ------------------------------------------------------------------------

@pytest.mark.parametrize("trainable", [
    r"Dense_1", [r"Dense_1/kernel", r"bias$"], r".",
    lambda path: path.endswith("bias"),
], ids=["regex", "regex_list", "all", "callable"])
def test_trainable_matches_jax_and_freezes(trainable):
    jt, tt = _trainers("adamw_decay_exclude", trainable=trainable)
    before = {k: v.detach().clone() for k, v in tt.state.params.items()}
    data = _batches(4)
    _assert_history(jt.fit(data, epochs=2, verbose=False),
                    tt.fit(data, epochs=2, verbose=False))
    _assert_params(jt, tt)
    trains = {n for n, p in tt.module.named_parameters() if p.requires_grad}
    for k, v in tt.state.params.items():
        assert torch.equal(v, before[k]) == (k not in trains), k
    # moments for the trainable parameters only
    assert len(tt.optimizer.state) == len(trains)


def test_trainable_all_equals_unfrozen_run():
    _, t1 = _trainers("adam")
    _, t2 = _trainers("adam", trainable=r".")
    t1.fit(_batches(4), epochs=3, verbose=False)
    t2.fit(_batches(4), epochs=3, verbose=False)
    _bit_equal_state(t1, t2)


def test_trainable_with_accumulation_and_ema_matches_jax():
    jt, tt = _trainers("adam", trainable=r"Dense_1",
                       gradient_accumulation_steps=2, ema_decay=0.5)
    before = tt.module.Dense_0.kernel.detach().clone()
    data = _batches(4)
    jt.fit(data, epochs=2, verbose=False)
    tt.fit(data, epochs=2, verbose=False)
    assert torch.equal(tt.module.Dense_0.kernel, before)
    assert torch.equal(tt.ema_variables["Dense_0.kernel"], before)
    _assert_params(jt, tt)
    _assert_params(jt, tt, ema=True)


# --- BatchNorm, MoE, quantized models -----------------------------------------------

class _JBNNet(nn.Module):
    @nn.compact
    def __call__(self, x, deterministic=True):
        x = nn.Dense(16)(x)
        x = nn.BatchNorm(use_running_average=deterministic, momentum=0.9)(x)
        x = nn.relu(x)
        return nn.Dense(1)(x)


class _TBNNet(torch.nn.Module):
    def __init__(self):
        from chambers_tpu_torch.layers.convolution import BatchNorm

        super().__init__()
        self.Dense_0 = QuantDense(4, 16, device="cpu")
        self.BatchNorm_0 = BatchNorm(16, device="cpu")
        self.BatchNorm_0.momentum = 0.9
        self.Dense_1 = QuantDense(16, 1, device="cpu")

    def forward(self, x, deterministic=None):
        train = (self.training if deterministic is None
                 else not deterministic)
        x = self.BatchNorm_0(self.Dense_0(x), train)
        return self.Dense_1(torch.relu(x))


def test_batchnorm_statistics_match_jax():
    module = _JBNNet()
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    net = _TBNNet()
    v = jax.device_get(variables)
    net.load_state_dict(state_dict_from_jax(v["params"],
                                            batch_stats=v["batch_stats"]))
    # SGD: the bias before BatchNorm gets a gradient of rounding noise
    # only, which Adam's g / (|g| + eps) would blow up to full steps
    jopt_, topt_ = _optimizers("sgdw_momentum")
    jt = JTrainer(JModel(module, variables), loss=_jmse, optimizer=jopt_)
    tt = Trainer(net, loss=_tmse, optimizer=topt_)
    data = _batches(4)
    _assert_history(jt.fit(data, epochs=3, verbose=False),
                    tt.fit(data, epochs=3, verbose=False))
    _assert_params(jt, tt)
    stats = state_dict_from_jax(jax.device_get(
        jt.state.extra_vars["batch_stats"]))
    for k, want in stats.items():
        np.testing.assert_allclose(tt.state.extra_vars[k].numpy(),
                                   want.numpy(), **TOL, err_msg=k)
    assert float((tt.state.extra_vars["BatchNorm_0.var"] - 1).abs().max()) \
        > 1e-3
    logs_j, logs_t = jt.evaluate(data, verbose=False), tt.evaluate(
        data, verbose=False)
    np.testing.assert_allclose(logs_t["loss"], logs_j["loss"], **TOL)
    assert tt.variables["batch_stats"]["BatchNorm_0"]["mean"].shape == (16,)


def test_moe_aux_loss_is_added_and_logged_as_jax():
    from chambers_tpu.layers.moe import MoEMLP as JMoE
    from chambers_tpu_torch.layers.moe import MoEMLP as TMoE

    class JNet(nn.Module):
        @nn.compact
        def __call__(self, x, deterministic=True):
            x = JMoE(ff_dim=16, n_experts=4, aux_loss_weight=1e-2)(
                x, deterministic=deterministic)
            return nn.Dense(1)(x)

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.MoEMLP_0 = TMoE(4, 16, 4, aux_loss_weight=1e-2,
                                 device="cpu")
            self.Dense_0 = QuantDense(4, 1, device="cpu")

        def forward(self, x, deterministic=None):
            return self.Dense_0(self.MoEMLP_0(x))

    module = JNet()
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    net = TNet()
    net.load_state_dict(state_dict_from_jax(jax.device_get(
        variables["params"])))
    jt = JTrainer(JModel(module, variables), loss=_jmse,
                  optimizer=optax.adam(1e-2))
    tt = Trainer(net, loss=_tmse, optimizer=_optimizers("adam")[1])
    router = net.MoEMLP_0.w_router.detach().clone()
    data = _batches(4)
    jh = jt.fit(data, epochs=3, verbose=False)
    th = tt.fit(data, epochs=3, verbose=False)
    assert 0.0 < th[0]["moe_aux_loss"] < th[0]["loss"]
    _assert_history(jh, th)
    _assert_params(jt, tt)
    assert float((net.MoEMLP_0.w_router - router).abs().max()) > 0


def test_quantized_module_is_refused():
    from chambers_tpu_torch.quantization import quantize_model

    _, net = _pair()
    quantize_model(net)
    with pytest.raises(ValueError, match="int8"):
        Trainer(net, loss=_tmse, optimizer=_optimizers("adam")[1])


# --- sample and class weights (tests/test_training_weighted.py) -------------------

class _JMSE(JLoss):
    def call(self, y_true, y_pred):
        return jnp.mean((jnp.asarray(y_true) - jnp.asarray(y_pred)) ** 2,
                        axis=-1)


class _TMSE(TLoss):
    def call(self, y_true, y_pred):
        return torch.mean((y_true - y_pred) ** 2, dim=-1)


class _JSparseCE(JLoss):
    def call(self, y_true, y_pred):
        return optax.softmax_cross_entropy_with_integer_labels(
            y_pred, jnp.asarray(y_true))


class _TSparseCE(TLoss):
    def call(self, y_true, y_pred):
        return torch.nn.functional.cross_entropy(
            y_pred, y_true.to(torch.int64), reduction="none")


def _weighted_batches(n_batches=6, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(4, 1).astype(np.float32)
    data = []
    for _ in range(n_batches):
        x = rng.randn(batch, 4).astype(np.float32)
        y = (x @ w_true).astype(np.float32)
        w = rng.rand(batch).astype(np.float32) + 0.25
        data.append((x, y, w))
    return data


def _class_batches(n_batches=4, batch=16, classes=3, seed=1, one_hot=False,
                   column=False):
    rng = np.random.RandomState(seed)
    data = []
    for _ in range(n_batches):
        x = rng.randn(batch, 4).astype(np.float32)
        y = rng.randint(0, classes, batch)
        if one_hot:
            y = np.eye(classes, dtype=np.float32)[y]
        elif column:
            y = y[:, None]
        data.append((x, y))
    return data


def _weighted_trainers(kind="sgd", out=1, loss="mse", **kwargs):
    jl, tl = (_JMSE(), _TMSE()) if loss == "mse" else (_JSparseCE(),
                                                      _TSparseCE())
    return _trainers(kind, out=out, jloss=jl, tloss=tl, **kwargs)


@pytest.mark.parametrize("spe", [1, 3])
def test_weighted_fit_and_evaluate_match_jax(spe):
    data = _weighted_batches()
    jt, tt = _weighted_trainers(steps_per_execution=spe)
    _assert_history(jt.fit(data, epochs=2, verbose=False),
                    tt.fit(data, epochs=2, verbose=False))
    _assert_params(jt, tt)
    np.testing.assert_allclose(tt.evaluate(data, verbose=False)["loss"],
                               jt.evaluate(data, verbose=False)["loss"],
                               **TOL)


def test_zero_weighted_samples_do_not_train():
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    data = [(x, np.ones((8, 1), np.float32), np.zeros(8, np.float32))]
    _, tt = _weighted_trainers()
    before = {k: v.detach().clone() for k, v in tt.state.params.items()}
    tt.fit(data, epochs=3, verbose=False)
    for k, v in tt.state.params.items():
        assert torch.equal(v, before[k])


@pytest.mark.parametrize("layout", ["sparse", "column", "one_hot"])
def test_class_weight_matches_jax(layout):
    data = _class_batches(one_hot=layout == "one_hot",
                          column=layout == "column")
    cw = {0: 1.0, 1: 3.0, 2: 0.5}
    if layout == "one_hot":
        jl, tl = (lambda y, p, sample_weight=None: _JSparseCE()(
            jnp.argmax(y, -1), p, sample_weight=sample_weight),
            lambda y, p, sample_weight=None: _TSparseCE()(
                y.argmax(-1), p, sample_weight=sample_weight))
    elif layout == "column":
        jl, tl = (lambda y, p, sample_weight=None: _JSparseCE()(
            y[:, 0], p, sample_weight=sample_weight),
            lambda y, p, sample_weight=None: _TSparseCE()(
                y[:, 0], p, sample_weight=sample_weight))
    else:
        jl, tl = _JSparseCE(), _TSparseCE()
    jt, tt = _trainers("sgd", out=3, jloss=jl, tloss=tl)
    _assert_history(jt.fit(data, epochs=2, verbose=False, class_weight=cw),
                    tt.fit(data, epochs=2, verbose=False, class_weight=cw))
    _assert_params(jt, tt)


def test_class_weight_equals_explicit_weights_and_multiplies():
    data = _class_batches()
    cw = {0: 2.0, 2: 0.5}          # class 1 absent: weight 1
    table = np.array([2.0, 1.0, 0.5], np.float32)
    _, a = _weighted_trainers(out=3, loss="ce")
    _, b = _weighted_trainers(out=3, loss="ce")
    a.fit(data, epochs=1, verbose=False, class_weight=cw)
    b.fit([(x, y, table[y]) for x, y in data], epochs=1, verbose=False)
    _bit_equal_state(a, b)
    w = np.linspace(0.5, 1.5, 16).astype(np.float32)
    _, c = _weighted_trainers(out=3, loss="ce")
    _, d = _weighted_trainers(out=3, loss="ce")
    c.fit([(x, y, w) for x, y in data], epochs=1, verbose=False,
          class_weight=cw)
    d.fit([(x, y, w * table[y]) for x, y in data], epochs=1, verbose=False)
    _bit_equal_state(c, d)


@pytest.mark.parametrize("case,error,match", [
    ("out_of_range", ValueError, "outside class_weight"),
    ("rank3", ValueError, "rank 3"),
    ("plain_loss", TypeError, "sample_weight"),
    ("mixed_window", ValueError, "mixes weighted"),
    ("bad_table", ValueError, "non-empty"),
])
def test_weighting_errors(case, error, match):
    x = np.zeros((4, 4), np.float32)
    _, tt = _weighted_trainers(out=3, loss="ce", steps_per_execution=2)
    kwargs = {"epochs": 1, "verbose": False}
    if case == "out_of_range":
        data, kwargs["class_weight"] = [(x, np.array([0, 1, 2, 5]))], {0: 1.0,
                                                                     1: 1.0}
    elif case == "rank3":
        data = [(x, np.zeros((4, 2, 3), np.float32))]
        kwargs["class_weight"] = {0: 1.0}
    elif case == "plain_loss":
        tt.loss = lambda y, p: torch.mean(p)
        tt._loss_takes_sw = False
        data = [(x, np.zeros(4, np.int64), np.ones(4, np.float32))]
    elif case == "mixed_window":
        data = [(x, np.zeros(4, np.int64), np.ones(4, np.float32)),
                (x[:3], np.zeros(3, np.int64))]
    else:
        data, kwargs["class_weight"] = [(x, np.zeros(4, np.int64))], {}
    with pytest.raises(error, match=match):
        tt.fit(data, **kwargs)


class _WeightedMAE:
    """A streaming weighted MAE (init/update/compute), generic over the
    array module."""

    def __init__(self, xp):
        self.xp = xp

    def init(self):
        zero = (self.xp.zeros(()) if self.xp is jnp
                else torch.zeros((), dtype=torch.float32))
        return {"sum": zero, "weight": zero}

    def update(self, state, y_true, y_pred, sample_weight=None):
        err = abs(y_true - y_pred)[:, 0]
        sw = (sample_weight if sample_weight is not None
              else err * 0 + 1)
        return {"sum": state["sum"] + (sw * err).sum(),
                "weight": state["weight"] + sw.sum()}

    def compute(self, state):
        return state["sum"] / state["weight"]


def test_weighted_metrics_receive_weights_and_match_jax():
    def jfn(y, p, sw):
        return jnp.sum(sw * jnp.abs(y - p)[:, 0]) / jnp.sum(sw)

    def tfn(y, p, sw):
        return torch.sum(sw * torch.abs(y - p)[:, 0]) / torch.sum(sw)

    data = _weighted_batches(4)
    jm, tm = _optimizers("sgd")
    jmodel, net = _pair()
    jt = JTrainer(jmodel, loss=_JMSE(), optimizer=jm,
                  weighted_metrics={"wmae": jfn, "smae": _WeightedMAE(jnp)})
    tt = Trainer(net, loss=_TMSE(), optimizer=tm,
                 weighted_metrics={"wmae": tfn, "smae": _WeightedMAE(torch)})
    _assert_history(jt.fit(data, epochs=2, verbose=False),
                    tt.fit(data, epochs=2, verbose=False))
    # without weights in the data, weighted metrics see ones
    logs = tt.evaluate([(x, y) for x, y, _ in data], verbose=False)
    assert np.isfinite(logs["wmae"])
    with pytest.raises(ValueError, match="unique"):
        Trainer(_pair()[1], loss=_TMSE(), optimizer=tm,
                metrics={"a": tfn}, weighted_metrics={"a": tfn})


# --- the mutable learning rate and the rate callbacks ------------------------------

def test_mutable_lr_scale_identity_and_decay_unscaled():
    lr, wd, g, w0 = 0.01, 0.05, 0.3, 1.5
    for scale, expect_plain in ((1.0, True), (0.5, False)):
        p = torch.nn.Parameter(torch.tensor([w0]))
        q = torch.nn.Parameter(torch.tensor([w0]))
        plain = topt.AdamW([p], weight_decay=wd, learning_rate=lr)
        mut = topt.AdamW([q], weight_decay=wd, learning_rate=lr,
                         mutable_lr=True)
        topt.set_lr_scale(mut, scale)
        assert topt.get_lr_scale(mut) == scale
        assert topt.get_lr_scale(plain) is None
        for t, o in ((p, plain), (q, mut)):
            t.grad = torch.tensor([g])
            o.step()
        if expect_plain:
            assert torch.equal(p, q)
        else:
            adam_step = lr * g / (np.sqrt(g * g) + 1e-7)
            np.testing.assert_allclose(
                q.detach().numpy(), [w0 - 0.5 * adam_step - wd * w0],
                rtol=1e-5)


def test_mutable_lr_matches_jax_optimizer():
    params = {"w": jnp.asarray([1.5, -0.5])}
    grads = {"w": jnp.asarray([0.3, 0.7])}
    jmut = jopt.AdamW(weight_decay=0.05, learning_rate=0.01, mutable_lr=True)
    state = jopt.set_lr_scale(jmut.init(params), 0.25)
    p = torch.nn.Parameter(torch.tensor([1.5, -0.5]))
    tmut = topt.AdamW([p], weight_decay=0.05, learning_rate=0.01,
                      mutable_lr=True)
    topt.set_lr_scale(tmut, 0.25)
    for _ in range(3):
        updates, state = jmut.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.tensor([0.3, 0.7])
        tmut.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]),
                               rtol=1e-6)
    assert tmut.state_dict()["param_groups"][0]["lr_scale"] == 0.25


def test_set_lr_scale_requires_flag():
    opt = topt.AdamW([torch.nn.Parameter(torch.ones(1))], weight_decay=0.0)
    with pytest.raises(ValueError, match="mutable_lr=True"):
        topt.set_lr_scale(opt, 0.5)


def _mutable_trainers(**kwargs):
    jmodel, net = _pair()
    jt = JTrainer(jmodel, loss=_jmse, optimizer=jopt.AdamW(
        weight_decay=0.0, learning_rate=0.1, mutable_lr=True), **kwargs)
    tt = Trainer(net, loss=_tmse, optimizer=functools.partial(
        topt.AdamW, weight_decay=0.0, learning_rate=0.1, mutable_lr=True),
        **kwargs)
    return jt, tt


def test_reduce_lr_on_plateau_keras_semantics_as_jax():
    from chambers_tpu.callbacks import CallbackList as JList
    from chambers_tpu.callbacks import ReduceLROnPlateau as JReduce
    from chambers_tpu.training.trainer import _CallbackModel as JFacade
    from chambers_tpu_torch.training.trainer import _CallbackModel

    jt, tt = _mutable_trainers()
    kw = dict(monitor="val_loss", factor=0.5, patience=2, cooldown=1,
              min_lr=0.02, min_delta=0.0)
    jcb_, tcb_ = JReduce(**kw), tcb.ReduceLROnPlateau(**kw)
    JList([jcb_]).set_model(JFacade(jt))
    tcb.CallbackList([tcb_]).set_model(_CallbackModel(tt))
    jcb_.on_train_begin()
    tcb_.on_train_begin()
    lrs, jlrs = [], []
    for epoch, val in enumerate([1.0, 0.9] + [0.9] * 10):
        jcb_.on_epoch_end(epoch, {"val_loss": val})
        tcb_.on_epoch_end(epoch, {"val_loss": val})
        lrs.append(round(0.1 * tt.get_lr_scale(), 6))
        jlrs.append(round(0.1 * jt.get_lr_scale(), 6))
    assert lrs == jlrs == [0.1, 0.1, 0.1, 0.05, 0.05, 0.025, 0.025, 0.02,
                           0.02, 0.02, 0.02, 0.02]


def test_reduce_lr_requires_mutable_optimizer():
    _, tt = _trainers("adamw")
    with pytest.raises(ValueError, match="mutable_lr=True"):
        tt.fit(_batches(1), epochs=1, verbose=False,
               callbacks=[tcb.ReduceLROnPlateau()])


def test_learning_rate_scheduler_matches_jax():
    from chambers_tpu.callbacks import LearningRateScheduler as JSched

    jt, tt = _mutable_trainers()
    schedule = lambda epoch: 0.1 * (0.5 ** epoch)  # noqa: E731
    data = _batches(2)
    jh = jt.fit(data, epochs=3, verbose=False, callbacks=[JSched(schedule)])
    th = tt.fit(data, epochs=3, verbose=False,
                callbacks=[tcb.LearningRateScheduler(schedule)])
    np.testing.assert_allclose([h["lr"] for h in th], [0.1, 0.05, 0.025],
                               rtol=1e-6)
    _assert_history(jh, th)
    _assert_params(jt, tt)


def test_lr_scale_zero_freezes_training_through_accumulation():
    _, tt = _mutable_trainers(gradient_accumulation_steps=2)
    before = {k: v.detach().clone() for k, v in tt.state.params.items()}
    tt.set_lr_scale(0.0)
    assert tt.get_lr_scale() == 0.0
    tt.fit(_batches(4), epochs=2, verbose=False)
    for k, v in tt.state.params.items():
        assert torch.equal(v, before[k])


def test_weight_decay_extension_matches_jax():
    ext_j = jopt.WeightDecayExtension(0.5, decay_exclude=["bias"])
    ext_t = topt.WeightDecayExtension(0.5, decay_exclude=["bias"])
    kernel = torch.nn.Parameter(torch.tensor([2.0]))
    bias = torch.nn.Parameter(torch.tensor([2.0]))
    named = [("kernel", kernel), ("bias", bias)]
    assert ext_t.mask(named) == {"kernel": True, "bias": False}
    opt = ext_t.extend(torch.optim.SGD(named, lr=1.0))
    for p in (kernel, bias):
        p.grad = torch.tensor([0.0])
    opt.step()
    params = {"kernel": jnp.asarray([2.0]), "bias": jnp.asarray([2.0])}
    tx = ext_j.extend(optax.sgd(learning_rate=1.0))
    upd, _ = tx.update({k: jnp.zeros(1) for k in params}, tx.init(params),
                       params)
    new = optax.apply_updates(params, upd)
    assert float(kernel) == float(new["kernel"][0]) == 1.0
    assert float(bias) == float(new["bias"][0]) == 2.0
    with pytest.raises(ValueError, match="only"):
        topt.WeightDecayExtension(0.1, decay_include=["a"],
                                  decay_exclude=["b"])
    rt = topt.WeightDecayExtension.from_config(ext_t.get_config())
    assert rt.get_config() == ext_t.get_config() == ext_j.get_config()


def test_extend_with_weight_decay_factory_in_the_trainer_matches_jax():
    jmodel, net = _pair()
    jt = JTrainer(jmodel, loss=_jmse, optimizer=jopt.extend_with_weight_decay(
        optax.sgd(0.05), 1e-2, decay_exclude=["bias"]))
    factory = topt.extend_with_weight_decay(
        lambda named: torch.optim.SGD(named, lr=0.05), 1e-2,
        decay_exclude=["bias"])
    tt = Trainer(net, loss=_tmse, optimizer=factory)
    data = _batches(4)
    _assert_history(jt.fit(data, epochs=2, verbose=False),
                    tt.fit(data, epochs=2, verbose=False))
    _assert_params(jt, tt)
    state = tt.optimizer.state_dict()
    tt.optimizer.load_state_dict(state)
    assert tt.optimizer.count == 8


def test_jax_callbacks_see_the_same_epoch_logs():
    """The epoch logs the callbacks receive: the JAX package's keys and
    values."""
    seen = {"jax": [], "port": []}

    class JSpy(JCallback):
        def on_epoch_end(self, epoch, logs=None):
            seen["jax"].append(dict(logs))

    class TSpy(tcb.Callback):
        def on_epoch_end(self, epoch, logs=None):
            seen["port"].append(dict(logs))

    jt, tt = _trainers("adamw", metrics=({"mae": _jmae}, {"mae": _tmae}))
    data = _batches(3)
    jt.fit(data, epochs=2, validation_data=data, callbacks=[JSpy()],
           verbose=False)
    tt.fit(data, epochs=2, validation_data=data, callbacks=[TSpy()],
           verbose=False)
    assert [sorted(e) for e in seen["jax"]] == [sorted(e)
                                               for e in seen["port"]]
    _assert_history(seen["jax"], seen["port"])
