"""Training callbacks and the experiment harness (port of
``chambers_tpu/callbacks.py``).

The hook surface is Keras's: ``Callback``/``CallbackList`` drive
:class:`chambers_tpu_torch.training.Trainer`, whose callbacks see a model
facade (``stop_training``, ``get_weights``/``set_weights``, the learning-
rate scale, ``save_weights``, ``export``). ``ExperimentCallback`` keeps the
JAX package's directory layout: ``logs/epoch_results.txt`` (CSV),
``logs/events.jsonl`` (scalars), ``logs/train`` and ``logs/validation``
(TensorBoard event files, :mod:`chambers_tpu_torch.utils.tensorboard`),
``model/checkpoints/init.msgpack`` and ``{epoch:02d}-{monitor:.5f}.msgpack``
(Flax's msgpack weight format, which the JAX package's
``Model.load_weights`` reads) and ``model/export/``, with the serving
artifact ``model.pt2`` when ``serving_input_shape`` is given.
"""

import csv
import datetime
import json
import math
import os
import warnings
from typing import Optional


class Callback:
    """Hook surface matching Keras callbacks (subset the Trainer drives)."""

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, batch, logs=None): ...
    def on_train_batch_end(self, batch, logs=None): ...
    def on_test_begin(self, logs=None): ...
    def on_test_end(self, logs=None): ...
    def on_test_batch_begin(self, batch, logs=None): ...
    def on_test_batch_end(self, batch, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...


def _dispatching(name):
    def method(self, *args, **kwargs):
        for c in self.callbacks:
            getattr(c, name)(*args, **kwargs)
    method.__name__ = name
    return method


class CallbackList(Callback):
    def __init__(self, callbacks=()):
        self.callbacks = list(callbacks)

    def set_params(self, params):
        self.params = params
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        self.model = model
        for c in self.callbacks:
            c.set_model(model)

    for _hook in (
        "on_train_begin", "on_train_end", "on_epoch_begin", "on_epoch_end",
        "on_train_batch_begin", "on_train_batch_end", "on_test_begin",
        "on_test_end", "on_test_batch_begin", "on_test_batch_end",
        "on_predict_begin", "on_predict_end",
    ):
        locals()[_hook] = _dispatching(_hook)
    del _hook


class CSVLogger(Callback):
    """Appends one CSV row of logs per epoch (keras.callbacks.CSVLogger)."""

    def __init__(self, filename):
        self.filename = filename
        self._writer = None
        self._file = None
        self._keys = None

    def on_train_begin(self, logs=None):
        os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
        self._file = open(self.filename, "a", newline="")
        self._writer = None  # rebind to the fresh file handle (refit support)

    def on_epoch_end(self, epoch, logs=None):
        logs = dict(logs or {})
        if self._keys is None:
            self._keys = ["epoch"] + sorted(logs.keys())
        if self._writer is None:
            self._writer = csv.DictWriter(self._file, fieldnames=self._keys,
                                          extrasaction="ignore")
            if self._file.tell() == 0:
                self._writer.writeheader()
        row = {"epoch": epoch}
        row.update({k: _scalarize(v) for k, v in logs.items()})
        self._writer.writerow(row)
        self._file.flush()

    def on_train_end(self, logs=None):
        if self._file:
            self._file.close()
            self._file = None


class ScalarLogger(Callback):
    """JSON-lines scalar event log (the TensorBoard-equivalent sink)."""

    def __init__(self, log_dir, update_freq="epoch"):
        self.log_dir = log_dir
        self.update_freq = update_freq
        self._file = None
        self._step = 0

    def on_train_begin(self, logs=None):
        os.makedirs(self.log_dir, exist_ok=True)
        self._file = open(os.path.join(self.log_dir, "events.jsonl"), "a")

    def _write(self, tag_prefix, step, logs):
        if not logs or self._file is None:
            return
        record = {"step": step}
        record.update({
            f"{tag_prefix}{k}": _scalarize(v)
            for k, v in logs.items() if _is_scalar(v)
        })
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def on_train_batch_end(self, batch, logs=None):
        self._step += 1
        if self.update_freq == "batch":
            self._write("batch_", self._step, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._write("epoch_", epoch, logs)

    def on_train_end(self, logs=None):
        if self._file:
            self._file.close()
            self._file = None


class TensorBoard(Callback):
    """Real TensorBoard event files with no TensorFlow dependency.

    Parity: ``tf.keras.callbacks.TensorBoard`` as wired by the reference's
    ``ExperimentCallback`` (callbacks.py:39-46). Keras's directory layout is
    kept so existing dashboards work unchanged: train metrics go to
    ``<log_dir>/train`` and ``val_``-prefixed metrics to
    ``<log_dir>/validation`` (same tag, so curves overlay), tagged
    ``epoch_<name>`` — plus ``batch_<name>`` per train batch when
    ``update_freq="batch"``. ``histogram_freq=N`` writes a weight histogram
    per parameter every N epochs (this pulls params to host — leave 0 for
    production runs). The wire format lives in
    :mod:`chambers_tpu_torch.utils.tensorboard`; ``write_graph`` has no meaning
    without a Keras graph and is accepted-and-ignored for signature parity.
    """

    def __init__(self, log_dir, update_freq="epoch", histogram_freq=0,
                 write_graph=True):
        if update_freq not in ("epoch", "batch"):
            raise ValueError(
                f"update_freq must be 'epoch'|'batch', got {update_freq!r}")
        self.log_dir = log_dir
        self.update_freq = update_freq
        self.histogram_freq = int(histogram_freq)
        self._train = None
        self._val = None
        self._step = 0

    def on_train_begin(self, logs=None):
        from chambers_tpu_torch.utils.tensorboard import SummaryWriter

        self._train = SummaryWriter(os.path.join(self.log_dir, "train"))
        self._val = None  # created lazily on the first val_ metric

    def _val_writer(self):
        if self._val is None:
            from chambers_tpu_torch.utils.tensorboard import SummaryWriter

            self._val = SummaryWriter(
                os.path.join(self.log_dir, "validation"))
        return self._val

    def _write(self, prefix, step, logs):
        for k, v in (logs or {}).items():
            if not _is_scalar(v):
                continue
            if k.startswith("val_"):
                self._val_writer().add_scalar(
                    f"{prefix}{k[len('val_'):]}", _scalarize(v), step)
            else:
                self._train.add_scalar(f"{prefix}{k}", _scalarize(v), step)

    def on_train_batch_end(self, batch, logs=None):
        self._step += 1
        if self.update_freq == "batch" and self._train is not None:
            self._write("batch_", self._step, logs)

    def on_epoch_end(self, epoch, logs=None):
        if self._train is None:
            return
        self._write("epoch_", epoch, logs)
        if self.histogram_freq and epoch % self.histogram_freq == 0:
            from chambers_tpu_torch.utils.pytree import param_paths

            module = self.model.module
            for path, leaf in zip(param_paths(module), module.parameters()):
                self._train.add_histogram(path, leaf, epoch)

    def on_train_end(self, logs=None):
        for w in (self._train, self._val):
            if w is not None:
                w.close()
        self._train = self._val = None


class ModelCheckpoint(Callback):
    """Per-epoch weight checkpoints named ``{epoch:02d}-{monitor:.5f}``
    (callbacks.py:31-38); epoch numbers are 1-based in filenames like Keras.
    ``save_best_only`` keeps only improvements."""

    def __init__(self, filepath, monitor="val_loss", mode="auto",
                 save_best_only=False):
        self.filepath = filepath
        self.monitor = monitor
        self.save_best_only = save_best_only
        if mode == "auto":
            mode = "max" if any(
                m in monitor for m in ("acc", "f1", "auc", "recall", "precision")
            ) else "min"
        self.mode = mode
        self._best = float("-inf") if mode == "max" else float("inf")

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        value = _scalarize(logs.get(self.monitor, float("nan")))
        if self.save_best_only:
            improved = (
                value > self._best if self.mode == "max" else value < self._best
            )
            if not improved:
                return
            self._best = value
        path = self.filepath.format(epoch=epoch + 1, **{self.monitor: value})
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.model.save_weights(path)


class EarlyStopping(Callback):
    """Stop training when a monitored metric stops improving.

    Keras ``EarlyStopping`` semantics (the reference's users reach for this
    from ``tf.keras.callbacks``; here it drives ``Trainer.stop_training``):
    ``patience`` epochs without an improvement of at least ``min_delta``
    ends training; ``restore_best_weights`` puts the best epoch's params
    (and mutable collections, e.g. BatchNorm stats) back when training
    stops — optimizer state and step are left as-is, like Keras.
    """

    def __init__(self, monitor="val_loss", min_delta=0.0, patience=0,
                 mode="auto", baseline=None, restore_best_weights=False):
        if mode == "auto":
            mode = "max" if any(
                m in monitor for m in ("acc", "f1", "auc", "recall", "precision")
            ) else "min"
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'auto'|'min'|'max', got {mode!r}")
        self.monitor = monitor
        self.min_delta = abs(float(min_delta))
        self.patience = int(patience)
        self.mode = mode
        self.baseline = baseline
        self.restore_best_weights = restore_best_weights
        self.stopped_epoch: Optional[int] = None

    def _improved(self, value):
        if self.mode == "max":
            return value > self._best + self.min_delta
        return value < self._best - self.min_delta

    def on_train_begin(self, logs=None):
        self._wait = 0
        self.stopped_epoch = None
        self._best_weights = None
        if self.baseline is not None:
            self._best = float(self.baseline)
        else:
            self._best = float("-inf") if self.mode == "max" else float("inf")

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            warnings.warn(
                f"EarlyStopping monitors '{self.monitor}' which is not in "
                f"the epoch logs {sorted(logs)}", stacklevel=2)
            return
        value = _scalarize(logs[self.monitor])
        # tf.keras contract, operation order included: wait increments
        # BEFORE the improvement check and resets on improvement, then
        # `wait >= patience` (never on the very first epoch) stops — so
        # patience=0 stops at epoch 1 even while the metric improves,
        # exactly as tf.keras does.
        self._wait += 1
        if self._improved(value):
            self._best = value
            self._wait = 0
            if self.restore_best_weights:
                self._best_weights = self.model.get_weights()
        if self._wait >= self.patience and epoch > 0:
            self.stopped_epoch = epoch
            self.model.stop_training = True

    def on_train_end(self, logs=None):
        if self.restore_best_weights and self._best_weights is not None:
            self.model.set_weights(self._best_weights)


class ReduceLROnPlateau(Callback):
    """Reduce the learning rate when a monitored metric plateaus.

    Keras ``ReduceLROnPlateau`` semantics: after ``patience`` epochs without
    an improvement of at least ``min_delta``, the rate becomes
    ``max(lr * factor, min_lr)``, followed by ``cooldown`` epochs of grace.

    Requires an optimizer built with ``mutable_lr=True`` (``AdamW``/``SGDW``)
    and a SCALAR ``learning_rate`` — the rate change is a multiplier in
    the optimizer's parameter groups (Keras likewise
    refuses to drive a ``LearningRateSchedule``). The effective rate lands
    in the epoch logs as ``lr``.
    """

    def __init__(self, monitor="val_loss", factor=0.1, patience=10,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0,
                 verbose=0):
        if factor >= 1.0:
            raise ValueError(f"factor={factor} must be < 1.0")
        if mode == "auto":
            mode = "max" if any(
                m in monitor for m in ("acc", "f1", "auc", "recall", "precision")
            ) else "min"
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'auto'|'min'|'max', got {mode!r}")
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = int(patience)
        self.mode = mode
        self.min_delta = abs(float(min_delta))
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.verbose = verbose

    def _improved(self, value):
        if self.mode == "max":
            return value > self._best + self.min_delta
        return value < self._best - self.min_delta

    def _base_lr(self):
        base = self.model.base_learning_rate
        if base is None:
            raise ValueError(
                "ReduceLROnPlateau requires an AdamW/SGDW optimizer with a "
                "scalar learning_rate (schedules cannot be scaled this way; "
                "gradient accumulation wraps the config away)")
        if self.model.get_lr_scale() is None:
            raise ValueError(
                "ReduceLROnPlateau requires the optimizer to be constructed "
                "with mutable_lr=True")
        return base

    def on_train_begin(self, logs=None):
        self._wait = 0
        self._cooldown_counter = 0
        self._best = float("-inf") if self.mode == "max" else float("inf")
        self._base_lr()  # fail at train start, not N epochs in

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.monitor not in logs:
            warnings.warn(
                f"ReduceLROnPlateau monitors '{self.monitor}' which is not "
                f"in the epoch logs {sorted(logs)}", stacklevel=2)
            return
        value = _scalarize(logs[self.monitor])
        if self._cooldown_counter > 0:
            self._cooldown_counter -= 1
            self._wait = 0
        if self._improved(value):
            self._best = value
            self._wait = 0
        elif self._cooldown_counter == 0:
            self._wait += 1
            if self._wait >= self.patience:
                base = self._base_lr()
                old_lr = base * self.model.get_lr_scale()
                if old_lr > self.min_lr:
                    new_lr = max(old_lr * self.factor, self.min_lr)
                    self.model.set_lr_scale(new_lr / base)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: epoch {epoch + 1}: "
                              f"reducing learning rate to {new_lr:.6g}")
                    self._cooldown_counter = self.cooldown
                    self._wait = 0


class LearningRateScheduler(Callback):
    """Keras ``LearningRateScheduler``: at each epoch start, set the rate to
    ``schedule(epoch)`` (or ``schedule(epoch, current_lr)``).

    Same mechanism and requirements as :class:`ReduceLROnPlateau` — the
    absolute rate is realized as a multiplier over the optimizer's
    configured scalar ``learning_rate`` in the live optimizer state. For a schedule known up front, prefer
    passing an `chambers_tpu_torch.schedules` schedule to the optimizer
    (it evaluates per optimizer step); this callback exists for the Keras
    per-epoch, host-computed idiom.
    """

    def __init__(self, schedule, verbose=0):
        self.schedule = schedule
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        base = self.model.base_learning_rate
        scale = self.model.get_lr_scale()
        if base is None or scale is None:
            raise ValueError(
                "LearningRateScheduler requires an AdamW/SGDW optimizer "
                "with a scalar learning_rate and mutable_lr=True")
        try:
            lr = self.schedule(epoch, base * scale)
        except TypeError:
            lr = self.schedule(epoch)
        lr = float(lr)
        if not (lr > 0 or lr == 0):
            raise ValueError(f"schedule returned an invalid rate: {lr!r}")
        self.model.set_lr_scale(lr / base)
        if self.verbose:
            print(f"LearningRateScheduler: epoch {epoch + 1}: "
                  f"learning rate {lr:.6g}")


class TerminateOnNaN(Callback):
    """Stop training the moment the loss goes non-finite.

    ``check="epoch"`` (default) inspects the averaged epoch logs — free,
    since those are already on host. ``check="batch"`` matches Keras's
    per-batch behavior by ``float()``-ing the loss every step (every
    window under ``steps_per_execution``), which waits for the card each
    time — use it when debugging a blow-up, not in production runs (the
    Trainer keeps per-step losses on the device).
    """

    def __init__(self, check: str = "epoch"):
        if check not in ("epoch", "batch"):
            raise ValueError(f"check must be 'epoch'|'batch', got {check!r}")
        self.check = check

    def _maybe_stop(self, value, where):
        value = _scalarize(value)
        if isinstance(value, float) and not math.isfinite(value):
            print(f"TerminateOnNaN: non-finite loss at {where}, stopping")
            self.model.stop_training = True

    def on_train_batch_end(self, batch, logs=None):
        if self.check == "batch" and logs and "loss" in logs:
            self._maybe_stop(logs["loss"], f"batch {batch}")

    def on_epoch_end(self, epoch, logs=None):
        if logs and "loss" in logs:
            self._maybe_stop(logs["loss"], f"epoch {epoch}")


class ExperimentCallback(CallbackList):
    """Composite experiment harness, the JAX package's directory layout.

    Creates ``<experiments_dir>/<timestamp>/`` with:
    - ``logs/epoch_results.txt`` (CSV), ``logs/events.jsonl`` (scalars),
      and ``logs/train``+``logs/validation`` tfevents (TensorBoard)
    - ``model/checkpoints/init.msgpack`` at train start and
      ``{epoch:02d}-{monitor:.5f}.msgpack`` per epoch
    - ``model/export/`` at train end: ``model.msgpack`` (the variables)
      and ``opt_state.pt`` (the optimizer's ``state_dict``), and with
      ``serving_input_shape`` the serving artifact ``model.pt2``
    - ``config_dump.json`` if a config dict is given
    """

    def __init__(self, experiments_dir, checkpoint_monitor="val_loss",
                 checkpoint_mode="auto", tensorboard_update_freq="epoch",
                 config_dump: Optional[dict] = None,
                 serving_input_shape=None):
        """``serving_input_shape``: per-example input shape; when given,
        train end also writes ``model/export/model.pt2``, the
        ``serving.export_serving_artifact`` of the live module with a
        dynamic batch (the JAX package writes ``model.stablehlo``)."""
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        self.experiment_dir = os.path.join(experiments_dir, now)
        self.log_dir = os.path.join(self.experiment_dir, "logs")
        self.model_dir = os.path.join(self.experiment_dir, "model")
        self.checkpoint_dir = os.path.join(self.model_dir, "checkpoints")
        self.export_dir = os.path.join(self.model_dir, "export")
        self.config_dump = config_dump
        self.serving_input_shape = serving_input_shape

        super().__init__([
            CSVLogger(os.path.join(self.log_dir, "epoch_results.txt")),
            ModelCheckpoint(
                os.path.join(
                    self.checkpoint_dir,
                    "{epoch:02d}-{" + checkpoint_monitor + ":.5f}.msgpack",
                ),
                monitor=checkpoint_monitor,
                mode=checkpoint_mode,
            ),
            ScalarLogger(self.log_dir, update_freq=tensorboard_update_freq),
            TensorBoard(self.log_dir, update_freq=tensorboard_update_freq),
        ])

    def on_train_begin(self, logs=None):
        os.makedirs(self.experiment_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        os.makedirs(self.export_dir, exist_ok=True)

        if self.config_dump is not None:
            with open(os.path.join(self.experiment_dir, "config_dump.json"), "w") as f:
                json.dump(self.config_dump, f)

        self.model.save_weights(os.path.join(self.checkpoint_dir, "init.msgpack"))
        for c in self.callbacks:
            c.on_train_begin(logs)

    def on_train_end(self, logs=None):
        self.model.export(self.export_dir)
        if self.serving_input_shape is not None:
            from chambers_tpu_torch.serving import export_serving_artifact

            export_serving_artifact(
                self.model, os.path.join(self.export_dir, "model.pt2"),
                self.serving_input_shape)
        for c in self.callbacks:
            c.on_train_end(logs)


def _is_scalar(v):
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _scalarize(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
