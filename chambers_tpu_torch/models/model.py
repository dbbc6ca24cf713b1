"""The Keras front door (port of ``chambers_tpu/models/model.py``).

:class:`Model` wraps an ``nn.Module`` (the presets return modules: the
front door is ``Model(preset)``) with the Keras surface: ``predict``,
``count_params``, ``summary``, ``compile``/``fit``/``evaluate`` over a
:class:`~chambers_tpu_torch.training.Trainer`, and ``save_weights``/
``load_weights`` in the JAX package's format (Flax's msgpack of the
variables), so each package reads the other's files.

Three faults of the JAX wrapper are not carried over: array-form ``fit``
batches every leaf of a nested ``x`` (a seq2seq's ``(src, tgt_in)``),
``metrics={"name": "accuracy"}`` resolves its strings as the list form
does, and ``evaluate`` on an empty dataset raises a ``ValueError`` that
says so.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from chambers_tpu_torch.models.backbones.convert import (
    jax_variables,
    load_jax_variables,
)


def _is_array(x):
    return isinstance(x, (np.ndarray, torch.Tensor))


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _as_array(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _is_array_tree(x):
    """An array, or a tuple/list/dict whose leaves all are arrays (not a
    batch iterable)."""
    if _is_array(x):
        return True
    if isinstance(x, (tuple, list, dict)) and x:
        return all(_is_array(leaf) for leaf in _leaves(x))
    return False


class _ArrayBatcher:
    """Re-iterable batches over in-memory arrays (Keras array-form
    ``fit(x, y, batch_size=...)``). ``arrays`` is a list whose entries may
    be nested tuples/lists/dicts of arrays: every leaf is batched along its
    first axis. With ``shuffle`` each iteration draws a new permutation
    from ``np.random.RandomState(seed + epoch)``, the JAX package's; the
    tail batch is partial."""

    def __init__(self, arrays, batch_size: int, shuffle: bool = False,
                 seed: int = 0):
        self.arrays = [_map(_as_array, a) for a in arrays]
        sizes = {leaf.shape[0] for a in self.arrays for leaf in _leaves(a)}
        if len(sizes) != 1:
            raise ValueError(
                f"x/y/sample_weight cardinalities differ: {sorted(sizes)}")
        self.n = sizes.pop()
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self._epoch = 0

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            self._epoch += 1
            rng.shuffle(idx)
        for i in range(0, self.n, self.batch_size):
            sel = idx[i: i + self.batch_size]
            yield tuple(_map(lambda leaf: leaf[sel], a) for a in self.arrays)

    def __len__(self):
        return math.ceil(self.n / self.batch_size)


def _split(arrays, split):
    return ([_map(lambda leaf: leaf[:split], a) for a in arrays],
            [_map(lambda leaf: leaf[split:], a) for a in arrays])


class Model:
    """Bundles an ``nn.Module`` with Keras-style inference, training and
    persistence."""

    def __init__(self, module, preprocess: Optional[Callable] = None,
                 name: Optional[str] = None,
                 apply_fn: Optional[Callable] = None):
        self.module = module
        self.preprocess = preprocess
        self.name = name or type(module).__name__
        # an apply override ``apply_fn(module, x, deterministic,
        # generator)``: every inference path and the Trainer's step use it
        self._apply_override = apply_fn

    # -- variables -------------------------------------------------------------
    @property
    def variables(self):
        """The weights as the JAX package's ``variables``: ``{"params":
        ..., "batch_stats": ...}`` nested numpy copies under its paths
        (``batch_stats`` only when the module has buffers); whole under a
        mesh, as JAX's global arrays (every rank must call)."""
        out = jax_variables(self.module)
        if not out["batch_stats"]:
            del out["batch_stats"]
        return out

    @property
    def params(self):
        return self.variables["params"]

    @property
    def device(self):
        p = next(self.module.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    @property
    def _mesh(self):
        """The mesh the module is placed on, or None."""
        return getattr(self.module, "_mesh", None)

    def replace_variables(self, variables) -> "Model":
        """Install ``{"params": ..., "batch_stats": ...}`` (nested arrays
        under the JAX paths, whole) into the module; a placed module keeps
        each value's shard."""
        load_jax_variables(self.module, variables)
        return self

    def with_apply_fn(self, apply_fn: Optional[Callable]) -> "Model":
        """Install (or clear, with None) the apply override."""
        self._apply_override = apply_fn
        return self

    def apply_fn(self, x, deterministic=True, generator=None):
        if self._apply_override is not None:
            return self._apply_override(self.module, x, deterministic,
                                        generator)
        from chambers_tpu_torch.training.trainer import _accepts

        kwargs = {}
        if _accepts(self.module.forward, "deterministic"):
            kwargs["deterministic"] = deterministic
        if generator is not None and _accepts(self.module.forward,
                                              "generator"):
            kwargs["generator"] = generator
        return self.module(x, **kwargs)

    # -- inference -------------------------------------------------------------
    def __call__(self, x, training: bool = False, generator=None):
        return self.apply_fn(x, deterministic=not training,
                             generator=generator)

    @torch.no_grad()
    def predict(self, x, batch_size: int = 32, mesh=None):
        """Batched inference in eval mode over host arrays (``x`` may be a
        nested tuple/list/dict of them); returns numpy.

        ``mesh``: split each batch into the ranks' rows over the mesh's
        ``data`` axis and gather the outputs (data-parallel inference; a
        tail that does not divide is padded and the padding dropped).
        Defaults to the mesh the model was :meth:`compile`-d with, if
        any."""
        if mesh is None:
            mesh = getattr(getattr(self, "_trainer", None), "mesh", None)
        x = _map(_as_array, x)
        n = _leaves(x)[0].shape[0]
        device = self.device
        was_training = self.module.training
        self.module.eval()
        outs = []
        try:
            for i in range(0, n, batch_size):
                batch = _map(lambda leaf: leaf[i:i + batch_size], x)
                if mesh is None:
                    batch = _map(lambda leaf: torch.as_tensor(leaf).to(
                        device), batch)
                    out = self.apply_fn(batch, deterministic=True)
                else:
                    out = self._predict_sharded(batch, mesh, device)
                outs.append(_map(lambda t: t.detach().float().cpu().numpy()
                                 if t.is_floating_point()
                                 else t.cpu().numpy(), out))
        finally:
            self.module.train(was_training)
        if not outs:
            raise ValueError("predict() got no samples")
        if isinstance(outs[0], (tuple, list)):
            return type(outs[0])(np.concatenate(parts, 0)
                                 for parts in zip(*outs))
        return np.concatenate(outs, 0)

    def _predict_sharded(self, batch, mesh, device):
        from chambers_tpu_torch.parallel.distributed import (
            data_parallel,
            gather_rows,
            local_rows,
        )

        rows = _leaves(batch)[0].shape[0]
        batch = _map(lambda leaf: torch.as_tensor(
            local_rows(leaf, mesh)).to(device), batch)
        with data_parallel(self.module, mesh):
            out = self.apply_fn(batch, deterministic=True)
        return _map(lambda t: gather_rows(t, mesh, rows), out)

    def count_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def summary(self, depth: int = 2, print_fn: Optional[Callable] = None
                ) -> str:
        """Keras-style parameter summary: one row per group of the
        parameter paths cut at ``depth`` levels, with its count and
        shapes; buffers (BatchNorm statistics) are footnoted."""
        from chambers_tpu_torch.utils.pytree import param_paths

        groups: dict = {}
        for path, leaf in zip(param_paths(self.module),
                              self.module.parameters()):
            head = "/".join(path.split("/")[:depth]) or "(root)"
            count, shapes = groups.get(head, (0, []))
            groups[head] = (count + leaf.numel(), shapes + [tuple(leaf.shape)])
        name_w = max([len(g) for g in groups] + [10]) + 2
        lines = [f'Model: "{self.name}"', "=" * (name_w + 30),
                 f"{'Path (grouped)':<{name_w}}{'Param #':>12}  Shapes",
                 "-" * (name_w + 30)]
        for head, (count, shapes) in groups.items():
            shown = ", ".join(
                "x".join(map(str, s)) if s else "()" for s in shapes[:4])
            if len(shapes) > 4:
                shown += f", ... (+{len(shapes) - 4})"
            lines.append(f"{head:<{name_w}}{count:>12,}  {shown}")
        lines.append("=" * (name_w + 30))
        total = self.count_params()
        lines.append(f"Total params: {total:,} "
                     f"({4 * total / 2**20:.1f} MB at f32)")
        n_buffers = sum(b.numel() for b in self.module.buffers())
        if n_buffers:
            lines.append(f"Non-trainable 'batch_stats': {n_buffers:,}")
        out = "\n".join(lines)
        (print_fn or print)(out)
        return out

    # -- the Keras training facade ---------------------------------------------
    def compile(self, optimizer, loss, metrics=None, weighted_metrics=None,
                **trainer_kwargs) -> "Model":
        """``tf.keras.Model.compile``: build the
        :class:`~chambers_tpu_torch.training.Trainer` behind ``fit``.

        ``optimizer``: a factory ``named_params -> optimizer``, a built
        optimizer, or one of ``"adam"``, ``"adamw"``, ``"sgd"``,
        ``"sgdw"``, ``"rmsprop"``. ``loss``: a ``losses.Loss``/callable or
        ``"categorical_crossentropy"``, ``"sparse_categorical_crossentropy"``,
        ``"binary_crossentropy"``/``"bce"``, ``"mse"``. ``metrics``/
        ``weighted_metrics``: the Keras list form or the ``{name: metric}``
        dict form, strings resolved in both. Every other keyword passes to
        the Trainer. Returns ``self``."""
        from chambers_tpu_torch import losses
        from chambers_tpu_torch import metrics as M
        from chambers_tpu_torch.training import Trainer

        def resolve_optimizer(opt):
            if not isinstance(opt, str):
                return opt
            from functools import partial

            from chambers_tpu_torch.optimizers import SGDW, AdamW

            table = {
                # optax.adam(1e-3): Adam's epsilon 1e-8, no decay
                "adam": partial(AdamW, weight_decay=0.0, learning_rate=1e-3,
                                epsilon=1e-8),
                "adamw": partial(AdamW, weight_decay=1e-4,
                                 learning_rate=1e-3),
                "sgd": partial(SGDW, weight_decay=0.0, learning_rate=1e-2),
                "sgdw": partial(SGDW, weight_decay=1e-4, learning_rate=1e-2),
                # optax.rmsprop(1e-3): decay 0.9, eps 1e-8 outside the root
                "rmsprop": lambda named: torch.optim.RMSprop(
                    [p for _, p in named], lr=1e-3, alpha=0.9, eps=1e-8),
            }
            if opt.lower() not in table:
                raise ValueError(
                    f"unknown optimizer string {opt!r}: use one of "
                    f"{sorted(table)} or pass an optimizer or a factory")
            return table[opt.lower()]

        def resolve_loss(fn):
            if not isinstance(fn, str):
                return fn
            table = {
                "categorical_crossentropy": losses.CategoricalCrossentropy,
                "sparse_categorical_crossentropy":
                    losses.SparseCategoricalCrossentropy,
                "binary_crossentropy": losses.BinaryCrossentropy,
                "bce": losses.BinaryCrossentropy,
                "mse": losses.MeanSquaredError,
                "mean_squared_error": losses.MeanSquaredError,
            }
            if fn.lower() not in table:
                raise ValueError(
                    f"unknown loss string {fn!r}: use one of "
                    f"{sorted(table)} or pass a losses.Loss/callable")
            return table[fn.lower()]()

        loss_obj = resolve_loss(loss)
        device = self.device

        def resolve_metric(m):
            """Keras string metrics; ``"accuracy"``/``"acc"`` take their
            flavour from the compiled loss and report under the string."""
            if not isinstance(m, str):
                return m
            key = m.lower()
            if key in ("accuracy", "acc"):
                for loss_cls, metric_cls in (
                        (losses.SparseCategoricalCrossentropy,
                         M.SparseCategoricalAccuracy),
                        (losses.BinaryCrossentropy, M.BinaryAccuracy),
                        (losses.CategoricalCrossentropy,
                         M.CategoricalAccuracy)):
                    if isinstance(loss_obj, loss_cls):
                        return metric_cls(name=m, device=device)
                raise ValueError(
                    f"cannot infer {m!r} flavor from loss "
                    f"{type(loss_obj).__name__} — use an explicit string "
                    "('sparse_categorical_accuracy', 'categorical_accuracy',"
                    " 'binary_accuracy') or a metric instance")
            table = {
                "categorical_accuracy": M.CategoricalAccuracy,
                "sparse_categorical_accuracy": M.SparseCategoricalAccuracy,
                "binary_accuracy": M.BinaryAccuracy,
                "top_k_categorical_accuracy": M.TopKCategoricalAccuracy,
                "sparse_top_k_categorical_accuracy":
                    M.SparseTopKCategoricalAccuracy,
                "auc": M.AUC,
                "precision": M.Precision,
                "recall": M.Recall,
                "f1": M.F1,
                "dsc": M.SoftDiceCoefficient,
            }
            if key not in table:
                raise ValueError(
                    f"unknown metric string {m!r}: use one of "
                    f"{sorted(table) + ['accuracy']} or pass a metric "
                    "instance")
            return table[key](device=device)

        def as_dict(ms, kind):
            if ms is None:
                return None
            if isinstance(ms, dict):
                return {name: resolve_metric(m) for name, m in ms.items()}
            out = {}
            for m in ms:
                m = resolve_metric(m)
                name = getattr(m, "name", None) or getattr(m, "__name__",
                                                           None)
                if not name:
                    raise ValueError(
                        f"{kind} entry {m!r} has no name — use the "
                        "{name: metric} dict form")
                if name in out:
                    raise ValueError(f"duplicate {kind} name {name!r}")
                out[name] = m
            return out

        self._trainer = Trainer(
            self, loss=loss_obj, optimizer=resolve_optimizer(optimizer),
            metrics=as_dict(metrics, "metrics"),
            weighted_metrics=as_dict(weighted_metrics, "weighted_metrics"),
            **trainer_kwargs)
        return self

    @property
    def trainer(self):
        """The :meth:`compile`-built Trainer (raises before compile)."""
        t = getattr(self, "_trainer", None)
        if t is None:
            raise ValueError("model is not compiled — call "
                             "model.compile(optimizer, loss, ...) first")
        return t

    def fit(self, x, y=None, batch_size: int = 32, shuffle: bool = True,
            validation_split: float = 0.0, sample_weight=None, seed: int = 0,
            **kwargs):
        """``tf.keras.Model.fit`` in both Keras input forms: an iterable of
        ``(x, y[, sample_weight])`` batches (``y=None``), or whole-dataset
        arrays (``x`` may be a nested tuple/list/dict of arrays), batched
        to ``batch_size``, reshuffled every epoch (seeded) and with
        ``validation_split`` taken from the tail before shuffling. The rest
        goes to :meth:`Trainer.fit`."""
        dataset = x
        val = kwargs.get("validation_data")
        # Keras's validation_data=(x_val, y_val[, w_val]) of arrays (x_val
        # may be nested), told apart from a list of batch tuples by y_val
        if (isinstance(val, (tuple, list)) and len(val) in (2, 3)
                and _is_array(val[1]) and _is_array_tree(val[0])):
            kwargs["validation_data"] = _ArrayBatcher(list(val), batch_size)
        if y is not None or _is_array(x):
            if y is None:
                raise ValueError(
                    "array-form fit(x) needs targets: fit(x, y, ...)")
            arrays = [x, y] + ([sample_weight] if sample_weight is not None
                               else [])
            if validation_split:
                if not 0.0 < validation_split < 1.0:
                    raise ValueError(
                        f"validation_split must be in (0, 1), got "
                        f"{validation_split}")
                n = _leaves(_map(_as_array, x))[0].shape[0]
                split = int(n * (1.0 - validation_split))
                if split == 0 or split == n:
                    raise ValueError(
                        f"validation_split={validation_split} leaves an "
                        f"empty train or validation set for {n} samples")
                arrays, val = _split([_map(_as_array, a) for a in arrays],
                                     split)
                kwargs.setdefault("validation_data",
                                  _ArrayBatcher(val, batch_size))
            dataset = _ArrayBatcher(arrays, batch_size, shuffle=shuffle,
                                    seed=seed)
        elif sample_weight is not None:
            raise ValueError(
                "sample_weight= only applies to array-form fit(x, y, ...); "
                "for a batch-iterable dataset yield (x, y, sample_weight) "
                "elements instead")
        return self.trainer.fit(dataset, **kwargs)

    def evaluate(self, x, y=None, batch_size: int = 32, sample_weight=None,
                 return_dict: bool = False, **kwargs):
        """``tf.keras.Model.evaluate``: the scalar loss, or ``[loss,
        *metrics]`` in compile order when there are metrics;
        ``return_dict=True`` gives the logs dict. An empty dataset raises
        ``ValueError``."""
        dataset = x
        if y is not None or _is_array(x):
            if y is None:
                raise ValueError(
                    "array-form evaluate(x) needs targets: evaluate(x, y)")
            arrays = [x, y] + ([sample_weight] if sample_weight is not None
                               else [])
            dataset = _ArrayBatcher(arrays, batch_size)
        elif sample_weight is not None:
            raise ValueError(
                "sample_weight= only applies to array-form evaluate(x, y); "
                "for a batch-iterable dataset yield (x, y, sample_weight) "
                "elements instead")
        logs = self.trainer.evaluate(dataset, **kwargs)
        if return_dict:
            return logs
        names = (list(self.trainer.metrics)
                 + list(self.trainer.weighted_metrics))
        values = [logs["loss"]] + [logs[n] for n in names if n in logs]
        return values[0] if len(values) == 1 else values

    # -- persistence -------------------------------------------------------------
    def save_weights(self, path: str):
        """Write the variables as Flax's msgpack (what the JAX package's
        ``Model.save_weights`` writes and its ``load_weights`` reads). A
        module placed on a mesh writes its whole weights, from the mesh's
        first rank (every rank must call)."""
        from chambers_tpu_torch.parallel.sharding import write_once
        from chambers_tpu_torch.utils import msgpack_io

        variables = self.variables
        write_once(self._mesh, lambda: msgpack_io.dump(variables, path))

    def load_weights(self, path: str):
        """Load a ``Model.save_weights`` file of either package (into a
        placed module, each whole value cut to the rank's shard)."""
        from chambers_tpu_torch.utils import msgpack_io

        return self.replace_variables(msgpack_io.load(path))

    def export(self, directory: str):
        """``model.msgpack`` (the variables) and ``config.json`` (name and
        module class), the JAX package's full-model export. The serving
        artifact is ``serving.export_serving_artifact``'s."""
        import json
        import os

        from chambers_tpu_torch.parallel.sharding import write_once

        os.makedirs(directory, exist_ok=True)
        self.save_weights(os.path.join(directory, "model.msgpack"))
        config = {"name": self.name, "module": type(self.module).__name__}

        def write():
            with open(os.path.join(directory, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

        write_once(self._mesh, write)
