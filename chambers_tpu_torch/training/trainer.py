"""Training loop (port of ``chambers_tpu/training/trainer.py``).

:class:`Trainer` drives a module's train and eval steps from a host loop
with Keras-style callback hooks, the options of the JAX package's
``Trainer`` kept, in PyTorch's idiom:

- the module trains in place: its parameters and buffers (BatchNorm
  statistics) are the train state, and :attr:`Trainer.state` is a
  :class:`TrainState` view of it with the optimizer state, the EMA shadow,
  the gradient-accumulation buffer, the step and the generator's state;
- the optimizer is built by the Trainer, after ``trainable=`` is resolved,
  from a factory ``named_params -> optimizer`` (for example
  ``functools.partial(optimizers.AdamW, weight_decay=1e-4)``), or is given
  built over exactly the trainable parameters;
- frozen parameters get ``requires_grad_(False)``, so the backward pass
  computes no weight gradient for them and the optimizer holds no state
  for them;
- ``steps_per_execution=N`` runs N steps with no host synchronisation
  between them: the per-step logs stay on the device and are read once a
  window; batch callbacks fire once a window with the last step's logs,
  and ``stop_training`` is honoured at window boundaries. The steps are
  the ones ``N=1`` runs, in the same order, so the numbers are the same;
- batches reach the card through ``data/loader.py``'s
  :class:`_DevicePrefetcher` (which ``device_prefetch`` shares): pinned
  host memory, ``non_blocking`` copies on a copy stream, at most ``depth``
  batches ahead of the step;
- one explicit ``torch.Generator`` seeded from ``seed`` feeds the module's
  dropout (its ``generator=`` argument).

With a ``mesh`` (``chambers_tpu_torch.parallel``, one process a device) the
same steps run data-parallel over its ``data`` axis: the module is placed
by ``param_sharding_rules`` (replicated without them), so the optimizer
built after it keeps its state at each parameter's shard; every batch is
split into the ranks' rows (a tail batch that does not divide is padded
with zero rows and the padding dropped from the outputs, so it counts
exactly as without a mesh); the outputs are gathered and the loss and the
metrics computed on the global batch on every rank; the gradients are
summed over ``data`` (``parallel.sharding.reduce_gradients``).

The state under a mesh. :attr:`Trainer.state` stays the live local view:
each rank's shards of the placed parameters, their optimizer moments, EMA
shadow and accumulated gradients. :meth:`Trainer.global_state` gathers it
into whole tensors (a collective: every rank calls it), the state JAX's
global arrays hold; checkpoints (``training/checkpoint.py``) save that.
Assigning :attr:`Trainer.state` takes either: a value of a placed
parameter's whole shape is cut to this rank's shard, one of its shard's
shape is copied as it is. So a checkpoint moves between meshes and to and
from a run without one, as Orbax's restore into the target's sharding
does.
"""

from __future__ import annotations

import inspect
import itertools
import re
import time
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from chambers_tpu_torch.callbacks import Callback, CallbackList
from chambers_tpu_torch.data.loader import (
    _DevicePrefetcher,
    _leaves,
    _to_device,
    _tree_map,
)
from chambers_tpu_torch.models.backbones.convert import jax_path


@dataclass
class TrainState:
    """Everything that sets the next step. ``params`` and ``extra_vars``
    (the persistent buffers) are ``{name: tensor}`` under the module's
    ``state_dict`` names; ``opt_state`` is the optimizer's ``state_dict``
    (moments, count, lr scale); ``rng`` the generator's state; ``step``
    the number of train steps (microbatches) taken; ``ema_params`` the EMA
    shadow (None without ``ema_decay``); ``accumulation`` the gradient
    accumulator and its microbatch counter (None without accumulation)."""

    params: Dict[str, torch.Tensor]
    extra_vars: Dict[str, torch.Tensor]
    opt_state: Any
    rng: torch.Tensor
    step: int
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    accumulation: Optional[dict] = None

    def as_dict(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


class _PushbackIterator:
    """Iterator wrapper with one-batch pushback (window boundary cuts)."""

    def __init__(self, it):
        self._it = iter(it)
        self._stack = []

    def __iter__(self):
        return self

    def __next__(self):
        if self._stack:
            return self._stack.pop()
        return next(self._it)

    def push(self, item):
        self._stack.append(item)


def _clone(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


class _CallbackModel:
    """The model facade handed to callbacks: stop flag, weight snapshots,
    the learning-rate scale, ``save_weights`` and ``export``."""

    def __init__(self, trainer: "Trainer"):
        self._trainer = trainer

    @property
    def stop_training(self):
        return self._trainer.stop_training

    @stop_training.setter
    def stop_training(self, value):
        self._trainer.stop_training = bool(value)

    @property
    def module(self):
        return self._trainer.module

    def apply_fn(self, x, deterministic=True):
        """The trainer's forward (its ``apply_fn``), what a serving export
        of the live module traces."""
        trainer = self._trainer
        return trainer._apply_fn(trainer.module, x, deterministic, None)

    def get_weights(self):
        """A copy of the learnable state (parameters and buffers)."""
        state = self._trainer.state
        return {"params": _clone(state.params),
                "extra_vars": _clone(state.extra_vars)}

    def set_weights(self, weights):
        """Restore a :meth:`get_weights` snapshot (EarlyStopping's
        ``restore_best_weights``); optimizer state and step are untouched."""
        live = self._trainer.state
        with torch.no_grad():
            for kind in ("params", "extra_vars"):
                for name, value in weights[kind].items():
                    getattr(live, kind)[name].copy_(value)

    @property
    def variables(self):
        return self._trainer.variables

    def get_lr_scale(self):
        return self._trainer.get_lr_scale()

    def set_lr_scale(self, value):
        self._trainer.set_lr_scale(value)

    @property
    def base_learning_rate(self):
        """The optimizer's configured scalar rate, or None (a schedule, or
        an optimizer without ``get_config``)."""
        rate = self._trainer._config_value("learning_rate")
        return float(rate) if isinstance(rate, (int, float)) else None

    def save_weights(self, path):
        """The variables as Flax's msgpack; under a mesh whole, written by
        the mesh's first rank (every rank must call)."""
        from chambers_tpu_torch.parallel.sharding import write_once
        from chambers_tpu_torch.utils import msgpack_io

        variables = self._trainer.variables
        write_once(self._trainer.mesh,
                   lambda: msgpack_io.dump(variables, path))

    def export(self, directory):
        """``model.msgpack`` (the variables, Flax's format) and
        ``opt_state.pt`` (the optimizer's ``state_dict``); under a mesh
        both whole, written by the mesh's first rank (every rank must
        call)."""
        import os

        from chambers_tpu_torch.parallel.sharding import write_once
        from chambers_tpu_torch.utils import msgpack_io

        trainer = self._trainer
        variables, opt_state = trainer.variables, trainer._whole_opt_state()

        def write():
            os.makedirs(directory, exist_ok=True)
            msgpack_io.dump(variables,
                            os.path.join(directory, "model.msgpack"))
            torch.save(opt_state, os.path.join(directory, "opt_state.pt"))

        write_once(trainer.mesh, write)


def _refuse_quantized(module):
    state = module.state_dict()
    quantized = sorted(k for k, v in state.items()
                       if v.dtype == torch.int8
                       or (k.endswith("_scale") and k[:-len("_scale")] in state))
    if quantized:
        raise ValueError(
            f"the module holds int8 serving weights ({quantized[:3]} ...; "
            "chambers_tpu_torch.quantization). Quantized weights are "
            "inference-only — rounding has zero gradient, so training "
            "through them would silently learn nothing. Train the float "
            "model, then quantize it for serving.")


def _accepts(fn, name):
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


class Trainer:
    """Drives train/eval steps of a module.

    :param model: a :class:`chambers_tpu_torch.models.Model` or an
        ``nn.Module``; the Trainer runs on its parameters' device.
    :param loss: ``loss(y_true, y_pred) -> scalar`` (with a
        ``sample_weight`` keyword for weighted data, the Keras ``Loss``
        contract of ``chambers_tpu_torch.losses.Loss``).
    :param optimizer: a factory ``named_params -> optimizer`` or an
        optimizer built over exactly the trainable parameters.
    :param metrics: ``{name: metric}``: a per-batch callable
        ``fn(y_true, y_pred)`` (averaged over the epoch) or a streaming
        metric (``init``/``update``/``compute``, state on the device).
    :param apply_fn: optional ``apply_fn(module, x, deterministic,
        generator)`` in place of the module's call.
    :param mesh: a ``DeviceMesh`` (``parallel.create_mesh``): the steps
        run data-parallel over its ``data`` axis (see the module docstring).
    :param param_sharding_rules: ``(regex, PartitionSpec)`` rules that
        place the parameters on the mesh (``parallel.sharding``).
    """

    def __init__(self, model, loss, optimizer,
                 metrics: Optional[Dict[str, Callable]] = None,
                 seed: int = 0, apply_fn: Optional[Callable] = None,
                 donate: bool = True, mesh=None, param_sharding_rules=None,
                 gradient_accumulation_steps: int = 1,
                 ema_decay: Optional[float] = None,
                 trainable: Optional[Union[str, Sequence[str], Callable]] = None,
                 steps_per_execution: int = 1,
                 weighted_metrics: Optional[Dict[str, Callable]] = None):
        """``donate`` is accepted for the JAX signature and has no effect:
        the module trains in place. ``gradient_accumulation_steps=N``:
        ``optax.MultiSteps``'s semantics — gradients average over N
        microbatches (``acc += (g - acc) / (k + 1)``), the optimizer steps
        once per N (its count, which schedules read, counts updates), the
        accumulator carries over epoch and ``fit`` boundaries, and
        BatchNorm statistics update every microbatch. ``ema_decay``:
        ``ema = d·ema + (1-d)·p`` over every parameter after each optimizer
        update. ``trainable``: a regex, a list of regexes (any
        ``re.search``-matches the parameter's JAX path) or a callable
        ``path -> bool``."""
        if param_sharding_rules is not None and mesh is None:
            raise ValueError("param_sharding_rules= places parameters on a "
                             "mesh: pass mesh= as well")
        if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
            raise TypeError(f"mesh= takes a DeviceMesh (parallel."
                            f"create_mesh), got {type(mesh).__name__}")
        if gradient_accumulation_steps < 1:
            raise ValueError(
                "gradient_accumulation_steps must be >= 1, got "
                f"{gradient_accumulation_steps}")
        if steps_per_execution < 1:
            raise ValueError(
                f"steps_per_execution must be >= 1, got {steps_per_execution}")
        if ema_decay is not None and not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay={ema_decay} must be in [0, 1)")
        self.model = model
        self.module = module = getattr(model, "module", model)
        self.loss = loss
        self._spe = int(steps_per_execution)
        self._accum = int(gradient_accumulation_steps)
        self.ema_decay = ema_decay
        self.stop_training = False
        self.metrics = dict(metrics or {})
        self.weighted_metrics = dict(weighted_metrics or {})
        overlap = set(self.metrics) & set(self.weighted_metrics)
        if overlap:
            raise ValueError(
                f"metric names {sorted(overlap)} appear in both metrics= and "
                "weighted_metrics= — log keys must be unique")
        self._loss_takes_sw = _accepts(loss, "sample_weight")

        def split(mapping):
            streaming = {n: m for n, m in mapping.items()
                         if hasattr(m, "init") and hasattr(m, "update")
                         and hasattr(m, "compute")}
            return streaming, {n: m for n, m in mapping.items()
                               if n not in streaming}

        self._streaming, self._metric_fns = split(self.metrics)
        self._streaming_w, self._weighted_metric_fns = split(
            self.weighted_metrics)

        _refuse_quantized(module)
        self.mesh = mesh
        if mesh is not None and getattr(module, "_mesh", None) is not mesh:
            from chambers_tpu_torch.parallel.sharding import shard_params

            shard_params(module, mesh, param_sharding_rules)
        named = list(module.named_parameters())
        self.device = named[0][1].device if named else torch.device("cpu")
        if trainable is not None:
            if callable(trainable):
                predicate = trainable
            else:
                patterns = ([trainable] if isinstance(trainable, str)
                            else list(trainable))
                predicate = lambda path: any(re.search(p, path)
                                             for p in patterns)
            train = [name for name, _ in named if predicate(jax_path(name))]
            if not train:
                sample = [jax_path(n) for n, _ in named[:5]]
                raise ValueError(
                    f"trainable={trainable!r} matches no parameters. "
                    f"Example param paths: {sample}")
            train = set(train)
            for name, p in named:
                p.requires_grad_(name in train)
        self._trainable = [(n, p) for n, p in named if p.requires_grad]

        if hasattr(optimizer, "param_groups"):
            given = {id(p) for g in optimizer.param_groups
                     for p in g["params"]}
            if given != {id(p) for _, p in self._trainable}:
                raise ValueError(
                    "the optimizer was built over other parameters than the "
                    f"{len(self._trainable)} trainable ones; pass a factory "
                    "named_params -> optimizer, or build it over exactly "
                    "the trainable parameters")
        elif callable(optimizer):
            optimizer = optimizer(list(self._trainable))
        else:
            raise TypeError(
                f"optimizer must be an optimizer or a factory "
                f"named_params -> optimizer, got {type(optimizer).__name__}")
        self.optimizer = optimizer

        self._acc = None
        self._mini_step = 0
        self._ema = (_clone(dict(named)) if ema_decay is not None else None)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._step = 0
        self._params = dict(named)
        buffer_names = {n for n, _ in module.named_buffers()}
        self._buffers = {n: t for n, t in module.state_dict(
            keep_vars=True).items() if n in buffer_names}

        if apply_fn is None:
            apply_fn = getattr(model, "_apply_override", None)
        if apply_fn is None:
            kwargs = [k for k in ("deterministic", "generator")
                      if _accepts(module.forward, k)]

            def apply_fn(module, x, deterministic, generator):
                extra = {"deterministic": deterministic,
                         "generator": generator}
                return module(x, **{k: extra[k] for k in kwargs})
        self._apply_fn = apply_fn
        from chambers_tpu_torch.layers.moe import MoEMLP

        self._has_moe = any(isinstance(m, MoEMLP) for m in module.modules())
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    # -- state --------------------------------------------------------------
    @property
    def state(self) -> TrainState:
        """The live train state (references, not copies). Under a mesh it
        holds this rank's shards: :meth:`global_state` gathers them."""
        acc = None
        if self._accum > 1:
            acc = {"grads": self._acc, "mini_step": self._mini_step}
        return TrainState(
            params=self._params, extra_vars=self._buffers,
            opt_state=self.optimizer.state_dict(),
            rng=self.generator.get_state(), step=self._step,
            ema_params=self._ema, accumulation=acc)

    @state.setter
    def state(self, state):
        """Install a :class:`TrainState` (or its ``as_dict``), copying
        its tensors into the live ones. Under a mesh a tensor of a placed
        parameter's whole shape (a :meth:`global_state`, a checkpoint) is
        cut to this rank's shard first."""
        if isinstance(state, TrainState):
            state = state.as_dict()
        shard = self._sharded_names
        with torch.no_grad():
            for kind, live in (("params", self._params),
                               ("extra_vars", self._buffers)):
                for name, value in shard(state[kind]).items():
                    live[name].copy_(value)
            opt_state = state["opt_state"]
            if self.mesh is not None:
                from chambers_tpu_torch.parallel.sharding import (
                    slice_optimizer_state,
                )

                opt_state = slice_optimizer_state(opt_state,
                                                  self._optimizer_params())
            self.optimizer.load_state_dict(opt_state)
            self.generator.set_state(state["rng"].to("cpu"))
            self._step = int(state["step"])
            if self.ema_decay is not None:
                ema = state.get("ema_params")
                source = ema if ema is not None else state["params"]
                self._ema = {n: v.detach().to(self._params[n].device,
                                              copy=True)
                             for n, v in shard(source).items()}
            acc = state.get("accumulation")
            if self._accum > 1 and acc is not None:
                self._mini_step = int(acc["mini_step"])
                self._acc = (None if acc["grads"] is None else
                             {n: v.to(self.device, copy=True)
                              for n, v in shard(acc["grads"]).items()})

    def _sharded_names(self, tensors):
        """``{name: tensor}`` with the whole values of placed parameters
        cut to this rank's shards (as they are without a mesh)."""
        if self.mesh is None:
            return tensors
        from chambers_tpu_torch.parallel.sharding import slice_tensors

        return slice_tensors(tensors, self._params)

    def _optimizer_params(self):
        return [p for group in self.optimizer.param_groups
                for p in group["params"]]

    def _whole_opt_state(self):
        """The optimizer's ``state_dict``, under a mesh with every placed
        parameter's state gathered whole (every rank must call)."""
        opt_state = self.optimizer.state_dict()
        if self.mesh is None:
            return opt_state
        from chambers_tpu_torch.parallel.sharding import (
            gather_optimizer_state,
        )

        return gather_optimizer_state(opt_state, self._optimizer_params())

    def global_state(self) -> TrainState:
        """The train state with whole tensors, what a checkpoint holds:
        under a mesh every placed parameter, its optimizer state, EMA
        shadow and accumulated gradient gathered from the ranks' shards (a
        collective: every rank must call); without one :attr:`state`
        itself."""
        state = self.state
        if self.mesh is None:
            return state
        from chambers_tpu_torch.parallel.sharding import gather_tensors

        def whole(tensors):
            return (None if tensors is None
                    else gather_tensors(tensors, self._params))

        acc = state.accumulation
        if acc is not None:
            acc = {**acc, "grads": whole(acc["grads"])}
        return TrainState(
            params=whole(state.params), extra_vars=state.extra_vars,
            opt_state=self._whole_opt_state(),
            rng=state.rng, step=state.step,
            ema_params=whole(state.ema_params), accumulation=acc)

    @property
    def step(self) -> int:
        """The number of train steps (microbatches) taken."""
        return self._step

    @property
    def variables(self):
        """``{"params": ..., "batch_stats": ...}``: the module's weights as
        nested dicts under the JAX package's paths (the layout of its
        ``Model.variables``); ``batch_stats`` only when there are
        buffers. Under a mesh whole, as JAX's global arrays (every rank
        must call)."""
        from chambers_tpu_torch.models.backbones.convert import jax_variables

        out = jax_variables(self.module)
        if not out["batch_stats"]:
            del out["batch_stats"]
        return out

    @property
    def ema_variables(self):
        """The EMA shadow as ``{name: tensor}`` (``Trainer(ema_decay=)``);
        ``twin.load_state_dict(trainer.ema_variables, strict=False)`` puts
        it into a twin of the module to evaluate or export it. Under a
        mesh whole, the shards gathered (every rank must call)."""
        if self._ema is None:
            raise ValueError(
                "EMA is not enabled — construct the Trainer with "
                "ema_decay=<float in [0, 1)>")
        if self.mesh is None:
            return self._ema
        from chambers_tpu_torch.parallel.sharding import gather_tensors

        return gather_tensors(self._ema, self._params)

    def get_lr_scale(self) -> Optional[float]:
        """The mutable lr factor (``AdamW/SGDW(mutable_lr=True)``), or None."""
        from chambers_tpu_torch.optimizers import get_lr_scale

        return get_lr_scale(self.optimizer)

    def set_lr_scale(self, value: float):
        """Set the mutable lr factor (what ReduceLROnPlateau and
        LearningRateScheduler call); raises without ``mutable_lr=True``."""
        from chambers_tpu_torch.optimizers import set_lr_scale

        set_lr_scale(self.optimizer, value)

    def sync_model(self):
        """The wrapped model. The module trains in place, so there is
        nothing to copy back (the JAX package copies its train state)."""
        return self.model

    # -- steps ----------------------------------------------------------------
    def _loss_value(self, y, y_pred, sw):
        return (self.loss(y, y_pred) if sw is None
                else self.loss(y, y_pred, sample_weight=sw))

    def _metric_logs(self, y, y_pred, metric_states, sw=None):
        logs = {name: fn(y, y_pred) for name, fn in self._metric_fns.items()}
        if self._weighted_metric_fns:
            sw_fns = sw
            if sw is None:
                # weighted metrics degrade to unweighted (weights of ones)
                batch = _leaves(y_pred)[0].shape[0]
                sw_fns = torch.ones(batch, dtype=torch.float32,
                                    device=_leaves(y_pred)[0].device)
            logs.update({name: fn(y, y_pred, sw_fns) for name, fn in
                         self._weighted_metric_fns.items()})
        for name, m in self._streaming.items():
            metric_states[name] = m.update(metric_states[name], y, y_pred)
        for name, m in self._streaming_w.items():
            metric_states[name] = m.update(metric_states[name], y, y_pred,
                                           sample_weight=sw)
        return {k: torch.as_tensor(v).detach() for k, v in logs.items()}

    def _accumulate(self):
        """Fold this microbatch's gradients into the mean; True when the
        N-th one arrived and the gradients now hold the mean."""
        if self._acc is None:
            self._acc = {n: torch.zeros_like(p) for n, p in self._trainable}
        k = self._mini_step
        for name, p in self._trainable:
            acc = self._acc[name]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (k + 1))
        self._mini_step = (k + 1) % self._accum
        if self._mini_step:
            return False
        for name, p in self._trainable:
            p.grad = self._acc[name].clone()
            self._acc[name].zero_()
        return True

    def _update_ema(self):
        d = self.ema_decay
        ema = list(self._ema.values())
        live = [self._params[n].detach() for n in self._ema]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(live, 1.0 - d))

    def train_step(self, metric_states, x, y, sw=None):
        """One step (microbatch): forward, loss (+ the MoE aux loss),
        backward, and — every ``gradient_accumulation_steps`` — the
        optimizer update and the EMA. Returns the logs as 0-dim tensors on
        the device; nothing here waits for the card."""
        self.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            y_pred = self._forward(x, y, False, self.generator)
            loss = self._loss_value(y, y_pred, sw)
            aux = None
            if self._has_moe:
                from chambers_tpu_torch.layers.moe import moe_aux_loss

                aux = moe_aux_loss(self.module)
                loss = loss + aux
        loss.backward()
        if self.mesh is not None:
            from chambers_tpu_torch.parallel.sharding import reduce_gradients

            reduce_gradients(self.module)
        if self._accum == 1 or self._accumulate():
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            if self._ema is not None:
                with torch.no_grad():
                    self._update_ema()
        self._step += 1
        with torch.no_grad():
            logs = self._metric_logs(y, _tree_map(torch.Tensor.detach, y_pred),
                                     metric_states, sw)
        logs["loss"] = loss.detach()
        if aux is not None:
            logs["moe_aux_loss"] = aux.detach()
        return logs

    @torch.no_grad()
    def eval_step(self, metric_states, x, y, sw=None):
        y_pred = self._forward(x, y, True, None)
        logs = self._metric_logs(y, y_pred, metric_states, sw)
        logs["loss"] = torch.as_tensor(self._loss_value(y, y_pred, sw))
        return logs

    def _forward(self, x, y, deterministic, generator):
        """The module's outputs for the batch; on a mesh ``x`` holds this
        rank's rows and the outputs come back as the global batch, as many
        rows as ``y`` has. Every rank then computes the loss and metrics on
        the whole batch, as the JAX loss sees it under a mesh: the pair
        losses, NT-Xent and the DETR matcher need every row, not a rank's
        share. The price is a gather of the outputs a step (PERF.md §6
        counts its bytes for phase 9's step)."""
        if self.mesh is None:
            return self._apply_fn(self.module, x, deterministic, generator)
        from chambers_tpu_torch.parallel.distributed import (
            data_parallel,
            gather_rows,
        )

        with data_parallel(self.module, self.mesh):
            y_pred = self._apply_fn(self.module, x, deterministic, generator)
        n = _leaves(y)[0].shape[0]
        return _tree_map(lambda t: gather_rows(t, self.mesh, n), y_pred)

    # -- data -------------------------------------------------------------------
    def _place_batch(self, x, y, sw=None):
        def place(leaf):
            return _to_device(leaf, self.device)

        if self.mesh is not None:
            from chambers_tpu_torch.parallel.distributed import local_rows

            x = _tree_map(lambda leaf: local_rows(leaf, self.mesh), x)
        return _tree_map(place, x), _tree_map(place, y), _tree_map(place, sw)

    def _prefetch(self, it):
        return _DevicePrefetcher(it, self._place_batch,
                                 stream=self._copy_stream)

    def _normalized_stream(self, it, class_weight=None):
        """Dataset elements as ``(x, y, sample_weight or None)``: the Keras
        ``fit`` contract, with ``class_weight`` turned into per-sample
        weights on the host (multiplying an element's own weights)."""
        table = None
        if class_weight is not None:
            if not class_weight or min(class_weight) < 0:
                raise ValueError(
                    f"class_weight={class_weight!r}: expected a non-empty "
                    "{non-negative class index: weight} mapping")
            table = np.ones(max(class_weight) + 1, np.float32)
            for k, v in class_weight.items():
                table[int(k)] = float(v)
        for elem in it:
            if not isinstance(elem, (tuple, list)) or len(elem) not in (2, 3):
                raise ValueError(
                    "dataset elements must be (x, y) or (x, y, sample_weight) "
                    f"tuples, got a {type(elem).__name__} of length "
                    f"{len(elem) if isinstance(elem, (tuple, list)) else 'n/a'}")
            x, y = elem[0], elem[1]
            sw = elem[2] if len(elem) == 3 else None
            if table is not None:
                yarr = np.asarray(y)
                if yarr.ndim > 2:
                    raise ValueError(
                        "class_weight= supports integer [b] or one-hot "
                        f"[b, classes] targets, got rank {yarr.ndim}")
                if yarr.ndim == 2 and yarr.shape[-1] == 1:
                    idx = yarr[:, 0]
                elif yarr.ndim == 2:
                    idx = yarr.argmax(-1)
                else:
                    idx = yarr
                idx = np.asarray(idx, np.int64)
                if idx.size and idx.max() >= table.size:
                    raise ValueError(
                        f"label {int(idx.max())} is outside class_weight's "
                        f"index range [0, {table.size - 1}]")
                cw = table[idx]
                sw = cw if sw is None else np.asarray(sw, np.float32) * cw
            if sw is not None and not self._loss_takes_sw:
                raise TypeError(
                    "the dataset carries sample weights (or class_weight= "
                    "was passed) but the loss does not accept a "
                    "sample_weight kwarg — use a chambers_tpu_torch.losses."
                    "Loss subclass (or any loss(y_true, y_pred, "
                    "sample_weight=) callable)")
            yield x, y, sw

    @staticmethod
    def _collect_window(it, n):
        """Up to ``n`` same-shaped batches; a batch of another shape (the
        partial tail) ends the window and is pushed back."""
        batches, shapes = [], None
        for _ in range(n):
            try:
                b = next(it)
            except StopIteration:
                break
            s = _tree_map(lambda t: tuple(t.shape), b)
            if shapes is None:
                shapes = s
            elif s != shapes:
                if (b[2] is None) != (batches[0][2] is None):
                    raise ValueError(
                        "a steps_per_execution window mixes weighted "
                        "(x, y, w) and unweighted (x, y) batches — the "
                        "dataset must be consistent")
                it.push(b)
                break
            batches.append(b)
        return batches

    # -- loops ------------------------------------------------------------------
    def _init_metric_states(self):
        return {name: m.init() for name, m in
                {**self._streaming, **self._streaming_w}.items()}

    @staticmethod
    def _run_window(step_fn, batches, metric_states):
        """The steps of one window: their logs stacked, ``{key: [w]}``."""
        logs = [step_fn(metric_states, *b) for b in batches]
        return {k: torch.stack([step[k] for step in logs]) for k in logs[0]}

    def fit(self, dataset: Iterable, epochs: int = 1,
            steps_per_epoch: Optional[int] = None,
            validation_data: Optional[Iterable] = None,
            validation_steps: Optional[int] = None,
            callbacks: Sequence[Callback] = (), verbose: bool = True,
            initial_epoch: int = 0, skip_batches: int = 0,
            class_weight: Optional[Dict[int, float]] = None):
        """Train over an iterable of ``(x, y)`` or ``(x, y, sample_weight)``
        batches (numpy arrays or tensors; ``x`` and ``y`` may be nested
        tuples, lists or dicts). ``skip_batches`` drains that many leading
        batches on the host before the first step: the mid-epoch resume
        recipe after :meth:`CheckpointCallback.restore_into`::

            ckpt.restore_into(trainer)
            step = trainer.state.step
            trainer.fit(ds, epochs=E, steps_per_epoch=S,
                        initial_epoch=step // S, skip_batches=step % S)
        """
        callback_list = CallbackList(list(callbacks))
        callback_list.set_model(_CallbackModel(self))
        callback_list.set_params({"epochs": epochs})
        self.stop_training = False
        was_training = self.module.training
        self.module.train()
        callback_list.on_train_begin()

        def drained(raw_it):
            for _ in range(skip_batches):
                try:
                    next(raw_it)
                except StopIteration:
                    break
            return raw_it

        def stream():
            return _PushbackIterator(self._prefetch(
                self._normalized_stream(iter(dataset), class_weight)))

        history = []
        persistent_it = None
        if steps_per_epoch is not None:
            persistent_it = _PushbackIterator(self._prefetch(drained(
                self._normalized_stream(iter(dataset), class_weight))))
        for epoch in range(initial_epoch, epochs):
            callback_list.on_epoch_begin(epoch)
            epoch_start = time.perf_counter()
            batch_logs: Dict[str, list] = {}
            metric_states = self._init_metric_states()
            if persistent_it is not None:
                it = persistent_it
            elif epoch == initial_epoch:
                it = _PushbackIterator(self._prefetch(drained(
                    self._normalized_stream(iter(dataset), class_weight))))
            else:
                it = stream()
            step = 0
            any_batch = False
            while ((steps_per_epoch is None or step < steps_per_epoch)
                   and not self.stop_training):
                target = (self._spe if steps_per_epoch is None
                          else min(self._spe, steps_per_epoch - step))
                batches = self._collect_window(it, target)
                if not batches and persistent_it is not None:
                    persistent_it = it = stream()  # restart the stream
                    batches = self._collect_window(it, target)
                if not batches:
                    break
                w = len(batches)
                callback_list.on_train_batch_begin(step)
                logs = self._run_window(self.train_step, batches,
                                        metric_states)
                any_batch = True
                for k, v in logs.items():
                    batch_logs.setdefault(k, []).append(v)
                callback_list.on_train_batch_end(
                    step + w - 1, {k: v[-1] for k, v in logs.items()})
                step += w
            if not any_batch and not self.stop_training and epoch > initial_epoch:
                raise ValueError(
                    "Dataset yielded no batches after the first epoch — "
                    "pass a re-iterable dataset, or use `steps_per_epoch` "
                    "for single-pass generators.")
            logs = {k: float(torch.cat(vs).mean())
                    for k, vs in batch_logs.items()}
            if "loss" not in logs:
                logs["loss"] = float("nan")
            for name, m in {**self._streaming, **self._streaming_w}.items():
                logs[name] = float(m.compute(metric_states[name]))
            lr = self._current_lr()
            if lr is not None:
                logs["lr"] = lr
            if validation_data is not None:
                val_logs = self.evaluate(validation_data,
                                         callbacks=callback_list,
                                         steps=validation_steps,
                                         verbose=False)
                self.module.train()
                logs.update({f"val_{k}": v for k, v in val_logs.items()})
            if verbose:
                dt = time.perf_counter() - epoch_start
                msg = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items())
                print(f"Epoch {epoch + 1}/{epochs} [{dt:.1f}s] {msg}")
            callback_list.on_epoch_end(epoch, logs)
            history.append(logs)
            if self.stop_training:
                break
        callback_list.on_train_end()
        self.module.train(was_training)
        return history

    def _config_value(self, key):
        get_config = getattr(self.optimizer, "get_config", None)
        return None if get_config is None else get_config().get(key)

    def _current_lr(self) -> Optional[float]:
        """The learning rate at the current step, when the optimizer has a
        ``learning_rate`` in its ``get_config``: a scalar as it is, a
        schedule evaluated at the step count, with ``decay`` and the
        mutable scale applied."""
        rate = self._config_value("learning_rate")
        if rate is None:
            return None
        value = float(rate(self._step)) if callable(rate) else float(rate)
        time_decay = self._config_value("decay") or 0.0
        if time_decay:
            value /= 1.0 + time_decay * float(self._step)
        scale = self.get_lr_scale()
        if scale is not None:
            value *= scale
        return value

    def evaluate(self, dataset: Iterable, callbacks=None, verbose: bool = True,
                 steps: Optional[int] = None):
        """Loss and metrics over ``dataset`` (``steps`` batches at most),
        in eval mode without gradients. Raises ``ValueError`` on an empty
        dataset."""
        if callbacks is None:
            callback_list = CallbackList([])
        elif isinstance(callbacks, CallbackList):
            callback_list = callbacks
        else:
            callback_list = CallbackList(list(callbacks))
        was_training = self.module.training
        self.module.eval()
        callback_list.on_test_begin()
        totals: Dict[str, list] = {}
        metric_states = self._init_metric_states()
        it = _PushbackIterator(self._prefetch(itertools.islice(
            self._normalized_stream(iter(dataset)), steps)))
        step = 0
        while True:
            batches = self._collect_window(it, self._spe)
            if not batches:
                break
            w = len(batches)
            callback_list.on_test_batch_begin(step)
            logs = self._run_window(self.eval_step, batches, metric_states)
            for k, v in logs.items():
                totals.setdefault(k, []).append(v)
            callback_list.on_test_batch_end(step + w - 1)
            step += w
        callback_list.on_test_end()
        self.module.train(was_training)
        if not totals:
            raise ValueError(
                "evaluate() got an empty dataset: it yielded no batches")
        result = {k: float(torch.cat(vs).mean()) for k, vs in totals.items()}
        for name, m in {**self._streaming, **self._streaming_w}.items():
            result[name] = float(m.compute(metric_states[name]))
        if verbose:
            print(" - ".join(f"{k}: {v:.4f}" for k, v in result.items()))
        return result

    def predict(self, x, batch_size: int = 32):
        from chambers_tpu_torch.models.model import Model

        model = self.model if isinstance(self.model, Model) else Model(
            self.module)
        return model.predict(x, batch_size=batch_size, mesh=self.mesh)
