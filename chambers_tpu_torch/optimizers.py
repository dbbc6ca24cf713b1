"""Optimizers with decoupled weight decay and regex decay filtering (port of
``chambers_tpu/optimizers.py``): ``AdamW`` and ``SGDW`` as
``torch.optim.Optimizer`` subclasses with the JAX constructors.

The decay is the original's (tfa's ``DecoupledWeightDecayExtension``): the
raw rate times the parameter from before the update, not scaled by the
learning rate — ``torch.optim.AdamW`` multiplies it by the learning rate,
which at ``lr=1e-3`` is a thousand times less decay. One step, in the JAX
package's order, is::

    g = clip(grad)                 # clipnorm per tensor or global_clipnorm,
                                   # then clipvalue
    u = adam(g)                    # bias-corrected, eps outside the root
                                   # (SGDW: g, or its momentum trace)
    u = -lr(count) * u             # ``decay`` divides lr by 1 + decay·count
    u = u - wd(count) * p          # decayed parameters only
    p = p + u

``count`` is the number of steps taken before this one; a scheduled
learning rate or weight decay reads it. Keras's ``epsilon=1e-7`` is the
default. ``decay_include``/``decay_exclude`` are regexes matched
(``re.search``) against the JAX package's parameter paths (``/``-joined,
``layers_<i>``, ``bbox_head_<i>``), into which the port's names
(``.``-joined, ``layers.<i>``) are turned back, so the same parameters
decay; the decayed and the other parameters are two parameter groups. The
parameters come as ``model.named_parameters()``, a ``{name: tensor}`` dict
or a module; bare tensors take no decay filter.

Clipping reads whole parameters, as optax does on the global arrays of a
mesh: the gradient of a parameter placed by ``parallel.sharding`` (one
carrying ``.sharding``) holds this rank's shard, and its squared norm is
summed over the ranks that hold the other shards
(``parallel.sharding.whole_sq_norms``), so every rank scales by the same
factor. Without placed parameters the norms are the local ones, the same
arithmetic in the same order.

``mutable_lr=True`` adds a host-settable factor on the learning rate,
``lr_scale`` (1.0 at first), which :func:`set_lr_scale` changes and
:func:`get_lr_scale` reads (``callbacks.ReduceLROnPlateau`` and
``LearningRateScheduler`` drive it). It multiplies the step after the
learning rate and before the decoupled decay, so the decay keeps its
strength when the rate drops, as in the JAX package. It lives in the
parameter groups, so ``state_dict`` (and a checkpoint) carries it.

:func:`extend_with_weight_decay` and :class:`WeightDecayExtension` add the
decoupled decay to any other optimizer (a ``torch.optim`` one included):
``-wd·p`` of the parameter from before the base optimizer's step, added
after it.
"""

import re

import numpy as np
import torch
from torch import nn

from chambers_tpu_torch.models.backbones.convert import jax_path


def _named(params):
    """``[(name or None, tensor)]`` from a module, a dict, named pairs or
    bare tensors."""
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    if isinstance(params, dict):
        return list(params.items())
    items = list(params)
    return [item if isinstance(item, tuple) else (None, item)
            for item in items]


def _decays(names, decay_include, decay_exclude):
    """For each name, whether its parameter receives weight decay."""
    if decay_include is not None and decay_exclude is not None:
        raise ValueError(
            "Got both `decay_include` and `decay_exclude` arguments. "
            "Use only `decay_include` or `decay_exclude`.")
    if decay_include is None and decay_exclude is None:
        return [True] * len(names)
    if None in names:
        raise ValueError(
            "decay_include/decay_exclude match parameter names: pass "
            "model.named_parameters(), a {name: tensor} dict or the module")
    if decay_include is not None:
        return [any(re.search(p, jax_path(n)) for p in decay_include)
                for n in names]
    return [not any(re.search(p, jax_path(n)) for p in decay_exclude)
            for n in names]


def decay_mask(params, decay_include=None, decay_exclude=None):
    """``{name: bool}``, which parameters receive weight decay: with
    ``decay_include`` only those whose JAX path matches a pattern, with
    ``decay_exclude`` all but those, with neither all."""
    names = [name for name, _ in _named(params)]
    return dict(zip(names, _decays(names, decay_include, decay_exclude)))


def clip_by_norm(grads, max_norm, sq_norms=None):
    """Keras ``clipnorm``: each tensor alone, ``g * max_norm / max(|g|,
    max_norm)``. ``sq_norms``: each whole tensor's ``|g|²`` where ``grads``
    hold shards (default: the tensors' own)."""
    if sq_norms is None:
        sq_norms = [(g * g).sum() for g in grads]
    return [g * (max_norm / torch.clamp(torch.sqrt(sq), min=max_norm))
            for g, sq in zip(grads, sq_norms)]


def clip_by_global_norm(grads, max_norm, sq_norms=None):
    """``optax.clip_by_global_norm``: every tensor scaled by ``max_norm /
    |all|`` when the joint norm ``|all|`` reaches ``max_norm``.
    ``sq_norms`` as for :func:`clip_by_norm`."""
    if sq_norms is None:
        sq_norms = [(g * g).sum() for g in grads]
    g_norm = torch.sqrt(sum(sq_norms))
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, g / g_norm * max_norm) for g in grads]


def _resolve_lr(learning_rate, lr):
    """The legacy ``lr`` alias replaces ``learning_rate``; it never
    overrides an explicit one silently."""
    if lr is None:
        return learning_rate
    if not (isinstance(learning_rate, float) and learning_rate == 0.001):
        raise ValueError(
            f"Got both learning_rate={learning_rate!r} and its legacy "
            f"alias lr={lr!r}; pass only one.")
    return lr


def _bias_correction(beta, t):
    """``1 - beta ** t`` in float32, as optax computes it: at ``beta_2 =
    0.999`` the float32 ``beta`` alone moves it by 1.3e-5 of itself."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(t))


def _value(schedule, count):
    return float(schedule(count)) if callable(schedule) else float(schedule)


class _DecoupledOptimizer(torch.optim.Optimizer):
    """What ``AdamW`` and ``SGDW`` share: the parameter groups (decayed or
    not), clipping, the learning rate with time decay, the decoupled decay
    and the config round trip. ``_direction`` is the base optimizer's
    update direction for one parameter."""

    def __init__(self, params, config):
        if (config["clipnorm"] is not None
                and config["global_clipnorm"] is not None):
            raise ValueError(
                "At most one of `clipnorm` and `global_clipnorm` can be set "
                "(Keras optimizer contract).")
        named = _named(params)
        decays = (_decays([name for name, _ in named],
                          config["decay_include"], config["decay_exclude"])
                  if config["weight_decay"] else [False] * len(named))
        groups = [{"params": [p for (_, p), d in zip(named, decays)
                              if d is decay],
                   "decay": decay, "count": 0} for decay in (True, False)]
        if config["mutable_lr"]:
            for group in groups:
                group["lr_scale"] = 1.0
        super().__init__([g for g in groups if g["params"]], {})
        self._config = config

    def get_config(self):
        return dict(self._config)

    @classmethod
    def from_config(cls, config, params):
        """The optimizer of ``config`` (:meth:`get_config`) over
        ``params``."""
        return cls(params, **config)

    def _clip(self, params, grads):
        """Clipping of the gradients ``grads`` of ``params``, by the norms of
        the whole parameters (see the module docstring)."""
        c = self._config
        sq_norms = None
        if (c["clipnorm"] is not None or c["global_clipnorm"] is not None) \
                and any(hasattr(p, "sharding") for p in params):
            from chambers_tpu_torch.parallel.sharding import whole_sq_norms

            sq_norms = whole_sq_norms(
                grads, [getattr(p, "sharding", None) for p in params])
        if c["clipnorm"] is not None:
            grads = clip_by_norm(grads, c["clipnorm"], sq_norms)
        if c["global_clipnorm"] is not None:
            grads = clip_by_global_norm(grads, c["global_clipnorm"],
                                        sq_norms)
        if c["clipvalue"] is not None:
            grads = [g.clamp(-c["clipvalue"], c["clipvalue"]) for g in grads]
        return grads

    def _direction(self, p, g, state, count):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        c = self._config
        count = self.param_groups[0]["count"]
        lr = _value(c["learning_rate"], count)
        if c["decay"]:
            lr = lr / (1.0 + c["decay"] * count)
        wd = _value(c["weight_decay"], count) if c["weight_decay"] else 0.0
        params = [(group, p) for group in self.param_groups
                  for p in group["params"] if p.grad is not None]
        grads = self._clip([p for _, p in params],
                           [p.grad for _, p in params])
        for (group, p), g in zip(params, grads):
            u = self._direction(p, g, self.state[p], count) * -lr
            if "lr_scale" in group:
                u = u * group["lr_scale"]
            if group["decay"]:
                u = u - wd * p
            p.add_(u)
        for group in self.param_groups:
            group["count"] = count + 1
        return loss


class AdamW(_DecoupledOptimizer):
    """Adam with decoupled weight decay. Per parameter it keeps the moments
    ``mu``, ``nu`` (and ``nu_max`` with ``amsgrad``: the running maximum of
    the bias-corrected ``nu``, as ``optax.scale_by_amsgrad``)."""

    def __init__(self, params, weight_decay, decay_include=None,
                 decay_exclude=None, learning_rate=0.001, beta_1=0.9,
                 beta_2=0.999, epsilon=1e-7, amsgrad=False, clipnorm=None,
                 clipvalue=None, global_clipnorm=None, lr=None, decay=0.0,
                 mutable_lr=False):
        super().__init__(params, dict(
            weight_decay=weight_decay, decay_include=decay_include,
            decay_exclude=decay_exclude,
            learning_rate=_resolve_lr(learning_rate, lr), beta_1=beta_1,
            beta_2=beta_2, epsilon=epsilon, amsgrad=amsgrad,
            clipnorm=clipnorm, clipvalue=clipvalue,
            global_clipnorm=global_clipnorm, decay=decay,
            mutable_lr=mutable_lr))

    def _direction(self, p, g, state, count):
        c = self._config
        b1, b2 = c["beta_1"], c["beta_2"]
        if not state:
            state["mu"] = torch.zeros_like(p)
            state["nu"] = torch.zeros_like(p)
            if c["amsgrad"]:
                state["nu_max"] = torch.zeros_like(p)
        mu = state["mu"] = (1 - b1) * g + b1 * state["mu"]
        nu = state["nu"] = (1 - b2) * (g * g) + b2 * state["nu"]
        mu_hat = mu / _bias_correction(b1, count + 1)
        nu_hat = nu / _bias_correction(b2, count + 1)
        if c["amsgrad"]:
            nu_hat = state["nu_max"] = torch.maximum(state["nu_max"], nu_hat)
        return mu_hat / (torch.sqrt(nu_hat) + c["epsilon"])


class SGDW(_DecoupledOptimizer):
    """SGD, with momentum (``trace = g + momentum · trace``, the update
    ``trace`` or, with ``nesterov``, ``g + momentum · trace``) and
    decoupled weight decay."""

    def __init__(self, params, weight_decay, decay_include=None,
                 decay_exclude=None, learning_rate=0.001, momentum=0.0,
                 nesterov=False, clipnorm=None, clipvalue=None,
                 global_clipnorm=None, lr=None, decay=0.0, mutable_lr=False):
        super().__init__(params, dict(
            weight_decay=weight_decay, decay_include=decay_include,
            decay_exclude=decay_exclude,
            learning_rate=_resolve_lr(learning_rate, lr), momentum=momentum,
            nesterov=nesterov, clipnorm=clipnorm, clipvalue=clipvalue,
            global_clipnorm=global_clipnorm, decay=decay,
            mutable_lr=mutable_lr))

    def _direction(self, p, g, state, count):
        momentum = self._config["momentum"]
        if not momentum:
            return g
        trace = state.get("trace")
        trace = state["trace"] = g if trace is None else g + momentum * trace
        if self._config["nesterov"]:
            return g + momentum * trace
        return trace


def _scaled_groups(optimizer):
    while not hasattr(optimizer, "param_groups") or hasattr(optimizer, "base"):
        optimizer = optimizer.base
    return [g for g in optimizer.param_groups if "lr_scale" in g]


def get_lr_scale(optimizer):
    """The mutable learning-rate factor, or None when the optimizer was not
    built with ``mutable_lr=True``."""
    groups = _scaled_groups(optimizer)
    return float(groups[0]["lr_scale"]) if groups else None


def set_lr_scale(optimizer, scale):
    """Set the mutable learning-rate factor of every parameter group."""
    groups = _scaled_groups(optimizer)
    if not groups:
        raise ValueError(
            "the optimizer carries no mutable lr scale: construct it with "
            "mutable_lr=True (AdamW/SGDW) to use ReduceLROnPlateau / "
            "LearningRateScheduler")
    for group in groups:
        group["lr_scale"] = float(scale)


def _param_names(optimizer):
    names = []
    for group in optimizer.param_groups:
        group_names = group.get("param_names")
        if group_names is None:
            return None
        names += list(group_names)
    return names


class DecoupledWeightDecay:
    """``base`` (any optimizer) with the decoupled decay added: before its
    step, ``-wd(count)·p`` of each decayed parameter with a gradient is
    taken; after it, added. ``parameter groups``, ``state``, ``zero_grad``
    and the ``state_dict`` round trip pass through (the count rides along
    in the ``state_dict``)."""

    def __init__(self, base, weight_decay, decayed):
        self.base = base
        self.weight_decay = weight_decay
        self._decayed = list(decayed)
        self.count = 0

    @property
    def param_groups(self):
        return self.base.param_groups

    @property
    def state(self):
        return self.base.state

    def zero_grad(self, set_to_none=True):
        self.base.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        wd = _value(self.weight_decay, self.count)
        decay = [(p, p * -wd) for p in self._decayed if p.grad is not None]
        loss = self.base.step(closure)
        for p, d in decay:
            p.add_(d)
        self.count += 1
        return loss

    def state_dict(self):
        return {"base": self.base.state_dict(), "count": self.count}

    def load_state_dict(self, state_dict):
        self.base.load_state_dict(state_dict["base"])
        self.count = int(state_dict["count"])


def _decay_flags(optimizer, decay_include, decay_exclude):
    n = sum(len(g["params"]) for g in optimizer.param_groups)
    if decay_include is None and decay_exclude is None:
        return [True] * n
    names = _param_names(optimizer)
    if names is None:
        raise ValueError(
            "decay_include/decay_exclude match parameter names: build the "
            "base optimizer over named parameters (model.named_parameters())")
    return _decays(names, decay_include, decay_exclude)


def extend_with_weight_decay(base_optimizer, weight_decay, decay_include=None,
                             decay_exclude=None):
    """Any optimizer -> its decoupled-weight-decay variant. ``base_optimizer``
    is an optimizer (built over named parameters when a decay filter is
    given) or a factory ``named_params -> optimizer``, for which a factory
    comes back. With no ``weight_decay`` the base is returned as it is."""
    if not weight_decay:
        return base_optimizer
    if not hasattr(base_optimizer, "param_groups"):
        def factory(named_params):
            return extend_with_weight_decay(
                base_optimizer(named_params), weight_decay, decay_include,
                decay_exclude)
        return factory
    # the flags follow the groups' parameter order
    flags = _decay_flags(base_optimizer, decay_include, decay_exclude)
    params = [p for g in base_optimizer.param_groups for p in g["params"]]
    return DecoupledWeightDecay(
        base_optimizer, weight_decay,
        [p for p, d in zip(params, flags) if d])


class WeightDecayExtension:
    """The decoupled decay with regex filtering as a value object (the JAX
    package's public ``WeightDecayExtension``): ``extend(base)`` is
    :func:`extend_with_weight_decay` with this configuration, and
    ``mask(params)`` says which parameters decay."""

    def __init__(self, weight_decay, decay_include=None, decay_exclude=None):
        if decay_include is not None and decay_exclude is not None:
            raise ValueError(
                "Got both `decay_include` and `decay_exclude` arguments. "
                "Use only `decay_include` or `decay_exclude`.")
        self.weight_decay = weight_decay
        self.decay_include = decay_include
        self.decay_exclude = decay_exclude

    def mask(self, params):
        """``{name: bool}`` over the parameters (as :func:`decay_mask`)."""
        return decay_mask(params, decay_include=self.decay_include,
                          decay_exclude=self.decay_exclude)

    def extend(self, base_optimizer):
        return extend_with_weight_decay(
            base_optimizer, self.weight_decay,
            decay_include=self.decay_include,
            decay_exclude=self.decay_exclude)

    __call__ = extend

    def get_config(self):
        return {"weight_decay": self.weight_decay,
                "decay_include": self.decay_include,
                "decay_exclude": self.decay_exclude}

    @classmethod
    def from_config(cls, config):
        return cls(**config)
