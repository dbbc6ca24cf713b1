"""LoRA: low-rank adapters for parameter-efficient fine-tuning (port of
``chambers_tpu/training/lora.py``).

- :func:`add_lora` registers ``<name>_lora_a`` / ``<name>_lora_b``
  parameters beside each target weight (on the module that owns it), so
  their paths are the JAX package's and ``Trainer(trainable=
  lora.TRAINABLE)`` selects them unchanged. ``b`` starts at zero, so the
  adapted forward equals the base forward exactly until training moves
  ``b``.
- :func:`wrap_apply` makes the module's forward use ``W + scale·A@B``: a
  forward pre-hook on each owning module computes the merged weight (in
  float32, cast back to the weight's dtype, as ``merge_lora``) and shadows
  the parameter for the length of that module's forward; a forward hook
  removes it again. The base weight stays the registered parameter, so
  ``state_dict`` and the optimizer see it, and autograd reaches ``A``,
  ``B`` and, when it trains, ``W``.
- :func:`merge_lora` bakes the deltas into a ``state_dict`` and drops the
  adapters: a base-shaped ``state_dict`` for the unmodified module.
- :func:`extract_lora` / :func:`insert_lora` move the adapter entries
  between ``state_dict``\\ s.

Factorization (``_factor_shapes``): a 2-D ``kernel [in, out]`` takes
``A[in, r] @ B[r, out]``; the attention's ``w_query/w_key/w_value (d, n,
h)`` take ``A[d, r]`` and ``B[r, n, h]``; ``w_projection (n, d, h)`` takes
``A[n·h, r]`` and ``B[r, d]``, the delta transposed back into ``(n, d,
h)``.

Typical use::

    from chambers_tpu_torch.training import Trainer, lora

    model = lora.apply_to_model(model, rank=8)
    trainer = Trainer(model, loss, optimizer,
                      trainable=[lora.TRAINABLE, "predictions"])
    trainer.fit(train_ds, epochs=3)
    served = lora.merge_lora(model.state_dict())   # base-shaped
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch

from chambers_tpu_torch.models.backbones.convert import jax_path

# Dense kernels and the four attention projections; 4-D conv kernels are
# not matched
DEFAULT_TARGETS = (r"/kernel$", r"/w_query$", r"/w_key$", r"/w_value$",
                   r"/w_projection$")

# pass to ``Trainer(trainable=...)`` to train only the adapters
TRAINABLE = r"_lora_[ab]$"

_A, _B = "_lora_a", "_lora_b"


def _is_adapter(name):
    return name.endswith(_A) or name.endswith(_B)


def _factor_shapes(name: str, shape, rank: int):
    """(a_shape, b_shape) for a target weight of ``shape``."""
    if name == "w_projection" and len(shape) == 3:
        n, d, h = shape
        return (n * h, rank), (rank, d)
    return (shape[0], rank), (rank,) + tuple(shape[1:])


def _delta(name: str, a, b, shape):
    """The low-rank update, reshaped into the weight's layout."""
    if name == "w_projection" and len(shape) == 3:
        n, d, h = shape
        return (a @ b).reshape(n, h, d).permute(0, 2, 1)
    return torch.tensordot(a, b, dims=1)


def _merged(name, weight, a, b, scale):
    d = _delta(name, a.to(torch.float32), b.to(torch.float32), weight.shape)
    return (weight.to(torch.float32) + scale * d).to(weight.dtype)


def _targets(module, patterns):
    """``(owner, name, weight)`` of every 2-D/3-D parameter whose JAX path
    matches a pattern."""
    out = []
    for owner_name, owner in module.named_modules():
        for name, p in owner.named_parameters(recurse=False):
            if _is_adapter(name) or p.ndim not in (2, 3):
                continue
            full = f"{owner_name}.{name}" if owner_name else name
            if any(re.search(pat, "/" + jax_path(full)) for pat in patterns):
                out.append((owner, name, p))
    return out


def add_lora(module, rank: int, generator: Optional[torch.Generator] = None,
             targets: Sequence[str] = DEFAULT_TARGETS,
             stddev: Optional[float] = None):
    """Register zero-initialized LoRA factors beside each target weight, in
    place; returns ``module``. ``a ~ N(0, stddev)`` (default
    ``1/sqrt(fan_in)``) drawn from ``generator``, ``b = 0``; both in the
    weight's dtype and on its device."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    found = _targets(module, targets)
    if not found:
        sample = [jax_path(n) for n, _ in list(module.named_parameters())[:5]]
        raise ValueError(
            f"targets={targets!r} matched no 2D/3D weights. "
            f"Example param paths: {sample}")
    for owner, name, w in found:
        a_shape, b_shape = _factor_shapes(name, w.shape, rank)
        sd = stddev if stddev is not None else a_shape[0] ** -0.5
        a = torch.randn(a_shape, generator=generator, dtype=torch.float32,
                        device=generator.device if generator is not None
                        else w.device) * sd
        owner.register_parameter(name + _A, torch.nn.Parameter(
            a.to(w.device, w.dtype)))
        owner.register_parameter(name + _B, torch.nn.Parameter(
            torch.zeros(b_shape, dtype=w.dtype, device=w.device)))
    return module


def _adapted(owner):
    return [name for name, _ in owner.named_parameters(recurse=False)
            if not _is_adapter(name)
            and hasattr(owner, name + _A) and hasattr(owner, name + _B)]


def _validate_adapters(names, require_base=True):
    """Every ``_lora_a`` pairs with its ``_lora_b`` (and, with
    ``require_base``, sits beside its base weight)."""
    names = set(names)
    for key in names:
        if key.endswith(_A):
            stem, other, missing = key[:-len(_A)], key[:-len(_A)] + _B, _B
        elif key.endswith(_B):
            stem, other, missing = key[:-len(_B)], key[:-len(_B)] + _A, _A
        else:
            continue
        if other not in names:
            raise ValueError(
                f"orphan adapter leaf {jax_path(key)}: its "
                f"{stem.rsplit('.', 1)[-1]}{missing} counterpart is missing "
                "(filtered or corrupted state?)")
        if require_base and stem not in names:
            raise ValueError(
                f"adapter {jax_path(key)} has no base weight {jax_path(stem)}")


def merge_lora(state_dict, scale: float = 1.0):
    """Bake ``W + scale·A@B`` and drop the adapters: a ``state_dict`` of
    the base module's exact keys. Use the ``scale`` the model trained
    with."""
    _validate_adapters(state_dict)
    out = {}
    for key, value in state_dict.items():
        if _is_adapter(key):
            continue
        if key + _A in state_dict:
            value = _merged(key.rsplit(".", 1)[-1], value,
                            state_dict[key + _A], state_dict[key + _B], scale)
        out[key] = value
    return out


class _Shadow:
    """The pre-hook and hook pair of one owning module."""

    def __init__(self, scale):
        self.scale = scale

    def before(self, owner, args):
        for name in _adapted(owner):
            owner.__dict__[name] = _merged(
                name, owner._parameters[name], owner._parameters[name + _A],
                owner._parameters[name + _B], self.scale)

    @staticmethod
    def after(owner, args, output):
        for name in _adapted(owner):
            owner.__dict__.pop(name, None)


def wrap_apply(module, scale: float = 1.0):
    """Make ``module``'s forward run the adapted weights (see the module
    docstring); returns ``module``. Calling it again replaces the hooks
    (with the new ``scale``)."""
    unwrap(module)
    owners = [m for m in module.modules() if _adapted(m)]
    if not owners:
        raise ValueError("the module carries no LoRA adapters (add_lora "
                         "first)")
    for owner in owners:
        shadow = _Shadow(scale)
        owner._lora_hooks = (
            owner.register_forward_pre_hook(shadow.before),
            owner.register_forward_hook(shadow.after, always_call=True))
    return module


def unwrap(module):
    """Remove :func:`wrap_apply`'s hooks: the module runs its base
    weights again (the adapters stay registered)."""
    for m in module.modules():
        for hook in m.__dict__.pop("_lora_hooks", ()):
            hook.remove()
    return module


def apply_to_model(model, rank: int,
                   generator: Optional[torch.Generator] = None,
                   targets: Sequence[str] = DEFAULT_TARGETS,
                   scale: float = 1.0, stddev: Optional[float] = None):
    """One-call LoRA setup on a :class:`~chambers_tpu_torch.models.Model`
    or module: :func:`add_lora` then :func:`wrap_apply`, so every forward
    (``predict``, a ``Trainer`` built on it) runs the adapted weights.
    Returns ``model``."""
    module = getattr(model, "module", model)
    add_lora(module, rank, generator, targets=targets, stddev=stddev)
    wrap_apply(module, scale=scale)
    return model


def extract_lora(state_dict):
    """The adapter entries of a ``state_dict`` (the per-task checkpoint)."""
    adapters = {k: v for k, v in state_dict.items() if _is_adapter(k)}
    if not adapters:
        raise ValueError("the state carries no LoRA adapters (add_lora "
                         "first)")
    _validate_adapters(adapters, require_base=False)
    return adapters


def insert_lora(base_state_dict, adapters):
    """``base_state_dict`` with the :func:`extract_lora` entries added,
    each shape-checked against its weight's factorization."""
    _validate_adapters(adapters, require_base=False)
    out = dict(base_state_dict)
    for key, value in adapters.items():
        if not _is_adapter(key):
            raise ValueError(f"not an adapter leaf: {jax_path(key)}")
        wkey = key[:-len(_A)]
        if wkey not in out:
            raise ValueError(f"adapter {jax_path(key)} has no base weight "
                             f"{jax_path(wkey)}")
        rank = value.shape[0 if key.endswith(_B) else -1]
        a_shape, b_shape = _factor_shapes(wkey.rsplit(".", 1)[-1],
                                          out[wkey].shape, rank)
        expected = a_shape if key.endswith(_A) else b_shape
        if tuple(value.shape) != tuple(expected):
            raise ValueError(
                f"adapter {jax_path(key)} shape {tuple(value.shape)} does "
                f"not factor base weight {tuple(out[wkey].shape)} (want "
                f"{expected})")
        out[key] = value
    return out
