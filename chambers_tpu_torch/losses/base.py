"""The Keras ``Loss`` call contract, ``sample_weight`` and ``reduction``
(port of ``chambers_tpu/losses/base.py``).

``call(y_true, y_pred)`` returns the per-sample losses; ``__call__`` weights
and reduces them:

- ``sample_weight`` broadcasts against the per-sample losses: a scalar, a
  ``[n]`` vector or a ``[n, 1]`` column all weight sample ``i``.
- ``"sum_over_batch_size"`` (the default): ``sum(w * losses) /
  losses.numel()``, the number of loss elements, not the sum of weights.
- ``"sum"``: ``sum(w * losses)``; ``"none"`` (or ``None``): the weighted
  per-sample losses.
"""

import torch

_REDUCTIONS = ("sum_over_batch_size", "sum", "none")


def reduce_weighted_loss(losses, sample_weight=None,
                         reduction="sum_over_batch_size"):
    """Keras ``compute_weighted_loss`` on per-sample losses: a weight with
    one more trailing length-1 axis than the losses is squeezed, one with
    fewer axes gets trailing length-1 axes."""
    losses = torch.as_tensor(losses)
    if not losses.is_floating_point():
        losses = losses.to(torch.float32)
    if sample_weight is not None:
        w = torch.as_tensor(sample_weight, device=losses.device).to(
            losses.dtype)
        if w.ndim == losses.ndim + 1 and w.shape[-1] == 1:
            w = w.squeeze(-1)
        elif w.ndim and w.ndim < losses.ndim:
            w = w.reshape(w.shape + (1,) * (losses.ndim - w.ndim))
        losses = losses * w
    if reduction == "none":
        return losses
    total = losses.sum()
    if reduction == "sum":
        return total
    return total / losses.numel()


class Loss:
    """Base class giving a per-sample ``call`` the Keras ``Loss`` contract:
    ``__call__(y_true, y_pred, sample_weight=None)`` weights and reduces by
    the constructor's ``reduction``."""

    def __init__(self, reduction="sum_over_batch_size", name=None):
        if reduction is None:
            reduction = "none"
        if reduction == "auto":  # tf.keras legacy alias for the default
            reduction = "sum_over_batch_size"
        if reduction not in _REDUCTIONS:
            raise ValueError(
                f"reduction={reduction!r}: use one of {_REDUCTIONS} "
                "(or None, an alias for 'none')")
        self.reduction = reduction
        self.name = name

    def call(self, y_true, y_pred):
        """Per-sample loss values (the unreduced ``[n]``-or-finer tensor)."""
        raise NotImplementedError

    def __call__(self, y_true, y_pred, sample_weight=None):
        return reduce_weighted_loss(self.call(y_true, y_pred), sample_weight,
                                    self.reduction)
