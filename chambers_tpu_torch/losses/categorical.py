"""Categorical and segmentation losses (port of
``chambers_tpu/losses/categorical.py``).

The classes carry the Keras ``Loss`` call contract of the port's
``losses/base.py``: ``call`` returns per-sample losses, ``__call__``
weights them by ``sample_weight`` and reduces them by ``reduction``.
"""

import torch

from chambers_tpu_torch.losses.base import Loss
from chambers_tpu_torch.losses.metric_learning import (
    categorical_crossentropy_per_row,
)

_EPSILON = 1e-7  # keras backend epsilon


def remove_indices(x, indices, dim=0):
    """``x`` without the entries ``indices`` (a Python list) along
    ``dim``, stacked from slices (no index tensor to copy to the card)."""
    drop = set(int(i) % x.shape[dim] for i in indices)
    keep = [i for i in range(x.shape[dim]) if i not in drop]
    return torch.stack([x.select(dim, i) for i in keep], dim=dim)


def _per_sample_dsc(y_true, y_pred, exclude_classes):
    """Per-sample mean over classes of the soft Dice coefficient ``[b]``
    of ``[b, h, w, c]`` maps."""
    y_true = torch.as_tensor(y_true).to(torch.float32)
    y_pred = torch.as_tensor(y_pred, device=y_true.device).to(torch.float32)
    intersection = (y_true * y_pred).sum(dim=(1, 2))
    channel_dsc = (2.0 * intersection + _EPSILON) / (
        y_true.sum(dim=(1, 2)) + y_pred.sum(dim=(1, 2)) + _EPSILON)
    if exclude_classes is not None:
        channel_dsc = remove_indices(channel_dsc, exclude_classes, dim=1)
    return channel_dsc.mean(dim=1)


def soft_dice_coefficient(y_true, y_pred, exclude_classes=None):
    """Mean soft Dice *loss* ``1 - DSC`` of ``[b, h, w, c]`` one-hot or
    soft maps: DSC = ``(2 TP + eps) / (2 TP + FP + FN + eps)`` per class,
    averaged over the classes, then over the batch."""
    return 1 - _per_sample_dsc(y_true, y_pred, exclude_classes).mean(dim=0)


class SoftDiceLoss(Loss):
    """:func:`soft_dice_coefficient` as a ``Loss``: per sample ``1 -`` its
    mean-class DSC; ``sample_weight`` weights per image."""

    def __init__(self, exclude_classes=None, name="soft_dice",
                 reduction="sum_over_batch_size"):
        super().__init__(reduction=reduction, name=name)
        self.exclude_classes = exclude_classes

    def call(self, y_true, y_pred):
        return 1.0 - _per_sample_dsc(y_true, y_pred, self.exclude_classes)


class CategoricalCrossentropy(Loss):
    """``tf.keras.losses.CategoricalCrossentropy``: ``from_logits``,
    ``label_smoothing`` (``y (1 - s) + s / n``). Without ``from_logits``
    the predictions are renormalized and clipped to ``[eps, 1 - eps]``."""

    def __init__(self, from_logits=False, label_smoothing=0.0,
                 name="categorical_crossentropy",
                 reduction="sum_over_batch_size"):
        super().__init__(reduction=reduction, name=name)
        self.from_logits = from_logits
        self.label_smoothing = float(label_smoothing)

    def call(self, y_true, y_pred):
        y_pred = torch.as_tensor(y_pred)
        y_true = torch.as_tensor(y_true, device=y_pred.device).to(
            torch.float32)
        if self.label_smoothing:
            n_classes = y_true.shape[-1]
            y_true = (y_true * (1.0 - self.label_smoothing)
                      + self.label_smoothing / n_classes)
        return categorical_crossentropy_per_row(y_true, y_pred,
                                                from_logits=self.from_logits)


def _one_hot_of(y_true, y_pred):
    """Integer labels ``[b]`` (or ``[b, 1]``) one-hot against ``y_pred``'s
    classes, float32."""
    y_true = torch.as_tensor(y_true, device=y_pred.device)
    if y_true.ndim == y_pred.ndim and y_true.shape[-1] == 1:
        y_true = y_true.squeeze(-1)  # Keras squeeze-or-expand
    classes = torch.arange(y_pred.shape[-1], device=y_pred.device)
    return (y_true.to(torch.int64)[..., None] == classes).to(torch.float32)


class SparseCategoricalCrossentropy(Loss):
    """``tf.keras.losses.SparseCategoricalCrossentropy``: integer labels
    ``[b]`` (or ``[b, 1]``) against ``[b, n_classes]`` predictions."""

    def __init__(self, from_logits=False,
                 name="sparse_categorical_crossentropy",
                 reduction="sum_over_batch_size"):
        super().__init__(reduction=reduction, name=name)
        self.from_logits = from_logits

    def call(self, y_true, y_pred):
        y_pred = torch.as_tensor(y_pred)
        return categorical_crossentropy_per_row(
            _one_hot_of(y_true, y_pred), y_pred, from_logits=self.from_logits)


class MeanSquaredError(Loss):
    """``tf.keras.losses.MeanSquaredError``: the mean over the last axis
    per sample."""

    def __init__(self, name="mean_squared_error",
                 reduction="sum_over_batch_size"):
        super().__init__(reduction=reduction, name=name)

    def call(self, y_true, y_pred):
        y_pred = torch.as_tensor(y_pred).to(torch.float32)
        y_true = torch.as_tensor(y_true, device=y_pred.device).to(
            torch.float32)
        return ((y_true - y_pred) ** 2).mean(dim=-1)


class BinaryCrossentropy(Loss):
    """``tf.keras.losses.BinaryCrossentropy``: elementwise BCE averaged
    over the last axis per sample. ``from_logits`` uses the stable
    ``max(z, 0) - z y + log(1 + exp(-|z|))``; probabilities are clipped to
    ``[eps, 1 - eps]``; ``label_smoothing`` maps ``y`` to ``y (1 - s) + s
    / 2``."""

    def __init__(self, from_logits=False, label_smoothing=0.0,
                 name="binary_crossentropy",
                 reduction="sum_over_batch_size"):
        super().__init__(reduction=reduction, name=name)
        self.from_logits = from_logits
        self.label_smoothing = float(label_smoothing)

    def call(self, y_true, y_pred):
        y_pred = torch.as_tensor(y_pred).to(torch.float32)
        y_true = torch.as_tensor(y_true, device=y_pred.device).to(
            torch.float32)
        if self.label_smoothing:
            y_true = (y_true * (1.0 - self.label_smoothing)
                      + 0.5 * self.label_smoothing)
        if self.from_logits:
            z = y_pred
            bce = (z.clamp(min=0.0) - z * y_true
                   + torch.log1p(torch.exp(-z.abs())))
        else:
            p = y_pred.clamp(_EPSILON, 1.0 - _EPSILON)
            bce = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))
        return bce.mean(dim=-1)
