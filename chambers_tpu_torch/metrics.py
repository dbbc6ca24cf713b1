"""Model-quality metrics (port of ``chambers_tpu/metrics.py``).

Every metric is a functional triple whose state is a dict of tensors on
the metric's ``device`` (CUDA unless the caller says otherwise):

    state = metric.init()
    state = metric.update(state, y_true, y_pred)   # no host sync
    value = metric.compute(state)                  # a 0-dim tensor

and the Keras-style ``update_state`` / ``result`` / ``reset_states`` wrap
it; ``result`` is the one call that reads a value back to the host.

``F1``, ``Precision`` and ``Recall`` count thresholded predictions (Keras's
``thresholds``, ``top_k`` and ``class_id``); ``Mean``; ``BinaryAccuracy``,
``CategoricalAccuracy``, ``SparseCategoricalAccuracy``,
``TopKCategoricalAccuracy`` and its Sparse variant; ``AUC`` (ROC
trapezoids, or Keras's PR interpolation, over Keras's buckets); and
``SoftDiceCoefficient``. Top-k follows ``lax.top_k``: among equal scores
the lower class index ranks first, on the CPU and the card alike.
"""

import torch

from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.losses.categorical import (
    soft_dice_coefficient as _dsc_loss,
)


def _safe_ratio(num, den):
    """``num / den`` where ``den > 0``, else 0."""
    return torch.where(den > 0, num / den.clamp(min=1e-12),
                       torch.zeros_like(num))


def _safe_div(num, den):
    """``num / den`` where ``den > 0``, else 0, dividing by 1 elsewhere."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _top_k_mask(scores, k):
    """Bool mask of each row's ``k`` best scores, ties to the lower index
    (a stable descending sort)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    mask = torch.zeros_like(scores, dtype=torch.bool)
    return mask.scatter(-1, order[..., :k], True)


def _in_top_k(scores, labels, k):
    """Whether each row's ``labels`` class is among its ``k`` best scores,
    ties to the lower index: its rank is the count of better scores plus
    that of equal scores at lower indices."""
    labels = labels.to(torch.int64)
    own = torch.gather(scores, -1, labels[..., None])
    index = torch.arange(scores.shape[-1], device=scores.device)
    rank = ((scores > own).sum(-1)
            + ((scores == own) & (index < labels[..., None])).sum(-1))
    return rank < k


class StreamingMetric:
    """Base: the functional ``init``/``update``/``compute`` and the
    Keras-style wrappers."""

    name = "metric"

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _zeros(self, shape=()):
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _tensor(self, x, dtype=None):
        t = torch.as_tensor(x, device=self.device)
        return t if dtype is None else t.to(dtype)

    def init(self):
        raise NotImplementedError

    def update(self, state, y_true, y_pred, sample_weight=None):
        raise NotImplementedError

    def compute(self, state):
        raise NotImplementedError

    def update_state(self, y_true, y_pred, sample_weight=None):
        self._state = self.update(self._state, y_true, y_pred,
                                  sample_weight=sample_weight)

    def result(self):
        return float(self.compute(self._state))

    def reset_states(self):
        self._state = self.init()


class _ConfusionMetric(StreamingMetric):
    """Streaming true/false positive and false negative counts behind F1,
    Precision and Recall: predictions above ``thresholds`` (default 0.5),
    only among each row's ``top_k`` scores if given, only in column
    ``class_id`` if given; labels above 0.5 are positive."""

    def __init__(self, thresholds=None, top_k=None, class_id=None, name=None,
                 device=None):
        super().__init__(device)
        self.thresholds = 0.5 if thresholds is None else thresholds
        self.top_k = top_k
        self.class_id = class_id
        if name is not None:
            self.name = name
        self.reset_states()

    def init(self):
        return {k: self._zeros() for k in ("tp", "fp", "fn")}

    def update(self, state, y_true, y_pred, sample_weight=None):
        y_pred = self._tensor(y_pred)
        y_true = self._tensor(y_true)
        pred_pos = y_pred > self.thresholds
        if self.top_k is not None:
            pred_pos = pred_pos & _top_k_mask(y_pred, self.top_k)
        if self.class_id is not None:
            y_true = y_true[..., self.class_id]
            pred_pos = pred_pos[..., self.class_id]
        true_pos = y_true > 0.5
        w = (1.0 if sample_weight is None
             else self._tensor(sample_weight, torch.float32))
        return {
            "tp": state["tp"] + ((pred_pos & true_pos) * w).sum(),
            "fp": state["fp"] + ((pred_pos & ~true_pos) * w).sum(),
            "fn": state["fn"] + ((~pred_pos & true_pos) * w).sum(),
        }

    def get_config(self):
        return {"thresholds": self.thresholds, "top_k": self.top_k,
                "class_id": self.class_id}


class F1(_ConfusionMetric):
    """Streaming F1 = 2PR / (P + R) of thresholded predictions."""

    name = "f1"

    def compute(self, state):
        tp, fp, fn = state["tp"], state["fp"], state["fn"]
        precision = _safe_ratio(tp, tp + fp)
        recall = _safe_ratio(tp, tp + fn)
        return _safe_ratio(2 * precision * recall, precision + recall)


class Precision(_ConfusionMetric):
    """Streaming precision TP / (TP + FP)."""

    name = "precision"

    def compute(self, state):
        return _safe_ratio(state["tp"], state["tp"] + state["fp"])


class Recall(_ConfusionMetric):
    """Streaming recall TP / (TP + FN)."""

    name = "recall"

    def compute(self, state):
        return _safe_ratio(state["tp"], state["tp"] + state["fn"])


class Mean(StreamingMetric):
    """Streaming weighted mean (``tf.keras.metrics.Mean``); ``update``
    takes the values as ``y_pred`` (``y_true`` when ``y_pred`` is None)."""

    def __init__(self, name="mean", device=None):
        super().__init__(device)
        self.name = name
        self.reset_states()

    def init(self):
        return {"total": self._zeros(), "count": self._zeros()}

    def update(self, state, y_true, y_pred=None, sample_weight=None):
        values = self._tensor(y_pred if y_pred is not None else y_true,
                              torch.float32)
        w = (torch.ones_like(values) if sample_weight is None else
             self._tensor(sample_weight, torch.float32).expand(values.shape))
        return {"total": state["total"] + (values * w).sum(),
                "count": state["count"] + w.sum()}

    def compute(self, state):
        return _safe_ratio(state["total"], state["count"])

    def get_config(self):
        return {"name": self.name}


class _MeanOfMatches(Mean):
    """Base of the accuracies: a per-sample match in {0, 1}, mean-streamed."""

    def _matches(self, y_true, y_pred):
        raise NotImplementedError

    def update(self, state, y_true, y_pred, sample_weight=None):
        matches = self._matches(self._tensor(y_true), self._tensor(y_pred))
        return super().update(state, None, matches.to(torch.float32),
                              sample_weight=sample_weight)


class BinaryAccuracy(_MeanOfMatches):
    """The prediction thresholded to {0, 1} and compared with ``y_true`` by
    equality (a soft label never matches)."""

    def __init__(self, threshold=0.5, name="binary_accuracy", device=None):
        self.threshold = threshold
        super().__init__(name=name, device=device)

    def _matches(self, y_true, y_pred):
        return y_true.to(torch.float32) == (y_pred > self.threshold).to(
            torch.float32)

    def get_config(self):
        return {"threshold": self.threshold, "name": self.name}


class CategoricalAccuracy(_MeanOfMatches):
    """``argmax(y_true) == argmax(y_pred)`` per row."""

    def __init__(self, name="categorical_accuracy", device=None):
        super().__init__(name=name, device=device)

    def _matches(self, y_true, y_pred):
        return torch.argmax(y_true, dim=-1) == torch.argmax(y_pred, dim=-1)


class SparseCategoricalAccuracy(_MeanOfMatches):
    """Integer labels against ``argmax(y_pred)``."""

    def __init__(self, name="sparse_categorical_accuracy", device=None):
        super().__init__(name=name, device=device)

    def _matches(self, y_true, y_pred):
        if y_true.ndim == y_pred.ndim:  # a trailing [..., 1] label column
            y_true = y_true[..., 0]
        return y_true.to(torch.int64) == torch.argmax(y_pred, dim=-1)


class TopKCategoricalAccuracy(_MeanOfMatches):
    """The label's class among the ``k`` best scores."""

    def __init__(self, k=5, name="top_k_categorical_accuracy", device=None):
        self.k = int(k)
        super().__init__(name=name, device=device)

    def _label_ids(self, y_true):
        return torch.argmax(y_true, dim=-1)

    def _matches(self, y_true, y_pred):
        return _in_top_k(y_pred, self._label_ids(y_true), self.k)

    def get_config(self):
        return {"k": self.k, "name": self.name}


class SparseTopKCategoricalAccuracy(TopKCategoricalAccuracy):
    """``TopKCategoricalAccuracy`` with integer labels."""

    def __init__(self, k=5, name="sparse_top_k_categorical_accuracy",
                 device=None):
        super().__init__(k=k, name=name, device=device)

    def _label_ids(self, y_true):
        if y_true.ndim and y_true.shape[-1] == 1:
            y_true = y_true[..., 0]
        return y_true.to(torch.int64)


class AUC(StreamingMetric):
    """Streaming AUC over ``num_thresholds`` buckets, as
    ``tf.keras.metrics.AUC``: thresholds ``[-eps, 1/(T-1), ..., (T-2)/(T-1),
    1 + eps]``; ROC integrates (FPR, TPR) by trapezoids, PR by Keras's
    precision-slope interpolation."""

    def __init__(self, num_thresholds=200, curve="ROC", name=None,
                 device=None):
        super().__init__(device)
        if curve not in ("ROC", "PR"):
            raise ValueError(f"curve must be 'ROC'|'PR', got {curve!r}")
        if num_thresholds < 2:
            raise ValueError("num_thresholds must be >= 2")
        self.num_thresholds = int(num_thresholds)
        self.curve = curve
        self.name = name or "auc"
        eps = 1e-7
        inner = [(i + 1) / (num_thresholds - 1)
                 for i in range(num_thresholds - 2)]
        self._thresholds = torch.tensor([-eps] + inner + [1.0 + eps],
                                        dtype=torch.float32,
                                        device=self.device)
        self.reset_states()

    def init(self):
        return {k: self._zeros((self.num_thresholds,))
                for k in ("tp", "fp", "tn", "fn")}

    def update(self, state, y_true, y_pred, sample_weight=None):
        y_true = self._tensor(y_true, torch.float32).reshape(-1)
        y_pred = self._tensor(y_pred, torch.float32).reshape(-1)
        w = (torch.ones_like(y_pred) if sample_weight is None else
             self._tensor(sample_weight, torch.float32).reshape(-1).expand(
                 y_pred.shape))[None, :]
        pred_pos = y_pred[None, :] > self._thresholds[:, None]
        pos = (y_true > 0.5)[None, :]
        return {
            "tp": state["tp"] + ((pred_pos & pos) * w).sum(dim=1),
            "fp": state["fp"] + ((pred_pos & ~pos) * w).sum(dim=1),
            "tn": state["tn"] + ((~pred_pos & ~pos) * w).sum(dim=1),
            "fn": state["fn"] + ((~pred_pos & pos) * w).sum(dim=1),
        }

    def compute(self, state):
        tp, fp, tn, fn = (state[k] for k in ("tp", "fp", "tn", "fn"))
        if self.curve == "ROC":
            x = _safe_div(fp, fp + tn)
            y = _safe_div(tp, tp + fn)
            heights = (y[:-1] + y[1:]) / 2.0
            return ((x[:-1] - x[1:]) * heights).sum()
        # PR: Keras's interpolate_pr_auc
        dtp = tp[:-1] - tp[1:]
        p = tp + fp
        dp = p[:-1] - p[1:]
        prec_slope = _safe_div(dtp, dp.clamp(min=0.0))
        intercept = tp[1:] - prec_slope * p[1:]
        safe_p_ratio = torch.where(
            (p[:-1] > 0) & (p[1:] > 0), _safe_div(p[:-1], p[1:].clamp(
                min=0.0)), torch.ones_like(p[1:]))
        increment = _safe_div(
            prec_slope * (dtp + intercept * torch.log(safe_p_ratio)),
            (tp[1:] + fn[1:]).clamp(min=0.0))
        return increment.sum()

    def get_config(self):
        return {"num_thresholds": self.num_thresholds, "curve": self.curve,
                "name": self.name}


def soft_dice_coefficient(y_true, y_pred, exclude_classes=None):
    """The soft Dice coefficient as a metric: ``|dice_loss - 1|``."""
    return (_dsc_loss(y_true, y_pred, exclude_classes=exclude_classes)
            - 1).abs()


class SoftDiceCoefficient(StreamingMetric):
    """Streaming mean of :func:`soft_dice_coefficient` over the updates."""

    def __init__(self, exclude_classes=None, name="soft_dice_coefficient",
                 device=None):
        super().__init__(device)
        self.exclude_classes = exclude_classes
        self.name = name
        self.reset_states()

    def init(self):
        return {"total": self._zeros(), "count": self._zeros()}

    def update(self, state, y_true, y_pred, sample_weight=None):
        value = soft_dice_coefficient(
            self._tensor(y_true), self._tensor(y_pred),
            exclude_classes=self.exclude_classes)
        return {"total": state["total"] + value,
                "count": state["count"] + 1.0}

    def compute(self, state):
        return torch.where(state["count"] > 0,
                           state["total"] / state["count"].clamp(min=1.0),
                           torch.zeros_like(state["total"]))


dsc = DSC = soft_dice_coefficient
