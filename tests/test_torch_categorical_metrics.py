"""The port's categorical losses, ``DistillationLoss`` and metrics against
the JAX package's (``chambers_tpu/losses/categorical.py``,
``chambers_tpu/losses/distillation.py``, ``chambers_tpu/metrics.py``),
modelled on ``tests/losses/test_categorical_and_metrics.py`` and
``tests/test_metrics.py``.

Losses are compared in every reduction, with and without sample weights
(a scalar, ``[n]`` and ``[n, 1]``), within 1e-6 relative (float32 sums in
another order); soft distillation within 1e-5, its KL being a sum of
terms that cancel, times ``tau^2`` (up to 25 here). Metrics are streamed
over three batches through the Keras-style wrappers and the functional
triple, each result within 1e-6 of JAX's; counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu import metrics as jmetrics
from chambers_tpu.losses import categorical as jcat
from chambers_tpu.losses.distillation import (
    DistillationLoss as JaxDistillationLoss,
)
from chambers_tpu_torch import metrics as tmetrics
from chambers_tpu_torch.losses import categorical as tcat
from chambers_tpu_torch.losses.distillation import DistillationLoss
from test_torch_package import one_torch_thread  # noqa: F401

_N, _K = 12, 6
_RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=_RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=1e-7)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    logits = rng.randn(_N, _K).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.randint(0, _K, _N)
    one_hot = np.eye(_K, dtype=np.float32)[labels]
    soft = rng.dirichlet(np.ones(_K), _N).astype(np.float32)
    binary = (rng.rand(_N, _K) > 0.5).astype(np.float32)
    seg_true = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (3, 5, 5))]
    seg_pred = rng.dirichlet(np.ones(4), (3, 5, 5)).astype(np.float32)
    return dict(logits=logits, probs=probs.astype(np.float32), labels=labels,
                one_hot=one_hot, soft=soft, binary=binary, seg_true=seg_true,
                seg_pred=seg_pred, weights=rng.rand(_N).astype(np.float32))


def _weights(data, form):
    return {"none": None, "scalar": 0.7, "vector": data["weights"],
            "column": data["weights"][:, None]}[form]


_LOSSES = [
    ("CategoricalCrossentropy", {"from_logits": True}, "soft", "logits"),
    ("CategoricalCrossentropy", {"from_logits": True,
                                 "label_smoothing": 0.1}, "one_hot", "logits"),
    ("CategoricalCrossentropy", {}, "soft", "probs"),
    ("CategoricalCrossentropy", {"label_smoothing": 0.2}, "one_hot",
     "probs"),
    ("SparseCategoricalCrossentropy", {"from_logits": True}, "labels",
     "logits"),
    ("SparseCategoricalCrossentropy", {}, "labels", "probs"),
    ("MeanSquaredError", {}, "soft", "probs"),
    ("BinaryCrossentropy", {}, "binary", "probs"),
    ("BinaryCrossentropy", {"from_logits": True, "label_smoothing": 0.1},
     "binary", "logits"),
]


@pytest.mark.parametrize("weights", ["none", "scalar", "vector", "column"])
@pytest.mark.parametrize("reduction", ["sum_over_batch_size", "sum", "none"])
@pytest.mark.parametrize("case", range(len(_LOSSES)))
def test_losses_match_jax(data, case, reduction, weights):
    name, kwargs, y_key, p_key = _LOSSES[case]
    jl = getattr(jcat, name)(reduction=reduction, **kwargs)
    tl = getattr(tcat, name)(reduction=reduction, **kwargs)
    w = _weights(data, weights)
    want = jl(jnp.asarray(data[y_key]), jnp.asarray(data[p_key]),
              sample_weight=w)
    got = tl(_t(data[y_key]), _t(data[p_key]),
             sample_weight=None if w is None else _t(w))
    assert tuple(got.shape) == np.asarray(want).shape
    _close(got, want)


def test_sparse_labels_as_a_column(data):
    labels = data["labels"][:, None]
    want = jcat.SparseCategoricalCrossentropy(from_logits=True)(
        jnp.asarray(labels), jnp.asarray(data["logits"]))
    _close(tcat.SparseCategoricalCrossentropy(from_logits=True)(
        _t(labels), _t(data["logits"])), want)


@pytest.mark.parametrize("exclude", [None, [0], [1, 3], [-1]])
def test_soft_dice_matches_jax(data, exclude):
    args_j = (jnp.asarray(data["seg_true"]), jnp.asarray(data["seg_pred"]))
    args_t = (_t(data["seg_true"]), _t(data["seg_pred"]))
    _close(tcat.soft_dice_coefficient(*args_t, exclude_classes=exclude),
           jcat.soft_dice_coefficient(*args_j, exclude_classes=exclude))
    for reduction in ("sum_over_batch_size", "none"):
        w = np.array([0.2, 1.0, 3.0], np.float32)
        _close(tcat.SoftDiceLoss(exclude, reduction=reduction)(
            *args_t, sample_weight=_t(w)),
            jcat.SoftDiceLoss(exclude, reduction=reduction)(
                *args_j, sample_weight=w))
    # a perfect prediction scores zero loss
    perfect = tcat.soft_dice_coefficient(args_t[0], args_t[0])
    assert abs(float(perfect)) < 1e-6


@pytest.mark.parametrize("weights", ["none", "vector"])
@pytest.mark.parametrize("reduction", ["sum_over_batch_size", "sum", "none"])
@pytest.mark.parametrize("kind,alpha,tau", [("hard", 0.5, 3.0),
                                            ("soft", 0.5, 3.0),
                                            ("soft", 0.2, 1.0),
                                            ("soft", 1.0, 5.0)])
def test_distillation_matches_jax(data, kind, alpha, tau, reduction,
                                  weights):
    rng = np.random.RandomState(1)
    cls_logits = data["logits"]
    dist_logits = rng.randn(_N, _K).astype(np.float32)
    teacher = rng.randn(_N, _K).astype(np.float32) * 3
    jl = JaxDistillationLoss(kind, alpha, tau, reduction=reduction)
    tl = DistillationLoss(kind, alpha, tau, reduction=reduction)
    w = _weights(data, weights)
    want = jl((jnp.asarray(data["labels"]), jnp.asarray(teacher)),
              [jnp.asarray(cls_logits), jnp.asarray(dist_logits)],
              sample_weight=w)
    got = tl((_t(data["labels"]), _t(teacher)),
             [_t(cls_logits), _t(dist_logits)],
             sample_weight=None if w is None else _t(w))
    _close(got, want, rtol=_RTOL if kind == "hard" else 1e-5)
    # bf16 heads are taken to float32 first, as in the JAX package
    got16 = tl((_t(data["labels"]), _t(teacher)),
               [_t(cls_logits).bfloat16(), _t(dist_logits).bfloat16()])
    assert got16.dtype == torch.float32


def test_distillation_config_round_trips():
    jl = JaxDistillationLoss("soft", alpha=0.3, tau=2.0, reduction="sum")
    tl = DistillationLoss.from_config(jl.get_config())
    assert tl.get_config() == jl.get_config()
    again = DistillationLoss.from_config(tl.get_config())
    assert (again.kind, again.alpha, again.tau, again.reduction) == (
        "soft", 0.3, 2.0, "sum")
    for bad in (dict(kind="medium"), dict(alpha=1.5), dict(tau=0.0)):
        with pytest.raises(ValueError):
            DistillationLoss(**bad)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _batches(kind, weighting, seed=0):
    """Three batches ``(y_true, y_pred, sample_weight)`` of one kind; the
    second is weighted, per row (``[n]``), per row as a column (``[n,
    1]``) or per element (``y_pred``'s shape)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(3):
        n = 10 + i
        if kind == "multilabel":
            y = (rng.rand(n, _K) > 0.6).astype(np.float32)
            p = rng.rand(n, _K).astype(np.float32)
        elif kind == "categorical":
            y = np.eye(_K, dtype=np.float32)[rng.randint(0, _K, n)]
            # scores on a coarse grid, so that ties occur
            p = np.round(rng.rand(n, _K) * 4).astype(np.float32) / 4
        elif kind == "sparse":
            y = rng.randint(0, _K, n)
            p = np.round(rng.rand(n, _K) * 4).astype(np.float32) / 4
        elif kind == "sparse_column":
            y = rng.randint(0, _K, (n, 1))
            p = rng.rand(n, _K).astype(np.float32)
        elif kind == "binary":
            y = (rng.rand(n) > 0.5).astype(np.float32)
            p = rng.rand(n).astype(np.float32)
        elif kind == "values":
            y = None
            p = rng.randn(n).astype(np.float32)
        elif kind == "segmentation":
            y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 4, 4))]
            p = rng.dirichlet(np.ones(3), (2, 4, 4)).astype(np.float32)
        shape = {"row": (n,), "column": (n, 1), "element": p.shape}[
            weighting]
        w = rng.rand(*shape).astype(np.float32) if i == 1 else None
        if kind == "segmentation":
            w = None
        out.append((y, p, w))
    return out


_METRICS = [
    ("F1", {}, "multilabel", "element"),
    ("F1", {"thresholds": 0.3, "class_id": 2}, "multilabel", "row"),
    ("F1", {"top_k": 2}, "categorical", "column"),
    ("Precision", {}, "multilabel", "column"),
    ("Precision", {"top_k": 3}, "categorical", "element"),
    ("Recall", {"thresholds": 0.7}, "multilabel", "element"),
    ("Recall", {"class_id": 0}, "multilabel", "row"),
    ("Mean", {}, "values", "row"),
    ("BinaryAccuracy", {}, "binary", "row"),
    ("BinaryAccuracy", {"threshold": 0.3}, "multilabel", "element"),
    ("CategoricalAccuracy", {}, "categorical", "row"),
    ("SparseCategoricalAccuracy", {}, "sparse", "row"),
    ("SparseCategoricalAccuracy", {}, "sparse_column", "row"),
    ("TopKCategoricalAccuracy", {"k": 2}, "categorical", "row"),
    ("SparseTopKCategoricalAccuracy", {"k": 2}, "sparse", "row"),
    ("SparseTopKCategoricalAccuracy", {"k": 3}, "sparse_column", "row"),
    ("AUC", {}, "binary", "row"),
    ("AUC", {"curve": "PR", "num_thresholds": 50}, "binary", "row"),
    ("AUC", {"num_thresholds": 31}, "multilabel", "element"),
    ("SoftDiceCoefficient", {}, "segmentation", "row"),
    ("SoftDiceCoefficient", {"exclude_classes": [1]}, "segmentation", "row"),
]


def _ids(case):
    name, kwargs, kind, weighting = case
    return (f"{name}-{'-'.join(f'{k}={v}' for k, v in kwargs.items())}-"
            f"{kind}-{weighting}")


@pytest.mark.parametrize("case", _METRICS, ids=_ids)
def test_metrics_stream_like_jax(case):
    name, kwargs, kind, weighting = case
    jm = getattr(jmetrics, name)(**kwargs)
    tm = getattr(tmetrics, name)(device="cpu", **kwargs)
    state = tm.init()
    for y, p, w in _batches(kind, weighting):
        jm.update_state(y, p, sample_weight=w)
        tm.update_state(None if y is None else _t(y), _t(p),
                        sample_weight=None if w is None else _t(w))
        state = tm.update(state, None if y is None else _t(y), _t(p),
                          sample_weight=None if w is None else _t(w))
        want = jm.result()
        assert tm.result() == pytest.approx(want, rel=_RTOL, abs=1e-7)
        assert float(tm.compute(state)) == pytest.approx(want, rel=_RTOL,
                                                         abs=1e-7)
    assert all(v.device.type == "cpu" for v in state.values())
    tm.reset_states()
    jm.reset_states()
    assert tm.result() == pytest.approx(jm.result(), abs=1e-7)


def test_top_k_ties_rank_the_lower_index_first():
    """Equal scores at the k-th place: the lower class index is in the top
    k, as ``lax.top_k`` orders them."""
    scores = np.array([[0.5, 0.5, 0.5, 0.1], [0.2, 0.9, 0.2, 0.2]],
                      np.float32)
    for labels, want in (([0, 2], [1.0, 0.0]), ([2, 3], [0.0, 0.0]),
                         ([1, 0], [1.0, 1.0])):
        jm = jmetrics.SparseTopKCategoricalAccuracy(k=2)
        tm = tmetrics.SparseTopKCategoricalAccuracy(k=2, device="cpu")
        jm.update_state(np.array(labels), scores)
        tm.update_state(_t(np.array(labels)), _t(scores))
        assert tm.result() == jm.result() == np.mean(want)


def test_metrics_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmetrics.SparseCategoricalAccuracy()
    assert tmetrics.dsc is tmetrics.DSC is tmetrics.soft_dice_coefficient
