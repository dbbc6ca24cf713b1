"""Losses of the port: the Keras call contract and the metric-learning
losses."""

from chambers_tpu_torch.losses.base import Loss, reduce_weighted_loss
from chambers_tpu_torch.losses.metric_learning import (
    ContrastiveLoss,
    MultiSimilarityLoss,
    MultiSimilarityLossMatrix,
    NTXentLoss,
    PairLoss,
    PairMatrixLoss,
    categorical_crossentropy,
    categorical_crossentropy_per_row,
)

__all__ = [
    "ContrastiveLoss",
    "Loss",
    "MultiSimilarityLoss",
    "MultiSimilarityLossMatrix",
    "NTXentLoss",
    "PairLoss",
    "PairMatrixLoss",
    "categorical_crossentropy",
    "categorical_crossentropy_per_row",
    "reduce_weighted_loss",
]
