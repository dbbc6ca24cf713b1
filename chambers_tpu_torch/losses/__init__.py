"""Losses of the port: the Keras call contract, the metric-learning,
categorical and distillation losses."""

from chambers_tpu_torch.losses.base import Loss, reduce_weighted_loss
from chambers_tpu_torch.losses.categorical import (
    BinaryCrossentropy,
    CategoricalCrossentropy,
    MeanSquaredError,
    SoftDiceLoss,
    SparseCategoricalCrossentropy,
    soft_dice_coefficient,
)
from chambers_tpu_torch.losses.distillation import DistillationLoss
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
    "BinaryCrossentropy",
    "CategoricalCrossentropy",
    "ContrastiveLoss",
    "DistillationLoss",
    "Loss",
    "MeanSquaredError",
    "MultiSimilarityLoss",
    "MultiSimilarityLossMatrix",
    "NTXentLoss",
    "PairLoss",
    "PairMatrixLoss",
    "SoftDiceLoss",
    "SparseCategoricalCrossentropy",
    "categorical_crossentropy",
    "categorical_crossentropy_per_row",
    "reduce_weighted_loss",
    "soft_dice_coefficient",
]
