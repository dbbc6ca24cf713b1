"""Distance and similarity layers over ``[a, b]`` (port of
``chambers_tpu/layers/distance.py``), reduced along ``axis``.
``CosineSimilarity`` rescales to ``[0, 1]`` by ``(cos + 1) / 2``; the
angular, cubic and square-root variants rescale otherwise."""

import math

import torch

from chambers_tpu_torch.layers.normalization import l2_normalize


class Distance:
    def __init__(self, axis=-1, keepdims=False):
        self.axis = axis
        self.keepdims = keepdims


class L1Distance(Distance):
    """``sum(|a - b|)``."""

    def __call__(self, inputs):
        a, b = inputs
        return torch.sum(torch.abs(a - b), dim=self.axis,
                         keepdim=self.keepdims)


class L2Distance(Distance):
    """``sqrt(sum((a - b)^2))``."""

    def __call__(self, inputs):
        a, b = inputs
        return torch.sqrt(torch.sum(torch.square(a - b), dim=self.axis,
                                    keepdim=self.keepdims))


class CosineSimilarity(Distance):
    """Cosine similarity rescaled to ``[0, 1]``."""

    def __call__(self, inputs):
        a, b = inputs
        return self._scale(self._cosine_similarity(a, b))

    def _cosine_similarity(self, a, b):
        a = l2_normalize(a, axis=self.axis)
        b = l2_normalize(b, axis=self.axis)
        return torch.sum(a * b, dim=self.axis, keepdim=self.keepdims)

    def _scale(self, cos_sim):
        return (cos_sim + 1) / 2


class AngularCosineSimilarity(CosineSimilarity):
    def _scale(self, cos_sim):
        return 1 - torch.arccos(cos_sim) / math.pi


class CubicCosineSimilarity(CosineSimilarity):
    def _scale(self, cos_sim):
        return 0.5 + 0.25 * cos_sim + 0.25 * torch.pow(cos_sim, 3)


class SqrtCosineSimilarity(CosineSimilarity):
    def _scale(self, cos_sim):
        return 1 - torch.sqrt((1 - cos_sim) / 2)
