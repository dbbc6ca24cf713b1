"""Pair miners over a dense similarity matrix (port of
``chambers_tpu/miners.py``).

A miner takes the ``[n, n]`` similarity matrix and boolean positive and
negative pair masks and returns refined masks. Masked reductions pad with
the identity (``-inf`` for a max, ``inf`` for a min), so a row with no pair
reduces to it, as the ragged reductions of the original did.
"""

from abc import ABC, abstractmethod

import torch


def masked_max(x, mask, axis=1):
    return torch.where(mask, x, -torch.inf).amax(dim=axis)


def masked_min(x, mask, axis=1):
    return torch.where(mask, x, torch.inf).amin(dim=axis)


class Miner(ABC):
    """Refines positive/negative pair masks given the similarity matrix."""

    def __init__(self, name=None):
        self.name = name

    def __call__(self, similarity_matrix, positive_mask, negative_mask):
        mined_pos, mined_neg = self.compute_masks(
            similarity_matrix, positive_mask, negative_mask)
        return positive_mask & mined_pos, negative_mask & mined_neg

    @abstractmethod
    def compute_masks(self, similarity_matrix, positive_mask, negative_mask):
        ...

    def get_config(self):
        return {"name": self.name}

    @classmethod
    def from_config(cls, config):
        return cls(**config)


class MultiSimilarityMiner(Miner):
    """Keep positive pairs ``< max(neg) + margin`` and negative pairs ``>
    min(pos) - margin`` per row."""

    def __init__(self, margin, name="multi_similarity_miner"):
        super().__init__(name=name)
        self.margin = margin

    def compute_masks(self, similarity_matrix, positive_mask, negative_mask):
        pos_thresh = masked_max(similarity_matrix, negative_mask) + self.margin
        neg_thresh = masked_min(similarity_matrix, positive_mask) - self.margin
        mined_pos = similarity_matrix < pos_thresh[:, None]
        mined_neg = similarity_matrix > neg_thresh[:, None]
        return mined_pos, mined_neg

    def get_config(self):
        config = super().get_config()
        config["margin"] = self.margin
        return config
