"""Pair-based metric-learning losses over a dense similarity matrix (port
of ``chambers_tpu/losses/metric_learning.py``).

Embeddings ``[n, d]`` -> the dot-product similarity matrix ``[n, n]`` ->
boolean positive/negative pair masks from label equality -> optional
removal of the diagonal and of negative-label columns -> an optional miner
-> one loss per row. Each per-row reduction is a sum, max or min over the
kept pairs with a masked identity, so a row with no pair gives what the
ragged reductions of the original gave.

- Label -1 marks a negative-only sample; ``ignore_negative_labels`` removes
  such columns from both masks.
- ``ignore_diag`` removes the mirror pairs.
- The Keras ``Loss`` contract (``losses/base.py``): ``call`` returns the
  per-row losses, ``__call__(y_true, y_pred, sample_weight=None)`` weights
  row ``i`` by ``sample_weight[i]`` and reduces.

Every intermediate keeps the JAX package's dtype: bf16 embeddings give a
bf16 similarity matrix and bf16 row losses, as they do there.
"""

from abc import ABC, abstractmethod

import torch

from chambers_tpu_torch.losses.base import Loss
from chambers_tpu_torch.miners import MultiSimilarityMiner as _MSMiner

_EPSILON = 1e-7  # keras backend epsilon
_DEFAULT_MINER = object()  # sentinel: "use the class default miner"


def _inverse_eye(similarity_matrix):
    n, m = similarity_matrix.shape
    return ~torch.eye(n, m, dtype=torch.bool,
                      device=similarity_matrix.device)


class PairLoss(Loss, ABC):
    def __init__(self, ignore_diag=True, ignore_negative_labels=True,
                 miner=None, name=None, reduction="sum_over_batch_size"):
        """
        :param ignore_diag: ignore the diagonal (mirror) pairs.
        :param ignore_negative_labels: exclude samples with negative labels
            from the candidate pairs.
        :param miner: optional pair miner.
        :param reduction: Keras reduction over the per-row losses; a
            ``sample_weight`` weights per row (anchor).
        """
        super().__init__(reduction=reduction, name=name)
        self.ignore_diag = ignore_diag
        self.ignore_negative_labels = ignore_negative_labels
        self.miner = miner

    def call(self, y_true, y_pred):
        """Per-row losses ``[n]`` for labels ``[n]`` and embeddings ``[n,
        d]`` (or a similarity matrix for the Matrix variants)."""
        similarity_matrix = self.compute_similarity_matrix(y_pred)
        pos_mask, neg_mask = self.get_signed_masks(similarity_matrix, y_true)
        if self.miner is not None:
            pos_mask, neg_mask = self.miner(similarity_matrix, pos_mask,
                                            neg_mask)
        return self.compute_loss(similarity_matrix, pos_mask, neg_mask)

    def compute_similarity_matrix(self, y_pred):
        """Dot-product similarity between all embedding pairs, ``[n, n]``."""
        return torch.matmul(y_pred, y_pred.T)

    def compute_signed_masks(self, y_true):
        labels = y_true.reshape(-1, 1)
        pos_mask = labels == labels.T
        return pos_mask, ~pos_mask

    def get_signed_masks(self, similarity_matrix, y_true):
        pos_mask, neg_mask = self.compute_signed_masks(y_true)
        if self.ignore_negative_labels:
            # [n] & [n, n] broadcasts over rows: masks the columns of
            # negative labels
            not_triplet_neg = y_true.reshape(-1) >= 0
            pos_mask = pos_mask & not_triplet_neg
            neg_mask = neg_mask & not_triplet_neg
        if self.ignore_diag:
            inverse_eye = _inverse_eye(similarity_matrix)
            pos_mask = pos_mask & inverse_eye
            neg_mask = neg_mask & inverse_eye
        return pos_mask, neg_mask

    @abstractmethod
    def compute_loss(self, similarity_matrix, positive_mask, negative_mask):
        """Per-row loss from the similarity matrix and final pair masks."""


class PairMatrixLoss(PairLoss):
    """``y_pred`` is already a similarity matrix and ``y_true`` a binary pair
    matrix."""

    def compute_similarity_matrix(self, y_pred):
        return y_pred

    def compute_signed_masks(self, y_true):
        pos_mask = y_true.bool()
        return pos_mask, ~pos_mask

    def get_signed_masks(self, similarity_matrix, y_true):
        pos_mask, neg_mask = self.compute_signed_masks(y_true)
        # ignore_negative_labels means nothing for a binary pair matrix
        if self.ignore_diag:
            inverse_eye = _inverse_eye(similarity_matrix)
            pos_mask = pos_mask & inverse_eye
            neg_mask = neg_mask & inverse_eye
        return pos_mask, neg_mask


class _MultiSimilarityMixin:
    """MS loss (Wang et al., CVPR'19): softplus of the sum of exponentials
    around the threshold λ, with scales α (positives) and β (negatives);
    the miner defaults to ``MultiSimilarityMiner(margin=0.1)``."""

    def __init__(self, pos_scale=2.0, neg_scale=40.0, threshold=0.5,
                 ignore_diag=True, ignore_negative_labels=True,
                 miner=_DEFAULT_MINER, name="multi_similarity_loss",
                 reduction="sum_over_batch_size"):
        if miner is _DEFAULT_MINER:
            miner = _MSMiner(margin=0.1)
        super().__init__(ignore_diag=ignore_diag,
                         ignore_negative_labels=ignore_negative_labels,
                         miner=miner, name=name, reduction=reduction)
        self.pos_scale = pos_scale  # alpha
        self.neg_scale = neg_scale  # beta
        self.threshold = threshold  # lambda

    def compute_loss(self, similarity_matrix, positive_mask, negative_mask):
        # log(1 + Σ exp(x)) as logaddexp(0, logsumexp(x)): masked pairs
        # cannot poison values or gradients, and large similarities saturate
        # to a finite loss where exp would overflow (beta = 40)
        pos = self._row_term(similarity_matrix, positive_mask,
                             -self.pos_scale)
        neg = self._row_term(similarity_matrix, negative_mask,
                             self.neg_scale)
        return pos / self.pos_scale + neg / self.neg_scale

    def _row_term(self, sim, mask, signed_scale):
        x = signed_scale * (sim - self.threshold)
        has_pairs = mask.any(dim=1)
        x = torch.where(mask, x, -torch.inf)
        # a row with no pair: a dummy row of zeros, so that logsumexp of all
        # -inf cannot give NaN gradients; its result is zeroed
        x_safe = torch.where(has_pairs[:, None], x, 0.0)
        lse = torch.logsumexp(x_safe, dim=1)
        term = torch.logaddexp(torch.zeros_like(lse), lse)
        return torch.where(has_pairs, term, 0.0)


class MultiSimilarityLoss(_MultiSimilarityMixin, PairLoss):
    """The MS loss over embeddings ``[n, d]`` and labels ``[n]``."""


class MultiSimilarityLossMatrix(_MultiSimilarityMixin, PairMatrixLoss):
    """The MS loss over a similarity matrix and a binary pair matrix."""


class ContrastiveLoss(PairLoss):
    """Similarity-space contrastive loss: positives below
    ``positive_margin`` and negatives above ``negative_margin`` contribute,
    raised to ``exponent``."""

    def __init__(self, positive_margin=1.0, negative_margin=0.3, exponent=2,
                 ignore_diag=True, ignore_negative_labels=True, miner=None,
                 name="contrastive_loss", reduction="sum_over_batch_size"):
        super().__init__(ignore_diag=ignore_diag,
                         ignore_negative_labels=ignore_negative_labels,
                         miner=miner, name=name, reduction=reduction)
        self.positive_margin = positive_margin
        self.negative_margin = negative_margin
        self.exponent = exponent

    def compute_loss(self, similarity_matrix, positive_mask, negative_mask):
        pos_pair_loss = (torch.pow(self.positive_margin - similarity_matrix,
                                   self.exponent) / self.exponent)
        pos_loss = torch.where(positive_mask, pos_pair_loss, 0.0).sum(dim=1)
        neg_pair_loss = (torch.pow(
            torch.clamp(similarity_matrix - self.negative_margin, min=0.0),
            self.exponent) / self.exponent)
        neg_loss = torch.where(negative_mask, neg_pair_loss, 0.0).sum(dim=1)
        return pos_loss + neg_loss


def categorical_crossentropy_per_row(y_true, y_pred, from_logits=False):
    """Keras categorical crossentropy, per row ``[n]``. Without
    ``from_logits`` the predictions are renormalized to sum to 1 and clipped
    to ``[eps, 1 - eps]``."""
    y_true = y_true.to(torch.float32)
    if from_logits:
        log_p = y_pred - torch.logsumexp(y_pred, dim=-1, keepdim=True)
    else:
        p = y_pred / y_pred.sum(dim=-1, keepdim=True)
        log_p = torch.log(torch.clamp(p, _EPSILON, 1.0 - _EPSILON))
    return -(y_true * log_p).sum(dim=-1)


def categorical_crossentropy(y_true, y_pred, from_logits=False):
    """Keras categorical crossentropy, the mean over rows."""
    return categorical_crossentropy_per_row(
        y_true, y_pred, from_logits=from_logits).mean()


class NTXentLoss(Loss):
    """SimCLR's NT-Xent: the similarity matrix over the temperature, mirror
    pairs set to -1e9, crossentropy against the one-hot positive pairs.

    With the default ``from_logits=False`` the similarities are renormalized
    as if they were probabilities (the original's behaviour): with the -1e9
    diagonal that saturates the clip and gives zero gradients. Pass
    ``from_logits=True`` for a trainable objective."""

    def __init__(self, temperature=1.0, from_logits=False, name=None,
                 reduction="sum_over_batch_size"):
        super().__init__(reduction=reduction, name=name)
        self.temperature = temperature
        self.from_logits = from_logits

    def call(self, y_true, y_pred):
        """Per-row crossentropy ``[n]`` (a row is one anchor)."""
        n = y_pred.shape[0]
        eye = torch.eye(n, dtype=torch.bool, device=y_pred.device)
        similarity_matrix = (self.compute_similarity_matrix(y_pred)
                             / self.temperature)
        similarity_matrix = torch.where(eye, -1e9, similarity_matrix)
        labels = y_true.reshape(-1, 1)
        y_onehot = torch.where(eye, 0, (labels == labels.T).to(torch.int32))
        return categorical_crossentropy_per_row(
            y_onehot, similarity_matrix, from_logits=self.from_logits)

    def compute_similarity_matrix(self, y_pred):
        return torch.matmul(y_pred, y_pred.T)
