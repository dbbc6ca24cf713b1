"""Retrieval-evaluation ranking (port of ``chambers_tpu/utils/ranking.py``).
Sorting is stable and descending, so equal scores keep the lower index
first, as ``jnp.argsort(-scores, stable=True)``."""

import torch


def _ranking(scores, remove_top1):
    index_ranking = torch.sort(-scores, dim=1, stable=True).indices
    return index_ranking[:, 1:] if remove_top1 else index_ranking


def score_matrix_to_binary_ranking(similarity_matrix, query_labels,
                                   candidate_labels, remove_top1=False):
    """``[nq, nc]`` (or ``[nq, nc-1]``) float relevance, each query's
    candidates ranked by descending score."""
    pair_signs = (query_labels.reshape(-1, 1)
                  == candidate_labels.reshape(1, -1)).to(torch.float32)
    return torch.gather(pair_signs, 1,
                        _ranking(similarity_matrix, remove_top1))


def rank_labels(y, scores, remove_top1=False):
    """Labels sorted by descending score per query; ``(labels, indices)``."""
    index_ranking = _ranking(scores, remove_top1)
    labels = y.reshape(1, -1).expand(index_ranking.shape[0], y.shape[0])
    return torch.gather(labels, 1, index_ranking), index_ranking


def recall_at_k(binary_ranking, k):
    """Share of queries with a relevant candidate in their top ``k``."""
    return binary_ranking[:, :k].amax(dim=1).mean()


def mean_average_precision(binary_ranking):
    """Mean average precision over the queries of a binary ranking."""
    n = binary_ranking.shape[1]
    cum_rel = torch.cumsum(binary_ranking, dim=1)
    ranks = torch.arange(1, n + 1, dtype=torch.float32,
                         device=binary_ranking.device)
    ap_num = (cum_rel / ranks * binary_ranking).sum(dim=1)
    return (ap_num / cum_rel[:, -1].clamp(min=1.0)).mean()
