"""Cross-device retrieval evaluation (port of
``chambers_tpu/parallel/collective_eval.py``).

Queries and candidates are row-sharded over a mesh axis; each rank gathers
the candidates, scores its own queries, and (for recall) takes its top-k
locally: only the candidates and two counts cross ranks, never a score.
Inputs are global arrays (numpy or tensors, every rank passing the same;
each takes its rows) or ``DTensor`` rows from ``shard_batch``.
"""

import torch
from torch.distributed.tensor import DTensor

from chambers_tpu_torch.parallel.distributed import (
    _all_gather,
    axis_group,
    axis_size,
    local_rows,
    mesh_device,
    reduce_forward,
)
from chambers_tpu_torch.parallel.sharding import P, _placements


def _rows(x, mesh, axis):
    rows = local_rows(x, mesh, axis)
    if not isinstance(x, DTensor) and len(x) % axis_size(mesh, axis):
        raise ValueError(f"{len(x)} rows do not divide over mesh axis "
                         f"{axis!r}")
    return torch.as_tensor(rows).to(mesh_device(mesh))


def _gathered(x, group):
    return x if group is None else _all_gather(x, group, 0)


def distributed_pairwise_scores(queries, candidates, mesh,
                                axis: str = "data"):
    """The ``[nq, nc]`` score matrix ``queries @ candidatesᵀ`` with both
    row-sharded on ``axis``: each rank gathers the candidates and scores its
    query rows. Returns a ``DTensor`` with the rows sharded like the
    queries (``.full_tensor()`` for the whole matrix)."""
    group = axis_group(mesh, axis)
    q = _rows(queries, mesh, axis)
    c = _gathered(_rows(candidates, mesh, axis), group)
    return DTensor.from_local(q @ c.T, mesh, _placements(mesh, P(axis)))


def distributed_recall_at_k(queries, candidates, query_labels,
                            candidate_labels, k: int, mesh,
                            axis: str = "data", remove_top1: bool = False):
    """recall@k with sharded queries: each rank takes the top-k of its
    query rows against the gathered candidates (ties to the lower index,
    as ``lax.top_k``) and the hit and query counts are all-reduced. Returns
    a float32 scalar tensor, the same on every rank."""
    group = axis_group(mesh, axis)
    q = _rows(queries, mesh, axis)
    yq = _rows(query_labels, mesh, axis)
    c = _gathered(_rows(candidates, mesh, axis), group)
    yc = _gathered(_rows(candidate_labels, mesh, axis), group)
    scores = q @ c.T                                        # [nq_local, nc]
    kk = k + 1 if remove_top1 else k
    top = torch.sort(scores, dim=1, descending=True, stable=True).indices
    top = top[:, 1:kk] if remove_top1 else top[:, :kk]
    hits = (yc[top] == yq[:, None]).any(dim=1)
    counts = torch.stack([hits.to(torch.float32).sum(),
                          torch.tensor(float(hits.shape[0]),
                                       device=hits.device)])
    counts = reduce_forward(counts, group)
    return counts[0] / counts[1]
