"""Pairwise batch prediction for retrieval evaluation (port of
``chambers_tpu/utils/data.py``).

``batch_predict_pairs`` runs a two-input (pair-scoring / siamese) model
over all query×candidate batch combinations and reassembles the full
``[nq, nc]`` score matrix: a double-batched loop on the card over
candidates placed there once, as the JAX package's loop over
device-resident candidates. ``pair_iteration_dataset`` is the same
Cartesian iteration as a :class:`~chambers_tpu_torch.data.Dataset`.
"""

import math
from typing import Callable, Optional

import numpy as np
import torch

from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.data.core import Dataset
from chambers_tpu_torch.data.loader import _host_tensor


def valid_cardinality(dataset) -> bool:
    """True iff the dataset reports a finite, known cardinality
    (``Dataset.cardinality`` uses tf.data's negative sentinels: −1
    infinite, −2 unknown)."""
    return dataset.cardinality() >= 0


def pair_iteration_dataset(q, c, bq, bc, yq=None, yc=None) -> Dataset:
    """Cartesian batch iteration: every query batch is paired with every
    candidate batch, candidate-major within a query batch."""
    q = np.asarray(q)
    c = np.asarray(c)
    nqb = math.ceil(len(q) / bq)
    ncb = math.ceil(len(c) / bc)
    with_labels = yq is not None

    def gen():
        for i in range(nqb):
            qb = q[i * bq:(i + 1) * bq]
            yqb = None if yq is None else np.asarray(yq)[i * bq:(i + 1) * bq]
            for j in range(ncb):
                cb = c[j * bc:(j + 1) * bc]
                ycb = None if yc is None else np.asarray(yc)[j * bc:(j + 1) * bc]
                if with_labels:
                    yield (qb, cb), (yqb, ycb)
                else:
                    yield (qb, cb)

    return Dataset(gen)


def reshape_pair_predictions(x, bq, bc, nq, nc, y=None):
    """Reassemble per-pair-batch scores ``[nqb*ncb, bq, bc]`` into the full
    ``[nq, nc]`` matrix."""
    nqb = math.ceil(nq / bq)
    ncb = math.ceil(nc / bc)
    x = np.asarray(x).reshape(nqb, ncb, bq, bc)
    x = x.transpose(0, 2, 1, 3).reshape(nqb * bq, ncb * bc)
    x = x[:nq, :nc]
    if y is not None:
        yq, yc = y
        yq = np.asarray(yq).reshape(nqb, ncb, -1)[:, 0].reshape(-1, 1)[:nq]
        yc = np.asarray(yc)[:nc]
        return x, (yq, yc)
    return x


def batch_predict_pairs(
    model: Callable,
    q,
    bq: int,
    c=None,
    bc: Optional[int] = None,
    yq=None,
    yc=None,
    verbose: bool = True,
    device=None,
):
    """Score all query×candidate pairs with a pair model.

    :param model: callable ``model([q_batch, c_batch]) -> [bq, bc]`` score
        matrix of tensors on ``device`` (e.g. embeddings through
        :class:`~chambers_tpu_torch.layers.CosineSimilarity` with
        broadcasting), called without gradients over padded batches.
    :param q: ``[nq, ...]`` queries; ``c``: candidates (defaults to ``q``).
    :param device: where the model runs: CUDA unless the caller says
        otherwise. The padded candidates are placed there once.
    :return: ``[nq, nc]`` numpy score matrix, or ``(scores, (yq, yc))``
        when labels are given.
    """
    device = resolve_device(device)
    if c is None:
        c, bc, yc = q, bq, yq
    elif bc is None:
        bc = bq

    q = np.asarray(q)
    c = np.asarray(c)
    nq, nc = len(q), len(c)
    bq, bc = min(bq, nq), min(bc, nc)

    q_pad = _pad_to_multiple(q, bq)
    c_pad = _pad_to_multiple(c, bc)
    nqb = len(q_pad) // bq
    ncb = len(c_pad) // bc

    c_dev = _host_tensor(c_pad).to(device)
    blocks = []
    done = 0
    total = nqb * ncb
    with torch.no_grad():
        for i in range(nqb):
            qb = _host_tensor(q_pad[i * bq:(i + 1) * bq]).to(device)
            row = []
            for j in range(ncb):
                row.append(model([qb, c_dev[j * bc:(j + 1) * bc]]))
                done += 1
                if verbose:
                    print(f"\r{done}/{total}", end="", flush=True)
            blocks.append([r.float().cpu().numpy() for r in row])
    if verbose:
        print()

    scores = np.block(blocks)[:nq, :nc]
    if yq is not None:
        return scores, (np.asarray(yq).reshape(-1, 1), np.asarray(yc))
    return scores


def _pad_to_multiple(x, b):
    pad = (-len(x)) % b
    if pad == 0:
        return x
    return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
