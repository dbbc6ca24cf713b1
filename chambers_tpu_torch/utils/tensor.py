"""Tensor utilities (port of ``chambers_tpu/utils/tensor.py``)."""

import numpy as np
import torch


def remove_indices(x, indices, axis=0):
    """Drop the given ``indices`` along ``axis``."""
    length = x.shape[axis]
    mask = np.ones((length,), dtype=bool)
    mask[np.asarray(indices)] = False
    keep = torch.as_tensor(np.arange(length)[mask], device=x.device)
    return torch.index_select(x, axis, keep)


def remove_diagonal(mat):
    """Remove the diagonal of an ``[n, m]`` matrix, giving ``[n, m-1]``."""
    n, m = mat.shape
    rows, cols = np.nonzero(~np.eye(n, m, dtype=bool))
    return mat[torch.as_tensor(rows, device=mat.device),
               torch.as_tensor(cols, device=mat.device)].reshape(n, m - 1)


def arg_to_gather_nd(arg):
    """Per-row indices ``[n, k]`` as flat ``[n*k, 2]`` (row, col) pairs."""
    arg = torch.as_tensor(arg)
    rows = torch.arange(arg.shape[0], dtype=arg.dtype,
                        device=arg.device)[:, None].expand(arg.shape)
    return torch.stack([rows, arg], dim=-1).reshape(-1, 2)


def take_along_rows(mat, indices):
    """``mat[i, indices[i, j]]``."""
    return torch.gather(mat, 1, torch.as_tensor(indices, device=mat.device))
