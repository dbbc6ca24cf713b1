"""Learned token and position embeddings (port of
``chambers_tpu/layers/embedding.py``: ``ConcatEmbedding`` and
``LearnedEmbedding1D``). Each holds one parameter, ``embeddings``."""

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device


class LearnedEmbedding1D(nn.Module):
    """Learned per-position embedding ``(seq_len, d)`` added to the input
    (the JAX module infers ``seq_len`` from its first input)."""

    def __init__(self, seq_len, dim, add_to_input=True,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.add_to_input = add_to_input
        self.embeddings = initializers.new_param(
            (seq_len, dim), param_dtype, resolve_device(device))

    def reset_parameters(self, generator=None):
        initializers.truncated_normal_002(self.embeddings, generator)

    def forward(self, x):
        if self.add_to_input:
            return x + self.embeddings.to(x.dtype)
        return self.embeddings


class ConcatEmbedding(nn.Module):
    """Learned token(s) broadcast over the batch and concatenated to the
    input; with ``axis=1, side='left'`` this prepends a CLS token."""

    def __init__(self, n_embeddings, embedding_dim, axis=-1, side="left",
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if side not in ("left", "right"):
            raise ValueError("Argument `side` must be either 'left' or "
                             "'right'.")
        self.axis = axis
        self.side = side
        self.embeddings = initializers.new_param(
            (n_embeddings, embedding_dim), param_dtype,
            resolve_device(device))

    def reset_parameters(self, generator=None):
        initializers.truncated_normal_002(self.embeddings, generator)

    def forward(self, x):
        emb = self.embeddings.to(x.dtype)
        emb = emb[None].expand(x.shape[0], *emb.shape)
        operands = [emb, x] if self.side == "left" else [x, emb]
        return torch.cat(operands, dim=self.axis)
