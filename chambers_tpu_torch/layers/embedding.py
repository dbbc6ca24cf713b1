"""Positional encodings and learned embeddings (port of
``chambers_tpu/layers/embedding.py``: ``positional_encoding_1d``,
``PositionalEncoding1D``, ``ConcatEmbedding`` and ``LearnedEmbedding1D``).

The sinusoidal table uses the interleaved layout: ``out[..., 2i] =
sin(pos * rate_2i)``, ``out[..., 2i+1] = cos(pos * rate_2i+1)`` with
``rate_j = temperature^(-2 (j // 2) / dim)``. It is computed in float64
numpy, cast to float32 and then to the input's dtype, in that order: the
order decides the bf16 bits. Each learned embedding holds one parameter,
``embeddings``."""

import numpy as np
import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device


def _angle_rates(dim: int, temperature: float) -> np.ndarray:
    j = np.arange(dim, dtype=np.float64)
    exponent = (2.0 * (j // 2)) / float(dim)
    return 1.0 / np.power(float(temperature), exponent)


def _interleaved_sin_cos(angles: np.ndarray) -> np.ndarray:
    """sin on even channels, cos on odd channels."""
    out = np.empty_like(angles)
    out[..., 0::2] = np.sin(angles[..., 0::2])
    out[..., 1::2] = np.cos(angles[..., 1::2])
    return out


def positional_encoding_1d(seq_len: int, dim: int,
                           temperature: float = 10000.0) -> np.ndarray:
    """Sinusoidal positional encoding, ``[1, seq_len, dim]`` float32."""
    pos = np.arange(seq_len, dtype=np.float64)[:, None]
    angles = pos * _angle_rates(dim, temperature)[None, :]
    return _interleaved_sin_cos(angles)[None].astype(np.float32)


class PositionalEncoding1D(nn.Module):
    """Adds (or returns) the sinusoidal encoding of the input's length and
    width; it has no parameters. The table is kept per ``(seq_len, dim,
    dtype, device)`` once made."""

    def __init__(self, temperature=10000.0, add_to_input=True):
        super().__init__()
        self.temperature = temperature
        self.add_to_input = add_to_input
        self._tables = {}

    def forward(self, x):
        key = (x.shape[1], x.shape[2], x.dtype, x.device)
        enc = self._tables.get(key)
        if enc is None:
            table = positional_encoding_1d(x.shape[1], x.shape[2],
                                           self.temperature)
            enc = torch.from_numpy(table).to(x.device).to(x.dtype)
            self._tables[key] = enc
        if self.add_to_input:
            return x + enc
        return enc


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
