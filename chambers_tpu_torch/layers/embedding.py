"""Positional encodings and learned embeddings (port of
``chambers_tpu/layers/embedding.py``: ``angle_rates``,
``sequence_sin_cos_angles``, ``positional_encoding_1d``/``_2d``,
``PositionalEncoding1D``/``2D``, ``LearnedEmbedding1D``/``0D`` and
``ConcatEmbedding``).

The sinusoidal tables use the interleaved layout: ``out[..., 2i] =
sin(pos * rate_2i)``, ``out[..., 2i+1] = cos(pos * rate_2i+1)`` with
``rate_j = temperature^(-2 (j // 2) / dim)``. They are computed in float64
numpy, cast to float32 and then to the input's dtype, in that order: the
order decides the bf16 bits. The 2D table is DETR's: channels ``[0:d/2]``
encode the row (y), ``[d/2:d]`` the column (x). Each learned embedding
holds one parameter, ``embeddings``.

``angle_rates`` and ``sequence_sin_cos_angles`` compute in float32 torch
ops, as the JAX helpers compute in float32 XLA ops; the two agree within
one float32 step (XLA's own jitted and op-by-op results differ by as
much)."""

import numpy as np
import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device


def angle_rates(embedding_range, embedding_dim, temperature: float = 10000.0):
    """Per-channel sinusoid rates ``temperature^(-2 (j // 2) / dim)`` of the
    channel indices ``embedding_range``, float32 ``[1, len(range)]``."""
    r = torch.as_tensor(embedding_range, dtype=torch.float32)[None, :]
    exponent = (2.0 * torch.floor(r / 2.0)) / torch.tensor(
        float(embedding_dim), dtype=torch.float32)
    return 1.0 / torch.pow(torch.tensor(float(temperature),
                                        dtype=torch.float32), exponent)


def sequence_sin_cos_angles(seq, embedding_dim, temperature: float = 10000.0):
    """Interleaved sin/cos encoding ``[1, seq_len, dim]`` of the position
    column ``seq`` ``[seq_len, 1]``: sin on even channels, cos on odd."""
    rng = torch.arange(embedding_dim, dtype=torch.float32)
    rads = torch.as_tensor(seq, dtype=torch.float32) * angle_rates(
        rng, embedding_dim, temperature)
    sine_cos = torch.stack(
        [torch.sin(rads[..., 0::2]), torch.cos(rads[..., 1::2])], dim=-1)
    return sine_cos.reshape(1, rads.shape[0], -1)


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


def positional_encoding_2d(height: int, width: int, dim: int,
                           temperature: float = 10000.0,
                           normalize: bool = False, scale=None,
                           eps: float = 1e-6) -> np.ndarray:
    """DETR's 2D sinusoidal encoding, ``[1, height, width, dim]`` float32:
    channels ``[0:dim/2]`` encode the row index, ``[dim/2:dim]`` the
    column index; with ``normalize`` each axis is divided by its own last
    index (plus ``eps``) and multiplied by ``scale`` (2π if None)."""
    if scale is not None and not normalize:
        raise ValueError("normalize should be True if scale is passed")
    if scale is None:
        scale = 2 * np.pi
    ys = np.arange(height, dtype=np.float64)
    xs = np.arange(width, dtype=np.float64)
    if normalize:
        ys = ys / (ys[-1] + eps) * scale
        xs = xs / (xs[-1] + eps) * scale
    dim_1d = dim // 2
    rates = _angle_rates(dim_1d, temperature)
    enc_y = _interleaved_sin_cos(ys[:, None] * rates[None, :])
    enc_x = _interleaved_sin_cos(xs[:, None] * rates[None, :])
    enc_y = np.broadcast_to(enc_y[:, None, :], (height, width, dim_1d))
    enc_x = np.broadcast_to(enc_x[None, :, :], (height, width, dim_1d))
    return np.concatenate([enc_y, enc_x], axis=-1)[None].astype(np.float32)


class PositionalEncoding1D(nn.Module):
    """Adds (or returns) the sinusoidal encoding of the input's length and
    width; it has no parameters. The table is kept per ``(seq_len, dim,
    dtype, device)`` once made."""

    def __init__(self, temperature=10000.0, add_to_input=True):
        super().__init__()
        self.temperature = temperature
        self.add_to_input = add_to_input
        self._tables = {}

    def table(self, seq_len, dim, dtype, device):
        """The ``[1, seq_len, dim]`` encoding in ``dtype`` on ``device``."""
        key = (seq_len, dim, dtype, device)
        enc = self._tables.get(key)
        if enc is None:
            table = positional_encoding_1d(seq_len, dim, self.temperature)
            enc = torch.from_numpy(table).to(device).to(dtype)
            self._tables[key] = enc
        return enc

    def forward(self, x):
        enc = self.table(x.shape[1], x.shape[2], x.dtype, x.device)
        if self.add_to_input:
            return x + enc
        return enc


class PositionalEncoding2D(nn.Module):
    """Adds (or returns) DETR's 2D encoding (:func:`positional_encoding_2d`)
    of a ``[b, h, w, dim]`` input; it has no parameters. The table is kept
    per ``(h, w, dim, dtype, device)`` once made."""

    def __init__(self, temperature=10000.0, normalize=False, scale=None,
                 eps=1e-6, add_to_input=True):
        super().__init__()
        self.temperature = temperature
        self.normalize = normalize
        self.scale = scale
        self.eps = eps
        self.add_to_input = add_to_input
        self._tables = {}

    def table(self, height, width, dim, dtype, device):
        """The ``[1, height, width, dim]`` encoding in ``dtype`` on
        ``device``."""
        key = (height, width, dim, dtype, device)
        enc = self._tables.get(key)
        if enc is None:
            table = positional_encoding_2d(
                height, width, dim, temperature=self.temperature,
                normalize=self.normalize, scale=self.scale, eps=self.eps)
            enc = torch.from_numpy(table).to(device).to(dtype)
            self._tables[key] = enc
        return enc

    def forward(self, x):
        enc = self.table(x.shape[1], x.shape[2], x.shape[3], x.dtype,
                         x.device)
        if self.add_to_input:
            return x + enc
        return enc


class LearnedEmbedding1D(nn.Module):
    """Learned per-position embedding ``(seq_len, d)`` added to the input
    (the JAX module infers ``seq_len`` from its first input)."""

    def __init__(self, seq_len, dim, add_to_input=True,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.seq_len, self.dim = seq_len, dim
        self.add_to_input = add_to_input
        self.param_dtype = param_dtype
        self.embeddings = initializers.new_param(
            (seq_len, dim), param_dtype, resolve_device(device))

    def reset_parameters(self, generator=None):
        initializers.truncated_normal_002(self.embeddings, generator)

    def forward(self, x):
        if self.add_to_input:
            return x + self.embeddings.to(x.dtype)
        return self.embeddings


class LearnedEmbedding0D(nn.Module):
    """One learned embedding ``(1, d)`` broadcast-added to the input."""

    def __init__(self, dim, add_to_input=True, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim = dim
        self.add_to_input = add_to_input
        self.param_dtype = param_dtype
        self.embeddings = initializers.new_param(
            (1, dim), param_dtype, resolve_device(device))

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
