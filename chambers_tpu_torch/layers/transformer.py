"""Transformer encoder blocks (port of ``chambers_tpu/layers/transformer.py``:
``EncoderLayer`` and ``Encoder``, pre- or post-norm, optional output norm).

Submodule and parameter names are the JAX package's, so a converted
``state_dict`` loads as it is: ``multi_head_attention``, ``norm1``,
``norm2``, ``dense1``, ``dense2`` per layer; ``layers.<i>`` and
``norm_layer`` in the stack. The mixture-of-experts layers, the decoder and
dropout come in later slices; these blocks compute inference.
"""

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.activations import gelu
from chambers_tpu_torch.layers.attention import MultiHeadAttention
from chambers_tpu_torch.layers.normalization import FastLayerNorm, LayerNorm
from chambers_tpu_torch.quantization import QuantDense


def _make_norm(dim, epsilon, dtype, param_dtype, stats_dtype, device):
    """float32-statistics LayerNorm (the parity default), or FastLayerNorm
    with statistics in ``stats_dtype``; the same parameters either way."""
    if stats_dtype is None:
        return LayerNorm(dim, epsilon, dtype, param_dtype, device)
    return FastLayerNorm(dim, epsilon, dtype, param_dtype, stats_dtype,
                         device)


class EncoderLayer(nn.Module):
    def __init__(self, embed_dim=512, num_heads=8, ff_dim=2048,
                 norm_epsilon=1e-6, pre_norm=False, dtype=None,
                 param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, gelu_approximate=False,
                 norm_stats_dtype=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.pre_norm = pre_norm
        self.gelu_approximate = gelu_approximate
        self.multi_head_attention = MultiHeadAttention(
            embed_dim, head_dim=embed_dim // num_heads, num_heads=num_heads,
            dtype=dtype, param_dtype=param_dtype,
            attention_impl=attention_impl, score_dtype=score_dtype,
            device=device)
        norm = (embed_dim, norm_epsilon, dtype, param_dtype,
                norm_stats_dtype, device)
        self.norm1 = _make_norm(*norm)
        self.norm2 = _make_norm(*norm)
        dense = dict(dtype=dtype, param_dtype=param_dtype,
                     kernel_init=initializers.glorot_uniform, device=device)
        self.dense1 = QuantDense(embed_dim, ff_dim, **dense)
        self.dense2 = QuantDense(ff_dim, embed_dim, **dense)

    def forward(self, x, mask=None):
        if self.pre_norm:
            x = x + self._self_attn(self.norm1(x), mask)
            return x + self._mlp(self.norm2(x))
        x = self.norm1(x + self._self_attn(x, mask))
        return self.norm2(x + self._mlp(x))

    def _self_attn(self, q, mask):
        return self.multi_head_attention([q, q, q], mask=[mask, mask])

    def _mlp(self, x):
        return self.dense2(gelu(self.dense1(x),
                                approximate=self.gelu_approximate))


class Encoder(nn.Module):
    def __init__(self, embed_dim, num_heads, ff_dim, num_layers,
                 norm_epsilon=1e-6, pre_norm=False, norm_output=False,
                 dtype=None, param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, gelu_approximate=False,
                 norm_stats_dtype=None, moe_every_n=0, device=None):
        super().__init__()
        if moe_every_n:
            raise NotImplementedError(
                "mixture-of-experts encoder layers are not ported yet; they "
                "come in a later slice.")
        device = resolve_device(device)
        self.layers = nn.ModuleList(
            EncoderLayer(embed_dim, num_heads, ff_dim, norm_epsilon,
                         pre_norm, dtype, param_dtype, attention_impl,
                         score_dtype, gelu_approximate, norm_stats_dtype,
                         device)
            for _ in range(num_layers))
        self.norm_layer = (
            _make_norm(embed_dim, norm_epsilon, dtype, param_dtype,
                       norm_stats_dtype, device)
            if norm_output else None)

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask=mask)
        if self.norm_layer is not None:
            x = self.norm_layer(x)
        return x

