"""Transformer encoder and decoder blocks (port of
``chambers_tpu/layers/transformer.py``: ``EncoderLayer``, ``DecoderLayer``,
``Encoder`` and ``Decoder``, pre- or post-norm, optional output norm).

Submodule and parameter names are the JAX package's, so a converted
``state_dict`` loads as it is: ``multi_head_attention``, ``norm1``,
``norm2``, ``dense1``, ``dense2`` per encoder layer;
``multi_head_attention1`` (causal self-attention), ``multi_head_attention2``
(cross attention over the encoder memory), ``norm1..3``, ``dense1``,
``dense2`` per decoder layer; ``layers.<i>`` and ``norm_layer`` in a stack.

``DecoderLayer`` keeps a quirk of the original for checkpoint parity: its
pre-norm path normalises the encoder memory with the same ``norm2`` as the
query. ``Decoder(return_sequence=True)`` stacks every layer's output to
``[batch, n_layers, t, d]``.

Dropout follows the calls' ``deterministic`` argument (``None`` reads ``not
self.training``) and draws from ``generator``. The mixture-of-experts
layers, rematerialisation and the incremental decode cache come in later
slices.
"""

import torch
from torch import nn
from torch.nn import functional as F

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


def _dropout(x, rate, deterministic, generator):
    """Inverted dropout as ``flax.linen.Dropout``: keep with probability
    ``1 - rate`` and scale the kept values by ``1 / (1 - rate)``."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        return F.dropout(x, rate, training=True)
    keep = torch.empty_like(x, dtype=torch.float32).bernoulli_(
        1.0 - rate, generator=generator).bool()
    return torch.where(keep, x / (1.0 - rate), 0.0)


class _Block(nn.Module):
    """What the two layer kinds share: the norms, the MLP and dropout."""

    def __init__(self, n_norms, embed_dim, ff_dim, dense_dropout_rate,
                 norm_epsilon, pre_norm, dtype, param_dtype,
                 gelu_approximate, norm_stats_dtype, device):
        super().__init__()
        self.pre_norm = pre_norm
        self.gelu_approximate = gelu_approximate
        self.dense_dropout_rate = dense_dropout_rate
        for i in range(1, n_norms + 1):
            setattr(self, f"norm{i}",
                    _make_norm(embed_dim, norm_epsilon, dtype, param_dtype,
                               norm_stats_dtype, device))
        dense = dict(dtype=dtype, param_dtype=param_dtype,
                     kernel_init=initializers.glorot_uniform, device=device)
        self.dense1 = QuantDense(embed_dim, ff_dim, **dense)
        self.dense2 = QuantDense(ff_dim, embed_dim, **dense)

    def _drop(self, x, deterministic, generator):
        return _dropout(x, self.dense_dropout_rate, deterministic, generator)

    def _mlp(self, x, deterministic, generator):
        x = self.dense2(gelu(self.dense1(x),
                             approximate=self.gelu_approximate))
        return self._drop(x, deterministic, generator)


class EncoderLayer(_Block):
    def __init__(self, embed_dim=512, num_heads=8, ff_dim=2048,
                 attention_dropout_rate=0.1, dense_dropout_rate=0.1,
                 norm_epsilon=1e-6, pre_norm=False, dtype=None,
                 param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, gelu_approximate=False,
                 norm_stats_dtype=None, device=None):
        device = resolve_device(device)
        super().__init__(2, embed_dim, ff_dim, dense_dropout_rate,
                         norm_epsilon, pre_norm, dtype, param_dtype,
                         gelu_approximate, norm_stats_dtype, device)
        self.multi_head_attention = MultiHeadAttention(
            embed_dim, head_dim=embed_dim // num_heads, num_heads=num_heads,
            dtype=dtype, param_dtype=param_dtype,
            attention_impl=attention_impl, score_dtype=score_dtype,
            dropout_rate=attention_dropout_rate, device=device)

    def forward(self, x, mask=None, deterministic=None, generator=None):
        if deterministic is None:
            deterministic = not self.training
        rng = (deterministic, generator)
        if self.pre_norm:
            x = x + self._self_attn(self.norm1(x), mask, *rng)
            return x + self._mlp(self.norm2(x), *rng)
        x = self.norm1(x + self._self_attn(x, mask, *rng))
        return self.norm2(x + self._mlp(x, *rng))

    def _self_attn(self, q, mask, deterministic, generator):
        attention = self.multi_head_attention(
            [q, q, q], mask=[mask, mask], deterministic=deterministic,
            generator=generator)
        return self._drop(attention, deterministic, generator)


class DecoderLayer(_Block):
    def __init__(self, embed_dim=512, num_heads=8, ff_dim=2048,
                 attention_dropout_rate=0.1, dense_dropout_rate=0.1,
                 norm_epsilon=1e-6, pre_norm=False, causal=True, dtype=None,
                 param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, gelu_approximate=False,
                 norm_stats_dtype=None, device=None):
        device = resolve_device(device)
        super().__init__(3, embed_dim, ff_dim, dense_dropout_rate,
                         norm_epsilon, pre_norm, dtype, param_dtype,
                         gelu_approximate, norm_stats_dtype, device)
        mha = dict(head_dim=embed_dim // num_heads, num_heads=num_heads,
                   dtype=dtype, param_dtype=param_dtype,
                   attention_impl=attention_impl, score_dtype=score_dtype,
                   dropout_rate=attention_dropout_rate, device=device)
        self.multi_head_attention1 = MultiHeadAttention(embed_dim,
                                                        causal=causal, **mha)
        self.multi_head_attention2 = MultiHeadAttention(embed_dim,
                                                        causal=False, **mha)

    def forward(self, inputs, mask=None, deterministic=None, generator=None):
        """``inputs = [x, memory]``; ``mask = [target mask, memory mask]``,
        each ``[b, t]`` bool or None."""
        if deterministic is None:
            deterministic = not self.training
        x, x_enc = inputs
        q_mask, v_mask = mask if mask is not None else (None, None)
        rng = (deterministic, generator)
        if self.pre_norm:
            x = x + self._self_attn(self.norm1(x), q_mask, *rng)
            # quirk kept for parity: the memory goes through the same norm2
            # as the query
            x = x + self._cross_attn(self.norm2(x), self.norm2(x_enc),
                                     q_mask, v_mask, *rng)
            return x + self._mlp(self.norm3(x), *rng)
        x = self.norm1(x + self._self_attn(x, q_mask, *rng))
        x = self.norm2(x + self._cross_attn(x, x_enc, q_mask, v_mask, *rng))
        return self.norm3(x + self._mlp(x, *rng))

    def _self_attn(self, q, mask, deterministic, generator):
        attention = self.multi_head_attention1(
            [q, q, q], mask=[mask, mask], deterministic=deterministic,
            generator=generator)
        return self._drop(attention, deterministic, generator)

    def _cross_attn(self, q, v, q_mask, v_mask, deterministic, generator):
        attention = self.multi_head_attention2(
            [q, v, v], mask=[q_mask, v_mask], deterministic=deterministic,
            generator=generator)
        return self._drop(attention, deterministic, generator)


class _Stack(nn.Module):
    """``layers.<i>`` and the optional output norm ``norm_layer``."""

    def __init__(self, layer_cls, num_layers, norm_output, moe_every_n,
                 layer_kwargs):
        super().__init__()
        if moe_every_n:
            raise NotImplementedError(
                "mixture-of-experts layers are not ported yet; they come in "
                "a later slice.")
        device = resolve_device(layer_kwargs["device"])
        layer_kwargs = dict(layer_kwargs, device=device)
        self.layers = nn.ModuleList(layer_cls(**layer_kwargs)
                                    for _ in range(num_layers))
        self.norm_layer = (
            _make_norm(layer_kwargs["embed_dim"],
                       layer_kwargs["norm_epsilon"], layer_kwargs["dtype"],
                       layer_kwargs["param_dtype"],
                       layer_kwargs["norm_stats_dtype"], device)
            if norm_output else None)


class Encoder(_Stack):
    def __init__(self, embed_dim, num_heads, ff_dim, num_layers,
                 attention_dropout_rate=0.1, dense_dropout_rate=0.1,
                 norm_epsilon=1e-6, pre_norm=False, norm_output=False,
                 dtype=None, param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, gelu_approximate=False,
                 norm_stats_dtype=None, moe_every_n=0, device=None):
        super().__init__(EncoderLayer, num_layers, norm_output, moe_every_n,
                         dict(embed_dim=embed_dim, num_heads=num_heads,
                              ff_dim=ff_dim,
                              attention_dropout_rate=attention_dropout_rate,
                              dense_dropout_rate=dense_dropout_rate,
                              norm_epsilon=norm_epsilon, pre_norm=pre_norm,
                              dtype=dtype, param_dtype=param_dtype,
                              attention_impl=attention_impl,
                              score_dtype=score_dtype,
                              gelu_approximate=gelu_approximate,
                              norm_stats_dtype=norm_stats_dtype,
                              device=device))

    def forward(self, x, mask=None, deterministic=None, generator=None):
        for layer in self.layers:
            x = layer(x, mask=mask, deterministic=deterministic,
                      generator=generator)
        if self.norm_layer is not None:
            x = self.norm_layer(x)
        return x


class Decoder(_Stack):
    def __init__(self, embed_dim, num_heads, ff_dim, num_layers,
                 attention_dropout_rate=0.1, dense_dropout_rate=0.1,
                 norm_epsilon=1e-6, pre_norm=False, norm_output=False,
                 causal=True, return_sequence=False, dtype=None,
                 param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, gelu_approximate=False,
                 norm_stats_dtype=None, moe_every_n=0, device=None):
        super().__init__(DecoderLayer, num_layers, norm_output, moe_every_n,
                         dict(embed_dim=embed_dim, num_heads=num_heads,
                              ff_dim=ff_dim,
                              attention_dropout_rate=attention_dropout_rate,
                              dense_dropout_rate=dense_dropout_rate,
                              norm_epsilon=norm_epsilon, pre_norm=pre_norm,
                              causal=causal, dtype=dtype,
                              param_dtype=param_dtype,
                              attention_impl=attention_impl,
                              score_dtype=score_dtype,
                              gelu_approximate=gelu_approximate,
                              norm_stats_dtype=norm_stats_dtype,
                              device=device))
        self.return_sequence = return_sequence

    def forward(self, inputs, mask=None, deterministic=None, generator=None):
        """``inputs = [x, memory]`` -> ``[b, t, d]``, or every layer's
        output ``[b, n_layers, t, d]`` with ``return_sequence``."""
        x, x_encoder = inputs
        sequence = []
        for layer in self.layers:
            x = layer([x, x_encoder], mask=mask, deterministic=deterministic,
                      generator=generator)
            sequence.append(x)
        if self.return_sequence:
            if self.norm_layer is not None:
                sequence = [self.norm_layer(h) for h in sequence]
            return torch.stack(sequence, dim=1)
        if self.norm_layer is not None:
            x = self.norm_layer(x)
        return x
