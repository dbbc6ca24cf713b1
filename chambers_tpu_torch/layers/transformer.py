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
self.training``) and draws from ``generator``.

Incremental decoding: ``Decoder.init_cache(memory, max_len)`` makes one
dict per layer, ``{"multi_head_attention1": <self-attention cache>,
"multi_head_attention2": <cross-attention cache>}`` (see
``layers/attention.py``), and a call with ``cache=`` and ``index=`` runs
one target position through every layer, writing into the caches in place.

Routing (``layers/moe.py``): with ``moe_every_n = n > 0`` every n-th layer
of a stack, ``(i + 1) % n == 0``, is a ``MoEEncoderLayer`` or
``MoEDecoderLayer`` whose MLP is a ``MoEMLP`` (submodule ``moe``, still
``layers.<i>``); the ``moe_*`` arguments set its router. A routed decoder
has no cached decode step: its layers contest expert capacity across the
target positions, so generation recomputes the whole buffer instead.

``remat=True`` recomputes each layer's activations during backward
(``torch.utils.checkpoint``, non-reentrant) while gradients are enabled.
The recompute replays the dropout masks: it restores the explicit
``generator``'s state of the forward and afterwards puts back the state it
found, so later draws do not repeat.
"""

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.activations import gelu
from chambers_tpu_torch.layers.attention import MultiHeadAttention, keep_mask
from chambers_tpu_torch.layers.normalization import FastLayerNorm, LayerNorm
from chambers_tpu_torch.quantization import QuantDense


def _make_norm(dim, epsilon, dtype, param_dtype, stats_dtype, device):
    """float32-statistics LayerNorm (the parity default), or FastLayerNorm
    with statistics in ``stats_dtype``; the same parameters either way."""
    if stats_dtype is None:
        return LayerNorm(dim, epsilon, dtype, param_dtype, device)
    return FastLayerNorm(dim, epsilon, dtype, param_dtype, stats_dtype,
                         device)


def _dropout(x, rate, deterministic, generator, batch_group=None):
    """Inverted dropout as ``flax.linen.Dropout``: keep with probability
    ``1 - rate`` and scale the kept values by ``1 / (1 - rate)``. With a
    ``generator`` and a ``batch_group`` (the caller's ``_batch_group``: its
    batch is this rank's rows of one sharded over that group) each rank
    draws the whole batch's mask and keeps its rows."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        return F.dropout(x, rate, training=True)
    keep = keep_mask(x.shape, rate, generator, x.device,
                     ((0, batch_group),))
    return torch.where(keep, x / (1.0 - rate), 0.0)


class _Block(nn.Module):
    """What the two layer kinds share: the norms, the MLP (``dense1`` and
    ``dense2``, or with ``moe`` the router's arguments, a ``MoEMLP``
    named ``moe``) and dropout.

    On a mesh (``parallel.sharding``) whose rules shard ``dense1``'s
    columns and ``dense2``'s rows over one axis, the MLP runs on this
    rank's slice of the hidden units: ``_tp_group`` is that axis's group,
    which the input's gradient is summed over, and ``dense2`` sums the
    partial products. ``_batch_group`` is as ``MultiHeadAttention``'s, for
    the dense dropout."""

    _tp_group = None
    _batch_group = None

    def __init__(self, n_norms, embed_dim, ff_dim, dense_dropout_rate,
                 norm_epsilon, pre_norm, dtype, param_dtype,
                 gelu_approximate, norm_stats_dtype, device, moe):
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
        if moe is None:
            self.moe = None
            self.dense1 = QuantDense(embed_dim, ff_dim, **dense)
            self.dense2 = QuantDense(ff_dim, embed_dim, **dense)
        else:
            from chambers_tpu_torch.layers.moe import MoEMLP

            self.moe = MoEMLP(embed_dim, ff_dim,
                              gelu_approximate=gelu_approximate, **moe,
                              **dense)

    def _drop(self, x, deterministic, generator):
        return _dropout(x, self.dense_dropout_rate, deterministic, generator,
                        self._batch_group)

    def _mlp(self, x, deterministic, generator):
        if self.moe is not None:
            x = self.moe(x)
        else:
            if self._tp_group is not None:
                from chambers_tpu_torch.parallel.distributed import (
                    reduce_backward,
                )

                x = reduce_backward(x, self._tp_group)
            x = self.dense2(gelu(self.dense1(x),
                                 approximate=self.gelu_approximate))
        return self._drop(x, deterministic, generator)


class EncoderLayer(_Block):
    def __init__(self, embed_dim=512, num_heads=8, ff_dim=2048,
                 attention_dropout_rate=0.1, dense_dropout_rate=0.1,
                 norm_epsilon=1e-6, pre_norm=False, dtype=None,
                 param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, gelu_approximate=False,
                 norm_stats_dtype=None, device=None, moe=None):
        device = resolve_device(device)
        super().__init__(2, embed_dim, ff_dim, dense_dropout_rate,
                         norm_epsilon, pre_norm, dtype, param_dtype,
                         gelu_approximate, norm_stats_dtype, device, moe)
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
                 norm_stats_dtype=None, device=None, moe=None):
        device = resolve_device(device)
        super().__init__(3, embed_dim, ff_dim, dense_dropout_rate,
                         norm_epsilon, pre_norm, dtype, param_dtype,
                         gelu_approximate, norm_stats_dtype, device, moe)
        mha = dict(head_dim=embed_dim // num_heads, num_heads=num_heads,
                   dtype=dtype, param_dtype=param_dtype,
                   attention_impl=attention_impl, score_dtype=score_dtype,
                   dropout_rate=attention_dropout_rate, device=device)
        self.multi_head_attention1 = MultiHeadAttention(embed_dim,
                                                        causal=causal, **mha)
        self.multi_head_attention2 = MultiHeadAttention(embed_dim,
                                                        causal=False, **mha)

    def init_cache(self, memory, max_len):
        """This layer's decode cache for ``[b, max_len]`` targets over
        ``memory`` ``[b, t, d]``: an empty self-attention buffer and the
        memory's keys and values (after ``norm2`` in the pre-norm order,
        the quirk below)."""
        if self.pre_norm:
            memory = self.norm2(memory)
        return {
            "multi_head_attention1": self.multi_head_attention1
            .init_self_cache(memory.shape[0], max_len, memory.dtype,
                             memory.device),
            "multi_head_attention2": self.multi_head_attention2
            .init_cross_cache(memory)}

    def forward(self, inputs, mask=None, deterministic=None, generator=None,
                cache=None, index=None):
        """``inputs = [x, memory]``; ``mask = [target mask, memory mask]``,
        each ``[b, t]`` bool or None. With a ``cache`` (:meth:`init_cache`)
        ``x`` is the one target position ``index``; the memory is then read
        from the cache."""
        if deterministic is None:
            deterministic = not self.training
        x, x_enc = inputs
        q_mask, v_mask = mask if mask is not None else (None, None)
        rng = (deterministic, generator)
        caches = (None, None) if cache is None else (
            cache["multi_head_attention1"], cache["multi_head_attention2"])
        if self.pre_norm:
            x = x + self._self_attn(self.norm1(x), q_mask, *rng, caches[0],
                                    index)
            # quirk kept for parity: the memory goes through the same norm2
            # as the query
            memory = x_enc if cache is not None else self.norm2(x_enc)
            x = x + self._cross_attn(self.norm2(x), memory, q_mask, v_mask,
                                     *rng, caches[1])
            return x + self._mlp(self.norm3(x), *rng)
        x = self.norm1(x + self._self_attn(x, q_mask, *rng, caches[0],
                                           index))
        x = self.norm2(x + self._cross_attn(x, x_enc, q_mask, v_mask, *rng,
                                            caches[1]))
        return self.norm3(x + self._mlp(x, *rng))

    def _self_attn(self, q, mask, deterministic, generator, cache=None,
                   index=None):
        attention = self.multi_head_attention1(
            [q, q, q], mask=[mask, mask], deterministic=deterministic,
            generator=generator, cache=cache, index=index)
        return self._drop(attention, deterministic, generator)

    def _cross_attn(self, q, v, q_mask, v_mask, deterministic, generator,
                    cache=None):
        attention = self.multi_head_attention2(
            [q, v, v], mask=[q_mask, v_mask], deterministic=deterministic,
            generator=generator, cache=cache)
        return self._drop(attention, deterministic, generator)


def _remat(fn, generator, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant). The
    recompute runs with the explicit ``generator`` in the state the forward
    found it in, so it draws the same dropout masks, and then puts back the
    state that it found. (``checkpoint`` itself replays only the global
    generators.)"""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False)
    start, calls = generator.get_state(), []

    def run(*a):
        if not calls:
            calls.append(1)
            return fn(*a)
        found = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*a)
        finally:
            generator.set_state(found)

    return checkpoint(run, *args, use_reentrant=False)


class _Stack(nn.Module):
    """``layers.<i>`` (every ``moe_every_n``-th one routed) and the
    optional output norm ``norm_layer``."""

    def __init__(self, layer_cls, moe_cls, num_layers, norm_output, remat,
                 moe_every_n, routing, layer_kwargs):
        super().__init__()
        device = resolve_device(layer_kwargs["device"])
        layer_kwargs = dict(layer_kwargs, device=device)
        self.remat = remat
        self.moe_every_n = moe_every_n
        self.layers = nn.ModuleList(
            moe_cls(**routing, **layer_kwargs)
            if moe_every_n > 0 and (i + 1) % moe_every_n == 0
            else layer_cls(**layer_kwargs) for i in range(num_layers))
        self.norm_layer = (
            _make_norm(layer_kwargs["embed_dim"],
                       layer_kwargs["norm_epsilon"], layer_kwargs["dtype"],
                       layer_kwargs["param_dtype"],
                       layer_kwargs["norm_stats_dtype"], device)
            if norm_output else None)

    def _remat_on(self):
        return self.remat and torch.is_grad_enabled()


def _routing(n_experts, capacity_factor, router_z_loss_weight,
             n_selected_experts, group_size):
    """A routed layer's ``moe`` argument: its ``MoEMLP``'s router."""
    return dict(n_experts=n_experts, capacity_factor=capacity_factor,
                router_z_loss_weight=router_z_loss_weight,
                n_selected_experts=n_selected_experts, group_size=group_size)


class Encoder(_Stack):
    def __init__(self, embed_dim, num_heads, ff_dim, num_layers,
                 attention_dropout_rate=0.1, dense_dropout_rate=0.1,
                 norm_epsilon=1e-6, pre_norm=False, norm_output=False,
                 dtype=None, param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, gelu_approximate=False,
                 norm_stats_dtype=None, moe_every_n=0, moe_n_experts=8,
                 moe_capacity_factor=1.25, moe_router_z_loss_weight=0.0,
                 moe_n_selected_experts=1, moe_group_size=None, remat=False,
                 device=None):
        from chambers_tpu_torch.layers.moe import MoEEncoderLayer

        super().__init__(EncoderLayer, MoEEncoderLayer, num_layers,
                         norm_output, remat, moe_every_n,
                         _routing(moe_n_experts, moe_capacity_factor,
                                  moe_router_z_loss_weight,
                                  moe_n_selected_experts, moe_group_size),
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
            def run(x, layer=layer):
                return layer(x, mask=mask, deterministic=deterministic,
                             generator=generator)

            x = _remat(run, generator, x) if self._remat_on() else run(x)
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
                 norm_stats_dtype=None, moe_every_n=0, moe_n_experts=8,
                 moe_capacity_factor=1.25, moe_router_z_loss_weight=0.0,
                 moe_n_selected_experts=1, moe_group_size=None, remat=False,
                 device=None):
        from chambers_tpu_torch.layers.moe import MoEDecoderLayer

        super().__init__(DecoderLayer, MoEDecoderLayer, num_layers,
                         norm_output, remat, moe_every_n,
                         _routing(moe_n_experts, moe_capacity_factor,
                                  moe_router_z_loss_weight,
                                  moe_n_selected_experts, moe_group_size),
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

    def init_cache(self, memory, max_len):
        """The decode cache of every layer (``DecoderLayer.init_cache``)."""
        return [layer.init_cache(memory, max_len) for layer in self.layers]

    def forward(self, inputs, mask=None, deterministic=None, generator=None,
                cache=None, index=None):
        """``inputs = [x, memory]`` -> ``[b, t, d]``, or every layer's
        output ``[b, n_layers, t, d]`` with ``return_sequence``. With a
        ``cache`` (:meth:`init_cache`) ``x`` is the one target position
        ``index``."""
        x, x_encoder = inputs
        if cache is not None and self.moe_every_n > 0:
            raise NotImplementedError(
                "a cached decode step is not supported on a routed decoder "
                f"(moe_every_n={self.moe_every_n}): routed layers contest "
                "expert capacity across target positions; decode with full "
                "recompute (use_cache=False).")
        sequence = []
        for i, layer in enumerate(self.layers):
            def run(x, x_encoder, layer=layer, i=i):
                return layer([x, x_encoder], mask=mask,
                             deterministic=deterministic, generator=generator,
                             cache=None if cache is None else cache[i],
                             index=index)

            x = (_remat(run, generator, x, x_encoder)
                 if cache is None and self._remat_on()
                 else run(x, x_encoder))
            sequence.append(x)
        if self.return_sequence:
            if self.norm_layer is not None:
                sequence = [self.norm_layer(h) for h in sequence]
            return torch.stack(sequence, dim=1)
        if self.norm_layer is not None:
            x = self.norm_layer(x)
        return x
