"""Token-level sequence-to-sequence transformer (port of
``chambers_tpu/models/transformer.py``: ``Seq2SeqTransformer`` with
``encode``, ``decode`` and the full forward).

Token embeddings on both sides (id 0 is padding and makes the masks), the
sinusoidal positional encoding at the standard temperature, a post-norm
``Encoder``, a causal post-norm ``Decoder`` with cross attention, and a
dense vocabulary head. Submodule and parameter names are the JAX
package's: ``inputs_embed.embedding``, ``targets_embed.embedding``,
``encoder``, ``decoder``, ``vocab_head``.

With ``attention_impl="flash"`` every attention runs the blockwise CUDA
kernels with the padding masks applied in the kernel
(``chambers_tpu_torch.ops.flash_attention``), which have no attention
dropout: build with ``dropout_rate=0.0`` to train on them (a call with
attention dropout active raises).

``moe_every_n > 0`` routes every n-th layer of BOTH stacks through a
mixture-of-experts MLP (the GShard setting, ``layers/moe.py``); add
``layers.moe.moe_aux_loss(model)`` to the task loss to train the routers.
A routed model has no cached decode step: generation recomputes the whole
target buffer.

Incremental decoding (``models/generation.py``): ``init_cache(x_enc,
max_len)`` primes the per-layer caches for a ``[b, max_len]`` target
buffer, and ``decode_step`` runs one target position through them. The JAX
package primes by running the whole decoder over a zero buffer; the port
allocates the empty self-attention buffers and projects the memory's keys
and values once per layer, which gives the same cache (unwritten slots are
invalid either way).
"""

import torch
from torch import nn
from torch.nn import functional as F

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.layers.embedding import PositionalEncoding1D
from chambers_tpu_torch.layers.transformer import Decoder, Encoder
from chambers_tpu_torch.quantization import QuantDense


class Embed(nn.Module):
    """``flax.linen.Embed``: one parameter ``embedding`` ``[vocab, d]``,
    looked up and cast to ``dtype``."""

    def __init__(self, num_embeddings, features, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = initializers.new_param(
            (num_embeddings, features), param_dtype, resolve_device(device))

    def reset_parameters(self, generator=None):
        # flax's default_embed_init: normal with variance 1 / features
        with torch.no_grad():
            self.embedding.normal_(0.0, self.embedding.shape[1] ** -0.5,
                                   generator=generator)

    def forward(self, tokens):
        table = self.embedding
        if self.dtype is not None:
            table = table.to(self.dtype)
        return F.embedding(tokens, table)


class Seq2SeqTransformer(nn.Module):
    def __init__(self, input_vocab_size, output_vocab_size, embed_dim,
                 num_heads, dim_feedforward, num_encoder_layers,
                 num_decoder_layers, dropout_rate=0.1, dtype=None,
                 attention_impl="xla", score_dtype=None, moe_every_n=0,
                 moe_n_experts=8, moe_capacity_factor=1.25,
                 moe_router_z_loss_weight=0.0, moe_n_selected_experts=1,
                 moe_group_size=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.moe_every_n = moe_every_n
        self.inputs_embed = Embed(input_vocab_size, embed_dim, dtype,
                                  device=device)
        self.targets_embed = Embed(output_vocab_size, embed_dim, dtype,
                                   device=device)
        self.pos_encoding = PositionalEncoding1D()
        stack = dict(embed_dim=embed_dim, num_heads=num_heads,
                     ff_dim=dim_feedforward,
                     attention_dropout_rate=dropout_rate,
                     dense_dropout_rate=dropout_rate, pre_norm=False,
                     moe_every_n=moe_every_n, moe_n_experts=moe_n_experts,
                     moe_capacity_factor=moe_capacity_factor,
                     moe_router_z_loss_weight=moe_router_z_loss_weight,
                     moe_n_selected_experts=moe_n_selected_experts,
                     moe_group_size=moe_group_size, dtype=dtype,
                     attention_impl=attention_impl, score_dtype=score_dtype,
                     device=device)
        self.encoder = Encoder(num_layers=num_encoder_layers, **stack)
        self.decoder = Decoder(num_layers=num_decoder_layers,
                               norm_output=False, causal=True, **stack)
        self.vocab_head = QuantDense(embed_dim, output_vocab_size,
                                     dtype=dtype, device=device)

    def encode(self, tokens, deterministic=None, generator=None):
        """Source side only: ``[b, t_src]`` tokens -> ``(memory, mask)``."""
        input_mask = tokens != 0
        x_enc = self.pos_encoding(self.inputs_embed(tokens))
        x_enc = self.encoder(x_enc, mask=input_mask,
                             deterministic=deterministic,
                             generator=generator)
        return x_enc, input_mask

    def decode(self, targets, x_enc, input_mask, deterministic=None,
               generator=None):
        """Target side given the encoder memory -> vocabulary logits."""
        target_mask = targets != 0
        x_dec = self.pos_encoding(self.targets_embed(targets))
        x_dec = self.decoder([x_dec, x_enc], mask=[target_mask, input_mask],
                             deterministic=deterministic,
                             generator=generator)
        return self.vocab_head(x_dec)

    def init_cache(self, x_enc, max_len):
        """The decode cache for ``[b, max_len]`` targets over the encoder
        memory ``x_enc`` ``[b, t_src, d]``: a list with one dict per decoder
        layer (``Decoder.init_cache``)."""
        return self.decoder.init_cache(x_enc, max_len)

    def decode_step(self, token, index, x_enc, input_mask, max_len, cache):
        """One incremental decode step over a primed cache.

        :param token: ``[b, 1]`` integer tokens fed at target position
            ``index`` (BOS at step 0, then the previous step's token).
        :param index: the target position, a Python int (the number of
            steps already taken).
        :param max_len: length of the target buffer; the positional row is
            cut from the same ``positional_encoding_1d(max_len, d)`` table
            the full-length path uses.
        :returns: ``([b, 1, vocab]`` logits, ``cache)``; the step writes
            into ``cache`` in place.
        """
        target_mask = token != 0
        x = self.targets_embed(token)
        enc = self.pos_encoding.table(max_len, self.embed_dim, x.dtype,
                                      x.device)
        x = x + enc[:, index:index + 1]
        x = self.decoder([x, x_enc], mask=[target_mask, input_mask],
                         deterministic=True, cache=cache, index=index)
        return self.vocab_head(x), cache

    def forward(self, inputs, deterministic=None, generator=None):
        """``inputs = [input_tokens, target_tokens]``, integer ``[b, t]``;
        token id 0 is padding. Returns ``[b, t_tgt, vocab]`` logits."""
        tokens, targets = inputs
        x_enc, input_mask = self.encode(tokens, deterministic, generator)
        return self.decode(targets, x_enc, input_mask, deterministic,
                           generator)
