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
attention dropout active raises). The cached ``decode_step`` comes with
generation, in a later slice, as do the mixture-of-experts options.
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
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.inputs_embed = Embed(input_vocab_size, embed_dim, dtype,
                                  device=device)
        self.targets_embed = Embed(output_vocab_size, embed_dim, dtype,
                                   device=device)
        self.pos_encoding = PositionalEncoding1D()
        stack = dict(embed_dim=embed_dim, num_heads=num_heads,
                     ff_dim=dim_feedforward,
                     attention_dropout_rate=dropout_rate,
                     dense_dropout_rate=dropout_rate, pre_norm=False,
                     moe_every_n=moe_every_n, dtype=dtype,
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

    def forward(self, inputs, deterministic=None, generator=None):
        """``inputs = [input_tokens, target_tokens]``, integer ``[b, t]``;
        token id 0 is padding. Returns ``[b, t_tgt, vocab]`` logits."""
        tokens, targets = inputs
        x_enc, input_mask = self.encode(tokens, deterministic, generator)
        return self.decode(targets, x_enc, input_mask, deterministic,
                           generator)
