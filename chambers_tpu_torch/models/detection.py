"""DETR, the detection transformer (port of
``chambers_tpu/models/detection.py``: ``DETR`` and ``build_detr``).

A stride-``p`` VALID patch convolution as the backbone -> DETR's 2D
sinusoidal positions -> post-norm ``Encoder`` -> ``Decoder`` over learned
object queries (not causal, with an output norm) -> class and box heads.
Trained with :class:`chambers_tpu_torch.losses.detection.DETRLoss`.

The forward takes NHWC images, as the JAX module does, and returns
``{"logits": [b, (L,) q, classes + 1], "boxes": [b, (L,) q, 4]}``, both
float32; the layer axis ``L`` (every decoder layer's normed output) is
there with ``aux_loss=True``. Boxes are ``sigmoid`` of the float32 cast,
in normalized ``(cx, cy, w, h)``.

Attention is dense (``attention_impl="xla"``), as in the JAX module: the
head size is 32 at DETR's width. Parameter names are the JAX package's,
with Flax's ``bbox_head_<i>`` as ``bbox_head.<i>``, so
``convert.state_dict_from_jax`` of the JAX tree loads as it is. Dropout
follows the forward's ``deterministic`` (``None`` reads ``not
self.training``; the JAX module defaults to ``True``).
"""

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.layers.embedding import PositionalEncoding2D
from chambers_tpu_torch.layers.transformer import Decoder, Encoder
from chambers_tpu_torch.models.backbones.vision_transformer import (
    PatchEmbedding,
)
from chambers_tpu_torch.quantization import QuantDense


class DETR(nn.Module):
    """DETR over ``[b, H, W, c]`` images (a patch convolution as the
    backbone)."""

    def __init__(self, num_classes, num_queries=100, embed_dim=256,
                 num_heads=8, ff_dim=2048, num_encoder_layers=6,
                 num_decoder_layers=6, dropout_rate=0.1, patch_size=16,
                 aux_loss=True, in_channels=3, dtype=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.dtype = dtype
        self.backbone = PatchEmbedding(patch_size, in_channels, embed_dim,
                                       dtype, device=device)
        self.pos_encoding = PositionalEncoding2D(add_to_input=True)
        stack = dict(embed_dim=embed_dim, num_heads=num_heads, ff_dim=ff_dim,
                     attention_dropout_rate=dropout_rate,
                     dense_dropout_rate=dropout_rate, pre_norm=False,
                     dtype=dtype, device=device)
        self.encoder = Encoder(num_layers=num_encoder_layers, **stack)
        self.decoder = Decoder(num_layers=num_decoder_layers, causal=False,
                               norm_output=True, return_sequence=aux_loss,
                               **stack)
        self.query_embed = initializers.new_param(
            (num_queries, embed_dim), torch.float32, device)
        head = dict(dtype=dtype, device=device)
        self.class_head = QuantDense(embed_dim, num_classes + 1, **head)
        self.bbox_head = nn.ModuleList([
            QuantDense(embed_dim, embed_dim, **head),
            QuantDense(embed_dim, embed_dim, **head),
            QuantDense(embed_dim, 4, **head),
        ])

    def reset_parameters(self, generator=None):
        """``query_embed`` from ``normal(1.0)``; the submodules init their
        own."""
        with torch.no_grad():
            self.query_embed.normal_(0.0, 1.0, generator=generator)

    def forward(self, images, deterministic=None, generator=None):
        if deterministic is None:
            deterministic = not self.training
        x = images
        if self.dtype is not None:
            x = x.to(self.dtype)
        b, p = x.shape[0], self.patch_size
        gh, gw = x.shape[1] // p, x.shape[2] // p
        feats = self.backbone(x).reshape(b, gh, gw, self.embed_dim)
        tokens = self.pos_encoding(feats).reshape(b, gh * gw, self.embed_dim)
        rng = dict(deterministic=deterministic, generator=generator)
        memory = self.encoder(tokens, **rng)
        queries = self.query_embed.to(memory.dtype)[None].expand(
            b, *self.query_embed.shape)
        hs = self.decoder([queries, memory], **rng)  # [b, (L,) q, d]
        logits = self.class_head(hs).to(torch.float32)
        boxes = hs
        for i, dense in enumerate(self.bbox_head):
            boxes = dense(boxes)
            if i < len(self.bbox_head) - 1:
                boxes = torch.relu(boxes)
        boxes = torch.sigmoid(boxes.to(torch.float32))
        return {"logits": logits, "boxes": boxes}


def build_detr(num_classes, input_shape=(224, 224, 3), num_queries=100,
               embed_dim=256, num_heads=8, ff_dim=2048,
               num_encoder_layers=6, num_decoder_layers=6, aux_loss=True,
               dtype=None, seed=0, device=None):
    """Build, seed-initialise and return DETR in eval mode (an
    ``nn.Module``; the JAX function returns a ``Model``)."""
    device = resolve_device(device)
    model = DETR(num_classes=num_classes, num_queries=num_queries,
                 embed_dim=embed_dim, num_heads=num_heads, ff_dim=ff_dim,
                 num_encoder_layers=num_encoder_layers,
                 num_decoder_layers=num_decoder_layers, aux_loss=aux_loss,
                 in_channels=input_shape[-1], dtype=dtype, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return initializers.init_module(model, generator).eval()
