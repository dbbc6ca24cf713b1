"""Vision Transformer backbone (port of
``chambers_tpu/models/backbones/vision_transformer.py``: ``VisionTransformer``,
``_pool``, the ViT presets and ``fold_imagenet_normalization``).

Architecture: patch embedding (kernel = stride = patch size) -> CLS token
-> learned position embedding -> pre-norm ``Encoder`` with output norm ->
pooling -> optional tanh ``feature`` head -> ``predictions`` head; logits
come out in float32. The forward takes a ``[b, H, W, 3]`` uint8 or float
batch, as the JAX module does.

The patch embedding is written as a reshape to patches and one matmul
against the JAX package's ``[p, p, c, d]`` conv kernel — the same function
as the stride-``p`` VALID convolution, and it keeps cuDNN's default TF32
convolution out of a float32 comparison.

Presets build from the port's own seeded init (``weights=None``); the JAX
package's weights convert with ``convert.state_dict_from_jax``. Released
``.h5`` checkpoints, DeiT and dropout (training) come in later slices.
"""

from typing import Optional

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.layers.embedding import (
    ConcatEmbedding,
    LearnedEmbedding1D,
)
from chambers_tpu_torch.layers.transformer import Encoder
from chambers_tpu_torch.quantization import QuantDense, promote_dtype

# 'tf'-mode ImageNet normalization, x / 127.5 - 1, and the other two modes
# of ImageNetNormalization (chambers_tpu/augmentations/image_augmentations.py)
_CAFFE_MEAN = (103.939, 116.779, 123.68)
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


class PatchEmbedding(nn.Module):
    """Stride-``p`` VALID patch convolution with a flax-layout ``kernel``
    ``[p, p, c, d]`` and ``bias`` ``[d]``, as patches @ kernel."""

    def __init__(self, patch_size, in_channels, dim, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        p = patch_size
        self.patch_size = p
        self.dtype = dtype
        self.kernel = initializers.new_param((p, p, in_channels, dim),
                                             param_dtype, device)
        self.bias = initializers.new_param((dim,), param_dtype, device)

    def reset_parameters(self, generator=None):
        initializers.lecun_normal(self.kernel, generator)
        initializers.zeros(self.bias)

    def forward(self, x):
        """``[b, H, W, c]`` -> ``[b, (H/p)*(W/p), d]``."""
        b, hh, ww, c = x.shape
        p = self.patch_size
        gh, gw = hh // p, ww // p
        dtype = promote_dtype(x, self.kernel, self.bias, dtype=self.dtype)
        x = x[:, :gh * p, :gw * p].to(dtype)
        patches = (x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
                   .reshape(b, gh * gw, p * p * c))
        kernel = self.kernel.to(dtype).reshape(p * p * c, -1)
        return torch.matmul(patches, kernel) + self.bias.to(dtype)


def _pool(x, method: Optional[str]):
    """``avg``/``max``/``sum`` over the patch tokens (CLS cropped off),
    ``cls`` the first token, ``None`` the whole sequence."""
    if method == "avg":
        return x[:, 1:].mean(dim=1)
    if method == "max":
        return x[:, 1:].amax(dim=1)
    if method == "sum":
        return x[:, 1:].sum(dim=1)
    if method == "cls":
        return x[:, 0]
    return x


class VisionTransformer(nn.Module):
    """ViT over ``[batch, H, W, 3]`` images of size ``image_size``."""

    def __init__(self, patch_size, patch_dim, n_encoder_layers, n_heads,
                 ff_dim, image_size=(224, 224), include_top=True,
                 pooling="cls", feature_dim=None, classes=1000,
                 classifier_activation=None, dtype=None,
                 param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, gelu_approximate=False,
                 norm_stats_dtype=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.pooling = pooling
        self.include_top = include_top
        self.classifier_activation = classifier_activation
        self.dtype = dtype
        n_tokens = (image_size[0] // patch_size) * (image_size[1] // patch_size)
        self.patch_embeddings = PatchEmbedding(
            patch_size, 3, patch_dim, dtype, param_dtype, device)
        self.add_cls_token = ConcatEmbedding(
            1, patch_dim, axis=1, side="left", param_dtype=param_dtype,
            device=device)
        self.pos_embedding = LearnedEmbedding1D(
            n_tokens + 1, patch_dim, param_dtype=param_dtype, device=device)
        # the ViT's training dropout is not ported yet: its encoder is
        # built without any, so a model left in train mode computes the same
        self.encoder = Encoder(
            patch_dim, n_heads, ff_dim, n_encoder_layers,
            attention_dropout_rate=0.0, dense_dropout_rate=0.0, pre_norm=True,
            norm_output=True, dtype=dtype, param_dtype=param_dtype,
            attention_impl=attention_impl, score_dtype=score_dtype,
            gelu_approximate=gelu_approximate,
            norm_stats_dtype=norm_stats_dtype, device=device)
        head = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.feature = (QuantDense(patch_dim, feature_dim, **head)
                        if feature_dim is not None else None)
        if include_top:
            self.predictions = QuantDense(feature_dim or patch_dim, classes,
                                          **head)

    def embed(self, x):
        """images -> encoder token sequence ``[b, 1 + hw/p², d]``."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.patch_embeddings(x)
        x = self.add_cls_token(x)
        x = self.pos_embedding(x)
        return self.encoder(x)

    def forward(self, x):
        x = _pool(self.embed(x), self.pooling)
        if self.feature is not None:
            x = torch.tanh(self.feature(x))
        if self.include_top:
            x = self.predictions(x)
            if self.classifier_activation is not None:
                x = self.classifier_activation(x)
        return x.to(torch.float32)


def _vit_preset(model_name, patch_size, patch_dim, n_layers, n_heads, ff_dim):
    def preset(input_shape=None, include_top=True, weights=None,
               pooling="cls", feature_dim=None, classes=1000,
               classifier_activation=None, dtype=None, attention_impl="xla",
               score_dtype=None, gelu_approximate=False,
               norm_stats_dtype=None, seed: int = 0, device=None):
        """Build, seed-initialise and return the model in eval mode."""
        if weights is not None:
            raise NotImplementedError(
                "pretrained ViT weights are not ported yet (the .h5 import "
                "comes in a later slice); use weights=None, or load a "
                "state_dict converted with state_dict_from_jax.")
        device = resolve_device(device)
        input_shape = input_shape or (224, 224, 3)
        model = VisionTransformer(
            patch_size, patch_dim, n_layers, n_heads, ff_dim,
            image_size=tuple(input_shape[:2]), include_top=include_top,
            pooling=pooling, feature_dim=feature_dim, classes=classes,
            classifier_activation=classifier_activation, dtype=dtype,
            attention_impl=attention_impl, score_dtype=score_dtype,
            gelu_approximate=gelu_approximate,
            norm_stats_dtype=norm_stats_dtype, device=device)
        generator = torch.Generator(device=device).manual_seed(seed)
        return initializers.init_module(model, generator).eval()

    preset.__name__ = model_name
    return preset


ViTS16 = _vit_preset("vits16", 16, 384, 12, 6, 1536)
ViTB16 = _vit_preset("vitb16", 16, 768, 12, 12, 3072)
ViTB32 = _vit_preset("vitb32", 32, 768, 12, 12, 3072)
ViTL16 = _vit_preset("vitl16", 16, 1024, 24, 16, 4096)
ViTL32 = _vit_preset("vitl32", 32, 1024, 24, 16, 4096)


def fold_imagenet_normalization(state_dict, mode: str = "tf"):
    """Fold ImageNet input normalization into the patch embedding.

    Each mode is a per-channel affine map ``y_c = s_c * x_c + o_c`` (caffe
    also flips RGB -> BGR), and the patch embedding sees exactly one whole
    kernel footprint per output, so the map folds exactly::

        kernel'[kh, kw, c, d] = kernel[kh, kw, c, d] * s_c    (caffe: +flip)
        bias'[d]              = bias[d] + sum_khkwc kernel * o_c

    and the model then takes raw [0, 255] pixels. Folded in float32 and cast
    back to the parameters' dtype.

    :param state_dict: a ViT ``state_dict`` with ``patch_embeddings.kernel``
        ``[kh, kw, 3, d]`` and ``patch_embeddings.bias``.
    :return: a new ``state_dict``; the input is not changed.
    """
    if mode == "tf":
        scale = torch.full((3,), 1.0 / 127.5)
        offset = torch.full((3,), -1.0)
        flip = False
    elif mode == "torch":
        mean = torch.tensor(_TORCH_MEAN)
        std = torch.tensor(_TORCH_STD)
        scale = 1.0 / (255.0 * std)
        offset = -mean / std
        flip = False
    elif mode == "caffe":
        scale = torch.ones(3)
        offset = -torch.tensor(_CAFFE_MEAN)
        flip = True
    else:
        raise ValueError("Unknown mode " + str(mode))
    if "patch_embeddings.kernel" not in state_dict:
        raise ValueError("state_dict has no 'patch_embeddings.kernel': "
                         "fold_imagenet_normalization applies to ViT patch "
                         "embeddings only")
    k0 = state_dict["patch_embeddings.kernel"]
    b0 = state_dict["patch_embeddings.bias"]
    if k0.ndim != 4 or k0.shape[2] != 3:
        raise ValueError(f"expected a [kh, kw, 3, d] patch-embed kernel, got "
                         f"{tuple(k0.shape)}")
    kernel = k0.to(torch.float32)
    scale, offset = scale.to(kernel.device), offset.to(kernel.device)
    new_bias = b0.to(torch.float32) + torch.einsum("hwcd,c->d", kernel,
                                                   offset)
    if flip:
        kernel = kernel.flip(2)
        scale = scale.flip(0)
    out = dict(state_dict)
    out["patch_embeddings.kernel"] = (kernel * scale[None, None, :, None]
                                      ).to(k0.dtype)
    out["patch_embeddings.bias"] = new_bias.to(b0.dtype)
    return out
