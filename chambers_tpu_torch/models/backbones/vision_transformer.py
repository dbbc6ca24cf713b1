"""Vision Transformer and distilled ViT (DeiT) backbones (port of
``chambers_tpu/models/backbones/vision_transformer.py``: ``VisionTransformer``,
``DistilledVisionTransformer``, ``_pool``, the ViT and DeiT presets,
``preprocess_input`` and ``fold_imagenet_normalization``).

Architecture: patch embedding (kernel = stride = patch size) -> CLS token
-> learned position embedding -> pre-norm ``Encoder`` with output norm ->
pooling -> optional tanh ``feature`` head -> ``predictions`` head; logits
come out in float32. The forward takes a ``[b, H, W, 3]`` uint8 or float
batch, as the JAX module does.

The patch embedding is written as a reshape to patches and one matmul
against the JAX package's ``[p, p, c, d]`` conv kernel — the same function
as the stride-``p`` VALID convolution, and it keeps cuDNN's default TF32
convolution out of a float32 comparison.

``dropout_rate`` (0.1 by default, as in the JAX package) drives the
embedding dropout after the position embedding and the encoder's attention
and dense dropout. It is active when the forward's ``deterministic`` is
False (``None`` reads ``not self.training``): a directly built model is in
train mode, so call ``.eval()`` to serve it.

DeiT adds a distillation token, prepended before the CLS token (the
tokens run ``[cls, dist, patches...]``, the position table has two rows
more than the patches) and a second head, ``predictions_dist``, on token 1.
As in the JAX package, ``_pool`` crops only token 0, so DeiT's ``avg``,
``max`` and ``sum`` poolings include the distillation token.

Presets build from the port's own seeded init and return the model in eval
mode. ``weights`` takes a released spec of ``WEIGHTS_HASHES`` (its ``.h5``
file must be in ``weights_cache_dir()``, ``CHAMBERS_TPU_WEIGHTS_DIR``;
nothing is downloaded, a missing file raises ``FileNotFoundError`` naming
it) or the path of a Keras ``.h5`` file, imported with
``h5_import.load_vit_h5_weights``; the default is ``None`` (the JAX
presets default to the released spec). The JAX package's weights convert
with ``convert.state_dict_from_jax``.

``remat=True`` recomputes each encoder layer during backward
(``layers/transformer.py``). ``moe_every_n > 0`` routes every n-th encoder
MLP through a mixture of experts (the V-MoE placement, ``layers/moe.py``;
``moe_aux_loss(model)`` is its training loss term); the presets take
``moe_every_n``, ``moe_n_experts`` and ``moe_capacity_factor`` and refuse
routing together with a ``weights`` file, which holds no experts.
"""

import os
import warnings
from typing import Optional

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.layers.embedding import (
    ConcatEmbedding,
    LearnedEmbedding1D,
)
from chambers_tpu_torch.layers.transformer import Encoder, _dropout
from chambers_tpu_torch.models.backbones.h5_import import (
    import_h5,
    load_vit_h5_weights,
)
from chambers_tpu_torch.quantization import QuantDense, promote_dtype

# 'tf'-mode ImageNet normalization, x / 127.5 - 1, and the other two modes
# of ImageNetNormalization (chambers_tpu/augmentations/image_augmentations.py)
_CAFFE_MEAN = (103.939, 116.779, 123.68)
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)

# Released-weight location (vision_transformer.py:15) and registry of
# released pretrained-weight specs (vision_transformer.py:16-96).
# model_name -> {weights_spec: (top_md5, no_top_md5, file_suffix)}
BASE_WEIGHTS_PATH = "https://github.com/chjort/chambers/releases/download/v1.1/"
WEIGHTS_HASHES = {
    "vits16": {
        "imagenet_224_deit": (
            "6df5bc5734ace3fc83e4a2e826cfe37c",
            "3ddca7413a039e9a8979c1718e33c597",
            "imagenet_1000_224_deit",
        ),
    },
    "vitb16": {
        "imagenet21k": (None, "7600a249df4c5460e16ee8637a104683", "imagenet_21k_224"),
        "imagenet21k+_224": (
            "6c987252c94ae15c34e4b2ef8b69b026",
            "fb29e40486b4dd1b82ac8635555bed65",
            "imagenet_21k_1000_224",
        ),
        "imagenet21k+_384": (
            "f189719ecc305d0ccd9525206f741409",
            "e69336a399b1a334adf72ad237df2c30",
            "imagenet_21k_1000_384",
        ),
        "imagenet_224_deit": (
            "b313ff9ff936ac4639199e8c28cf2ca4",
            "600c2033dc9f53181147596c867f62f6",
            "imagenet_21k_1000_224_deit",
        ),
        "imagenet_384_deit": (
            "134ee39f1a10c276f528b521a4353647",
            "e3a4c07722b7e3a62cbf4b2c137759e3",
            "imagenet_21k_1000_384_deit",
        ),
    },
    "vitb32": {
        "imagenet21k": (None, "14f8c10584cf61786a658723cc8d1b68", "imagenet_21k_224"),
        "imagenet21k+_384": (
            "d4b41bf765992566151f5915cc1b275b",
            "aa8863a833d9e3e592768c5c95d74361",
            "imagenet_21k_1000_384",
        ),
    },
    "vitl16": {
        "imagenet21k": (None, "ad70eb7a7a50daf3c96a790b2f7c38ca", "imagenet_21k_224"),
        "imagenet21k+_224": (
            "c39ee61dfd071a1e1a8994fed58dec35",
            "51dbbcabe79feb81237369909dc14d2e",
            "imagenet_21k_1000_224",
        ),
        "imagenet21k+_384": (
            "451f946387516c835f576dff7b5074f5",
            "a0775f7493bd816fcb0513fb813d180c",
            "imagenet_21k_1000_384",
        ),
    },
    "vitl32": {
        "imagenet21k": (None, "645d669250d87f5d8ba0a2fb1188c510", "imagenet_21k_224"),
        "imagenet21k+_384": (
            "8aacec1f38deaec287b2122ded1bbff4",
            "6aa0e4197259e0a369972221af546cf0",
            "imagenet_21k_1000_384",
        ),
    },
    "deits16": {
        "imagenet_224": (
            "309350442160f3e9bc325a0cdeac49ef",
            "bf207ba3aeb8ec578eb0c5157192f59c",
            "imagenet_1000_224",
        ),
    },
    "deitb16": {
        "imagenet_224": (
            "898b74940e3a61e90b802dae47af4428",
            "2ae45d564218b76fea4aa03cc0db279b",
            "imagenet_1000_224",
        ),
        "imagenet_384": (
            "ca3e7ca40e4b96ead9508ea1e5e35893",
            "1e3be99ad5acc90101f80e94469c815e",
            "imagenet_1000_384",
        ),
    },
}


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
    """ViT over ``[batch, H, W, 3]`` images of size ``image_size``.
    ``_batch_group`` is set under ``parallel.distributed.data_parallel``,
    for the embedding dropout (``layers.transformer._dropout``)."""

    _extra_tokens = 1  # the CLS token
    _batch_group = None

    def __init__(self, patch_size, patch_dim, n_encoder_layers, n_heads,
                 ff_dim, dropout_rate=0.1, image_size=(224, 224),
                 include_top=True, pooling="cls", feature_dim=None,
                 classes=1000, classifier_activation=None, dtype=None,
                 param_dtype=torch.float32, remat=False,
                 attention_impl="xla", score_dtype=None,
                 gelu_approximate=False, norm_stats_dtype=None,
                 moe_every_n=0, moe_n_experts=8, moe_capacity_factor=1.25,
                 moe_router_z_loss_weight=0.0, moe_n_selected_experts=1,
                 moe_group_size=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dropout_rate = dropout_rate
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
            n_tokens + self._extra_tokens, patch_dim,
            param_dtype=param_dtype, device=device)
        self.encoder = Encoder(
            patch_dim, n_heads, ff_dim, n_encoder_layers,
            attention_dropout_rate=dropout_rate,
            dense_dropout_rate=dropout_rate, pre_norm=True,
            norm_output=True, dtype=dtype, param_dtype=param_dtype,
            attention_impl=attention_impl, score_dtype=score_dtype,
            gelu_approximate=gelu_approximate,
            norm_stats_dtype=norm_stats_dtype, moe_every_n=moe_every_n,
            moe_n_experts=moe_n_experts,
            moe_capacity_factor=moe_capacity_factor,
            moe_router_z_loss_weight=moe_router_z_loss_weight,
            moe_n_selected_experts=moe_n_selected_experts,
            moe_group_size=moe_group_size, remat=remat, device=device)
        head = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.feature = (QuantDense(patch_dim, feature_dim, **head)
                        if feature_dim is not None else None)
        if include_top:
            self.predictions = QuantDense(feature_dim or patch_dim, classes,
                                          **head)

    def _prepend_tokens(self, x):
        return self.add_cls_token(x)

    def embed(self, x, deterministic=None, generator=None):
        """images -> encoder token sequence ``[b, 1 + hw/p², d]``."""
        if deterministic is None:
            deterministic = not self.training
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.patch_embeddings(x)
        x = self._prepend_tokens(x)
        x = self.pos_embedding(x)
        x = _dropout(x, self.dropout_rate, deterministic, generator,
                     self._batch_group)
        return self.encoder(x, deterministic=deterministic,
                            generator=generator)

    def forward(self, x, deterministic=None, generator=None):
        """``[b, H, W, 3]`` images -> float32 logits (or features). Dropout
        is active unless ``deterministic`` (``None``: ``not
        self.training``) and draws from ``generator``."""
        x = _pool(self.embed(x, deterministic, generator), self.pooling)
        if self.feature is not None:
            x = torch.tanh(self.feature(x))
        if self.include_top:
            x = self.predictions(x)
            if self.classifier_activation is not None:
                x = self.classifier_activation(x)
        return x.to(torch.float32)


class DistilledVisionTransformer(VisionTransformer):
    """DeiT: a ViT with a distillation token and a second head.

    The forward returns ``[x_cls, x_dist]`` (float32): the ``predictions``
    head on the pooled sequence (``pooling``: ``cls`` takes token 0; the
    default ``None`` keeps the whole sequence, as the JAX module does) and
    ``predictions_dist`` on the distillation token; with
    ``return_dist_token=False`` their mean."""

    _extra_tokens = 2  # CLS and distillation tokens

    def __init__(self, patch_size, patch_dim, n_encoder_layers, n_heads,
                 ff_dim, dropout_rate=0.1, image_size=(224, 224),
                 return_dist_token=True, include_top=True, pooling=None,
                 classes=1000, classifier_activation=None, dtype=None,
                 param_dtype=torch.float32, remat=False,
                 attention_impl="xla", score_dtype=None,
                 gelu_approximate=False, norm_stats_dtype=None,
                 moe_every_n=0, moe_n_experts=8, moe_capacity_factor=1.25,
                 moe_router_z_loss_weight=0.0, moe_n_selected_experts=1,
                 moe_group_size=None, device=None):
        super().__init__(
            patch_size, patch_dim, n_encoder_layers, n_heads, ff_dim,
            dropout_rate=dropout_rate, image_size=image_size,
            include_top=include_top, pooling=pooling, classes=classes,
            classifier_activation=classifier_activation, dtype=dtype,
            param_dtype=param_dtype, remat=remat,
            attention_impl=attention_impl, score_dtype=score_dtype,
            gelu_approximate=gelu_approximate,
            norm_stats_dtype=norm_stats_dtype, moe_every_n=moe_every_n,
            moe_n_experts=moe_n_experts,
            moe_capacity_factor=moe_capacity_factor,
            moe_router_z_loss_weight=moe_router_z_loss_weight,
            moe_n_selected_experts=moe_n_selected_experts,
            moe_group_size=moe_group_size, device=device)
        device = resolve_device(device)
        self.return_dist_token = return_dist_token
        self.add_dist_token = ConcatEmbedding(
            1, patch_dim, axis=1, side="left", param_dtype=param_dtype,
            device=device)
        if include_top:
            self.predictions_dist = QuantDense(
                patch_dim, classes, dtype=dtype, param_dtype=param_dtype,
                device=device)

    def _prepend_tokens(self, x):
        # the distillation token first, then CLS: [cls, dist, patches...]
        return self.add_cls_token(self.add_dist_token(x))

    def forward(self, x, deterministic=None, generator=None):
        """``[b, H, W, 3]`` images -> ``[x_cls, x_dist]`` float32 logits
        (or their mean without ``return_dist_token``)."""
        x = self.embed(x, deterministic, generator)
        x_cls, x_dist = _pool(x, self.pooling), x[:, 1]
        if self.include_top:
            x_cls = self.predictions(x_cls)
            x_dist = self.predictions_dist(x_dist)
            if self.classifier_activation is not None:
                x_cls = self.classifier_activation(x_cls)
                x_dist = self.classifier_activation(x_dist)
        x_cls, x_dist = x_cls.to(torch.float32), x_dist.to(torch.float32)
        if self.return_dist_token:
            return [x_cls, x_dist]
        return (x_cls + x_dist) / 2.0


def _are_weights_pretrained(weights, model_name):
    return (model_name in WEIGHTS_HASHES) and (weights in WEIGHTS_HASHES[model_name])


def _get_model_info(weights, model_name):
    """(default_size, has_feature) for a weight spec (reference :103-114)."""
    if _are_weights_pretrained(weights, model_name):
        suffix = WEIGHTS_HASHES[model_name][weights][2].replace("_deit", "")
        default_size = int(suffix.split("_")[-1])
        has_feature = "21k" in suffix and "1000" not in suffix
    else:
        default_size = 224
        has_feature = False
    return default_size, has_feature


def weights_cache_dir() -> str:
    """Where named weight specs are looked up: ``CHAMBERS_TPU_WEIGHTS_DIR``,
    else ``~/.chambers_tpu/models``."""
    return os.environ.get(
        "CHAMBERS_TPU_WEIGHTS_DIR",
        os.path.join(os.path.expanduser("~"), ".chambers_tpu", "models"),
    )


def cached_weights(file_name, source):
    """The path of ``file_name`` in :func:`weights_cache_dir`, or
    ``FileNotFoundError`` naming it and ``source``: nothing is
    downloaded."""
    path = os.path.join(weights_cache_dir(), file_name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Pretrained weights expect the file {file_name} in "
            f"{weights_cache_dir()} (set CHAMBERS_TPU_WEIGHTS_DIR to "
            f"override): place {source} there, or pass weights=None. "
            "Nothing is downloaded.")
    return path


def _resolve_weights_path(model_name, weights, include_top):
    """Map a pretrained spec to its cached file (no network)."""
    _, _, suffix = WEIGHTS_HASHES[model_name][weights]
    top = "" if include_top else "_no_top"
    return cached_weights(f"{model_name}_{suffix}{top}.h5",
                          "the chjort/chambers v1.1 release file")


def _build(module_cls, model_name, widths, weights, input_shape,
           include_top, seed, device, feature_dim=None, **kwargs):
    """The presets' builder (the JAX package's ``_build``): a named weight
    spec fixes the input size (and, for the 21k-only files, a ``feature``
    head without a top) and loads its cached ``.h5`` file; a path loads
    that file; ``None`` keeps the seeded init. Returns eval mode."""
    if kwargs.get("moe_every_n") and weights is not None:
        raise ValueError(
            "moe_every_n adds expert weights that a weights file does not "
            "hold; use weights=None (train from scratch), or load a dense "
            "model and upcycle it by hand.")
    pretrained = _are_weights_pretrained(weights, model_name)
    default_size, has_feature = _get_model_info(weights, model_name)
    if module_cls is VisionTransformer:
        if pretrained and feature_dim is not None:
            raise ValueError(
                "'weights' and 'feature_dim' are mutually exclusive.")
        if pretrained and has_feature:
            feature_dim = widths[1]
            if include_top:
                warnings.warn(f"weights '{weights}' has no top. "
                              "'include_top' will be set to False.")
                include_top = False
        kwargs["feature_dim"] = feature_dim
    input_shape = tuple(input_shape or (default_size, default_size, 3))
    if pretrained:
        expected = (default_size, default_size, input_shape[-1])
        if input_shape != expected:
            raise ValueError(
                f"Weights '{weights}' require `input_shape` to be {expected}.")
    if None in input_shape:
        raise ValueError("Input shape must be fully specified; got input "
                         f"shape {input_shape}.")
    path = (_resolve_weights_path(model_name, weights, include_top)
            if pretrained else weights)
    device = resolve_device(device)
    model = module_cls(*widths, image_size=input_shape[:2],
                       include_top=include_top, device=device, **kwargs)
    generator = torch.Generator(device=device).manual_seed(seed)
    initializers.init_module(model, generator).eval()
    if path is not None:
        import_h5(model, path, load_vit_h5_weights)
    return model


def _vit_preset(model_name, patch_size, patch_dim, n_layers, n_heads, ff_dim):
    def preset(input_shape=None, include_top=True, weights=None,
               pooling="cls", feature_dim=None, classes=1000,
               classifier_activation=None, dtype=None, dropout_rate=0.1,
               attention_impl="xla", score_dtype=None,
               gelu_approximate=False, norm_stats_dtype=None, moe_every_n=0,
               moe_n_experts=8, moe_capacity_factor=1.25, seed: int = 0,
               device=None):
        """Build, seed-initialise, load ``weights`` (a spec of
        ``WEIGHTS_HASHES`` or an ``.h5`` path) and return the model in
        eval mode."""
        return _build(
            VisionTransformer, model_name,
            (patch_size, patch_dim, n_layers, n_heads, ff_dim), weights,
            input_shape, include_top, seed, device, feature_dim=feature_dim,
            dropout_rate=dropout_rate, pooling=pooling, classes=classes,
            classifier_activation=classifier_activation, dtype=dtype,
            attention_impl=attention_impl, score_dtype=score_dtype,
            gelu_approximate=gelu_approximate,
            norm_stats_dtype=norm_stats_dtype, moe_every_n=moe_every_n,
            moe_n_experts=moe_n_experts,
            moe_capacity_factor=moe_capacity_factor)

    preset.__name__ = model_name
    return preset


def _deit_preset(model_name, patch_size, patch_dim, n_layers, n_heads,
                 ff_dim):
    def preset(return_dist_token=True, input_shape=None, include_top=True,
               weights=None, pooling="cls", classes=1000,
               classifier_activation=None, dtype=None,
               attention_impl="xla", score_dtype=None,
               gelu_approximate=False, norm_stats_dtype=None, moe_every_n=0,
               moe_n_experts=8, moe_capacity_factor=1.25, seed: int = 0,
               device=None):
        """Build, seed-initialise, load ``weights`` (a spec of
        ``WEIGHTS_HASHES`` or an ``.h5`` path) and return the model in
        eval mode, with ``dropout_rate=0.1`` as the JAX package's DeiT
        presets fix it."""
        return _build(
            DistilledVisionTransformer, model_name,
            (patch_size, patch_dim, n_layers, n_heads, ff_dim), weights,
            input_shape, include_top, seed, device, dropout_rate=0.1,
            return_dist_token=return_dist_token, pooling=pooling,
            classes=classes, classifier_activation=classifier_activation,
            dtype=dtype, attention_impl=attention_impl,
            score_dtype=score_dtype, gelu_approximate=gelu_approximate,
            norm_stats_dtype=norm_stats_dtype, moe_every_n=moe_every_n,
            moe_n_experts=moe_n_experts,
            moe_capacity_factor=moe_capacity_factor)

    preset.__name__ = model_name
    return preset


ViTS16 = _vit_preset("vits16", 16, 384, 12, 6, 1536)
ViTB16 = _vit_preset("vitb16", 16, 768, 12, 12, 3072)
ViTB32 = _vit_preset("vitb32", 32, 768, 12, 12, 3072)
ViTL16 = _vit_preset("vitl16", 16, 1024, 24, 16, 4096)
ViTL32 = _vit_preset("vitl32", 32, 1024, 24, 16, 4096)
DeiTS16 = _deit_preset("deits16", 16, 384, 12, 6, 1536)
DeiTB16 = _deit_preset("deitb16", 16, 768, 12, 12, 3072)


def preprocess_input(x):
    """'tf'-mode ImageNet scaling to [-1, 1] (vision_transformer.py:640)."""
    from chambers_tpu_torch.augmentations import ImageNetNormalization

    return ImageNetNormalization(mode="tf")(x)


def fold_imagenet_normalization(state_dict, mode: str = "tf"):
    """Fold ImageNet input normalization into the patch embedding.

    Each mode is a per-channel affine map ``y_c = s_c * x_c + o_c`` (caffe
    also flips RGB -> BGR), and the patch embedding sees exactly one whole
    kernel footprint per output, so the map folds exactly::

        kernel'[kh, kw, c, d] = kernel[kh, kw, c, d] * s_c    (caffe: +flip)
        bias'[d]              = bias[d] + sum_khkwc kernel * o_c

    and the model then takes raw [0, 255] pixels. Folded in float32 and cast
    back to the parameters' dtype.

    :param state_dict: a ViT or DeiT ``state_dict`` with
        ``patch_embeddings.kernel`` ``[kh, kw, 3, d]`` and
        ``patch_embeddings.bias``.
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
                         "fold_imagenet_normalization applies to ViT and "
                         "DeiT patch embeddings only")
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
