"""ResNeXt-50/101 (32x4d) backbones (port of
``chambers_tpu/models/backbones/resnext.py``: ``_ConvBN``, ``_Block3``,
``ResNeXtModule``, the presets and ``preprocess_input``).

Keras ResNet conventions, as in the JAX package: BatchNorm epsilon
1.001e-5, a 7x7/2 stem without bias, zero padding and a VALID 3x3/2 max
pool, the stride on the grouped 3x3 conv, stage widths 128/256/512/1024
with 32 groups. A block's shortcut ``_ConvBN`` is created first, as in
Flax, so the names and their order are the JAX package's. The top is the
mean over the feature map, ``QuantDense_0`` and a float32 softmax;
without it ``pooling`` is ``"avg"``, ``"max"`` or ``None`` (the NHWC
feature map). The output is float32.

``weights`` is ``None`` (the port's seeded init), ``"imagenet"`` (the
keras-applications file ``resnext50.h5`` / ``resnext50_notop.h5`` in
``weights_cache_dir()``; nothing is downloaded) or the path of such an
``.h5`` file, imported by name with ``load_resnext_h5_weights``, which
also loads the ``predictions`` head (the JAX importer leaves it random).
"""

from typing import Optional

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.layers.convolution import (
    ConvBN,
    add_named,
    max_pool,
    pad_hw,
)
from chambers_tpu_torch.models.backbones.h5_import import import_h5
from chambers_tpu_torch.models.backbones.h5_import_cnn import (
    load_resnext_h5_weights,
)
from chambers_tpu_torch.models.backbones.vision_transformer import (
    cached_weights,
)
from chambers_tpu_torch.quantization import QuantDense

_BN_EPS = 1.001e-5


def _ConvBN(in_features, filters, kernel, strides=1, groups=1, pad=0,
            relu=True, use_bias=False, dtype=None, device=None):
    """Conv (Flax's default lecun-normal init) -> BatchNorm(1.001e-5) ->
    optional ReLU."""
    return ConvBN(in_features, filters, kernel, strides, groups, pad, relu,
                  use_bias, _BN_EPS, dtype=dtype, device=device)


class _Block3(nn.Module):
    """Keras ``block3``: 1x1 -> grouped 3x3 -> 1x1 (twice the width), with
    a projected shortcut in a stage's first block."""

    def __init__(self, in_features, filters, strides=1, groups=32,
                 conv_shortcut=True, dtype=None, device=None):
        super().__init__()
        out_ch = (64 // groups) * filters
        self.conv_shortcut = conv_shortcut
        if conv_shortcut:
            add_named(self, "_ConvBN", _ConvBN(
                in_features, out_ch, 1, strides, relu=False, dtype=dtype,
                device=device))
        add_named(self, "_ConvBN", _ConvBN(
            in_features, filters, 1, dtype=dtype, device=device))
        add_named(self, "_ConvBN", _ConvBN(
            filters, filters, 3, strides, groups, pad=1, dtype=dtype,
            device=device))
        add_named(self, "_ConvBN", _ConvBN(
            filters, out_ch, 1, relu=False, dtype=dtype, device=device))
        self.units = list(self.children())  # in creation order
        self.out_features = out_ch

    def forward(self, x, train=False):
        units = self.units
        shortcut = x
        if self.conv_shortcut:
            shortcut, units = units[0](x, train), units[1:]
        y = x
        for unit in units:
            y = unit(y, train)
        return torch.relu(y + shortcut)


class ResNeXtModule(nn.Module):
    """ResNeXt over ``[b, H, W, c]`` images; float32 out."""

    def __init__(self, stage_depths, include_top=True,
                 pooling: Optional[str] = None, classes=1000, groups=32,
                 dtype=None, in_channels=3, device=None):
        super().__init__()
        device = resolve_device(device)
        self.include_top = include_top
        self.pooling = pooling
        self.dtype = dtype
        # Keras ResNeXt passes use_bias=False to the stem
        add_named(self, "_ConvBN", _ConvBN(
            in_channels, 64, 7, 2, pad=3, dtype=dtype, device=device))
        self.blocks = []
        channels = 64
        for stage, (width, depth) in enumerate(zip((128, 256, 512, 1024),
                                                   stage_depths)):
            for block in range(depth):
                strides = 1 if (stage == 0 or block > 0) else 2
                unit = _Block3(channels, width, strides, groups,
                               conv_shortcut=(block == 0), dtype=dtype,
                               device=device)
                self.blocks.append(add_named(self, "_Block3", unit))
                channels = unit.out_features
        if include_top:
            add_named(self, "QuantDense", QuantDense(
                channels, classes, dtype=dtype, device=device))

    def forward(self, x, deterministic=None):
        """``deterministic`` (``None``: ``not self.training``) False runs
        BatchNorm on the batch's statistics and updates the running
        ones."""
        if deterministic is None:
            deterministic = not self.training
        train = not deterministic
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self._ConvBN_0(x, train)
        x = max_pool(pad_hw(x, ((1, 1), (1, 1))), 3, 2)
        for block in self.blocks:
            x = block(x, train)
        if self.include_top:
            x = self.QuantDense_0(x.mean((1, 2)))
            # Keras ResNet classifier_activation="softmax" default
            x = torch.softmax(x.to(torch.float32), dim=-1)
        elif self.pooling == "avg":
            x = x.mean((1, 2))
        elif self.pooling == "max":
            x = x.amax((1, 2))
        return x.to(torch.float32)


def _build(name, depths, input_shape, include_top, weights, pooling,
           classes, dtype, seed, device):
    if weights == "imagenet":
        weights = cached_weights(
            f"{name}{'.h5' if include_top else '_notop.h5'}",
            "the keras-team release file the reference uses")
    device = resolve_device(device)
    input_shape = input_shape or (224, 224, 3)
    model = ResNeXtModule(depths, include_top, pooling, classes, dtype=dtype,
                          in_channels=input_shape[-1], device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    initializers.init_module(model, generator).eval()
    if weights is not None:
        import_h5(model, weights, load_resnext_h5_weights, depths)
    return model


def ResNeXt50(include_top=True, weights=None, input_shape=None, pooling=None,
              classes=1000, dtype=None, seed=0, device=None):
    """ResNeXt-50 (32x4d), stages 3-4-6-3, in eval mode."""
    return _build("resnext50", (3, 4, 6, 3), input_shape, include_top,
                  weights, pooling, classes, dtype, seed, device)


def ResNeXt101(include_top=True, weights=None, input_shape=None,
               pooling=None, classes=1000, dtype=None, seed=0, device=None):
    """ResNeXt-101 (32x4d), stages 3-4-23-3, in eval mode."""
    return _build("resnext101", (3, 4, 23, 3), input_shape, include_top,
                  weights, pooling, classes, dtype, seed, device)


def preprocess_input(x):
    """'torch'-mode ImageNet scaling (resnext.py:48)."""
    from chambers_tpu_torch.augmentations import ImageNetNormalization

    return ImageNetNormalization(mode="torch")(x)
