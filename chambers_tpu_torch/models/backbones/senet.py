"""SE-ResNet / SE-ResNeXt / SENet-154 backbones (port of
``chambers_tpu/models/backbones/senet.py``: the helpers, ``GroupConv2D``,
``ChannelSE``, the three bottlenecks, ``SENetModule``, ``ModelParams``,
``MODELS_PARAMS``, ``SENet``, the six presets and ``preprocess_input``).

As in the JAX package: a 7x7/2 stem (three 3x3 convs for SENet-154), zero
padding and a VALID 3x3/2 max pool, four stages of SE bottlenecks,
BatchNorm epsilon 9.999999747378752e-06 and momentum 0.99, he-uniform
convs, and a head of the spatial mean, ``Dropout`` (SENet-154, 0.2),
``QuantDense_0`` and a float32 softmax. Without the top the output is the
NHWC feature map, in float32. Grouped 3x3 convs are one grouped
convolution. In each block the squeeze-and-excitation unit is created
before the shortcut conv, as in Flax, so the order-based ``.h5`` importer
walks the leaves in the Keras files' order.

``weights`` is ``None`` (the port's seeded init), ``"imagenet"`` (the
chjort/chambers v1.0 file ``<name>_imagenet_1000[_no_top].h5`` in
``weights_cache_dir()``; nothing is downloaded) or the path of a legacy
Keras ``.h5`` file, imported by order with ``load_cnn_h5_weights``.
"""

import collections

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.layers.convolution import (
    Conv,
    ConvBN,
    add_named,
    max_pool,
    pad_hw,
)
from chambers_tpu_torch.layers.transformer import _dropout
from chambers_tpu_torch.models.backbones.h5_import import import_h5
from chambers_tpu_torch.models.backbones.h5_import_cnn import (
    load_cnn_h5_weights,
)
from chambers_tpu_torch.models.backbones.vision_transformer import (
    cached_weights,
)
from chambers_tpu_torch.quantization import QuantDense

ModelParams = collections.namedtuple(
    "ModelParams",
    ["model_name", "repetitions", "residual_block", "groups",
     "reduction", "init_filters", "input_3x3", "dropout"],
)

# Released-weight location (senet.py:16-17) and registry (senet.py:18-31):
# model -> (top_md5, no_top_md5)
BASE_WEIGHTS_PATH = (
    "https://github.com/chjort/chambers/releases/download/v1.0/")
WEIGHTS_HASHES = {
    "seresnet50":
        ("ff0ce1ed5accaad05d113ecef2d29149", "043777781b0d5ca756474d60bf115ef1"),
    "seresnet101":
        ("5c31adee48c82a66a32dee3d442f5be8", "1c373b0c196918713da86951d1239007"),
    "seresnet152":
        ("96fc14e3a939d4627b0174a0e80c7371", "f58d4c1a511c7445ab9a2c2b83ee4e7b"),
    "seresnext50":
        ("5310dcd58ed573aecdab99f8df1121d5", "b0f23d2e1cd406d67335fb92d85cc279"),
    "seresnext101":
        ("be5b26b697a0f7f11efaa1bb6272fc84", "e48708cbe40071cc3356016c37f6c9c7"),
    "senet154":
        ("c8eac0e1940ea4d8a2e0b2eb0cdf4e75", "d854ff2cd7e6a87b05a8124cd283e0f2"),
}

_BN_EPS = 9.999999747378752e-06


def get_bn_params(**params):
    """BatchNorm defaults of the SENet family (senet.py:38-45): the
    trailing channel axis and the reference's epsilon; keyword overrides
    update them."""
    default_bn_params = {"axis": -1, "epsilon": _BN_EPS}
    default_bn_params.update(params)
    return default_bn_params


def get_num_channels(tensor):
    """Channel count of an NHWC tensor (senet.py:48-50)."""
    return tensor.shape[-1]


def slice_tensor(x, start, stop, axis):
    """Channel-range slice (senet.py:56-62): axis 3 or -1 for NHWC, 1 for
    NCHW."""
    if axis in (3, -1):
        return x[:, :, :, start:stop]
    elif axis == 1:
        return x[:, start:stop, :, :]
    raise ValueError("Slice axis should be in (1, 3), got {}.".format(axis))


def expand_dims(x, channels_axis):
    """``[b, c] -> [b, 1, 1, c]`` (or ``[b, c, 1, 1]`` for axis 1)
    (senet.py:130-135)."""
    if channels_axis in (3, -1):
        return x[:, None, None, :]
    elif channels_axis == 1:
        return x[:, :, None, None]
    raise ValueError(
        "Slice axis should be in (1, 3), got {}.".format(channels_axis))


_INITIALIZERS = {
    "he_uniform": initializers.he_uniform,
    "he_normal": initializers.he_normal,
    "glorot_uniform": initializers.glorot_uniform,
}


def GroupConv2D(filters, kernel_size, strides=(1, 1), groups=32,
                kernel_initializer="he_uniform", use_bias=True,
                activation="linear", padding="valid", *, in_features,
                **kwargs):
    """Grouped 2-D convolution (senet.py:65-127) as one grouped
    :class:`Conv` whose kernel ``[kh, kw, in/groups, filters]`` is the
    reference's per-group kernels concatenated on the output axis.
    ``padding`` ``"same"`` is XLA's SAME (at stride 2 the extra row and
    column go last). PyTorch needs ``in_features``, which Flax reads from
    the first input; ``kwargs`` go to :class:`Conv` (``dtype``,
    ``device``). Only the linear activation exists, as at every reference
    call site."""
    if activation not in (None, "linear"):
        raise ValueError(
            f"GroupConv2D only supports linear activation, got {activation!r}"
            " (every reference call site uses the default)")
    kernel_init = _INITIALIZERS.get(kernel_initializer, kernel_initializer)
    return Conv(in_features, filters, kernel_size, strides, padding.upper(),
                groups, use_bias, kernel_init, **kwargs)


def _ConvBN(in_features, filters, kernel, strides=1, groups=1, pad=0,
            relu=True, dtype=None, device=None):
    """He-uniform conv without bias -> BatchNorm(9.999999747378752e-06,
    momentum 0.99) -> optional ReLU."""
    return ConvBN(in_features, filters, kernel, strides, groups, pad, relu,
                  False, _BN_EPS, initializers.he_uniform, dtype=dtype,
                  device=device)


class ChannelSE(nn.Module):
    """Squeeze-and-excitation (senet.py:139-169): spatial mean -> 1x1
    reduce -> ReLU -> 1x1 expand -> sigmoid gate."""

    def __init__(self, channels, reduction=16, dtype=None, device=None):
        super().__init__()
        for n_in, n_out in ((channels, channels // reduction),
                            (channels // reduction, channels)):
            add_named(self, "Conv", Conv(
                n_in, n_out, 1, kernel_init=initializers.he_uniform,
                dtype=dtype, device=device))

    def forward(self, x):
        se = x.mean((1, 2), keepdim=True)
        se = torch.relu(self.Conv_0(se))
        return x * torch.sigmoid(self.Conv_1(se))


class _SEBlock(nn.Module):
    """What the three bottlenecks share: three ``_ConvBN`` units, the SE
    gate, then (where the stride or the width changes) the shortcut
    ``_ConvBN`` — created in that order, the reference's call order."""

    def _finish(self, in_features, filters, reduction, strides, dtype,
                device, shortcut_kernel=1):
        add_named(self, "ChannelSE", ChannelSE(filters, reduction, dtype,
                                               device))
        if strides != 1 or filters != in_features:
            add_named(self, "_ConvBN", _ConvBN(
                in_features, filters, shortcut_kernel, strides,
                pad=shortcut_kernel // 2, relu=False, dtype=dtype,
                device=device))
        self.units = list(self.children())  # in creation order
        self.out_features = filters

    def forward(self, x, train=False):
        y = x
        for unit in self.units[:3]:
            y = unit(y, train)
        y = self.units[3](y)
        residual = x if len(self.units) == 4 else self.units[4](x, train)
        return torch.relu(y + residual)


class SEResNetBottleneck(_SEBlock):
    """(senet.py:176-218): strided 1x1, 3x3, 1x1 at ``filters / 4`` wide;
    ``groups`` and ``is_first`` are unused (a uniform block signature)."""

    def __init__(self, in_features, filters, reduction=16, strides=1,
                 groups=1, is_first=False, dtype=None, device=None):
        super().__init__()
        w = filters // 4
        for args in ((in_features, w, 1, strides), (w, w, 3, 1, 1, 1),
                     (w, filters, 1, 1, 1, 0, False)):
            add_named(self, "_ConvBN", _ConvBN(*args, dtype=dtype,
                                               device=device))
        self._finish(in_features, filters, reduction, strides, dtype, device)


class SEResNeXtBottleneck(_SEBlock):
    """(senet.py:221-267): the grouped 3x3 (strided) is ``filters / 4 ·
    base_width · groups / 64`` wide."""

    def __init__(self, in_features, filters, reduction=16, strides=1,
                 groups=32, base_width=4, is_first=False, dtype=None,
                 device=None):
        super().__init__()
        w = (filters // 4) * base_width * groups // 64
        for args in ((in_features, w, 1), (w, w, 3, strides, groups, 1),
                     (w, filters, 1, 1, 1, 0, False)):
            add_named(self, "_ConvBN", _ConvBN(*args, dtype=dtype,
                                               device=device))
        self._finish(in_features, filters, reduction, strides, dtype, device)


class SEBottleneck(_SEBlock):
    """SENet-154's block (senet.py:270-318): 1x1 at ``filters / 2``, the
    grouped 3x3 (strided), 1x1; the downsampling shortcut is a padded 3x3
    conv except in the first block."""

    def __init__(self, in_features, filters, reduction=16, strides=1,
                 groups=64, is_first=False, dtype=None, device=None):
        super().__init__()
        for args in ((in_features, filters // 2, 1),
                     (filters // 2, filters, 3, strides, groups, 1),
                     (filters, filters, 1, 1, 1, 0, False)):
            add_named(self, "_ConvBN", _ConvBN(*args, dtype=dtype,
                                               device=device))
        self._finish(in_features, filters, reduction, strides, dtype, device,
                     shortcut_kernel=1 if is_first else 3)


class SENetModule(nn.Module):
    """The SENet body (senet.py:326-474) over ``[b, H, W, c]`` images.
    ``_batch_group`` is set under ``parallel.distributed.data_parallel``,
    for SENet-154's dropout (``layers.transformer._dropout``)."""

    _batch_group = None

    def __init__(self, model_params, include_top=True, classes=1000,
                 dtype=None, in_channels=3, device=None):
        super().__init__()
        device = resolve_device(device)
        p = self.model_params = model_params
        self.include_top = include_top
        self.classes = classes
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        if p.input_3x3:  # SENet-154 stem
            stem = ((in_channels, p.init_filters, 3, 2, 1, 1),
                    (p.init_filters, p.init_filters, 3, 1, 1, 1),
                    (p.init_filters, p.init_filters * 2, 3, 1, 1, 1))
        else:
            stem = ((in_channels, p.init_filters, 7, 2, 1, 3),)
        for args in stem:
            add_named(self, "_ConvBN", _ConvBN(*args, **kw))
        self.stem = list(self.children())
        self.blocks = []
        channels = stem[-1][1]
        filters = p.init_filters * 2
        for i, stage in enumerate(p.repetitions):
            filters *= 2
            for j in range(stage):
                block = p.residual_block(
                    channels, filters, reduction=p.reduction,
                    strides=2 if (i != 0 and j == 0) else 1,
                    groups=p.groups, is_first=(i == 0 and j == 0), **kw)
                self.blocks.append(add_named(
                    self, p.residual_block.__name__, block))
                channels = block.out_features
        if include_top:
            add_named(self, "QuantDense", QuantDense(channels, classes, **kw))

    def get_config(self):
        """Config round trip: the ``residual_block`` entry is encoded by
        its class name."""
        params = self.model_params._asdict()
        params["residual_block"] = params["residual_block"].__name__
        return {"model_params": params, "include_top": self.include_top,
                "classes": self.classes, "dtype": self.dtype}

    @classmethod
    def from_config(cls, config, **kwargs):
        """The module of ``config`` (:meth:`get_config`); ``kwargs`` go to
        the constructor (``in_channels``, ``device``)."""
        config = dict(config)
        params = dict(config.pop("model_params"))
        blocks = {c.__name__: c for c in
                  (SEResNetBottleneck, SEResNeXtBottleneck, SEBottleneck)}
        params["residual_block"] = blocks[params["residual_block"]]
        return cls(model_params=ModelParams(**params), **config, **kwargs)

    def forward(self, x, deterministic=None, generator=None):
        """``deterministic`` (``None``: ``not self.training``) False runs
        BatchNorm on the batch's statistics, updating the running ones,
        and SENet-154's dropout, drawn from ``generator``."""
        if deterministic is None:
            deterministic = not self.training
        train = not deterministic
        if self.dtype is not None:
            x = x.to(self.dtype)
        for unit in self.stem:
            x = unit(x, train)
        # ZeroPadding2D(1) + VALID 3x3/2 max-pool (senet.py:421-422)
        x = max_pool(pad_hw(x, ((1, 1), (1, 1))), 3, 2)
        for block in self.blocks:
            x = block(x, train)
        if self.include_top:
            x = x.mean((1, 2))
            if self.model_params.dropout is not None:
                x = _dropout(x, self.model_params.dropout, deterministic,
                             generator, self._batch_group)
            x = self.QuantDense_0(x)
            x = torch.softmax(x.to(torch.float32), dim=-1)
        return x.to(torch.float32)


MODELS_PARAMS = {
    "seresnet50": ModelParams(
        "seresnet50", repetitions=(3, 4, 6, 3), residual_block=SEResNetBottleneck,
        groups=1, reduction=16, init_filters=64, input_3x3=False, dropout=None,
    ),
    "seresnet101": ModelParams(
        "seresnet101", repetitions=(3, 4, 23, 3), residual_block=SEResNetBottleneck,
        groups=1, reduction=16, init_filters=64, input_3x3=False, dropout=None,
    ),
    "seresnet152": ModelParams(
        "seresnet152", repetitions=(3, 8, 36, 3), residual_block=SEResNetBottleneck,
        groups=1, reduction=16, init_filters=64, input_3x3=False, dropout=None,
    ),
    "seresnext50": ModelParams(
        "seresnext50", repetitions=(3, 4, 6, 3), residual_block=SEResNeXtBottleneck,
        groups=32, reduction=16, init_filters=64, input_3x3=False, dropout=None,
    ),
    "seresnext101": ModelParams(
        "seresnext101", repetitions=(3, 4, 23, 3), residual_block=SEResNeXtBottleneck,
        groups=32, reduction=16, init_filters=64, input_3x3=False, dropout=None,
    ),
    "senet154": ModelParams(
        "senet154", repetitions=(3, 8, 36, 3), residual_block=SEBottleneck,
        groups=64, reduction=16, init_filters=64, input_3x3=True, dropout=0.2,
    ),
}


def SENet(model_params, input_shape=None, include_top=True, classes=1000,
          weights=None, dtype=None, seed=0, device=None):
    """Build a SENet-family model in eval mode from the port's seeded init,
    then load ``weights`` (see the module docstring)."""
    if weights == "imagenet" and include_top and classes != 1000:
        raise ValueError(
            'If using `weights` as `"imagenet"` with `include_top` as true, '
            "`classes` should be 1000"
        )
    if weights == "imagenet":
        suffix = "_imagenet_1000.h5" if include_top else (
            "_imagenet_1000_no_top.h5")
        weights = cached_weights(model_params.model_name + suffix,
                                 "the chjort/chambers v1.0 release file")
    device = resolve_device(device)
    input_shape = input_shape or (224, 224, 3)
    model = SENetModule(model_params, include_top, classes, dtype,
                        in_channels=input_shape[-1], device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    initializers.init_module(model, generator).eval()
    if weights is not None:
        import_h5(model, weights, load_cnn_h5_weights)
    return model


def _preset(name):
    def build(input_shape=None, weights=None, classes=1000,
              include_top=True, dtype=None, seed=0, device=None):
        return SENet(
            MODELS_PARAMS[name], input_shape=input_shape,
            include_top=include_top, classes=classes, weights=weights,
            dtype=dtype, seed=seed, device=device,
        )

    build.__name__ = name
    return build


SEResNet50 = _preset("seresnet50")
SEResNet101 = _preset("seresnet101")
SEResNet152 = _preset("seresnet152")
SEResNeXt50 = _preset("seresnext50")
SEResNeXt101 = _preset("seresnext101")
SENet154 = _preset("senet154")


def preprocess_input(x):
    """'torch'-mode ImageNet scaling (senet.py:585)."""
    from chambers_tpu_torch.augmentations import ImageNetNormalization

    return ImageNetNormalization(mode="torch")(x)
