"""BN-Inception backbone (port of
``chambers_tpu/models/backbones/inception.py``: ``_ConvBN``, ``_pool2``,
``_Inception``, ``_MODULES``, ``BNInceptionModule``, ``BNInception``,
``with_pooling`` and ``preprocess_input``).

The published Inception-BN graph, as in the JAX package: convs with bias,
BatchNorm epsilon 1e-3, Caffe's ceil-mode 3x3/2 max pools (``-inf`` padding
at the bottom and right), and the ten modules of ``_MODULES``. The output
is the NHWC feature map, ``[b, 7, 7, 1024]`` at 224 px, in float32;
:func:`with_pooling` adds global average or max pooling, the 1024-d
retrieval descriptor.

``BNInception(weights_path=...)`` takes the path of the stored model's
``.h5`` file (imported by creation order with ``load_convbn_h5_weights``)
or of a ``Model.save_weights`` msgpack file of either package, ``None`` for the cached release file ``bninception_imagenet_1000_no_top.h5``
in ``weights_cache_dir()`` (nothing is downloaded), or ``False`` (the
default here; the JAX package defaults to ``None``) for the port's seeded
init.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.layers.convolution import (
    ConvBN,
    add_named,
    avg_pool,
    max_pool,
    pad_hw,
)
from chambers_tpu_torch.models.backbones.h5_import import import_h5
from chambers_tpu_torch.models.backbones.h5_import_cnn import (
    load_convbn_h5_weights,
)
from chambers_tpu_torch.models.backbones.vision_transformer import (
    cached_weights,
)

# Released-weight location + registry (inception.py:6-12).
BASE_WEIGHTS_PATH = (
    "https://github.com/chjort/chambers/releases/download/v1.0/")
WEIGHTS_HASHES = {
    "bninception":
        (None, "7eb8291a8e70fccbccc3bc2fff83311b35d2194ee584c1f1335bb9a240b94145"),
}

_BN_EPS = 1e-3  # Caffe BN-Inception epsilon


def _ConvBN(in_features, filters, kernel, strides=1, pad=0, dtype=None,
            device=None):
    """Conv with bias (lecun-normal init) -> BatchNorm(1e-3) -> ReLU."""
    return ConvBN(in_features, filters, kernel, strides, 1, pad, True, True,
                  _BN_EPS, dtype=dtype, device=device)


def _pool2(x, kind):
    """3x3/2 max pool with Caffe's ceil-mode output size: ``-inf`` padding
    at the bottom and right."""
    if kind != "max":
        raise ValueError(f"only max pooling exists here, got {kind!r}")
    return max_pool(pad_hw(x, ((0, 1), (0, 1)), float("-inf")), 3, 2)


class _Inception(nn.Module):
    """One BN-Inception module: 1x1 | 1x1-3x3 | 1x1-3x3-3x3 | pool-proj.
    ``b1 is None`` marks the stride-2 reduction variant (3c, 4e): no 1x1
    branch, stride 2 on both conv branches and a stride-2 max pool passed
    through in place of the projected pool branch."""

    def __init__(self, in_features, b1: Optional[int], b3_reduce, b3,
                 bd_reduce, bd, pool_proj=0, pool_kind="avg", dtype=None,
                 device=None):
        super().__init__()
        self.reduction = b1 is None
        self.pool_kind = pool_kind
        stride = 2 if self.reduction else 1
        units = []
        if not self.reduction:
            units.append((in_features, b1, 1))
        units += [(in_features, b3_reduce, 1), (b3_reduce, b3, 3, stride, 1),
                  (in_features, bd_reduce, 1), (bd_reduce, bd, 3, 1, 1),
                  (bd, bd, 3, stride, 1)]
        if not self.reduction:
            units.append((in_features, pool_proj, 1))
        for args in units:
            add_named(self, "_ConvBN", _ConvBN(*args, dtype=dtype,
                                               device=device))
        self.units = list(self.children())  # in creation order
        self.out_features = (b3 + bd + (in_features if self.reduction
                                        else b1 + pool_proj))

    def forward(self, x, train=False):
        units = iter(self.units)
        branches = []
        if not self.reduction:
            branches.append(next(units)(x, train))
        y = next(units)(x, train)
        branches.append(next(units)(y, train))
        z = next(units)(x, train)
        z = next(units)(z, train)
        branches.append(next(units)(z, train))
        if self.reduction:
            branches.append(_pool2(x, "max"))
        else:
            if self.pool_kind == "max":
                p = max_pool(pad_hw(x, ((1, 1), (1, 1)), float("-inf")),
                             3, 1)
            else:
                p = avg_pool(x, 3, 1, 1)
            branches.append(next(units)(p, train))
        return torch.cat(branches, dim=-1)


# (b1, b3_reduce, b3, bd_reduce, bd, pool_proj, pool_kind) per module —
# the published Inception-BN table; None b1 = stride-2 reduction module.
_MODULES = (
    (64, 64, 64, 64, 96, 32, "avg"),      # 3a
    (64, 64, 96, 64, 96, 64, "avg"),      # 3b
    (None, 128, 160, 64, 96, 0, "max"),   # 3c (stride 2)
    (224, 64, 96, 96, 128, 128, "avg"),   # 4a
    (192, 96, 128, 96, 128, 128, "avg"),  # 4b
    (160, 128, 160, 128, 160, 128, "avg"),  # 4c
    (96, 128, 192, 160, 192, 128, "avg"),   # 4d
    (None, 128, 192, 192, 256, 0, "max"),   # 4e (stride 2)
    (352, 192, 320, 160, 224, 128, "avg"),  # 5a
    (352, 192, 320, 192, 224, 128, "max"),  # 5b
)


class BNInceptionModule(nn.Module):
    """Feature extractor (no top): ``[b, 224, 224, 3] -> [b, 7, 7, 1024]``
    float32."""

    def __init__(self, dtype=None, modules: Sequence = _MODULES,
                 in_channels=3, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        for args in ((in_channels, 64, 7, 2, 3), (64, 64, 1),
                     (64, 192, 3, 1, 1)):
            add_named(self, "_ConvBN", _ConvBN(*args, **kw))
        self.stem = list(self.children())
        self.blocks = []
        channels = 192
        for spec in modules:
            block = _Inception(channels, *spec, **kw)
            self.blocks.append(add_named(self, "_Inception", block))
            channels = block.out_features

    def forward(self, x, deterministic=None):
        """``deterministic`` (``None``: ``not self.training``) False runs
        BatchNorm on the batch's statistics and updates the running
        ones."""
        if deterministic is None:
            deterministic = not self.training
        train = not deterministic
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = _pool2(self.stem[0](x, train), "max")
        x = self.stem[2](self.stem[1](x, train), train)
        x = _pool2(x, "max")
        for block in self.blocks:
            x = block(x, train)
        return x.to(torch.float32)


def BNInception(weights_path=False, pooling: Optional[str] = None,
                input_shape=(224, 224, 3), dtype=None, seed=0, device=None):
    """Build BN-Inception in eval mode from the port's seeded init, load
    ``weights_path`` (see the module docstring) and add ``pooling``
    (inception.py:14-49)."""
    if weights_path is None:
        weights_path = cached_weights(
            "bninception_imagenet_1000_no_top.h5",
            "the stored model of the chjort/chambers v1.0 release (sha256 "
            f"{WEIGHTS_HASHES['bninception'][1][:12]}…)")
    device = resolve_device(device)
    model = BNInceptionModule(dtype, in_channels=input_shape[-1],
                              device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    initializers.init_module(model, generator).eval()
    if weights_path:
        import_h5(model, weights_path, load_convbn_h5_weights)
    return with_pooling(model, pooling)


def with_pooling(model, pooling: Optional[str]):
    """Global ``"avg"`` or ``"max"`` pooling over a feature-map backbone's
    output (inception.py:41-45), as a forward hook: the module, its names
    and its ``state_dict`` stay as they are. ``None`` returns it
    unchanged."""
    if pooling not in (None, "avg", "max"):
        raise ValueError(f"Unknown pooling '{pooling}'")
    if pooling is not None:
        reduce = torch.mean if pooling == "avg" else torch.amax
        model.register_forward_hook(
            lambda module, args, out: reduce(out, dim=(1, 2)))
    return model


def preprocess_input(x):
    """'tf'-mode scaling (inception.py:49)."""
    from chambers_tpu_torch.augmentations import ImageNetNormalization

    return ImageNetNormalization(mode="tf")(x)
