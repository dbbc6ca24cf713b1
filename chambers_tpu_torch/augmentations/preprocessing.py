"""Keras-preprocessing-layer equivalents (port of
``chambers_tpu/augmentations/preprocessing.py``): ``Resizing``,
``Rescaling``, ``CenterCrop``, ``RandomCrop``, ``RandomFlip``,
``RandomRotation``, ``RandomTranslation``, ``RandomZoom``,
``RandomContrast``, ``RandomHeight`` and ``RandomWidth``.

Every layer takes ``[b, h, w, c]`` batches; integer images stay integer
through the geometric layers (nearest, or bilinear with rounding) and
``Rescaling`` returns float32. The random layers draw per image, except
``RandomHeight`` and ``RandomWidth``, whose one factor a call sets the
output's shape and is drawn on the host. As in the JAX package, a layer
called with ``training=False`` or without a ``generator`` is
deterministic (identity, or ``RandomCrop``'s centre crop).

Sampling is split from applying: ``layer.sample(batch, size, generator,
device)`` returns the draws, ``layer.apply(images, draws)`` uses them.
"""

import math

import numpy as np
import torch

from chambers_tpu_torch.augmentations.image_augmentations import (
    host_generator,
    resize_like,
)
from chambers_tpu_torch.ops import image_ops


def _pair(value):
    if isinstance(value, (tuple, list)):
        return float(value[0]), float(value[1])
    v = float(value)
    return -v, v


def _uniform(shape, low, high, generator, device):
    """Uniform float32 draws on ``[low, high)``."""
    u = torch.rand(shape, generator=generator, device=device)
    return u * float(np.float32(high - low)) + float(np.float32(low))


class _Layer:
    """A preprocessing layer: ``layer(images, generator=None,
    training=True)`` is ``apply(images, sample(...))`` when training with
    a generator, else the deterministic form."""

    def sample(self, batch, size, generator=None, device=None):
        return {}

    def apply(self, images, draws):
        return self.deterministic(images)

    def deterministic(self, images):
        return images

    def __call__(self, images, generator=None, training=True):
        if not training or generator is None:
            return self.deterministic(images)
        return self.apply(images, self.sample(
            images.shape[0], images.shape[1:3], generator, images.device))


class Resizing(_Layer):
    """Resize to ``(height, width)`` (``image_ops.resize``)."""

    def __init__(self, height, width, interpolation="bilinear"):
        self.height = height
        self.width = width
        self.interpolation = interpolation

    def deterministic(self, images):
        return resize_like(images, (self.height, self.width),
                           self.interpolation)


class Rescaling(_Layer):
    """``x * scale + offset`` in float32."""

    def __init__(self, scale, offset=0.0):
        self.scale = scale
        self.offset = offset

    def deterministic(self, images):
        return images.to(torch.float32) * self.scale + self.offset


class CenterCrop(_Layer):
    def __init__(self, height, width):
        self.height = height
        self.width = width

    def deterministic(self, images):
        h, w = images.shape[1], images.shape[2]
        top = (h - self.height) // 2
        left = (w - self.width) // 2
        if top < 0 or left < 0:
            raise ValueError(
                f"Crop size ({self.height}, {self.width}) larger than input "
                f"({h}, {w}).")
        return images[:, top:top + self.height, left:left + self.width]


class RandomCrop(_Layer):
    """A crop of ``(height, width)`` at a uniform offset per image
    (``tops``, ``lefts``); an input smaller than the crop is first resized
    up, keeping its aspect, to fit it. Without a generator, the centre
    crop."""

    def __init__(self, height, width):
        self.height = height
        self.width = width

    def fitted_size(self, size):
        """The size of images of ``size`` after :meth:`_fit`."""
        h, w = size
        if h >= self.height and w >= self.width:
            return h, w
        scale = max(self.height / h, self.width / w)
        return (max(int(np.ceil(h * scale)), self.height),
                max(int(np.ceil(w * scale)), self.width))

    def _fit(self, images):
        size = self.fitted_size(tuple(images.shape[1:3]))
        if size == tuple(images.shape[1:3]):
            return images
        return Resizing(*size).deterministic(images)

    def sample(self, batch, size, generator=None, device=None):
        h, w = self.fitted_size(size)
        return {"tops": torch.randint(0, h - self.height + 1, (batch,),
                                      generator=generator, device=device),
                "lefts": torch.randint(0, w - self.width + 1, (batch,),
                                       generator=generator, device=device)}

    def deterministic(self, images):
        return CenterCrop(self.height, self.width).deterministic(
            self._fit(images))

    def apply(self, images, draws):
        """Each image's crop, gathered: the JAX package translates each
        image by its offset (nearest, never out of bounds) and slices."""
        images = self._fit(images)
        dev = images.device
        b = images.shape[0]
        rows = (draws["tops"].to(dev)[:, None]
                + torch.arange(self.height, device=dev)[None])
        cols = (draws["lefts"].to(dev)[:, None]
                + torch.arange(self.width, device=dev)[None])
        bidx = torch.arange(b, device=dev)[:, None, None]
        return images[bidx, rows[:, :, None], cols[:, None, :]]


class RandomFlip(_Layer):
    """Per-image flips, each with probability 1/2: ``horizontal`` and
    ``vertical`` (bool ``[b]``)."""

    def __init__(self, mode="horizontal_and_vertical"):
        if mode not in ("horizontal", "vertical", "horizontal_and_vertical"):
            raise ValueError(f"Unknown flip mode '{mode}'")
        self.mode = mode

    def sample(self, batch, size, generator=None, device=None):
        draws = {}
        for axis in ("horizontal", "vertical"):
            u = torch.rand(batch, generator=generator, device=device)
            if axis in self.mode:
                draws[axis] = u < 0.5
        return draws

    def apply(self, images, draws):
        out = images
        for axis, dim in (("horizontal", 2), ("vertical", 1)):
            if axis in draws:
                do = draws[axis].to(images.device)[:, None, None, None]
                out = torch.where(do, out.flip(dim), out)
        return out


class RandomRotation(_Layer):
    """Per-image rotation by an angle uniform over ``factor`` of a full
    turn (Keras: ``0.1`` is ±10% of 2π), ``angles`` ``[b]`` in radians."""

    def __init__(self, factor, interpolation="bilinear", fill_value=0.0):
        self.lower, self.upper = _pair(factor)
        self.interpolation = interpolation
        self.fill_value = fill_value

    def sample(self, batch, size, generator=None, device=None):
        return {"angles": _uniform(batch, self.lower * 2 * math.pi,
                                   self.upper * 2 * math.pi, generator,
                                   device)}

    def apply(self, images, draws):
        return image_ops.rotate(images, draws["angles"], self.interpolation,
                                self.fill_value)


class RandomTranslation(_Layer):
    """Per-image translation by uniform fractions of the height and width:
    ``dy`` and ``dx`` ``[b]`` in pixels."""

    def __init__(self, height_factor, width_factor,
                 interpolation="bilinear", fill_value=0.0):
        self.height_range = _pair(height_factor)
        self.width_range = _pair(width_factor)
        self.interpolation = interpolation
        self.fill_value = fill_value

    def sample(self, batch, size, generator=None, device=None):
        h, w = size
        dy = _uniform(batch, *self.height_range, generator, device) * h
        dx = _uniform(batch, *self.width_range, generator, device) * w
        return {"dy": dy, "dx": dx}

    def apply(self, images, draws):
        shifts = torch.stack([draws["dx"], draws["dy"]], dim=1)
        return image_ops.translate(images, shifts, self.interpolation,
                                   self.fill_value)


class RandomZoom(_Layer):
    """Per-image zoom about the centre by ``1 + u``: ``zy`` and ``zx``
    ``[b]`` (``zx`` is ``zy`` without a ``width_factor``)."""

    def __init__(self, height_factor, width_factor=None,
                 interpolation="bilinear", fill_value=0.0):
        self.height_range = _pair(height_factor)
        self.width_range = (_pair(width_factor) if width_factor is not None
                            else None)
        self.interpolation = interpolation
        self.fill_value = fill_value

    def sample(self, batch, size, generator=None, device=None):
        zy = 1.0 + _uniform(batch, *self.height_range, generator, device)
        zx = (zy if self.width_range is None else
              1.0 + _uniform(batch, *self.width_range, generator, device))
        return {"zy": zy, "zx": zx}

    def apply(self, images, draws):
        h, w = images.shape[1], images.shape[2]
        zy = draws["zy"].to(images.device, torch.float32)
        zx = draws["zx"].to(images.device, torch.float32)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        z = torch.zeros_like(zx)
        mats = torch.stack([zx, z, cx * (1 - zx), z, zy, cy * (1 - zy), z, z],
                           dim=1)
        return image_ops.transform(images, mats, self.fill_value,
                                   self.interpolation)


class RandomContrast(_Layer):
    """Per-image contrast about each channel's spatial mean, ``(x - mean)
    * f + mean`` with ``factors`` ``[b]`` uniform on ``[1 - lower, 1 +
    upper]`` (a tuple gives the two bounds as positive numbers). Integer
    images are rounded and clipped back. The mean sums in float64 (the
    sum of 8-bit values is exact either way) and divides once in
    float32."""

    def __init__(self, factor):
        if isinstance(factor, (tuple, list)):
            lower, upper = float(factor[0]), float(factor[1])
        else:
            lower = upper = float(factor)
        self.lower, self.upper = max(1.0 - lower, 0.0), 1.0 + upper

    def sample(self, batch, size, generator=None, device=None):
        return {"factors": _uniform(batch, self.lower, self.upper, generator,
                                    device)}

    def apply(self, images, draws):
        x = images.to(torch.float32)
        total = x.to(torch.float64).sum(dim=(1, 2), keepdim=True).to(
            torch.float32)
        mean = total / torch.full_like(total, x.shape[1] * x.shape[2])
        factors = draws["factors"].to(x.device, torch.float32)
        out = (x - mean) * factors[:, None, None, None] + mean
        if not images.is_floating_point():
            out = torch.round(out.clamp(0, 255))
        return out.to(images.dtype)


class _RandomSide(_Layer):
    """One factor ``1 + u`` a call, drawn on the host (it sets the output's
    shape), and a resize of one side by it."""

    _axis = 1

    def __init__(self, factor, interpolation="bilinear"):
        self.lower, self.upper = _pair(factor)
        self.interpolation = interpolation

    def sample(self, batch, size, generator=None, device=None):
        u = float(torch.rand((), generator=host_generator(generator)))
        return {"factor": 1.0 + float(
            np.float32(self.lower + u * (self.upper - self.lower)))}

    def apply(self, images, draws):
        size = list(images.shape[1:3])
        size[self._axis - 1] = max(int(size[self._axis - 1]
                                       * draws["factor"]), 1)
        return resize_like(images, tuple(size), self.interpolation)


class RandomHeight(_RandomSide):
    """Batch-level random height scaling (one factor a call)."""

    _axis = 1


class RandomWidth(_RandomSide):
    """Batch-level random width scaling (one factor a call)."""

    _axis = 2
