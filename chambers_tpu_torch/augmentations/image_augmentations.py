"""Image-augmentation ops over batched uint8 NHWC tensors.

Port of ``chambers_tpu/augmentations/image_augmentations.py`` for the ops
RandAugment samples. Each op is a callable ``op(images, generator=None)``
over a whole ``[b, h, w, c]`` uint8 batch and keeps the attributes
``RandAugment`` reads (``factor``, ``mask_size``, ``constant_values``, …).
Random signs come from an explicit ``torch.Generator``; CutOut also takes
its centres explicitly so a caller can replay a draw. ``RandomChoice`` and
the whole-batch (non-elementwise) path come in a later slice.
"""

import math

import torch

from chambers_tpu_torch.ops import image_ops


class ImageAugmentation:
    """Base class: deterministic ops ignore ``generator``."""

    stochastic = False

    def __call__(self, images, generator=None):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class AutoContrast(ImageAugmentation):
    def __call__(self, images, generator=None):
        return image_ops.autocontrast(images)


class Equalize(ImageAugmentation):
    def __call__(self, images, generator=None):
        return image_ops.equalize(images)


class Invert(ImageAugmentation):
    def __call__(self, images, generator=None):
        return image_ops.invert(images)


class Posterize(ImageAugmentation):
    def __init__(self, bits):
        self.bits = bits

    def __call__(self, images, generator=None):
        return image_ops.posterize(images, self.bits)


class Solarize(ImageAugmentation):
    def __init__(self, threshold=128):
        self.threshold = threshold

    def __call__(self, images, generator=None):
        return image_ops.solarize(images, self.threshold)


class SolarizeAdd(ImageAugmentation):
    def __init__(self, addition=0, threshold=128):
        self.addition = addition
        self.threshold = threshold

    def __call__(self, images, generator=None):
        return image_ops.solarize_add(images, self.addition, self.threshold)


class _Enhance(ImageAugmentation):
    _op = None

    def __init__(self, factor):
        self.factor = factor

    def __call__(self, images, generator=None):
        return type(self)._op(images, self.factor)


class Color(_Enhance):
    _op = staticmethod(image_ops.color)


class Contrast(_Enhance):
    _op = staticmethod(image_ops.contrast)


class Brightness(_Enhance):
    _op = staticmethod(image_ops.brightness)


class Sharpness(_Enhance):
    _op = staticmethod(image_ops.sharpness)


def random_sign(batch, generator=None, device=None):
    """±1 per image with equal probability (float32 ``[b]``)."""
    u = torch.rand(batch, generator=generator, device=device)
    return torch.where(u < 0.5, -1.0, 1.0)


class _Geometric(ImageAugmentation):
    """A warp whose magnitude flips sign per image."""

    stochastic = True

    def __init__(self, interpolation="nearest", fill_mode="constant",
                 fill_value=0):
        if fill_mode != "constant":
            raise NotImplementedError("Only fill_mode='constant' is supported.")
        if interpolation != "nearest":
            raise NotImplementedError("Only nearest interpolation is ported.")
        self.interpolation = interpolation
        self.fill_mode = fill_mode
        self.fill_value = fill_value

    def _matrices(self, signed, h, w):
        raise NotImplementedError

    def __call__(self, images, generator=None):
        b, h, w = images.shape[:3]
        sign = random_sign(b, generator, images.device)
        return image_ops.transform(images, self._matrices(sign, h, w),
                                   fill_value=self.fill_value)


class Rotate(_Geometric):
    def __init__(self, degrees, **kwargs):
        super().__init__(**kwargs)
        self.degrees = degrees
        self._radians = degrees * math.pi / 180.0

    def _matrices(self, sign, h, w):
        return image_ops.rotation_matrices(sign * self._radians, h, w)


class ShearX(_Geometric):
    def __init__(self, level, **kwargs):
        super().__init__(**kwargs)
        self.level = level

    def _matrices(self, sign, h, w):
        return image_ops.shear_x_matrices(sign * self.level)


class ShearY(_Geometric):
    def __init__(self, level, **kwargs):
        super().__init__(**kwargs)
        self.level = level

    def _matrices(self, sign, h, w):
        return image_ops.shear_y_matrices(sign * self.level)


class TranslateX(_Geometric):
    def __init__(self, pixels, **kwargs):
        super().__init__(**kwargs)
        self.pixels = pixels

    def _matrices(self, sign, h, w):
        return image_ops.translate_x_matrices(sign * self.pixels)


class TranslateY(_Geometric):
    def __init__(self, pixels, **kwargs):
        super().__init__(**kwargs)
        self.pixels = pixels

    def _matrices(self, sign, h, w):
        return image_ops.translate_y_matrices(sign * self.pixels)


class CutOut(ImageAugmentation):
    """A ``mask_size`` square of ``constant_values`` per image at uniform
    random centres, or at ``centers=(cy, cx)`` (``[b]`` each) when given."""

    stochastic = True

    def __init__(self, mask_size, constant_values=0):
        self.mask_size = mask_size
        self.constant_values = constant_values

    def __call__(self, images, generator=None, centers=None):
        if self.mask_size == 0:
            return images
        b, h, w = images.shape[:3]
        if centers is None:
            dev = images.device
            centers = (torch.randint(0, h, (b,), generator=generator,
                                     device=dev),
                       torch.randint(0, w, (b,), generator=generator,
                                     device=dev))
        cy, cx = centers
        return image_ops.cutout(images, cy, cx, self.mask_size,
                                self.constant_values)
