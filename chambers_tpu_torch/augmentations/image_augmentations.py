"""Image-augmentation ops over batched uint8 NHWC tensors.

Port of ``chambers_tpu/augmentations/image_augmentations.py``. Each op is a
callable ``op(images, generator=None)`` over a whole ``[b, h, w, c]``
batch and keeps the attributes the policies read (``factor``,
``mask_size``, ``constant_values``, ...).

Sampling is split from applying: ``op.sample(batch, size, generator,
device)`` returns the op's draws (``{}`` for a deterministic op, ``sign``
for a warp, ``cy``/``cx`` for CutOut) and ``op.apply(images, draws)`` is
deterministic given them, so a test can feed the draws the JAX package
made. ``op(images, generator)`` is ``apply(images, sample(...))``.

``RandomChance`` and ``RandomChoice`` decide per batch (one decision for
the whole batch: drawn on a host ``torch.Generator`` as a Python value, so
choosing a branch never waits for the card) or per image
(``elementwise=True``: every candidate is computed and a mask or gather
selects, as in the JAX package).
"""

import math

import numpy as np
import torch

from chambers_tpu_torch.ops import image_ops


def to_device(draws, device):
    """``draws`` (nested dicts and lists of tensors and Python values) with
    every tensor on ``device``. Host tensors go to a card through pinned
    memory without blocking, so a copy never waits for queued work;
    ``device=None`` leaves them where they are."""
    if device is None:
        return draws
    if isinstance(draws, dict):
        return {k: to_device(v, device) for k, v in draws.items()}
    if isinstance(draws, list):
        return [to_device(v, device) for v in draws]
    if isinstance(draws, torch.Tensor) and draws.device != torch.device(
            device):
        if torch.device(device).type == "cuda" and draws.device.type == "cpu":
            return draws.pin_memory().to(device, non_blocking=True)
        return draws.to(device)
    return draws


def host_generator(generator):
    """``generator``, which must draw on the host: a decision taken for the
    whole batch is a Python value."""
    if generator is not None and generator.device.type != "cpu":
        raise ValueError("a per-batch decision draws on a host (CPU) "
                         "torch.Generator, so that choosing a branch never "
                         "waits for the card; got one on "
                         f"{generator.device}")
    return generator


class ImageAugmentation:
    """Base class: a deterministic op draws nothing."""

    stochastic = False

    def sample(self, batch, size, generator=None, device=None):
        """This op's draws for ``batch`` images of ``size = (h, w)``."""
        return {}

    def apply(self, images, draws):
        """The op on ``images`` with the given draws."""
        return self(images)

    def __call__(self, images, generator=None):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class _Random(ImageAugmentation):
    """A random op: ``op(images, generator)`` is ``apply(images,
    sample(...))`` with the draws made on the images' device."""

    stochastic = True

    def __call__(self, images, generator=None):
        return self.apply(images, self.sample(
            images.shape[0], images.shape[1:3], generator, images.device))


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


class _Geometric(_Random):
    """A warp whose magnitude flips sign per image (``sign``, ``[b]``),
    nearest or bilinear."""

    def __init__(self, interpolation="nearest", fill_mode="constant",
                 fill_value=0):
        if fill_mode != "constant":
            raise NotImplementedError("Only fill_mode='constant' is supported.")
        self.interpolation = interpolation
        self.fill_mode = fill_mode
        self.fill_value = fill_value

    def _matrices(self, signed, h, w):
        raise NotImplementedError

    def sample(self, batch, size, generator=None, device=None):
        return {"sign": random_sign(batch, generator, device)}

    def apply(self, images, draws):
        h, w = images.shape[1:3]
        mats = self._matrices(draws["sign"].to(images.device), h, w)
        return image_ops.transform(images, mats, self.fill_value,
                                   self.interpolation)


class Rotate(_Geometric):
    def __init__(self, degrees, interpolation="nearest", fill_mode="constant",
                 fill_value=0):
        super().__init__(interpolation, fill_mode, fill_value)
        self.degrees = degrees
        self._radians = degrees * math.pi / 180.0

    def _matrices(self, sign, h, w):
        return image_ops.rotation_matrices(sign * self._radians, h, w)


class ShearX(_Geometric):
    def __init__(self, level, interpolation="nearest", fill_mode="constant",
                 fill_value=0):
        super().__init__(interpolation, fill_mode, fill_value)
        self.level = level

    def _matrices(self, sign, h, w):
        return image_ops.shear_x_matrices(sign * self.level)


class ShearY(_Geometric):
    def __init__(self, level, interpolation="nearest", fill_mode="constant",
                 fill_value=0):
        super().__init__(interpolation, fill_mode, fill_value)
        self.level = level

    def _matrices(self, sign, h, w):
        return image_ops.shear_y_matrices(sign * self.level)


class TranslateX(_Geometric):
    def __init__(self, pixels, interpolation="nearest", fill_mode="constant",
                 fill_value=0):
        super().__init__(interpolation, fill_mode, fill_value)
        self.pixels = pixels

    def _matrices(self, sign, h, w):
        return image_ops.translate_x_matrices(sign * self.pixels)


class TranslateY(_Geometric):
    def __init__(self, pixels, interpolation="nearest", fill_mode="constant",
                 fill_value=0):
        super().__init__(interpolation, fill_mode, fill_value)
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

    def sample(self, batch, size, generator=None, device=None):
        h, w = size
        return {"cy": torch.randint(0, h, (batch,), generator=generator,
                                    device=device),
                "cx": torch.randint(0, w, (batch,), generator=generator,
                                    device=device)}

    def apply(self, images, draws):
        return self(images, centers=(draws["cy"], draws["cx"]))

    def __call__(self, images, generator=None, centers=None):
        if self.mask_size == 0:
            return images
        if centers is None:
            d = self.sample(images.shape[0], images.shape[1:3], generator,
                            images.device)
            centers = (d["cy"], d["cx"])
        cy, cx = centers
        return image_ops.cutout(images, cy, cx, self.mask_size,
                                self.constant_values)


# ---------------------------------------------------------------------------
# combinators
# ---------------------------------------------------------------------------

class RandomChance(_Random):
    """Apply ``transform`` with probability ``probability``.

    ``elementwise=False`` takes one decision for the whole batch (``do``, a
    Python bool drawn on a host generator, and the transform's draws
    moved to ``device``); ``elementwise=True`` one per image (``do``, bool
    ``[b]``, drawn on ``device``) and selects the transformed images by
    mask, as the JAX package does."""

    def __init__(self, transform, probability, elementwise=False):
        self.transform = transform
        self.probability = probability
        self.elementwise = elementwise

    def sample(self, batch, size, generator=None, device=None):
        if self.elementwise:
            u = torch.rand(batch, generator=generator, device=device)
            return {"do": u < self.probability,
                    "draws": self.transform.sample(batch, size, generator,
                                                   device)}
        generator = host_generator(generator)
        do = float(torch.rand((), generator=generator)) < self.probability
        return {"do": do, "draws": to_device(self.transform.sample(
            batch, size, generator, "cpu"), device)}

    def apply(self, images, draws):
        if self.elementwise:
            out = self.transform.apply(images, draws["draws"])
            return torch.where(draws["do"][:, None, None, None], out, images)
        if draws["do"]:
            return self.transform.apply(images, draws["draws"])
        return images


class RandomChoice(_Random):
    """Apply ``n_transforms`` rounds, each of one transform chosen
    uniformly from ``transforms``.

    ``elementwise=False``: one choice a round for the whole batch (``idx``,
    a Python int from a host generator) with the chosen transform's draws;
    only that transform runs. ``elementwise=True``: one choice per image
    (``idx``, int64 ``[b]``) with every transform's draws (``ops``); every
    candidate is computed over the whole batch and a gather selects."""

    def __init__(self, transforms, n_transforms, elementwise=False):
        self.transforms = list(transforms)
        self.n_transforms = n_transforms
        self.elementwise = elementwise

    def sample(self, batch, size, generator=None, device=None):
        n = len(self.transforms)
        rounds = []
        for _ in range(self.n_transforms):
            if self.elementwise:
                idx = torch.randint(0, n, (batch,), generator=generator,
                                    device=device)
                rounds.append({"idx": idx, "ops": [
                    t.sample(batch, size, generator, device)
                    for t in self.transforms]})
            else:
                generator = host_generator(generator)
                idx = int(torch.randint(0, n, (), generator=generator))
                rounds.append({"idx": idx, "draws": to_device(
                    self.transforms[idx].sample(batch, size, generator,
                                                "cpu"), device)})
        return rounds

    def apply(self, images, draws):
        for r in draws:
            if self.elementwise:
                outs = torch.stack([t.apply(images, d) for t, d in
                                    zip(self.transforms, r["ops"])])
                b = images.shape[0]
                images = outs[r["idx"].to(images.device),
                              torch.arange(b, device=images.device)]
            else:
                images = self.transforms[r["idx"]].apply(images, r["draws"])
        return images


# ---------------------------------------------------------------------------
# normalization / resizing
# ---------------------------------------------------------------------------

class ImageNetNormalization:
    """ImageNet input scaling in three modes, float32 out: ``caffe`` (RGB to
    BGR, minus the BGR means), ``tf`` (``x / 127.5 - 1``, to [-1, 1]),
    ``torch`` (``x / 255``, minus the means, over the deviations).

    Every division is a tensor over a tensor, which rounds once on the CPU
    and on the card alike (PyTorch's CUDA kernels turn a division by a
    Python number into a product with its reciprocal); that is the JAX
    package's arithmetic op by op. Under ``jit`` XLA fuses ``x * (1 /
    127.5) - 1`` into one rounding instead: within one float32 step. The
    constants are made on the images' device once and kept."""

    _CAFFE_MEAN = (103.939, 116.779, 123.68)
    _TORCH_MEAN = (0.485, 0.456, 0.406)
    _TORCH_STD = (0.229, 0.224, 0.225)

    def __init__(self, mode="caffe"):
        if mode not in {"caffe", "tf", "torch"}:
            raise ValueError("Unknown mode " + str(mode))
        self.mode = mode
        self._constants = {}  # device -> (mean, std or None)

    def _mean_std(self, device):
        key = str(device)
        if key not in self._constants:
            mean = self._CAFFE_MEAN if self.mode == "caffe" else (
                self._TORCH_MEAN)
            std = self._TORCH_STD if self.mode == "torch" else None
            self._constants[key] = tuple(
                None if v is None else torch.tensor(v, device=device)
                for v in (mean, std))
        return self._constants[key]

    def __call__(self, x):
        x = torch.as_tensor(x).to(torch.float32)
        if self.mode == "tf":
            return x / torch.full((), 127.5, device=x.device) - 1.0
        mean, std = self._mean_std(x.device)
        if self.mode == "torch":
            x = x / torch.full((), 255.0, device=x.device)
            return (x - mean) / std
        return x.flip(-1) - mean


class ResizingMinMax:
    """Aspect-preserving resize so that the short side is ``min_side``
    and/or the long side at most ``max_side`` (``image_ops.resize``);
    integer images are rounded and clipped back."""

    def __init__(self, min_side=None, max_side=None,
                 interpolation="bilinear"):
        if min_side is None and max_side is None:
            raise ValueError("Must specify either 'min_side' or 'max_side'.")
        self.min_side = min_side
        self.max_side = max_side
        self.interpolation = interpolation

    def __call__(self, images):
        h, w = images.shape[1], images.shape[2]
        if self.min_side is not None and self.max_side is not None:
            scale = min(self.max_side / max(h, w), self.min_side / min(h, w))
        elif self.min_side is not None:
            scale = self.min_side / min(h, w)
        else:
            scale = self.max_side / max(h, w)
        return resize_like(images, (int(h * scale), int(w * scale)),
                           self.interpolation)


def resize_like(images, size, interpolation):
    """``image_ops.resize`` back in the images' dtype: integer images are
    rounded half to even and clipped to [0, 255]."""
    out = image_ops.resize(images, size, interpolation)
    if not images.is_floating_point():
        out = torch.round(out.clamp(0, 255))
    return out.to(images.dtype)
