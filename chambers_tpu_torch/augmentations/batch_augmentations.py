"""Batch-level label mixing: MixUp and CutMix (port of
``chambers_tpu/augmentations/batch_augmentations.py``).

Each op takes ``(images, labels)`` and returns the mixed images and soft
labels ``[b, classes]``; integer labels are one-hot encoded with optional
label smoothing. The partner of image ``i`` is image ``b - 1 - i`` (the
flipped batch).

Sampling is split from applying: ``op.sample(batch, size, generator,
device)`` draws on a host ``torch.Generator`` and returns Python numbers
(a per-batch ``lam``, CutMix's box centre) or tensors moved to ``device``
(MixUp's per-image ``lam``); ``op.apply(images, labels, draws)`` is
deterministic given them, so a test can feed the JAX package's draws.
``jax.random.beta`` has no PyTorch counterpart that takes a generator, so
Beta draws come from a numpy ``Generator`` seeded from the torch one.

Mixing computes ``lam * x + (1 - lam) * partner`` as XLA does under
``jit``, where the JAX package's pipelines run it: the first product
rounded to float32, the second fused with the sum into one rounding (a
fused multiply-add, emulated in float64, where the fused result is exact
up to that rounding), so integer images round to the same values.
"""

import numpy as np
import torch

from chambers_tpu_torch.augmentations.image_augmentations import (
    host_generator,
    to_device,
)


def _as_soft_labels(labels, num_classes, label_smoothing, device):
    """Integer ``[b]`` labels one-hot, smoothed to ``1 - s + s/n`` and
    ``s/n``; ``[b, n]`` targets as float32."""
    labels = torch.as_tensor(labels, device=device)
    if labels.ndim == 1:
        if num_classes is None:
            raise ValueError(
                "integer labels need num_classes= to one-hot encode")
        on = 1.0 - label_smoothing + label_smoothing / num_classes
        off = label_smoothing / num_classes
        one_hot = torch.nn.functional.one_hot(labels.to(torch.int64),
                                              num_classes).to(torch.float32)
        return one_hot * (on - off) + off
    return labels.to(torch.float32)


def _convex(lam, x, partner):
    """``lam * x + (1 - lam) * partner`` in float32 with the second product
    fused into the sum (see the module notes). ``lam`` is a float32 Python
    number or a float32 tensor that broadcasts against ``x``."""
    if isinstance(lam, torch.Tensor):
        rest = 1.0 - lam
    else:
        lam = float(np.float32(lam))
        rest = float(np.float32(1) - np.float32(lam))
    first = (lam * x).to(torch.float64)
    return (rest * partner.to(torch.float64) + first).to(torch.float32)


def _mix_images(images, partner, lam):
    """Mix in float32 and give back the images' dtype: integer images are
    rounded half to even and clipped to the type's range."""
    mixed = _convex(lam, images.to(torch.float32), partner.to(torch.float32))
    if images.is_floating_point():
        return mixed.to(images.dtype)
    info = torch.iinfo(images.dtype)
    return torch.round(mixed).clamp(info.min, info.max).to(images.dtype)


def _beta(generator, alpha, size=None):
    """Beta(alpha, alpha) in float32 from a numpy generator seeded by
    ``generator`` (one draw of its 62-bit integers)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return np.float32(np.random.default_rng(seed).beta(alpha, alpha, size))


class MixUp:
    """mixup: each image and its target convex-combined with the flipped
    batch, ``lam ~ Beta(alpha, alpha)``; one ``lam`` for the batch, or one
    per image with ``per_example=True``."""

    stochastic = True

    def __init__(self, alpha=0.2, num_classes=None, label_smoothing=0.0,
                 per_example=False):
        if alpha <= 0:
            raise ValueError(f"alpha={alpha} must be > 0")
        self.alpha = float(alpha)
        self.num_classes = num_classes
        self.label_smoothing = float(label_smoothing)
        self.per_example = per_example

    def sample(self, batch, size=None, generator=None, device=None):
        """``{"lam": ...}``: a float32 Python number, or a float32 ``[b]``
        tensor on ``device`` with ``per_example``."""
        generator = host_generator(generator)
        if self.per_example:
            lam = torch.from_numpy(_beta(generator, self.alpha, batch))
            return {"lam": to_device(lam, device)}
        return {"lam": float(_beta(generator, self.alpha))}

    def apply(self, images, labels, draws):
        y = _as_soft_labels(labels, self.num_classes, self.label_smoothing,
                            images.device)
        lam = draws["lam"]
        if isinstance(lam, torch.Tensor):
            lam = lam.to(device=images.device, dtype=torch.float32)
            lam_img, lam_lab = lam[:, None, None, None], lam[:, None]
        else:
            lam_img = lam_lab = lam
        mixed = _mix_images(images, images.flip(0), lam_img)
        return mixed, _convex(lam_lab, y, y.flip(0))

    def __call__(self, images, labels, generator=None, training=True):
        if not training:
            return images, _as_soft_labels(
                labels, self.num_classes, self.label_smoothing, images.device)
        return self.apply(images, labels, self.sample(
            images.shape[0], images.shape[1:3], generator, images.device))


class CutMix:
    """cutmix: a box of the flipped batch pasted over each image, the
    targets mixed by the pasted share of the pixels.

    One ``lam ~ Beta(alpha, alpha)`` and one box centre for the batch. The
    box has sides ``sqrt(1 - lam)`` times the image's and is clipped at the
    borders; the label weight is the share of pixels kept after clipping.
    The box is a function of the draws alone, so it and its share are
    computed on the host, as float32 as the JAX package computes them."""

    stochastic = True

    def __init__(self, alpha=1.0, num_classes=None, label_smoothing=0.0):
        if alpha <= 0:
            raise ValueError(f"alpha={alpha} must be > 0")
        self.alpha = float(alpha)
        self.num_classes = num_classes
        self.label_smoothing = float(label_smoothing)

    def sample(self, batch, size, generator=None, device=None):
        """``{"lam", "cy", "cx"}``, float32 Python numbers: the Beta draw
        and the box centre, uniform over ``[0, h)`` and ``[0, w)``."""
        generator = host_generator(generator)
        h, w = size
        lam = float(_beta(generator, self.alpha))
        u = torch.rand(2, generator=generator, dtype=torch.float64).numpy()
        return {"lam": lam, "cy": float(np.float32(u[0] * h)),
                "cx": float(np.float32(u[1] * w))}

    def box(self, size, draws):
        """``(in_box, lam_real)``: the ``[h, w]`` bool box and the share of
        pixels it leaves, a float32 Python number."""
        f32 = np.float32
        h, w = size
        cut = np.sqrt(f32(1) - f32(draws["lam"]))
        half_h, half_w = f32(0.5) * cut * f32(h), f32(0.5) * cut * f32(w)
        rows = np.arange(h, dtype=f32)[:, None]
        cols = np.arange(w, dtype=f32)[None, :]
        in_box = ((np.abs(rows + f32(0.5) - f32(draws["cy"])) < half_h)
                  & (np.abs(cols + f32(0.5) - f32(draws["cx"])) < half_w))
        kept = f32(1) - f32(in_box.sum()) / f32(h * w)
        return in_box, float(kept)

    def apply(self, images, labels, draws):
        y = _as_soft_labels(labels, self.num_classes, self.label_smoothing,
                            images.device)
        in_box, lam_real = self.box(images.shape[1:3], draws)
        mask = to_device(torch.from_numpy(in_box), images.device)
        mixed = torch.where(mask[None, :, :, None], images.flip(0), images)
        return mixed, _convex(lam_real, y, y.flip(0))

    def __call__(self, images, labels, generator=None, training=True):
        if not training:
            return images, _as_soft_labels(
                labels, self.num_classes, self.label_smoothing, images.device)
        return self.apply(images, labels, self.sample(
            images.shape[0], images.shape[1:3], generator, images.device))


def sample_mixup_or_cutmix(batch, size, generator=None, *, mixup, cutmix,
                           switch_prob=0.5, device=None):
    """The draws of :func:`mixup_or_cutmix`: ``{"use_cutmix": bool,
    "draws": ...}``, the coin and the chosen op's draws, on a host
    generator."""
    generator = host_generator(generator)
    use_cutmix = float(torch.rand((), generator=generator)) < switch_prob
    op = cutmix if use_cutmix else mixup
    return {"use_cutmix": use_cutmix,
            "draws": op.sample(batch, size, generator, device)}


def mixup_or_cutmix(images, labels, generator=None, *, mixup, cutmix,
                    switch_prob=0.5, training=True, draws=None):
    """MixUp or CutMix, one coin for the batch (timm's ``switch_prob``):
    with probability ``switch_prob`` CutMix. ``draws`` (from
    :func:`sample_mixup_or_cutmix`) replaces the generator's; only the
    chosen op runs. Not training: MixUp's soft labels, images unchanged."""
    if not training:
        return mixup(images, labels, training=False)
    if draws is None:
        draws = sample_mixup_or_cutmix(
            images.shape[0], images.shape[1:3], generator, mixup=mixup,
            cutmix=cutmix, switch_prob=switch_prob, device=images.device)
    op = cutmix if draws["use_cutmix"] else mixup
    return op.apply(images, labels, draws["draws"])
