"""Per-image RandAugment over uint8 batches.

Port of ``chambers_tpu/augmentations/augmentation_schemes.py`` for
``RandAugment(elementwise=True)``: the magnitude maps, the static pointwise
lookup tables, the policy warp and both compositions of a round.

Sampling is split from applying. :meth:`RandAugment.sample` draws, for each
round, the op index, the sign of the op's magnitude and the CutOut centre of
every image from a ``torch.Generator``; :meth:`RandAugment.apply` is
deterministic given those draws, so a test can feed it the draws the JAX
package made and hold the outputs bit-equal.

A round runs in one of two compositions, selected by ``fused_round_kernel``:

- fused (the default): the warp, Color, Sharpness and CutOut candidates go
  through one launch of kernel K1 (``warp_kernels.fused_round``), in which
  every image computes only its own op;
- masked: one warp of the whole batch through kernel K2
  (``warp_kernels.transform_affine_separable``), then Color, Sharpness and
  CutOut over the whole batch, each selected in by mask.

Either way the eight per-pixel-value ops (AutoContrast, Equalize, Invert,
Brightness, Contrast, Posterize, Solarize, SolarizeAdd) compose into one
``[b*c, 256]`` table applied by a single gather. The two compositions are
bit-equal.
"""

import math

import numpy as np
import torch

from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.augmentations import image_augmentations
from chambers_tpu_torch.ops import image_ops
from chambers_tpu_torch.ops import warp_kernels

_INTERPOLATION_MODE = "nearest"
_FILL_MODE = "constant"
_FILL_VALUE = 128
_MAX_MAGNITUDE = 10.0


def _magnitude_to_enhance_kwargs(magnitude):
    return {"factor": magnitude / _MAX_MAGNITUDE * 1.8 + 0.1}


def _geometric_kwargs():
    return {"interpolation": _INTERPOLATION_MODE, "fill_mode": _FILL_MODE,
            "fill_value": _FILL_VALUE}


def _magnitude_to_shear_kwargs(magnitude):
    return {"level": magnitude / _MAX_MAGNITUDE * 0.3, **_geometric_kwargs()}


def _magnitude_to_translate_kwargs(magnitude):
    return {"pixels": magnitude / _MAX_MAGNITUDE * 100, **_geometric_kwargs()}


def _magnitude_to_rotate_kwargs(magnitude):
    return {"degrees": magnitude / _MAX_MAGNITUDE * 30.0,
            **_geometric_kwargs()}


def _magnitude_to_posterize_kwargs(magnitude):
    return {"bits": int(magnitude / _MAX_MAGNITUDE * 4)}


def _magnitude_to_solarize_kwargs(magnitude):
    return {"threshold": int(magnitude / _MAX_MAGNITUDE * 256)}


def _magnitude_to_solarizeadd_kwargs(magnitude):
    return {"addition": int(magnitude / _MAX_MAGNITUDE * 110)}


def _magnitude_to_cutout_kwargs(magnitude):
    return {"mask_size": int(magnitude / _MAX_MAGNITUDE * 80),
            "constant_values": _FILL_VALUE}


_MAGNITUDE_FN_MAP = {
    "AutoContrast": lambda magnitude: {},
    "Equalize": lambda magnitude: {},
    "Invert": lambda magnitude: {},
    "Brightness": _magnitude_to_enhance_kwargs,
    "Contrast": _magnitude_to_enhance_kwargs,
    "Color": _magnitude_to_enhance_kwargs,
    "Sharpness": _magnitude_to_enhance_kwargs,
    "ShearX": _magnitude_to_shear_kwargs,
    "ShearY": _magnitude_to_shear_kwargs,
    "TranslateX": _magnitude_to_translate_kwargs,
    "TranslateY": _magnitude_to_translate_kwargs,
    "Posterize": _magnitude_to_posterize_kwargs,
    "Solarize": _magnitude_to_solarize_kwargs,
    "SolarizeAdd": _magnitude_to_solarizeadd_kwargs,
    "CutOut": _magnitude_to_cutout_kwargs,
    "Rotate": _magnitude_to_rotate_kwargs,
}


def _get_transform(transform_name, magnitude):
    transform_cls = getattr(image_augmentations, transform_name)
    return transform_cls(**_MAGNITUDE_FN_MAP[transform_name](magnitude))


def _static_pointwise_table(name, magnitude, h, w):
    """uint8 ``[256]`` lookup table for a per-pixel-value op, or None.

    Each table repeats its ``image_ops`` op's arithmetic (trunc, clip,
    threshold wrap), so a lookup is bit-equal to running the op. Contrast's
    blend target is the reference's content-independent gray ``h*w/256``,
    hence the image-size arguments."""
    v = np.arange(256, dtype=np.float32)
    vu8 = np.arange(256, dtype=np.uint8)
    if name == "Invert":
        return 255 - vu8
    if name == "Brightness":
        f = np.float32(_magnitude_to_enhance_kwargs(magnitude)["factor"])
        return np.clip(f * v, 0, 255).astype(np.uint8)
    if name == "Posterize":
        shift = 8 - _magnitude_to_posterize_kwargs(magnitude)["bits"]
        return ((vu8 >> shift) << shift).astype(np.uint8)
    if name == "Solarize":
        # thresholds wrap to uint8 (TF semantics: magnitude 10 gives
        # threshold 256 -> 0 -> full inversion)
        thr = _magnitude_to_solarize_kwargs(magnitude)["threshold"]
        return np.where(vu8 < np.uint8(thr % 256), v, 255 - v).astype(np.uint8)
    if name == "SolarizeAdd":
        add = _magnitude_to_solarizeadd_kwargs(magnitude)["addition"]
        return np.where(vu8 < np.uint8(128),
                        np.clip(v + add, 0, 255), v).astype(np.uint8)
    if name == "Contrast":
        f = np.float32(_magnitude_to_enhance_kwargs(magnitude)["factor"])
        gray = np.float32(np.uint8(np.clip(h * w / 256.0, 0, 255)))
        return np.clip(gray + f * (v - gray), 0, 255).astype(np.uint8)
    return None


def _rotation_pad(theta, h, w):
    """Fill columns per side absorbing the shear passes' excursions for
    rotations up to ``theta``: ``tan(theta/2) * (d-1)/2``, plus 2."""
    d = max(h, w)
    return int(np.ceil(np.tan(abs(theta) / 2.0) * (d - 1) / 2.0)) + 2


def _policy_warp(images, mats, max_rotation_rad=None):
    """One separable warp per policy round with per-image affine ``mats``
    ``[b, 8]`` (kernel K2). Rotations round once per shear pass, so a source
    pick can differ by one pixel from a dense rotation, as in the JAX
    package. ``max_rotation_rad`` sizes the fill padding (default 30°)."""
    theta = (max_rotation_rad if max_rotation_rad is not None
             else 30.0 * math.pi / 180.0)
    pad = _rotation_pad(theta, images.shape[1], images.shape[2])
    return image_ops.transform_affine_separable(
        images, mats, fill_value=_FILL_VALUE, pad=pad)


class RandAugment:
    """``n_transforms`` random ops per image at fixed magnitude over the
    16-op pool. Only the per-image (``elementwise=True``) policy is ported.

    ``fused_round_kernel`` selects a round's composition: True (default)
    runs kernel K1 once per round, False the masked composition over K2.
    """

    OP_NAMES = (
        "AutoContrast", "Equalize", "Invert", "Brightness", "Contrast",
        "Color", "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY",
        "Posterize", "Solarize", "SolarizeAdd", "CutOut", "Rotate",
    )
    _PROJECTIVE = {"ShearX": 7, "ShearY": 8, "TranslateX": 9,
                   "TranslateY": 10, "Rotate": 15}
    _COLOR, _SHARPNESS, _CUTOUT = 5, 6, 14
    _AUTOCONTRAST, _EQUALIZE = 0, 1
    _STATIC_LUT_OPS = (2, 3, 4, 11, 12, 13)  # Invert ... SolarizeAdd

    def __init__(self, n_transforms: int, magnitude: float,
                 elementwise: bool = False, fused_round_kernel: bool = True):
        if not elementwise:
            raise NotImplementedError(
                "Only RandAugment(elementwise=True) is ported; the "
                "whole-batch RandomChoice policy comes in a later slice.")
        self.n_transforms = n_transforms
        self.magnitude = magnitude
        self.elementwise = elementwise
        self.fused_round_kernel = fused_round_kernel
        self.transforms = [_get_transform(n, magnitude) for n in self.OP_NAMES]
        self._shear_level = magnitude / _MAX_MAGNITUDE * 0.3
        self._translate_px = magnitude / _MAX_MAGNITUDE * 100
        self._rotate_rad = magnitude / _MAX_MAGNITUDE * 30.0 * math.pi / 180.0
        classes = np.full(len(self.OP_NAMES), warp_kernels.PASSTHROUGH,
                          np.int32)
        for k_i in self._PROJECTIVE.values():
            classes[k_i] = warp_kernels.WARP
        classes[self._COLOR] = warp_kernels.COLOR
        classes[self._SHARPNESS] = warp_kernels.SHARPNESS
        if self.transforms[self._CUTOUT].mask_size:  # 0 is the identity
            classes[self._CUTOUT] = warp_kernels.CUTOUT
        self._op_classes = classes
        self._tables = {}  # (h, w, device) -> see _device_tables

    # -- sampling ------------------------------------------------------------

    def sample(self, batch, size, generator=None, device=None):
        """Draw every round's randomness: a list of ``n_transforms`` dicts
        with ``idx`` (op index, int64 ``[b]``), ``sign`` (±1 float32
        ``[b]``), ``cy`` and ``cx`` (CutOut centre, int64 ``[b]``) on
        ``device``, for images of ``size = (h, w)``."""
        device = resolve_device(device)
        h, w = size
        draws = []
        for _ in range(self.n_transforms):
            idx = torch.randint(0, len(self.OP_NAMES), (batch,),
                                generator=generator, device=device)
            sign = image_augmentations.random_sign(batch, generator, device)
            cy = torch.randint(0, h, (batch,), generator=generator,
                               device=device)
            cx = torch.randint(0, w, (batch,), generator=generator,
                               device=device)
            draws.append({"idx": idx, "sign": sign, "cy": cy, "cx": cx})
        return draws

    def __call__(self, images, generator=None):
        draws = self.sample(images.shape[0], images.shape[1:3], generator,
                            images.device)
        return self.apply(images, draws)

    # -- applying ------------------------------------------------------------

    def apply(self, images, draws):
        """Run the rounds on uint8 ``[b, h, w, 3]`` ``images`` with the given
        draws (see :meth:`sample`)."""
        for d in draws:
            idx = d["idx"]
            mats = self.round_matrices(idx, d["sign"], *images.shape[1:3])
            if self.fused_round_kernel:
                result = self._fused_round(images, mats, idx, d["cy"],
                                           d["cx"])
            else:
                result = _policy_warp(images, mats,
                                      max_rotation_rad=self._rotate_rad)
            result = self._apply_lut_ops(images, idx, result)
            if not self.fused_round_kernel:
                # the non-LUT pointwise ops over the whole batch, masked in
                for k_i in (self._COLOR, self._SHARPNESS, self._CUTOUT):
                    t = self.transforms[k_i]
                    out = (t(images, centers=(d["cy"], d["cx"]))
                           if k_i == self._CUTOUT else t(images))
                    result = torch.where((idx == k_i)[:, None, None, None],
                                         out, result)
            images = result
        return images

    def round_matrices(self, idx, sign, h, w):
        """Per-image ``[b, 8]`` affine: the sampled projective op's matrix,
        identity for images that drew another op."""
        b = idx.shape[0]
        mats = image_ops.identity_matrices(b, idx.device)
        for name, build, value in (
            ("ShearX", image_ops.shear_x_matrices, self._shear_level),
            ("ShearY", image_ops.shear_y_matrices, self._shear_level),
            ("TranslateX", image_ops.translate_x_matrices,
             self._translate_px),
            ("TranslateY", image_ops.translate_y_matrices,
             self._translate_px),
        ):
            sel = (idx == self._PROJECTIVE[name])[:, None]
            mats = torch.where(sel, build(sign * value), mats)
        sel = (idx == self._PROJECTIVE["Rotate"])[:, None]
        rot = image_ops.rotation_matrices(sign * self._rotate_rad, h, w)
        return torch.where(sel, rot, mats)

    def fused_round_args(self, images, mats, idx, cy, cx):
        """Arguments of K1 for one round (``warp_kernels.fused_round``)."""
        h, w = images.shape[1:3]
        _, classes, _ = self._device_tables(h, w, images.device)
        color = self.transforms[self._COLOR]
        sharp = self.transforms[self._SHARPNESS]
        cut = self.transforms[self._CUTOUT]
        return dict(
            images=images, transforms=mats, op_class=classes[idx],
            cut_cy=cy, cut_cx=cx, fill_value=_FILL_VALUE,
            pad=_rotation_pad(self._rotate_rad, h, w),
            color_factor=color.factor, sharp_factor=sharp.factor,
            cut_half=cut.mask_size // 2, cut_fill=cut.constant_values,
        )

    def _fused_round(self, images, mats, idx, cy, cx):
        return warp_kernels.fused_round(
            **self.fused_round_args(images, mats, idx, cy, cx))

    def _device_tables(self, h, w, device):
        """Per-op tables on the device, cached: static LUT rows ``[16, 256]``
        (identity for ops without a static table), the op -> K1 class map
        ``[16]`` and the LUT-op mask ``[16]``."""
        key = (h, w, str(device))
        if key not in self._tables:
            rows = np.tile(np.arange(256, dtype=np.uint8), (16, 1))
            for k_i in self._STATIC_LUT_OPS:
                rows[k_i] = _static_pointwise_table(self.OP_NAMES[k_i],
                                                    self.magnitude, h, w)
            is_lut = np.zeros(16, bool)
            is_lut[[self._AUTOCONTRAST, self._EQUALIZE,
                    *self._STATIC_LUT_OPS]] = True
            self._tables[key] = tuple(
                torch.from_numpy(a).to(device)
                for a in (rows, self._op_classes, is_lut))
        return self._tables[key]

    def _apply_lut_ops(self, images, idx, result):
        """The eight per-pixel-value ops as one ``[b*c, 256]`` table
        gathered per (image, channel); other images keep ``result``."""
        b, h, w, c = images.shape
        rows, _, is_lut = self._device_tables(h, w, images.device)
        lut = rows[idx].repeat_interleave(c, dim=0)  # [b*c, 256]
        idx_bc = idx.repeat_interleave(c)[:, None]
        lut = torch.where(idx_bc == self._AUTOCONTRAST,
                          image_ops.autocontrast_luts(images), lut)
        lut = torch.where(idx_bc == self._EQUALIZE,
                          image_ops.equalize_luts(images), lut)
        lut_out = image_ops.apply_channel_luts(images, lut)
        return torch.where(is_lut[idx][:, None, None, None], lut_out, result)
