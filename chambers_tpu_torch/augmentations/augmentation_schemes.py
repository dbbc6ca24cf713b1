"""RandAugment and AutoAugment over uint8 batches.

Port of ``chambers_tpu/augmentations/augmentation_schemes.py``: the
magnitude maps, the static pointwise lookup tables, the policy warp, both
compositions of a per-image round (AutoAugment's stage is the same round
with its own draws, see :class:`AutoAugment`), and the whole-batch
policies (``elementwise=False``, the reference default): one op (or one
sub-policy) a round for the whole batch, chosen on a host generator as a
Python value, so only the chosen op runs and choosing never waits for the
card. The whole-batch ops are :mod:`image_augmentations`' own (the dense
nearest warp for the geometric ones), as the JAX package's ``lax.switch``
runs them.

Sampling is split from applying. :meth:`RandAugment.sample` draws, for each
round, the op index, the sign of the op's magnitude and the CutOut centre of
every image from a ``torch.Generator``; :meth:`RandAugment.apply` is
deterministic given those draws, so a test can feed it the draws the JAX
package made and hold the outputs bit-equal.

A round runs in one of two compositions, selected by ``fused_round_kernel``:

- fused: the warp, Color, Sharpness and CutOut candidates go through one
  launch of kernel K1 (``warp_kernels.fused_round``), in which every image
  computes only its own op;
- masked: one warp of the whole batch through kernel K2
  (``warp_kernels.transform_affine_separable``), then Color, Sharpness and
  CutOut over the whole batch, each selected in by mask.

``fused_round_kernel=None`` (the default) picks the fused composition for a
uint8 batch of three channels, which is all K1 takes, and the masked one
for any other batch, as the JAX package routes a batch that is not uint8
RGB; True or False forces one. The JAX package's TPU-only gate on the
kernel's VMEM working set has no counterpart here.

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


def _fused_round_applicable(scheme, images):
    """Whether a round goes through K1: ``scheme.fused_round_kernel`` if it
    is True or False, else whether the batch is uint8 RGB."""
    if scheme.fused_round_kernel is not None:
        return scheme.fused_round_kernel
    return images.dtype == torch.uint8 and images.shape[-1] == 3


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


# projective op -> (matrices of signed values for an h x w image, the
# op's value from its magnitude)
_PROJECTIVE_OPS = {
    "ShearX": (lambda v, h, w: image_ops.shear_x_matrices(v),
               lambda m: m / _MAX_MAGNITUDE * 0.3),
    "ShearY": (lambda v, h, w: image_ops.shear_y_matrices(v),
               lambda m: m / _MAX_MAGNITUDE * 0.3),
    "TranslateX": (lambda v, h, w: image_ops.translate_x_matrices(v),
                   lambda m: m / _MAX_MAGNITUDE * 100),
    "TranslateY": (lambda v, h, w: image_ops.translate_y_matrices(v),
                   lambda m: m / _MAX_MAGNITUDE * 100),
    "Rotate": (image_ops.rotation_matrices,
               lambda m: m / _MAX_MAGNITUDE * 30.0 * math.pi / 180.0),
}
_KERNEL_CLASSES = {"Color": warp_kernels.COLOR,
                   "Sharpness": warp_kernels.SHARPNESS,
                   "CutOut": warp_kernels.CUTOUT}


def _op_tables(specs, h, w, device):
    """Per-op tables on ``device`` for the ops ``specs``, ``[(name,
    magnitude), ...]`` at ``h x w``: static LUT rows ``rows [n, 256]``
    (identity for ops without a static table); the masks ``is_lut``,
    ``is_autocontrast``, ``is_equalize`` and ``is_color``; K1's class
    ``op_class``; Color's factor ``color_factor``; and ``projective_kind``
    (1 + the op's place in ``_PROJECTIVE_OPS``, 0 for other ops) with the
    op's unsigned value ``projective_value``."""
    n = len(specs)
    rows = np.tile(np.arange(256, dtype=np.uint8), (n, 1))
    masks = {k: np.zeros(n, bool) for k in (
        "is_lut", "is_autocontrast", "is_equalize", "is_color")}
    op_class = np.full(n, warp_kernels.PASSTHROUGH, np.int32)
    color_factor = np.zeros(n, np.float32)
    kind, value = np.zeros(n, np.int64), np.zeros(n, np.float32)
    projective = list(_PROJECTIVE_OPS)
    for i, (name, magnitude) in enumerate(specs):
        if name in _PROJECTIVE_OPS:
            op_class[i] = warp_kernels.WARP
            kind[i] = projective.index(name) + 1
            value[i] = _PROJECTIVE_OPS[name][1](magnitude or 0)
        elif name in _KERNEL_CLASSES:
            # a CutOut of size 0 is the identity
            if name != "CutOut" or _magnitude_to_cutout_kwargs(
                    magnitude)["mask_size"]:
                op_class[i] = _KERNEL_CLASSES[name]
            if name == "Color":
                masks["is_color"][i] = True
                color_factor[i] = _magnitude_to_enhance_kwargs(
                    magnitude)["factor"]
        else:
            masks["is_lut"][i] = True
            masks["is_autocontrast"][i] = name == "AutoContrast"
            masks["is_equalize"][i] = name == "Equalize"
            table = _static_pointwise_table(name, magnitude, h, w)
            if table is not None:
                rows[i] = table
            elif name not in ("AutoContrast", "Equalize"):
                raise NotImplementedError(
                    f"op {name} has no elementwise form")
    tables = dict(rows=rows, op_class=op_class, color_factor=color_factor,
                  projective_kind=kind, projective_value=value, **masks)
    return {k: torch.from_numpy(v).to(device) for k, v in tables.items()}


def _projective_matrices(t, op_idx, sign, h, w):
    """Per-image ``[b, 8]`` affine: the projective op ``op_idx`` drew, at
    ``sign`` times its value, from :func:`_op_tables`' ``t``; identity for
    an image that drew another op."""
    kind = t["projective_kind"][op_idx]
    value = sign * t["projective_value"][op_idx]
    mats = image_ops.identity_matrices(op_idx.shape[0], op_idx.device)
    for k, (build, _) in enumerate(_PROJECTIVE_OPS.values(), 1):
        mats = torch.where((kind == k)[:, None], build(value, h, w), mats)
    return mats


def _apply_lut_block(images, t, op_idx, result):
    """The per-pixel-value ops as one ``[b*c, 256]`` table gathered per
    (image, channel): each image's static row of :func:`_op_tables`' ``t``,
    or its AutoContrast or Equalize table; images whose op ``op_idx`` is no
    table op keep ``result``."""
    c = images.shape[-1]
    lut = t["rows"][op_idx].repeat_interleave(c, dim=0)  # [b*c, 256]
    for name, tables in (("is_autocontrast", image_ops.autocontrast_luts),
                         ("is_equalize", image_ops.equalize_luts)):
        sel = t[name][op_idx].repeat_interleave(c)[:, None]
        lut = torch.where(sel, tables(images), lut)
    lut_out = image_ops.apply_channel_luts(images, lut)
    return torch.where(t["is_lut"][op_idx][:, None, None, None], lut_out,
                       result)


class RandAugment:
    """``n_transforms`` random ops at fixed magnitude over the 16-op pool,
    one op a round for the whole batch (``elementwise=False``, the
    default) or one per image.

    Per image, ``fused_round_kernel`` selects a round's composition: True
    runs kernel K1 once per round, False the masked composition over K2,
    None (default) K1 for a uint8 RGB batch and the masked composition for
    any other. For the whole batch a round runs the chosen op alone.
    """

    OP_NAMES = (
        "AutoContrast", "Equalize", "Invert", "Brightness", "Contrast",
        "Color", "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY",
        "Posterize", "Solarize", "SolarizeAdd", "CutOut", "Rotate",
    )
    _COLOR, _SHARPNESS, _CUTOUT = 5, 6, 14

    def __init__(self, n_transforms: int, magnitude: float,
                 elementwise: bool = False, fused_round_kernel=None):
        self.n_transforms = n_transforms
        self.magnitude = magnitude
        self.elementwise = elementwise
        self.fused_round_kernel = fused_round_kernel
        self.transforms = [_get_transform(n, magnitude) for n in self.OP_NAMES]
        self._rotate_rad = _PROJECTIVE_OPS["Rotate"][1](magnitude)
        self._tables = {}  # (h, w, device) -> see _device_tables

    # -- sampling ------------------------------------------------------------

    def sample(self, batch, size, generator=None, device=None):
        """Draw every round's randomness: a list of ``n_transforms`` dicts
        with ``idx`` (op index, int64 ``[b]``; for the whole batch a Python
        int), ``sign`` (±1 float32 ``[b]``), ``cy`` and ``cx`` (CutOut
        centre, int64 ``[b]``) on ``device``, for images of ``size = (h,
        w)``. Per image the draws are made on ``device`` by ``generator``;
        for the whole batch on the host, by a host ``generator``, and the
        tensors then moved to ``device``."""
        device = resolve_device(device)
        h, w = size
        if not self.elementwise:
            generator = image_augmentations.host_generator(generator)
            draws = []
            for _ in range(self.n_transforms):
                idx = int(torch.randint(0, len(self.OP_NAMES), (),
                                        generator=generator))
                d = {"sign": image_augmentations.random_sign(
                    batch, generator, "cpu")}
                d.update(self.transforms[self._CUTOUT].sample(
                    batch, size, generator, "cpu"))
                draws.append({"idx": idx, **image_augmentations.to_device(
                    d, device)})
            return draws
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
        """Run the rounds on uint8 ``[b, h, w, c]`` ``images`` with the given
        draws (see :meth:`sample`)."""
        if not self.elementwise:
            for d in draws:
                images = self.transforms[d["idx"]].apply(images, d)
            return images
        t = self._device_tables(*images.shape[1:3], images.device)
        use_kernel = _fused_round_applicable(self, images)
        for d in draws:
            idx = d["idx"]
            mats = self.round_matrices(idx, d["sign"], *images.shape[1:3])
            if use_kernel:
                result = self._fused_round(images, mats, idx, d["cy"],
                                           d["cx"])
            else:
                result = _policy_warp(images, mats,
                                      max_rotation_rad=self._rotate_rad)
            result = _apply_lut_block(images, t, idx, result)
            if not use_kernel:
                # the non-LUT pointwise ops over the whole batch, masked in
                for k_i in (self._COLOR, self._SHARPNESS, self._CUTOUT):
                    op = self.transforms[k_i]
                    out = (op(images, centers=(d["cy"], d["cx"]))
                           if k_i == self._CUTOUT else op(images))
                    result = torch.where((idx == k_i)[:, None, None, None],
                                         out, result)
            images = result
        return images

    def round_matrices(self, idx, sign, h, w):
        """Per-image ``[b, 8]`` affine: the sampled projective op's matrix,
        identity for images that drew another op."""
        return _projective_matrices(self._device_tables(h, w, idx.device),
                                    idx, sign, h, w)

    def fused_round_args(self, images, mats, idx, cy, cx):
        """Arguments of K1 for one round (``warp_kernels.fused_round``)."""
        h, w = images.shape[1:3]
        t = self._device_tables(h, w, images.device)
        color = self.transforms[self._COLOR]
        sharp = self.transforms[self._SHARPNESS]
        cut = self.transforms[self._CUTOUT]
        return dict(
            images=images, transforms=mats, op_class=t["op_class"][idx],
            cut_cy=cy, cut_cx=cx, fill_value=_FILL_VALUE,
            pad=_rotation_pad(self._rotate_rad, h, w),
            color_factor=color.factor, sharp_factor=sharp.factor,
            cut_half=cut.mask_size // 2, cut_fill=cut.constant_values,
        )

    def _fused_round(self, images, mats, idx, cy, cx):
        return warp_kernels.fused_round(
            **self.fused_round_args(images, mats, idx, cy, cx))

    def _device_tables(self, h, w, device):
        """:func:`_op_tables` of the 16 ops, cached per size and device."""
        key = (h, w, str(device))
        if key not in self._tables:
            self._tables[key] = _op_tables(
                [(name, self.magnitude) for name in self.OP_NAMES], h, w,
                device)
        return self._tables[key]


# [(Transform, Probability, Magnitude), (Transform, Probability, Magnitude)]
_AUTO_AUGMENT_POLICY_V0 = [
    [("Equalize", 0.8, None), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, None)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, None)],
    [("Equalize", 0.4, None), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, None)],
    [("Invert", 0.4, None), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, None), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, None)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, None)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateY", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, None), ("Equalize", 0.0, None)],
    [("Equalize", 1.0, None), ("AutoContrast", 0.6, None)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]


class AutoAugment:
    """The AutoAugment V0 policy: one sub-policy pair for the whole batch
    (``elementwise=False``, the default) or one per image.

    For the whole batch, :meth:`sample` draws the sub-policy (a Python int)
    and, per stage, whether its op fires (a Python bool) on a host
    generator, with the op's signs; :meth:`apply` runs each stage's op
    alone when it fires, as two ``RandomChance`` stages.

    The 25 sub-policies index a table of unique ``(op, magnitude)`` specs,
    interned in the JAX package's order (both ``Equalize`` entries and the
    probability-0 ones included). :meth:`sample` draws each image's
    sub-policy and, for each of the two stages, whether its op fires and
    the sign of its magnitude; :meth:`apply` is deterministic given those
    draws. The V0 table samples no Sharpness or CutOut, so a stage needs no
    other randomness.

    A stage builds one ``[b, 8]`` affine per image (identity unless it drew
    a projective op), then runs one of two compositions, chosen as in
    :class:`RandAugment` by ``fused_round_kernel``:

    - fused: one launch of K1 (``warp_kernels.fused_round``) in which each
      image warps, takes Color at its own factor, or passes through (also
      where its op does not fire);
    - masked: one warp of the whole batch (K2), then Color over the whole
      batch at per-image factors, selected in by mask.

    Then one ``[b*c, 256]`` table block: Equalize, AutoContrast and the
    static tables of Invert, Posterize, Solarize and SolarizeAdd; and last
    ``where(fires, result, images)``. The fill padding comes from the
    largest Rotate magnitude of the table (27 degrees).
    """

    def __init__(self, elementwise: bool = False, fused_round_kernel=None):
        self.elementwise = elementwise
        self.fused_round_kernel = fused_round_kernel
        self._unique = {}    # (name, magnitude) -> index
        self._op_specs = []  # [(name, magnitude), ...]
        self.policies = []   # [((op_idx, p), (op_idx, p)), ...]
        for (t1, p1, m1), (t2, p2, m2) in _AUTO_AUGMENT_POLICY_V0:
            self.policies.append(
                ((self._intern(t1, m1), p1), (self._intern(t2, m2), p2)))
        self._ops = [_get_transform(name, m) for name, m in self._op_specs]
        self._max_rotation = max(
            _PROJECTIVE_OPS["Rotate"][1](m or 0)
            for name, m in self._op_specs if name == "Rotate")
        self._tables = {}    # (h, w, device) -> see _device_tables
        self._policy = {}    # device -> see policy_tables

    def _intern(self, name, magnitude):
        key = (name, magnitude)
        if key not in self._unique:
            self._unique[key] = len(self._op_specs)
            self._op_specs.append(key)
        return self._unique[key]

    def policy_tables(self, device):
        """The sub-policies on ``device``, cached: ``op_of_policy`` (int64
        ``[2, 25]``, each stage's spec index) and ``prob`` (float32 ``[2,
        25]``, each stage's probability)."""
        key = str(device)
        if key not in self._policy:
            self._policy[key] = {
                name: torch.tensor([[p[s][i] for p in self.policies]
                                    for s in (0, 1)], dtype=dtype,
                                   device=device)
                for name, i, dtype in (("op_of_policy", 0, torch.int64),
                                       ("prob", 1, torch.float32))}
        return self._policy[key]

    # -- sampling ------------------------------------------------------------

    def sample(self, batch, generator=None, device=None):
        """Draw the policy's randomness on ``device``: ``policy_idx`` (int64
        ``[b]``) and, per stage, ``do`` (bool ``[b]``, the op fires: a
        uniform draw below its probability) and ``sign`` (±1 float32
        ``[b]``), as ``{"policy_idx": ..., "stages": [{"do", "sign"}] * 2}``.
        For the whole batch ``policy_idx`` is a Python int and ``do`` a
        Python bool, drawn on a host ``generator``; the signs are moved to
        ``device``."""
        device = resolve_device(device)
        if not self.elementwise:
            generator = image_augmentations.host_generator(generator)
            policy_idx = int(torch.randint(0, len(self.policies), (),
                                           generator=generator))
            stages = []
            for s in (0, 1):
                p = self.policies[policy_idx][s][1]
                do = float(torch.rand((), generator=generator)) < p
                sign = image_augmentations.random_sign(batch, generator,
                                                       "cpu")
                stages.append({"do": do, "sign": sign})
            return {"policy_idx": policy_idx,
                    "stages": image_augmentations.to_device(stages, device)}
        prob = self.policy_tables(device)["prob"]
        policy_idx = torch.randint(0, len(self.policies), (batch,),
                                   generator=generator, device=device)
        stages = []
        for s in (0, 1):
            u = torch.rand(batch, generator=generator, device=device)
            stages.append({
                "do": u < prob[s][policy_idx],
                "sign": image_augmentations.random_sign(batch, generator,
                                                        device)})
        return {"policy_idx": policy_idx, "stages": stages}

    def __call__(self, images, generator=None):
        return self.apply(images, self.sample(images.shape[0], generator,
                                              images.device))

    # -- applying ------------------------------------------------------------

    def stage_ops(self, draws, s):
        """Spec index ``[b]`` of each image's op in stage ``s``."""
        policy_idx = draws["policy_idx"]
        return self.policy_tables(policy_idx.device)["op_of_policy"][s][
            policy_idx]

    def apply(self, images, draws):
        """Run both stages on uint8 ``[b, h, w, c]`` ``images`` with the
        given draws (see :meth:`sample`)."""
        if not self.elementwise:
            policy = self.policies[draws["policy_idx"]]
            for (op, _), stage in zip(policy, draws["stages"]):
                if stage["do"]:
                    images = self._ops[op].apply(images, stage)
            return images
        b, h, w, _ = images.shape
        t = self._device_tables(h, w, images.device)
        use_kernel = _fused_round_applicable(self, images)
        for s, stage in enumerate(draws["stages"]):
            op_idx = self.stage_ops(draws, s)
            do = stage["do"]
            mats = self.stage_matrices(op_idx, stage["sign"], h, w)
            if use_kernel:
                result = warp_kernels.fused_round(**self.fused_stage_args(
                    images, mats, op_idx, do))
            else:
                result = _policy_warp(images, mats,
                                      max_rotation_rad=self._max_rotation)
            result = _apply_lut_block(images, t, op_idx, result)
            if not use_kernel:
                color = image_ops.color(images, t["color_factor"][op_idx])
                result = torch.where(
                    t["is_color"][op_idx][:, None, None, None], color, result)
            images = torch.where(do[:, None, None, None], result, images)
        return images

    def stage_matrices(self, op_idx, sign, h, w):
        """Per-image ``[b, 8]`` affine of one stage: the drawn projective
        op's matrix at ``sign`` times its value, identity for other ops."""
        return _projective_matrices(self._device_tables(h, w, op_idx.device),
                                    op_idx, sign, h, w)

    def fused_stage_args(self, images, mats, op_idx, do):
        """Arguments of K1 for one stage: WARP, COLOR or PASSTHROUGH per
        image (PASSTHROUGH where the op does not fire or is a table op),
        Color's factor per image."""
        h, w = images.shape[1:3]
        t = self._device_tables(h, w, images.device)
        zeros = torch.zeros_like(op_idx)
        return dict(
            images=images, transforms=mats,
            op_class=torch.where(do, t["op_class"][op_idx],
                                 warp_kernels.PASSTHROUGH),
            cut_cy=zeros, cut_cx=zeros, fill_value=_FILL_VALUE,
            pad=_rotation_pad(self._max_rotation, h, w),
            color_factor=t["color_factor"][op_idx], sharp_factor=0.0,
            cut_half=0, cut_fill=0)

    def _device_tables(self, h, w, device):
        """:func:`_op_tables` of the interned specs, cached per size and
        device."""
        key = (h, w, str(device))
        if key not in self._tables:
            self._tables[key] = _op_tables(self._op_specs, h, w, device)
        return self._tables[key]
