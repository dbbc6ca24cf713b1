"""Augmentation of the port: the image ops and their combinators, the
RandAugment and AutoAugment policies, the Keras preprocessing layers and
the label-mixing MixUp and CutMix (the names the JAX package's
``chambers_tpu.augmentations`` exports)."""

from chambers_tpu_torch.augmentations.image_augmentations import (
    AutoContrast,
    Brightness,
    Color,
    Contrast,
    CutOut,
    Equalize,
    ImageNetNormalization,
    Invert,
    Posterize,
    RandomChance,
    RandomChoice,
    ResizingMinMax,
    Rotate,
    Sharpness,
    ShearX,
    ShearY,
    Solarize,
    SolarizeAdd,
    TranslateX,
    TranslateY,
)
from chambers_tpu_torch.augmentations.augmentation_schemes import (
    AutoAugment,
    RandAugment,
)
from chambers_tpu_torch.augmentations.preprocessing import (
    CenterCrop,
    RandomContrast,
    RandomCrop,
    RandomFlip,
    RandomHeight,
    RandomRotation,
    RandomTranslation,
    RandomWidth,
    RandomZoom,
    Rescaling,
    Resizing,
)
from chambers_tpu_torch.augmentations.batch_augmentations import (
    CutMix,
    MixUp,
    mixup_or_cutmix,
    sample_mixup_or_cutmix,
)

__all__ = [
    "AutoAugment", "AutoContrast", "Brightness", "CenterCrop", "Color",
    "Contrast", "CutMix", "CutOut", "Equalize", "ImageNetNormalization",
    "Invert", "MixUp", "Posterize", "RandAugment", "RandomChance",
    "RandomChoice", "RandomContrast", "RandomCrop", "RandomFlip",
    "RandomHeight", "RandomRotation", "RandomTranslation", "RandomWidth",
    "RandomZoom", "Rescaling", "Resizing", "ResizingMinMax", "Rotate",
    "Sharpness", "ShearX", "ShearY", "Solarize", "SolarizeAdd",
    "TranslateX", "TranslateY", "mixup_or_cutmix", "sample_mixup_or_cutmix",
]
