"""Backbones of the port: ViT and DeiT, SENet, ResNeXt, BN-Inception."""

from chambers_tpu_torch.models.backbones.vision_transformer import (
    DeiTB16,
    DeiTS16,
    DistilledVisionTransformer,
    ViTB16,
    ViTB32,
    ViTL16,
    ViTL32,
    ViTS16,
    VisionTransformer,
    fold_imagenet_normalization,
)
from chambers_tpu_torch.models.backbones.senet import (
    SENet,
    SENet154,
    SEResNet50,
    SEResNet101,
    SEResNet152,
    SEResNeXt50,
    SEResNeXt101,
)
from chambers_tpu_torch.models.backbones.resnext import ResNeXt50, ResNeXt101
from chambers_tpu_torch.models.backbones.inception import BNInception

__all__ = [
    "BNInception",
    "DeiTB16",
    "DeiTS16",
    "DistilledVisionTransformer",
    "ResNeXt50",
    "ResNeXt101",
    "SENet",
    "SENet154",
    "SEResNet50",
    "SEResNet101",
    "SEResNet152",
    "SEResNeXt50",
    "SEResNeXt101",
    "ViTB16",
    "ViTB32",
    "ViTL16",
    "ViTL32",
    "ViTS16",
    "VisionTransformer",
    "fold_imagenet_normalization",
]
