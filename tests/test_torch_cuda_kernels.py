"""The CUDA kernels K1 and K2 against their plain PyTorch versions on the
card, at odd sizes the main path does not reach. Marked ``cuda``: they skip
on a machine without a card. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import math

import pytest
import torch

from chambers_tpu_torch.augmentations.augmentation_schemes import RandAugment
from chambers_tpu_torch.ops import image_ops as iops
from chambers_tpu_torch.ops import warp_kernels as wk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU path is held to the JAX "
                    "package in test_torch_warp_kernels.py")
    return torch.device("cuda")


def _mats(b, h, w, dev):
    rad = torch.tensor([math.radians(29.0), -math.radians(17.0)], device=dev)
    kinds = torch.cat([
        iops.identity_matrices(1, dev), iops.rotation_matrices(rad, h, w),
        iops.shear_x_matrices(torch.tensor([0.27], device=dev)),
        iops.shear_y_matrices(torch.tensor([-0.3], device=dev)),
        iops.translate_x_matrices(torch.tensor([-7.5], device=dev)),
        iops.translate_y_matrices(torch.tensor([500.0], device=dev)),
    ])
    return kinds[torch.arange(b, device=dev) % kinds.shape[0]]


@pytest.mark.parametrize("b,h,w,c,pad", [(7, 37, 29, 3, 10), (5, 64, 48, 1, 9),
                                         (3, 5, 300, 4, 2)])
def test_warp_kernel_matches_plain(dev, b, h, w, c, pad):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (b, h, w, c), dtype=torch.uint8, device=dev,
                      generator=g)
    mats = _mats(b, h, w, dev)
    got = wk.transform_affine_separable(x, mats, 77, pad)
    n1, n2, n3 = wk._shift_vectors(mats, b, h, w, pad)
    assert torch.equal(got, wk.warp_plain(x, n1, n2, n3, 77, pad))


@pytest.mark.parametrize("factor", [1.72, 1.9, "per_image"])
def test_fused_round_kernel_matches_plain(dev, factor):
    g = torch.Generator(device=dev).manual_seed(1)
    b, h, w = 15, 41, 33
    x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=dev,
                      generator=g)
    if factor == "per_image":
        factor = torch.rand(b, device=dev, generator=g) * 1.8 + 0.1
    op_class = torch.arange(b, device=dev) % 5
    cy = torch.randint(-5, h + 5, (b,), device=dev, generator=g)
    cx = torch.randint(-5, w + 5, (b,), device=dev, generator=g)
    kw = dict(fill_value=128, pad=8, color_factor=factor,
              sharp_factor=factor, cut_half=9, cut_fill=3)
    mats = _mats(b, h, w, dev)
    got = wk.fused_round(x, mats, op_class, cy, cx, **kw)
    want = wk.fused_round_plain(
        x, *wk.fused_round_args(x, mats, op_class, cy, cx, **kw))
    assert torch.equal(got, want)


def test_randaugment_compositions_equal(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randint(0, 256, (16, 64, 64, 3), dtype=torch.uint8, device=dev,
                      generator=g)
    for magnitude in (10, 9, 0):
        fused = RandAugment(2, magnitude, elementwise=True)
        masked = RandAugment(2, magnitude, elementwise=True,
                             fused_round_kernel=False)
        draws = fused.sample(16, (64, 64), g, dev)
        cpu_draws = [{k: v.cpu() for k, v in d.items()} for d in draws]
        got = fused.apply(x, draws)
        assert torch.equal(got, masked.apply(x, draws))
        assert torch.equal(got.cpu(), fused.apply(x.cpu(), cpu_draws))


def test_kernel_wrappers_count_and_reject(dev):
    x = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=dev)
    ident = iops.identity_matrices(2, dev)
    before = wk.transform_affine_separable.launches
    assert torch.equal(wk.transform_affine_separable(x, ident, 0, 2), x)
    assert wk.transform_affine_separable.launches == before + 1
    with pytest.raises(ValueError):
        wk.transform_affine_separable(x.permute(0, 2, 1, 3), ident, 0, 2)
    with pytest.raises(TypeError):
        wk.fused_round(x.float(), ident, 0, 0, 0, fill_value=0, pad=2,
                       color_factor=1.0, sharp_factor=1.0, cut_half=0,
                       cut_fill=0)
