"""The port's plain K1/K2 (the CPU path of the CUDA kernel wrappers in
``chambers_tpu_torch.ops.warp_kernels``) against the JAX package's Pallas
kernels run in interpret mode, bit-equal on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.ops import image_ops as jops
from chambers_tpu.ops import warp_pallas
from chambers_tpu_torch.ops import image_ops as tops
from chambers_tpu_torch.ops import warp_kernels


def _det1_mats(rng, h, w, n):
    """Identity, then rotations / shears / translations cycling."""
    mats = [np.asarray(jops.identity_matrices(1))[0]]
    for i in range(n - 1):
        kind = i % 5
        if kind == 0:
            m = jops.rotation_matrices(np.float32(rng.uniform(-0.5, 0.5)), h, w)
        elif kind == 1:
            m = jops.shear_x_matrices(np.float32(rng.uniform(-0.3, 0.3)))
        elif kind == 2:
            m = jops.shear_y_matrices(np.float32(rng.uniform(-0.3, 0.3)))
        elif kind == 3:
            m = jops.translate_x_matrices(np.float32(rng.uniform(-20, 20)))
        else:
            m = jops.translate_y_matrices(np.float32(rng.uniform(-20, 20)))
        mats.append(np.asarray(m)[0])
    return np.stack(mats).astype(np.float32)


@pytest.mark.parametrize("h,w,pad", [(64, 64, 11), (48, 80, 9)])
def test_plain_warp_matches_pallas(h, w, pad):
    rng = np.random.RandomState(0)
    b = 6
    imgs = rng.randint(0, 256, (b, h, w, 3), dtype=np.uint8)
    mats = _det1_mats(rng, h, w, b)
    want = np.asarray(warp_pallas.transform_affine_separable_pallas(
        imgs, mats, fill_value=128, pad=pad, interpret=True))
    got = warp_kernels.transform_affine_separable(
        torch.from_numpy(imgs), torch.from_numpy(mats), 128, pad).numpy()
    assert int((want != got).sum()) == 0


def test_plain_warp_identity_and_full_fill():
    rng = np.random.RandomState(1)
    imgs = torch.from_numpy(rng.randint(0, 256, (2, 32, 32, 3), np.uint8))
    ident = tops.identity_matrices(2)
    assert torch.equal(
        warp_kernels.transform_affine_separable(imgs, ident, 0, 5), imgs)
    far = tops.translate_x_matrices(torch.full((2,), 1000.0))
    out = warp_kernels.transform_affine_separable(imgs, far, 77, 5)
    assert bool((out == 77).all())


def test_shift_vectors_match_jax():
    rng = np.random.RandomState(2)
    b, h, w, c, pad = 7, 40, 56, 3, 10
    mats = _det1_mats(rng, h, w, b)
    n1, _, n2e, _, n3, _ = warp_pallas._shift_vectors(
        jnp.asarray(mats), b, h, w, c, pad)
    t1, t2, t3 = warp_kernels._shift_vectors(torch.from_numpy(mats), b, h, w,
                                             pad)
    assert t1.dtype == t2.dtype == t3.dtype == torch.int32
    np.testing.assert_array_equal(t1.numpy(), np.asarray(n1)[:, :, 0])
    np.testing.assert_array_equal(t3.numpy(), np.asarray(n3)[:, :, 0])
    np.testing.assert_array_equal(t2.numpy(), np.asarray(n2e)[:, 0, ::c])


@pytest.mark.parametrize("per_image", [False, True])
def test_plain_fused_round_matches_pallas(per_image):
    """All five classes at 32x32, magnitude-9 and -10 factors (1.72 is the
    FMA-adversarial one) or per-image factors."""
    rng = np.random.RandomState(3)
    b, h, w, pad = 10, 32, 32, 6
    imgs = rng.randint(0, 256, (b, h, w, 3), dtype=np.uint8)
    mats = _det1_mats(rng, h, w, b)
    op_class = np.array([0, 1, 2, 3, 4, 1, 2, 3, 4, 1], np.int32)
    cy = rng.randint(0, h, b).astype(np.int32)
    cx = rng.randint(0, w, b).astype(np.int32)
    if per_image:
        fc = rng.uniform(0.1, 1.9, b).astype(np.float32)
        fs = rng.uniform(0.1, 1.9, b).astype(np.float32)
        cases = [(fc, fs)]
    else:
        cases = [(np.float32(1.72), np.float32(1.72)),
                 (np.float32(1.9), np.float32(1.9))]
    for fc, fs in cases:
        kw = dict(fill_value=128, pad=pad, cut_half=8, cut_fill=128)
        want = np.asarray(warp_pallas.fused_round_pallas(
            imgs, mats, op_class, cy, cx, color_factor=fc, sharp_factor=fs,
            interpret=True, **kw))
        got = warp_kernels.fused_round(
            torch.from_numpy(imgs), torch.from_numpy(mats),
            torch.from_numpy(op_class), torch.from_numpy(cy),
            torch.from_numpy(cx), color_factor=torch.as_tensor(fc),
            sharp_factor=torch.as_tensor(fs), **kw).numpy()
        assert int((want != got).sum()) == 0


def test_wrappers_reject_bad_inputs():
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    ident = tops.identity_matrices(2)
    with pytest.raises(TypeError):
        warp_kernels.transform_affine_separable(imgs.float(), ident, 0, 2)
    with pytest.raises(ValueError):
        warp_kernels.transform_affine_separable(
            imgs.permute(0, 2, 1, 3), ident, 0, 2)
    with pytest.raises(ValueError):
        warp_kernels.fused_round(
            imgs[..., :2].contiguous(), ident, 0, 0, 0, fill_value=0, pad=2,
            color_factor=1.0, sharp_factor=1.0, cut_half=0, cut_fill=0)
    with pytest.raises(OverflowError):
        warp_kernels.transform_affine_separable(imgs, ident, 256.5, 2)


def test_cpu_path_counts_no_launch():
    before = (warp_kernels.fused_round.launches,
              warp_kernels.transform_affine_separable.launches)
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    warp_kernels.transform_affine_separable(imgs, tops.identity_matrices(2),
                                            0, 2)
    warp_kernels.fused_round(imgs, tops.identity_matrices(2), 0, 0, 0,
                             fill_value=0, pad=2, color_factor=1.0,
                             sharp_factor=1.0, cut_half=0, cut_fill=0)
    assert (warp_kernels.fused_round.launches,
            warp_kernels.transform_affine_separable.launches) == before
