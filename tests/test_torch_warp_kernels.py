"""The port's plain K1/K2 (the CPU path of the CUDA kernel wrappers in
``chambers_tpu_torch.ops.warp_kernels``) against the JAX package's Pallas
kernels run in interpret mode, bit-equal on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.ops import image_ops as jops
from chambers_tpu.ops import warp_pallas
from chambers_tpu_torch.augmentations import augmentation_schemes
from chambers_tpu_torch.ops import image_ops as tops
from chambers_tpu_torch.ops import warp_kernels
from test_torch_package import one_torch_thread  # noqa: F401


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


def _kernel_shifts(t, h, w, pad):
    """The shift arithmetic of ``fill_shifts`` in ``csrc/warp.cu``, one
    rounded float32 step at a time in the order the kernel takes them
    (``__fsub_rn``, ``__fdiv_rn``, ``__fmul_rn``, ``__fadd_rn``; numpy
    rounds each float32 operation and fuses none)."""
    f = np.float32
    a0, a1, a2, b0, b1, b2 = (f(v) for v in t[:6])
    nz = abs(b0) > f(1e-8)
    A2 = b0
    A1 = (a0 - f(1.0)) / b0 if nz else f(0.0)
    A3 = (b1 - f(1.0)) / b0 if nz else a1
    B3 = f(0.0) if nz else a2
    B2 = b2 - A2 * B3
    B1 = (a2 - a0 * B3) - A1 * B2

    def shifts(A, B, coords):
        return np.floor((A * coords + B) + f(0.5)).astype(np.int32)

    ys = np.arange(h, dtype=np.int32).astype(f)
    xs = (np.arange(w + 2 * pad, dtype=np.int32) - pad).astype(f)
    return shifts(A1, B1, ys), shifts(A2, B2, xs), shifts(A3, B3, ys)


def _policy_mats(op, h, w):
    """``[22, 8]`` float32 matrices of one projective RandAugment op at
    magnitudes 0-10, both signs, as the policy sizes them; "AnyRotation" is
    400 rotations of seeded angles within ±0.6 rad, among which a shift
    whose float32 value lies close enough to a rounding boundary that
    another order of the same operations moves it (one at 384 px)."""
    if op == "AnyRotation":
        angles = np.random.RandomState(0).uniform(-0.6, 0.6, 400)
        return np.array(jops.rotation_matrices(angles.astype(np.float32), h,
                                               w), np.float32)
    mags = np.repeat(np.arange(11, dtype=np.float32), 2)
    signed = mags / np.float32(10.0) * np.tile(np.float32([1, -1]), 11)
    build = {
        "ShearX": lambda: jops.shear_x_matrices(signed * np.float32(0.3)),
        "ShearY": lambda: jops.shear_y_matrices(signed * np.float32(0.3)),
        "TranslateX": lambda: jops.translate_x_matrices(
            signed * np.float32(100)),
        "TranslateY": lambda: jops.translate_y_matrices(
            signed * np.float32(100)),
        "Rotate": lambda: jops.rotation_matrices(
            signed * np.float32(30.0 * np.pi / 180.0), h, w),
    }[op]
    return np.array(build(), np.float32)


@pytest.mark.parametrize("h,w", [(224, 224), (384, 384), (41, 33)])
@pytest.mark.parametrize("op", ["ShearX", "ShearY", "TranslateX",
                                "TranslateY", "Rotate", "AnyRotation"])
def test_kernel_shift_order_matches_both_packages(op, h, w):
    """The kernel computes the shift vectors itself; its float order,
    mirrored step by step, gives the plain version's and the JAX package's
    shifts for every projective op of the policy at magnitudes 0-10 and
    both signs, with the policy's fill padding."""
    mats = _policy_mats(op, h, w)
    b = mats.shape[0]
    pad = augmentation_schemes._rotation_pad(30.0 * np.pi / 180.0, h, w)
    j1, _, j2e, _, j3, _ = warp_pallas._shift_vectors(
        jnp.asarray(mats), b, h, w, 3, pad)
    t1, t2, t3 = warp_kernels._shift_vectors(torch.from_numpy(mats), b, h, w,
                                             pad)
    for i, t in enumerate(mats):
        k1, k2, k3 = _kernel_shifts(t, h, w, pad)
        np.testing.assert_array_equal(k1, t1[i].numpy())
        np.testing.assert_array_equal(k2, t2[i].numpy())
        np.testing.assert_array_equal(k3, t3[i].numpy())
        np.testing.assert_array_equal(k1, np.asarray(j1)[i, :, 0])
        np.testing.assert_array_equal(k2, np.asarray(j2e)[i, 0, ::3])
        np.testing.assert_array_equal(k3, np.asarray(j3)[i, :, 0])


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


def test_kernel_args_pass_device_inputs_as_they_are():
    """K1's kernel arguments: per-image values already in the kernel's type
    are the caller's tensors (no copy, so no launch on a card), others are
    cast once; scalar factors go as float32 numbers; one ``[8]`` transform
    is read with stride 0."""
    b = 4
    imgs = torch.zeros((b, 8, 16, 3), dtype=torch.uint8)
    mats = tops.identity_matrices(b)
    op = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    cy = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    cx32 = cy.to(torch.int32)
    factors = torch.full((b,), 1.72, dtype=torch.float32)
    (t, stride), op_k, cy_k, cx_k, fc, fs, fill, pad, half, cut_fill = (
        warp_kernels.kernel_round_args(
            imgs, mats, op, cy, cx32, fill_value=128, pad=3,
            color_factor=1.72, sharp_factor=factors, cut_half=2,
            cut_fill=7))
    assert t.data_ptr() == mats.data_ptr() and stride == 8
    assert op_k is op and cy_k is cy
    assert cx_k.dtype == torch.int64 and torch.equal(cx_k, cy)
    assert fc == (None, float(np.float32(1.72)))
    assert fs[0] is factors and fs[1] == 0.0
    assert (fill, pad, half, cut_fill) == (128, 3, 2, 7)
    one, stride = warp_kernels._device_transforms(mats[0], b, imgs.device)
    assert one.shape == (8,) and stride == 0
    with pytest.raises(ValueError):
        warp_kernels._device_transforms(mats[:2], b, imgs.device)
