"""The port's image ops (``chambers_tpu_torch.ops.image_ops``) against the
JAX package's (``chambers_tpu.ops.image_ops``), bit-equal on the same uint8
inputs made from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.ops import image_ops as jops
from chambers_tpu_torch.ops import image_ops as tops
from test_torch_package import one_torch_thread  # noqa: F401


def _batch(seed=0, shape=(4, 40, 48, 3)):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, shape, dtype=np.uint8)
    # a low-contrast image and a constant channel exercise the LUT edge
    # cases (autocontrast's hi == lo, equalize's step == 0)
    x[1] = rng.randint(90, 110, shape[1:], dtype=np.uint8)
    x[2, ..., 1] = 77
    return x


_PER_IMAGE = np.array([0.1, 1.72, 1.9, 0.55], np.float32)

# (case id, op called on either module) — both get the same batch
_CASES = [
    ("blend_1.72", lambda m, x: m.blend(x[::-1], x, 1.72)),
    ("blend_0.3", lambda m, x: m.blend(x[::-1], x, 0.3)),
    ("blend_per_image", lambda m, x: m.blend(x[::-1], x, _PER_IMAGE)),
    ("to_grayscale", lambda m, x: m.to_grayscale(x)),
    ("invert", lambda m, x: m.invert(x)),
    ("solarize_128", lambda m, x: m.solarize(x, 128)),
    ("solarize_0", lambda m, x: m.solarize(x, 0)),
    ("solarize_add", lambda m, x: m.solarize_add(x, 40, 128)),
    ("posterize_4", lambda m, x: m.posterize(x, 4)),
    ("posterize_0", lambda m, x: m.posterize(x, 0)),
    ("posterize_per_image",
     lambda m, x: m.posterize(x, np.array([0, 2, 6, 8], np.uint8))),
    ("autocontrast", lambda m, x: m.autocontrast(x)),
    ("brightness", lambda m, x: m.brightness(x, 1.72)),
    ("contrast", lambda m, x: m.contrast(x, 1.72)),
    ("color_1.72", lambda m, x: m.color(x, 1.72)),
    ("color_per_image", lambda m, x: m.color(x, _PER_IMAGE)),
    ("sharpness_1.72", lambda m, x: m.sharpness(x, 1.72)),
    ("sharpness_per_image", lambda m, x: m.sharpness(x, _PER_IMAGE)),
    ("channel_histograms", lambda m, x: m.channel_histograms(x)),
    ("equalize_luts", lambda m, x: m.equalize_luts(x)),
    ("autocontrast_luts", lambda m, x: m.autocontrast_luts(x)),
    ("equalize", lambda m, x: m.equalize(x)),
]


def _to_torch(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy())
    return v


class _TorchArgs:
    """Runs a case's op on the torch module with numpy args converted."""

    def __getattr__(self, name):
        fn = getattr(tops, name)
        return lambda *a: fn(*(_to_torch(v) for v in a))


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_op_bit_equal(case):
    _, op = case
    x = _batch()
    want = np.asarray(op(jops, x))
    got = op(_TorchArgs(), x).numpy()
    assert want.dtype == got.dtype, (want.dtype, got.dtype)
    assert want.shape == got.shape
    assert int((want != got).sum()) == 0


def test_apply_channel_luts_bit_equal():
    x = _batch(1)
    rng = np.random.RandomState(5)
    luts = rng.randint(0, 256, (x.shape[0] * 3, 256), dtype=np.uint8)
    want = np.asarray(jops.apply_channel_luts(x, luts))
    got = tops.apply_channel_luts(torch.from_numpy(x), torch.from_numpy(luts))
    np.testing.assert_array_equal(got.numpy(), want)


def test_affine_matrices_equal():
    h, w = 48, 40
    rad = np.array([0.5235988, -0.5235988, 0.1, 0.0], np.float32)
    lvl = np.array([0.3, -0.3, 0.13, 0.0], np.float32)
    px = np.array([100.0, -100.0, 7.5, 0.0], np.float32)
    for name, arg in (("rotation_matrices", rad), ("shear_x_matrices", lvl),
                      ("shear_y_matrices", lvl),
                      ("translate_x_matrices", px),
                      ("translate_y_matrices", px)):
        extra = (h, w) if name == "rotation_matrices" else ()
        want = np.asarray(getattr(jops, name)(arg, *extra))
        got = getattr(tops, name)(torch.from_numpy(arg), *extra).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    mats = np.concatenate([np.asarray(jops.rotation_matrices(rad, h, w)),
                           np.asarray(jops.shear_y_matrices(lvl)),
                           np.asarray(jops.translate_x_matrices(px))])
    want = jops.decompose_affine_shears(mats)
    got = tops.decompose_affine_shears(torch.from_numpy(mats))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_transform_nearest_equal():
    x = _batch(2, (4, 32, 36, 3))
    h, w = x.shape[1:3]
    mats = np.concatenate([
        np.asarray(jops.rotation_matrices(np.float32(0.4), h, w)),
        np.asarray(jops.shear_x_matrices(np.float32(-0.3))),
        np.asarray(jops.translate_y_matrices(np.float32(9.0))),
        np.asarray(jops.identity_matrices(1)),
    ])
    want = np.asarray(jops.transform(x, mats, fill_value=128))
    got = tops.transform(torch.from_numpy(x), torch.from_numpy(mats), 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w,pad", [(64, 64, 11), (48, 80, 9)])
def test_transform_affine_separable_equal(h, w, pad):
    """Against the JAX package's XLA barrel-shift path (not the kernel)."""
    x = _batch(3, (5, h, w, 3))
    rad = np.array([0.52, -0.52], np.float32)
    mats = np.concatenate([
        np.asarray(jops.rotation_matrices(rad, h, w)),
        np.asarray(jops.shear_x_matrices(np.float32(0.3))),
        np.asarray(jops.translate_x_matrices(np.float32(-100.0))),
        np.asarray(jops.translate_y_matrices(np.float32(30.0))),
    ])
    want = np.asarray(jops.transform_affine_separable(
        x, mats, fill_value=128, pad=pad))
    got = tops.transform_affine_separable(
        torch.from_numpy(x), torch.from_numpy(mats), fill_value=128, pad=pad)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask_size", [0, 16, 80])
def test_cutout_equal_on_jax_centres(mask_size):
    x = _batch(4)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jops.cutout(jnp.asarray(x), key, mask_size, 128))
    # replay the key split image_ops.cutout performs to get its centres
    key_y, key_x = jax.random.split(key)
    cy = np.asarray(jax.random.randint(key_y, (4,), 0, x.shape[1]))
    cx = np.asarray(jax.random.randint(key_x, (4,), 0, x.shape[2]))
    got = tops.cutout(torch.from_numpy(x), torch.tensor(cy), torch.tensor(cx),
                      mask_size, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def _every_range():
    """One ``[1, 2]`` one-channel image per ``(lo, hi)`` with ``0 <= lo <=
    hi <= 255``: its two pixels are ``lo`` and ``hi``."""
    lo, hi = np.triu_indices(256)
    return np.stack([lo, hi], axis=1).astype(np.uint8).reshape(-1, 1, 2, 1)


def test_autocontrast_luts_every_range():
    """Bit-equal tables for all 32,896 channel ranges. JAX's pipelines run
    the op under ``jit``, where XLA rounds ``255 / (hi - lo)`` once and
    contracts ``v * scale + offset`` into one rounding; the port does both
    (``image_ops._autocontrast_params``, ``_rescale``). A scalar over a
    tensor in torch rounds the scale twice and misses 46 of the 255 ranges."""
    x = _every_range()
    want = np.asarray(jax.jit(jops.autocontrast_luts)(jnp.asarray(x)))
    got = tops.autocontrast_luts(torch.from_numpy(x)).numpy()
    assert want.shape == got.shape == (x.shape[0], 256)
    assert int((want != got).any(axis=1).sum()) == 0


def test_autocontrast_on_a_ramp():
    """Every channel spans 0-7, a range whose scale 255/7 a double rounding
    misses."""
    x = (np.arange(4 * 8 * 8 * 3) % 8).astype(np.uint8).reshape(4, 8, 8, 3)
    want = np.asarray(jax.jit(jops.autocontrast)(jnp.asarray(x)))
    got = tops.autocontrast(torch.from_numpy(x)).numpy()
    assert int((want != got).sum()) == 0


_ONE_CHANNEL = [
    ("to_grayscale", lambda m, x: m.to_grayscale(x)),
    ("color_1.72", lambda m, x: m.color(x, 1.72)),
    ("color_per_image", lambda m, x: m.color(x, _PER_IMAGE)),
    ("color_0.1", lambda m, x: m.color(x, 0.1)),
]


@pytest.mark.parametrize("case", _ONE_CHANNEL, ids=[c[0] for c in _ONE_CHANNEL])
def test_one_channel_bit_equal(case):
    """A one-channel image weighs its channel three times in the grayscale
    sum, in the same float order, as the JAX package's clamped index does."""
    _, op = case
    x = np.random.RandomState(3).randint(0, 256, (4, 24, 20, 1), np.uint8)
    want = np.asarray(op(jops, x))
    got = op(_TorchArgs(), x).numpy()
    assert want.shape == got.shape == x.shape[:3] + (1,)
    assert int((want != got).sum()) == 0


def test_color_op_on_one_channel():
    from chambers_tpu.augmentations.image_augmentations import Color as JColor
    from chambers_tpu_torch.augmentations.image_augmentations import Color

    x = np.random.RandomState(4).randint(0, 256, (3, 16, 16, 1), np.uint8)
    want = np.asarray(JColor(factor=1.9)(jnp.asarray(x)))
    got = Color(1.9)(torch.from_numpy(x)).numpy()
    assert int((want != got).sum()) == 0
