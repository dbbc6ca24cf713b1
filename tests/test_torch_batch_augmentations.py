"""The port's ``MixUp``, ``CutMix`` and ``mixup_or_cutmix`` against the JAX
package's (``chambers_tpu/augmentations/batch_augmentations.py``) under
``jax.jit``, on the JAX package's draws: ``lam`` from ``jax.random.beta``,
CutMix's ``k_lam, k_y, k_x`` and the switch's ``k_switch, k_op``.

uint8 images are held bit-equal: the port computes ``lam x + (1 - lam)
partner`` with the second product fused into the sum, as XLA does under
``jit``. float32 images are held within one float32 step (2^-23 of values
below 1): which product XLA fuses depends on the program around it. Labels
are held within 1e-6 (CutMix's kept share is a mean that XLA takes as a
product with the reciprocal of the pixel count).
Also ``contrast_true_mean`` on uint8 images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.augmentations import batch_augmentations as jba
from chambers_tpu.ops import image_ops as jops
from chambers_tpu_torch.augmentations import batch_augmentations as tba
from chambers_tpu_torch.ops import image_ops as tops
from test_torch_package import one_torch_thread  # noqa: F401

_B, _H, _W, _C = 8, 16, 20, 5


@pytest.fixture(scope="module", params=["uint8", "float32"])
def batch(request):
    rng = np.random.RandomState(0)
    if request.param == "uint8":
        images = rng.randint(0, 256, (_B, _H, _W, 3)).astype(np.uint8)
    else:
        images = rng.rand(_B, _H, _W, 3).astype(np.float32)
    return images, rng.randint(0, _C, _B)


def _t(x):
    return torch.from_numpy(np.array(x))


def _check(want, got):
    (want_x, want_y), (got_x, got_y) = want, got
    want_x = np.asarray(want_x)
    assert got_x.numpy().dtype == want_x.dtype
    if want_x.dtype == np.uint8:
        np.testing.assert_array_equal(got_x.numpy(), want_x)
    else:
        np.testing.assert_allclose(got_x.numpy(), want_x, rtol=0,
                                   atol=2.0 ** -23)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("per_example", [False, True])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_mixup_matches_jax(batch, per_example, smoothing):
    images, labels = batch
    kw = dict(alpha=0.4, num_classes=_C, label_smoothing=smoothing,
              per_example=per_example)
    jop, top = jba.MixUp(**kw), tba.MixUp(**kw)
    run = jax.jit(lambda x, y, k: jop(x, y, k))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        lam = np.asarray(jax.random.beta(
            key, 0.4, 0.4, (_B,) if per_example else ()))
        draws = {"lam": _t(lam) if per_example else float(lam)}
        _check(run(images, labels, key),
               top.apply(_t(images), _t(labels), draws))


def test_mixup_soft_labels_eval_and_errors(batch):
    images, labels = batch
    soft = np.full((_B, _C), 0.2, np.float32)
    top = tba.MixUp(alpha=0.2)
    _, y = top.apply(_t(images), _t(soft), {"lam": 0.3})
    np.testing.assert_allclose(y.numpy(), 0.2, atol=1e-6)
    with pytest.raises(ValueError, match="num_classes"):
        top.apply(_t(images), _t(labels), {"lam": 0.3})
    with pytest.raises(ValueError, match="alpha"):
        tba.MixUp(alpha=0.0)
    x, y = tba.MixUp(0.2, _C, 0.1)(_t(images), _t(labels), training=False)
    assert torch.equal(x, _t(images))
    want = jba._as_soft_labels(jnp.asarray(labels), _C, 0.1)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))


def _cutmix_draws(key, h, w, alpha=1.0):
    k_lam, k_y, k_x = jax.random.split(key, 3)
    return {"lam": float(jax.random.beta(k_lam, alpha, alpha)),
            "cy": float(jax.random.uniform(k_y, (), minval=0.0,
                                           maxval=float(h))),
            "cx": float(jax.random.uniform(k_x, (), minval=0.0,
                                           maxval=float(w)))}


def test_cutmix_matches_jax(batch):
    """Over 40 keys, with boxes clipped at a border among them: the box,
    the mixed images and the labels mixed by the kept share."""
    images, labels = batch
    jop = jba.CutMix(alpha=1.0, num_classes=_C, label_smoothing=0.1)
    top = tba.CutMix(alpha=1.0, num_classes=_C, label_smoothing=0.1)
    run = jax.jit(lambda x, y, k: jop(x, y, k))
    clipped = 0
    for seed in range(40):
        key = jax.random.PRNGKey(seed)
        draws = _cutmix_draws(key, _H, _W)
        got = top.apply(_t(images), _t(labels), draws)
        _check(run(images, labels, key), got)
        in_box, kept = top.box((_H, _W), draws)
        half = 0.5 * np.sqrt(1 - draws["lam"]) * np.array([_H, _W])
        inside = (draws["cy"] - half[0] >= 0 and draws["cy"] + half[0] <= _H
                  and draws["cx"] - half[1] >= 0
                  and draws["cx"] + half[1] <= _W)
        clipped += not inside
        assert kept == pytest.approx(1 - in_box.mean(), abs=1e-7)
        rows, cols = np.nonzero(in_box)
        if len(rows):  # a solid rectangle
            assert in_box.sum() == ((rows.max() - rows.min() + 1)
                                    * (cols.max() - cols.min() + 1))
    assert clipped >= 10


@pytest.mark.parametrize("switch_prob", [0.0, 0.5, 1.0])
def test_mixup_or_cutmix_matches_jax(batch, switch_prob):
    """Both coins: the switch from ``k_switch``, the op's draws from
    ``k_op``."""
    images, labels = batch
    kw = dict(num_classes=_C, label_smoothing=0.1)
    jmix, jcut = jba.MixUp(0.8, **kw), jba.CutMix(1.0, **kw)
    tmix, tcut = tba.MixUp(0.8, **kw), tba.CutMix(1.0, **kw)
    run = jax.jit(lambda x, y, k: jba.mixup_or_cutmix(
        x, y, k, mixup=jmix, cutmix=jcut, switch_prob=switch_prob))
    coins = set()
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        k_switch, k_op = jax.random.split(key)
        use_cutmix = bool(jax.random.bernoulli(k_switch, switch_prob))
        coins.add(use_cutmix)
        op_draws = (_cutmix_draws(k_op, _H, _W) if use_cutmix else
                    {"lam": float(jax.random.beta(k_op, 0.8, 0.8))})
        got = tba.mixup_or_cutmix(
            _t(images), _t(labels), mixup=tmix, cutmix=tcut,
            switch_prob=switch_prob,
            draws={"use_cutmix": use_cutmix, "draws": op_draws})
        _check(run(images, labels, key), got)
    assert coins == ({False, True} if switch_prob == 0.5 else
                     {switch_prob == 1.0})


def test_sampling_draws_on_the_host(batch):
    images, labels = batch
    g = torch.Generator().manual_seed(0)
    mix, cut = tba.MixUp(0.8, _C), tba.CutMix(1.0, _C)
    draws = tba.sample_mixup_or_cutmix(_B, (_H, _W), g, mixup=mix,
                                       cutmix=cut, device="cpu")
    assert isinstance(draws["use_cutmix"], bool)
    assert all(isinstance(v, float) for v in draws["draws"].values())
    x, y = tba.mixup_or_cutmix(_t(images), _t(labels),
                               torch.Generator().manual_seed(0), mixup=mix,
                               cutmix=cut)
    want = tba.mixup_or_cutmix(_t(images), _t(labels), mixup=mix,
                               cutmix=cut, draws=draws)
    assert torch.equal(x, want[0]) and torch.equal(y, want[1])
    np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, atol=1e-6)
    lam = tba.MixUp(0.2, _C, per_example=True).sample(
        _B, (_H, _W), g, "cpu")["lam"]
    assert lam.shape == (_B,) and bool(((lam >= 0) & (lam <= 1)).all())
    # the Beta draws follow their law: mean 1/2, variance 1/(4 (2a + 1))
    many = tba._beta(torch.Generator().manual_seed(1), 0.4, 20000)
    assert abs(many.mean() - 0.5) < 0.01
    assert abs(many.var() - 1 / (4 * 1.8)) < 0.01


@pytest.mark.parametrize("channels", [3, 1])
def test_contrast_true_mean_matches_jax(channels):
    x = np.random.RandomState(channels).randint(
        0, 256, (_B, _H, _W, channels)).astype(np.uint8)
    for factor in (0.0, 0.55, 1.9, np.linspace(0.1, 1.9, _B, dtype=np.float32)):
        want = np.asarray(jax.jit(jops.contrast_true_mean)(x, factor))
        got = tops.contrast_true_mean(_t(x), factor).numpy()
        np.testing.assert_array_equal(got, want)
