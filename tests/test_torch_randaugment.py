"""The port's ``RandAugment.apply`` against the JAX package's
``RandAugment(2, M, elementwise=True)``, bit-equal on the same images and
the same draws.

``jax.random`` streams cannot be reproduced by a torch generator, so the
test replays the JAX package's key splits (augmentation_schemes.py: per
round ``kd, ks, ko``; the op index from ``kd``, the sign from ``ks``, the
CutOut centres from the CutOut op's key) and hands those draws to the
port. Seeds 0 and 1 at batch 16 draw all 16 ops between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.augmentations.augmentation_schemes import (
    RandAugment as JaxRandAugment,
)
from chambers_tpu.ops import image_ops as jops
from chambers_tpu_torch.augmentations.augmentation_schemes import RandAugment
from test_torch_package import one_torch_thread  # noqa: F401

_B, _H, _W = 16, 64, 64


def _jax_draws(key, b, h, w, n_transforms=2, n_ops=16, cutout_index=14):
    draws = []
    for key_round in jax.random.split(key, n_transforms):
        kd, ks, ko = jax.random.split(key_round, 3)
        idx = jax.random.randint(kd, (b,), 0, n_ops)
        sign = jops.random_sign(ks, (b,))
        op_keys = jax.random.split(ko, n_ops)
        key_y, key_x = jax.random.split(op_keys[cutout_index])
        cy = jax.random.randint(key_y, (b,), 0, h)
        cx = jax.random.randint(key_x, (b,), 0, w)
        draws.append({k: torch.tensor(np.asarray(v)) for k, v in
                      (("idx", idx), ("sign", sign), ("cy", cy), ("cx", cx))})
    for d in draws:
        d["idx"] = d["idx"].to(torch.int64)
    return draws


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    return rng.randint(0, 256, (_B, _H, _W, 3), dtype=np.uint8)


def test_seeds_draw_every_op(images):
    drawn = set()
    for seed in (0, 1):
        for d in _jax_draws(jax.random.PRNGKey(seed), _B, _H, _W):
            drawn |= set(d["idx"].tolist())
    assert drawn == set(range(16))


@pytest.mark.parametrize("magnitude", [10, 9, 0])
def test_apply_matches_jax(images, magnitude):
    jax_aug = JaxRandAugment(n_transforms=2, magnitude=magnitude,
                             elementwise=True)
    jax_aug.fused_round_kernel = False  # the masked XLA composition
    run = jax.jit(lambda x, k: jax_aug(x, key=k))
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(run(jnp.asarray(images), key))
        draws = _jax_draws(key, _B, _H, _W)
        for fused in (True, False):
            aug = RandAugment(2, magnitude, elementwise=True,
                              fused_round_kernel=fused)
            got = aug.apply(torch.from_numpy(images), draws).numpy()
            diff = int((want != got).sum())
            assert diff == 0, (magnitude, seed, fused, diff)


def test_call_samples_on_the_images_device(images):
    aug = RandAugment(2, 10, elementwise=True)
    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(images)
    out = aug(x, generator=g)
    assert out.shape == x.shape and out.dtype == torch.uint8
    # the same generator state gives the same draws and output
    draws = aug.sample(_B, (_H, _W), torch.Generator().manual_seed(0),
                       device="cpu")
    assert torch.equal(aug.apply(x, draws), out)
    assert all(0 <= int(d["idx"].min()) and int(d["idx"].max()) < 16
               for d in draws)


def test_whole_batch_policy_not_ported(images):
    """The whole-batch policy (the default, which raised until it was
    ported) against the JAX package's ``RandAugment(2, 10)`` under ``jit``,
    bit-equal on its draws: per round ``key_draw, key_op``, one op index
    for the batch from ``key_draw``, the signs and CutOut centres from
    ``key_op``."""
    jax_whole = JaxRandAugment(n_transforms=2, magnitude=10)
    run = jax.jit(lambda x, k: jax_whole(x, key=k))
    for seed in (0, 1, 2):
        key = jax.random.PRNGKey(seed)
        draws = []
        for key_round in jax.random.split(key, 2):
            key_draw, key_op = jax.random.split(key_round)
            key_y, key_x = jax.random.split(key_op)
            draws.append({k: torch.tensor(np.asarray(v)) for k, v in (
                ("sign", jops.random_sign(key_op, (_B,))),
                ("cy", jax.random.randint(key_y, (_B,), 0, _H)),
                ("cx", jax.random.randint(key_x, (_B,), 0, _W)))})
            draws[-1]["idx"] = int(jax.random.randint(key_draw, (), 0, 16))
        got = RandAugment(2, 10).apply(torch.from_numpy(images), draws)
        assert np.array_equal(got.numpy(), np.asarray(run(images, key)))


@pytest.mark.parametrize("channels", [1, 4])
@pytest.mark.parametrize("composition", ["default", "masked"])
def test_other_channel_counts_match_jax(channels, composition):
    """K1 takes RGB only, so by default a batch of another channel count
    takes the masked composition, as the JAX package routes it; both
    packages' defaults are compared, and the port's forced masked one."""
    x = np.random.RandomState(channels).randint(
        0, 256, (_B, 32, 32, channels), dtype=np.uint8)
    jax_aug = JaxRandAugment(n_transforms=2, magnitude=10, elementwise=True)
    forced = {} if composition == "default" else {"fused_round_kernel": False}
    aug = RandAugment(2, 10, elementwise=True, **forced)
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.jit(lambda x, k: jax_aug(x, key=k))(
            jnp.asarray(x), key))
        got = aug.apply(torch.from_numpy(x), _jax_draws(key, _B, 32, 32))
        assert got.shape == x.shape
        assert int((want != got.numpy()).sum()) == 0, (channels, seed)


@pytest.mark.parametrize("dtype,channels,fused", [
    (torch.uint8, 3, True), (torch.uint8, 1, False), (torch.uint8, 4, False),
    (torch.float32, 3, False)])
def test_default_routes_rgb_uint8_to_the_kernel(dtype, channels, fused):
    from chambers_tpu_torch.augmentations.augmentation_schemes import (
        _fused_round_applicable,
    )

    x = torch.zeros((2, 8, 8, channels), dtype=dtype)
    assert _fused_round_applicable(RandAugment(2, 10, elementwise=True),
                                   x) is fused
    for forced in (True, False):
        aug = RandAugment(2, 10, elementwise=True, fused_round_kernel=forced)
        assert _fused_round_applicable(aug, x) is forced
