"""The port's ``AutoAugment.apply`` against the JAX package's
``AutoAugment(elementwise=True)``, bit-equal on the same images and the
same draws, in both compositions (fused over K1's plain version, masked
over K2's).

A torch generator cannot replay ``jax.random``, so the test replays the
JAX package's key splits (augmentation_schemes.py: ``key_policy, key_s1,
key_s2``; per stage ``key_chance, key_sign, key_ops``) and hands the port
the sub-policy of each image and, per stage, whether its op fired and the
sign of its magnitude."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.augmentations import AutoAugment as JaxAutoAugment
from chambers_tpu.ops import image_ops as jops
from chambers_tpu_torch.augmentations.augmentation_schemes import (
    _PROJECTIVE_OPS,
    AutoAugment,
)
from test_torch_package import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "augmentations",
                      "golden_autoaugment_elementwise.npz")


def _jax_draws(key, b, policies):
    key_policy, key_s1, key_s2 = jax.random.split(key, 3)
    policy_idx = jax.random.randint(key_policy, (b,), 0, len(policies))
    stages = []
    for stage, stage_key in ((0, key_s1), (1, key_s2)):
        key_chance, key_sign, _ = jax.random.split(stage_key, 3)
        prob = jnp.asarray([p[stage][1] for p in policies], jnp.float32)
        do = jax.random.uniform(key_chance, (b,)) < prob[policy_idx]
        sign = jops.random_sign(key_sign, (b,))
        stages.append({"do": torch.tensor(np.asarray(do)),
                       "sign": torch.tensor(np.asarray(sign))})
    return {"policy_idx": torch.tensor(np.asarray(policy_idx),
                                       dtype=torch.int64),
            "stages": stages}


@pytest.fixture(scope="module")
def jax_aug():
    aug = JaxAutoAugment(elementwise=True)
    return aug, jax.jit(lambda x, k: aug(x, key=k))


def _check(jax_aug, images, seed, fused):
    aug, run = jax_aug
    key = jax.random.PRNGKey(seed)
    want = np.asarray(run(jnp.asarray(images), key))
    port = AutoAugment(elementwise=True, fused_round_kernel=fused)
    got = port.apply(torch.from_numpy(images),
                     _jax_draws(key, images.shape[0], aug.policies)).numpy()
    assert got.shape == images.shape and got.dtype == np.uint8
    assert int((want != got).sum()) == 0, (seed, fused)
    return got


def test_tables_follow_the_jax_package():
    aug = JaxAutoAugment(elementwise=True)
    port = AutoAugment(elementwise=True)
    assert port._op_specs == aug._op_specs
    assert port.policies == aug.policies
    assert len(port._op_specs) == 33
    assert [s for s in port._op_specs if s[0] == "Equalize"] == [
        ("Equalize", None), ("Equalize", 7), ("Equalize", 1)]
    assert port._max_rotation == pytest.approx(np.radians(27.0))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_golden_batch_bit_equal(jax_aug, seed, fused):
    """The golden batch, against JAX and against the outputs stored with
    it."""
    data = np.load(GOLDEN)
    got = _check(jax_aug, data["batch"], seed, fused)
    np.testing.assert_array_equal(got, data[f"seed{seed}"])


@pytest.mark.parametrize("fused", [True, False])
def test_384px_batch_bit_equal(jax_aug, fused):
    """BASELINE config 3's image size, two images."""
    x = np.random.RandomState(384).randint(0, 256, (2, 384, 384, 3),
                                           np.uint8)
    _check(jax_aug, x, 3, fused)


@pytest.mark.parametrize("channels", [1, 4])
def test_other_channel_counts_bit_equal(jax_aug, channels):
    """K1 takes RGB only: the default routes another channel count to the
    masked composition, as the JAX package does."""
    x = np.random.RandomState(channels).randint(0, 256, (8, 32, 32, channels),
                                                np.uint8)
    for seed in (0, 1):
        _check(jax_aug, x, seed, None)


def test_the_draws_cover_every_op_class(jax_aug):
    """The golden seeds fire a warp, Color, a table op and a passthrough
    stage between them, so the tests above reach every branch."""
    aug, _ = jax_aug

    def kind(name):
        if name in _PROJECTIVE_OPS:
            return "warp"
        return "color" if name == "Color" else "table"

    fired, skipped = set(), 0
    for seed in (0, 1, 7):
        d = _jax_draws(jax.random.PRNGKey(seed), 8, aug.policies)
        for s, stage in enumerate(d["stages"]):
            for i, do in zip(d["policy_idx"].tolist(), stage["do"].tolist()):
                if do:
                    fired.add(kind(aug._op_specs[aug.policies[i][s][0]][0]))
                else:
                    skipped += 1
    assert fired == {"warp", "color", "table"} and skipped


def test_sample_and_call():
    aug = AutoAugment(elementwise=True)
    draws = aug.sample(16, torch.Generator().manual_seed(0), device="cpu")
    assert draws["policy_idx"].dtype == torch.int64
    assert draws["policy_idx"].shape == (16,)
    assert int(draws["policy_idx"].max()) < 25
    for stage in draws["stages"]:
        assert stage["do"].dtype == torch.bool
        assert set(stage["sign"].tolist()) <= {-1.0, 1.0}
    # a probability-0 stage never fires
    never = [i for i, p in enumerate(aug.policies) if p[1][1] == 0.0]
    big = aug.sample(4096, torch.Generator().manual_seed(1), device="cpu")
    assert not big["stages"][1]["do"][
        torch.isin(big["policy_idx"], torch.tensor(never))].any()
    x = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (16, 32, 32, 3), np.uint8))
    out = aug(x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(out, aug.apply(x, draws))
    # the probability table is built once a device, not on every draw
    assert aug.policy_tables("cpu") is aug.policy_tables(torch.device("cpu"))


def test_whole_batch_policy_not_ported():
    """The whole-batch policy (the default, which raised until it was
    ported) against the JAX package's ``AutoAugment()`` under ``jit``,
    bit-equal on its draws: the sub-policy from ``key_policy``, and per
    stage whether the op fires and its signs from the stage's ``key_draw,
    key_op`` (``tests/test_torch_augmentation_layers.py`` covers every
    sub-policy)."""
    jax_whole, whole = JaxAutoAugment(), AutoAugment()
    images = np.random.RandomState(5).randint(0, 256, (8, 32, 32, 3),
                                              np.uint8)
    run = jax.jit(lambda x, k: jax_whole(x, key=k))
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        key_policy, *stage_keys = jax.random.split(key, 3)
        idx = int(jax.random.randint(key_policy, (), 0, 25))
        stages = []
        for s, k in enumerate(stage_keys):
            key_draw, key_op = jax.random.split(k)
            stages.append({
                "do": bool(jax.random.uniform(key_draw, ())
                           < whole.policies[idx][s][1]),
                "sign": torch.tensor(np.asarray(
                    jops.random_sign(key_op, (8,))))})
        got = whole.apply(torch.from_numpy(images),
                          {"policy_idx": idx, "stages": stages})
        assert np.array_equal(got.numpy(), np.asarray(run(images, key)))
