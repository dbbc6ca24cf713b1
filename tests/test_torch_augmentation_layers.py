"""The port's bilinear warp, geometric ops, ``RandomChance``,
``RandomChoice``, whole-batch ``RandAugment`` and ``AutoAugment``,
``ImageNetNormalization`` and ``ResizingMinMax`` against the JAX package.

uint8 outputs are held bit-equal to ``jax.jit`` of the JAX function (every
JAX pipeline runs jitted), with the JAX package's draws replayed from its
key splits. Two places cannot be made bit-equal, and the tests bound them:
XLA's own ``sin``/``cos`` under ``jit`` give rotation matrices one float32
step away from PyTorch's (the bilinear rotation is then bit-equal on the
JAX package's matrices and within one level on the port's own), and
``jax.image.resize`` under ``jit`` fuses its weight arithmetic and sums its
weights in a way that depends on XLA's fusion and vector lanes, so about
one weight in a hundred is a float32 step away from the port's (ROADMAP.md
§3): a uint8 resize is within one level of JAX's on at most 2% of the
pixels (under 0.1% in these tests; 1.8% in
``tests/test_torch_preprocessing.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.augmentations import image_augmentations as jaug
from chambers_tpu.augmentations.augmentation_schemes import (
    AutoAugment as JaxAutoAugment,
    RandAugment as JaxRandAugment,
)
from chambers_tpu.ops import image_ops as jops
from chambers_tpu_torch.augmentations import image_augmentations as taug
from chambers_tpu_torch.augmentations.augmentation_schemes import (
    AutoAugment,
    RandAugment,
)
from chambers_tpu_torch.ops import image_ops as tops
from test_torch_package import one_torch_thread  # noqa: F401

_B, _H, _W = 8, 24, 32
_GEOMETRIC = ("Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY")


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randint(0, 256, (_B, _H, _W, 3),
                                            dtype=np.uint8)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _diff(want, got):
    want = np.asarray(want).astype(np.int64)
    got = np.asarray(got).astype(np.int64)
    return int((want != got).sum()), int(np.abs(want - got).max())


# ---------------------------------------------------------------------------
# the bilinear warp and the geometric ops
# ---------------------------------------------------------------------------

def _projective(rng, b, h, w):
    """Rotations, shears, zooms and a projective row, per image."""
    rad = rng.uniform(-0.6, 0.6, b)
    mats = np.array(jops.rotation_matrices(rad, h, w))
    mats[:, 0] *= rng.uniform(0.7, 1.3, b)
    mats[:, 1] += rng.uniform(-0.2, 0.2, b)
    mats[:, 6:] = rng.uniform(-2e-3, 2e-3, (b, 2))
    return mats.astype(np.float32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("fill", [0.0, 128.0])
def test_bilinear_transform_matches_jax(images, dtype, fill):
    """Bit-equal on the same matrices: uint8 rounded, float32 exactly."""
    x = images.astype(dtype)
    mats = _projective(np.random.RandomState(1), _B, _H, _W)
    run = jax.jit(lambda x, t: jops.transform(
        x, t, interpolation="bilinear", fill_value=fill))
    want = np.asarray(run(x, mats))
    got = tops.transform(_t(x), _t(mats), fill, "bilinear").numpy()
    assert got.dtype == want.dtype
    assert _diff(want, got) == (0, 0)


def test_nearest_transform_is_the_default(images):
    mats = _projective(np.random.RandomState(2), _B, _H, _W)
    want = np.asarray(jax.jit(lambda x, t: jops.transform(x, t, fill_value=7))
                      (images, mats))
    got = tops.transform(_t(images), _t(mats), 7).numpy()
    assert _diff(want, got) == (0, 0)
    with pytest.raises(ValueError, match="interpolation"):
        tops.transform(_t(images), _t(mats), 0, "bicubic")


_OPS = {
    "rotate": (jops.rotate, tops.rotate, (-0.5, 0.5)),
    "shear_x": (jops.shear_x, tops.shear_x, (-0.3, 0.3)),
    "shear_y": (jops.shear_y, tops.shear_y, (-0.3, 0.3)),
    "translate_x": (jops.translate_x, tops.translate_x, (-9.5, 9.5)),
    "translate_y": (jops.translate_y, tops.translate_y, (-9.5, 9.5)),
}


@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
@pytest.mark.parametrize("name", sorted(_OPS))
def test_geometric_ops_match_jax(images, name, interpolation):
    """Each op at per-image magnitudes, uint8. Rotations build their
    matrices with ``sin``/``cos``, which XLA's jitted code rounds otherwise
    than PyTorch's in the last float32 step; on the JAX package's matrices
    the warp is bit-equal (``test_bilinear_transform_matches_jax``), on its
    own a bilinear rotation is within one level on at most 2 of these
    4608 pixels (1 here) and a nearest one is bit-equal."""
    jfn, tfn, (lo, hi) = _OPS[name]
    v = np.random.RandomState(3).uniform(lo, hi, _B).astype(np.float32)
    run = jax.jit(lambda x, v: jfn(x, v, interpolation=interpolation,
                                   fill_value=128.0))
    want = np.asarray(run(images, v))
    got = tfn(_t(images), _t(v), interpolation, 128).numpy()
    n, worst = _diff(want, got)
    if name == "rotate" and interpolation == "bilinear":
        assert n <= 2 and worst <= 1, (n, worst)
    else:
        assert (n, worst) == (0, 0)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_translate_matches_jax(images, dtype):
    x = images.astype(dtype)
    tr = np.random.RandomState(4).uniform(-6.3, 6.3, (_B, 2)).astype(
        np.float32)
    for interpolation in ("nearest", "bilinear"):
        want = np.asarray(jax.jit(lambda x, t: jops.translate(
            x, t, interpolation=interpolation, fill_value=3.0))(x, tr))
        got = tops.translate(_t(x), _t(tr), interpolation, 3.0).numpy()
        assert _diff(want, got) == (0, 0), interpolation


@pytest.mark.parametrize("name", _GEOMETRIC)
def test_bilinear_geometric_layers_match_jax(images, name):
    """The layer classes with ``interpolation="bilinear"`` (the port
    raised for it before), on the JAX package's signs."""
    kwargs = {"Rotate": {"degrees": 20.0}, "ShearX": {"level": 0.25},
              "ShearY": {"level": 0.25}, "TranslateX": {"pixels": 5.5},
              "TranslateY": {"pixels": 5.5}}[name]
    jop = getattr(jaug, name)(interpolation="bilinear", fill_value=128,
                              **kwargs)
    top = getattr(taug, name)(interpolation="bilinear", fill_value=128,
                              **kwargs)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda x, k: jop(x, key=k))(images, key))
    got = top.apply(_t(images), {"sign": _t(jops.random_sign(key, (_B,)))})
    n, worst = _diff(want, got.numpy())
    assert worst <= 1 and n <= (2 if name == "Rotate" else 0), (n, worst)


def test_contrast_true_mean_matches_jax(images):
    for factor in (0.3, 1.7, np.linspace(0.1, 1.9, _B).astype(np.float32)):
        want = np.asarray(jax.jit(jops.contrast_true_mean)(images, factor))
        got = tops.contrast_true_mean(_t(images), factor).numpy()
        assert _diff(want, got) == (0, 0)


# ---------------------------------------------------------------------------
# RandomChance, RandomChoice
# ---------------------------------------------------------------------------

def _jax_op_draws(name, key, b, h, w):
    """The draws a JAX op makes from ``key``, in the port's form."""
    if name in _GEOMETRIC:
        return {"sign": _t(jops.random_sign(key, (b,)))}
    if name == "CutOut":
        key_y, key_x = jax.random.split(key)
        return {"cy": _t(jax.random.randint(key_y, (b,), 0, h)).long(),
                "cx": _t(jax.random.randint(key_x, (b,), 0, w)).long()}
    return {}


def _pool():
    """(name, kwargs) of a small mixed pool, each op at a real magnitude."""
    return [("Invert", {}), ("Rotate", {"degrees": 20.0}),
            ("CutOut", {"mask_size": 8, "constant_values": 128}),
            ("Sharpness", {"factor": 1.6}), ("ShearX", {"level": 0.2}),
            ("Equalize", {})]


@pytest.mark.parametrize("elementwise", [False, True])
@pytest.mark.parametrize("probability", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("op", ["Rotate", "CutOut", "Invert"])
def test_random_chance_matches_jax(images, elementwise, probability, op):
    kwargs = dict(_pool())[op]
    jc = jaug.RandomChance(getattr(jaug, op)(**kwargs), probability,
                           elementwise=elementwise)
    tc = taug.RandomChance(getattr(taug, op)(**kwargs), probability,
                           elementwise=elementwise)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.jit(lambda x, k: jc(x, key=k))(images, key))
        key_draw, key_op = jax.random.split(key)
        if elementwise:
            do = _t(jax.random.uniform(key_draw, (_B,)) < probability)
        else:
            do = bool(jax.random.uniform(key_draw, ()) < probability)
        draws = {"do": do, "draws": _jax_op_draws(op, key_op, _B, _H, _W)}
        got = tc.apply(_t(images), draws).numpy()
        assert _diff(want, got) == (0, 0), seed


@pytest.mark.parametrize("elementwise", [False, True])
def test_random_choice_matches_jax(images, elementwise):
    pool = _pool()
    jc = jaug.RandomChoice([getattr(jaug, n)(**kw) for n, kw in pool], 2,
                           elementwise=elementwise)
    tc = taug.RandomChoice([getattr(taug, n)(**kw) for n, kw in pool], 2,
                           elementwise=elementwise)
    chosen = set()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.jit(lambda x, k: jc(x, key=k))(images, key))
        rounds = []
        for key_round in jax.random.split(key, 2):
            key_draw, key_op = jax.random.split(key_round)
            if elementwise:
                idx = jax.random.randint(key_draw, (_B,), 0, len(pool))
                op_keys = jax.random.split(key_op, len(pool))
                rounds.append({"idx": _t(idx).long(), "ops": [
                    _jax_op_draws(n, k, _B, _H, _W)
                    for (n, _), k in zip(pool, op_keys)]})
                chosen |= set(np.asarray(idx).tolist())
            else:
                idx = int(jax.random.randint(key_draw, (), 0, len(pool)))
                rounds.append({"idx": idx, "draws": _jax_op_draws(
                    pool[idx][0], key_op, _B, _H, _W)})
                chosen.add(idx)
        got = tc.apply(_t(images), rounds).numpy()
        assert _diff(want, got) == (0, 0), seed
    assert len(chosen) >= 4


def test_per_batch_decisions_draw_on_the_host(images):
    """A per-batch decision is a Python value from a host generator; a
    generator on another device is refused."""
    tc = taug.RandomChoice([taug.Invert(), taug.Rotate(10.0)], 3)
    rounds = tc.sample(_B, (_H, _W), torch.Generator().manual_seed(0),
                       "cpu")
    assert all(isinstance(r["idx"], int) for r in rounds)
    chance = taug.RandomChance(taug.Invert(), 0.5)
    assert isinstance(chance.sample(_B, (_H, _W), torch.Generator(),
                                    "cpu")["do"], bool)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="host"):
        taug.host_generator(on_card)
    out = tc(_t(images), torch.Generator().manual_seed(0))
    assert torch.equal(out, tc.apply(_t(images), rounds))


# ---------------------------------------------------------------------------
# whole-batch RandAugment and AutoAugment
# ---------------------------------------------------------------------------

def _jax_randaugment_draws(key, b, h, w, n_transforms=2):
    """JAX's RandomChoice over the 16 ops: per round ``key_draw, key_op``;
    the op index from ``key_draw``; the sign and the CutOut centres from
    ``key_op``, as each op draws them."""
    draws = []
    for key_round in jax.random.split(key, n_transforms):
        key_draw, key_op = jax.random.split(key_round)
        d = {"idx": int(jax.random.randint(key_draw, (), 0, 16))}
        d.update(_jax_op_draws("Rotate", key_op, b, h, w))
        d.update(_jax_op_draws("CutOut", key_op, b, h, w))
        draws.append(d)
    return draws


@pytest.mark.parametrize("magnitude", [10, 9])
def test_whole_batch_randaugment_matches_jax(images, magnitude):
    jra = JaxRandAugment(2, magnitude)
    tra = RandAugment(2, magnitude)
    run = jax.jit(lambda x, k: jra(x, key=k))
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(run(images, key))
        got = tra.apply(_t(images), _jax_randaugment_draws(key, _B, _H, _W))
        assert _diff(want, got.numpy()) == (0, 0), seed


@pytest.mark.parametrize("op", range(16))
def test_whole_batch_randaugment_every_op(images, op):
    """Each of the 16 ops forced, at magnitude 10 (Solarize's threshold
    256 wraps to 0, as in the JAX package) against the JAX op on the same
    key."""
    jra, tra = JaxRandAugment(2, 10), RandAugment(2, 10)
    key = jax.random.PRNGKey(op)
    want = np.asarray(jax.jit(lambda x, k: jra.transforms[op](x, key=k))(
        images, key))
    draws = {"idx": op, **_jax_op_draws("Rotate", key, _B, _H, _W),
             **_jax_op_draws("CutOut", key, _B, _H, _W)}
    got = tra.apply(_t(images), [draws]).numpy()
    assert _diff(want, got) == (0, 0)


def test_whole_batch_randaugment_sample(images):
    tra = RandAugment(2, 10)
    draws = tra.sample(_B, (_H, _W), torch.Generator().manual_seed(0),
                       device="cpu")
    assert len(draws) == 2
    for d in draws:
        assert isinstance(d["idx"], int) and 0 <= d["idx"] < 16
        assert set(d["sign"].tolist()) <= {-1.0, 1.0}
        assert d["cy"].shape == (_B,) and int(d["cx"].max()) < _W
    out = tra(_t(images), torch.Generator().manual_seed(0))
    assert torch.equal(out, tra.apply(_t(images), draws))


def _jax_autoaugment_draws(aug, key, b):
    key_policy, *stage_keys = jax.random.split(key, 3)
    idx = int(jax.random.randint(key_policy, (), 0, len(aug.policies)))
    stages = []
    for s, k in enumerate(stage_keys):
        key_draw, key_op = jax.random.split(k)
        p = aug.policies[idx][s][1]
        stages.append({"do": bool(jax.random.uniform(key_draw, ()) < p),
                       "sign": _t(jops.random_sign(key_op, (b,)))})
    return {"policy_idx": idx, "stages": stages}


def test_whole_batch_autoaugment_matches_jax(images):
    jaa, taa = JaxAutoAugment(), AutoAugment()
    run = jax.jit(lambda x, k: jaa(x, key=k))
    policies, fired = set(), 0
    for seed in range(30):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(run(images, key))
        draws = _jax_autoaugment_draws(taa, key, _B)
        policies.add(draws["policy_idx"])
        fired += sum(s["do"] for s in draws["stages"])
        got = taa.apply(_t(images), draws).numpy()
        assert _diff(want, got) == (0, 0), seed
    assert len(policies) >= 12 and fired >= 20


@pytest.mark.parametrize("policy", range(25))
def test_whole_batch_autoaugment_every_policy(images, policy):
    """Each sub-policy with both stages firing, against the JAX package's
    two ``RandomChance(op, 1.0)`` stages on the same keys."""
    jaa, taa = JaxAutoAugment(), AutoAugment()
    key = jax.random.PRNGKey(100 + policy)
    k1, k2 = jax.random.split(key)
    (op1, _), (op2, _) = jaa.policies[policy]

    def stages(x, k1, k2):
        x = jaug.RandomChance(jaa._ops[op1], 1.0)(x, key=k1)
        return jaug.RandomChance(jaa._ops[op2], 1.0)(x, key=k2)

    want = np.asarray(jax.jit(stages)(images, k1, k2))
    draws = {"policy_idx": policy, "stages": [
        {"do": True, "sign": _t(jops.random_sign(jax.random.split(k)[1],
                                                 (_B,)))}
        for k in (k1, k2)]}
    got = taa.apply(_t(images), draws).numpy()
    assert _diff(want, got) == (0, 0)


def test_whole_batch_autoaugment_sample():
    taa = AutoAugment()
    draws = taa.sample(_B, torch.Generator().manual_seed(3), device="cpu")
    assert isinstance(draws["policy_idx"], int)
    assert all(isinstance(s["do"], bool) for s in draws["stages"])
    assert draws["stages"][0]["sign"].shape == (_B,)


# ---------------------------------------------------------------------------
# ImageNetNormalization, ResizingMinMax
# ---------------------------------------------------------------------------

# the reference's 4x4 golden image and values
# (tests/augmentations/test_augmentation_layers.py)
_IMG = np.array([[139, 186, 208, 200], [175, 201, 198, 200],
                 [166, 191, 193, 195], [124, 155, 172, 151]], np.uint8)
_IMG = np.stack([_IMG] * 3, axis=-1)[None]
_GOLDEN = {
    "caffe": [[35.060997, 82.061, 104.061, 96.061],
              [71.061, 97.061, 94.061, 96.061],
              [62.060997, 87.061, 89.061, 91.061],
              [20.060997, 51.060997, 68.061, 47.060997]],
    "tf": [[0.0901961327, 0.458823562, 0.631372571, 0.568627477],
           [0.372549057, 0.576470613, 0.552941203, 0.568627477],
           [0.301960826, 0.498039246, 0.513725519, 0.529411793],
           [-0.0274509788, 0.215686321, 0.349019647, 0.184313774]],
    "torch": [[0.262436897, 1.06730032, 1.44404483, 1.30704677],
              [0.878928, 1.32417154, 1.27279735, 1.30704677],
              [0.724805236, 1.15292406, 1.1871736, 1.22142303],
              [0.00556548592, 0.536432922, 0.827553749, 0.467933923]],
}


@pytest.mark.parametrize("mode", ["caffe", "tf", "torch"])
def test_imagenet_normalization_golden(images, mode):
    """The golden pixels exactly in caffe and tf mode, within 1e-6 in
    torch mode (as the JAX package's own test holds them); on a random
    batch within 1e-6 of jitted JAX (which multiplies by the reciprocals
    and fuses ``x * (1 / 127.5) - 1``: a few float32 steps of values up to
    2.6) and exactly equal to JAX op by op."""
    norm = taug.ImageNetNormalization(mode)
    got = norm(_t(_IMG))[0, ..., 0].numpy()
    golden = np.asarray(_GOLDEN[mode], np.float32)
    if mode == "torch":
        np.testing.assert_allclose(got, golden, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, golden)
    jnorm = jaug.ImageNetNormalization(mode)
    got = norm(_t(images)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jnorm)(images)),
                               rtol=0, atol=1e-6)
    with jax.disable_jit():
        eager = np.asarray(jnorm(jnp.asarray(images)))
    np.testing.assert_array_equal(got, eager)
    assert got.dtype == np.float32 and got.shape == images.shape


def test_imagenet_normalization_unknown_mode():
    with pytest.raises(ValueError, match="Unknown mode"):
        taug.ImageNetNormalization("bogus")


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
@pytest.mark.parametrize("sides", [dict(min_side=12), dict(min_side=40),
                                   dict(max_side=20), dict(max_side=64),
                                   dict(min_side=30, max_side=36)])
def test_resizing_min_max_matches_jax(images, interpolation, sides):
    """Up- and down-scaling, uint8 and float32, against jitted JAX: nearest
    bit-equal; bilinear uint8 within one level on at most 2% of the
    pixels and float32 within 1e-4 (module notes)."""
    jr = jaug.ResizingMinMax(interpolation=interpolation, **sides)
    tr = taug.ResizingMinMax(interpolation=interpolation, **sides)
    want = np.asarray(jax.jit(jr)(images))
    got = tr(_t(images)).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    n, worst = _diff(want, got)
    if interpolation == "nearest":
        assert (n, worst) == (0, 0)
    else:
        assert worst <= 1 and n <= 2e-2 * want.size, (n, worst)
    x = images.astype(np.float32) / 7.0
    np.testing.assert_allclose(tr(_t(x)).numpy(), np.asarray(jax.jit(jr)(x)),
                               rtol=0, atol=1e-4)


def test_resizing_min_max_shapes():
    img = _t(_IMG[:, :, :3, :])
    assert tuple(taug.ResizingMinMax(min_side=100)(img).shape) == (
        1, 133, 100, 3)
    assert tuple(taug.ResizingMinMax(max_side=100)(img).shape) == (
        1, 100, 75, 3)
    assert tuple(taug.ResizingMinMax(min_side=100, max_side=50)(img).shape
                 ) == (1, 50, 37, 3)
    with pytest.raises(ValueError):
        taug.ResizingMinMax()

