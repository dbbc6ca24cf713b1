"""The port's DeiT (``DistilledVisionTransformer``, the DeiT presets) and
the two train steps of the DeiT recipe against the JAX package, float32
on the CPU, on the JAX package's seeded init converted with
``state_dict_from_jax``.

- The model: both heads within 1e-4 (BASELINE.md's sub-module gate for a
  whole model is 1e-3 on the logits; these 2-layer models meet 1e-4), in
  every pooling, with and without ``return_dist_token``, and on the flash
  kernel (the JAX kernel in interpret mode, the port's plain version).
- The steps, as ``examples/train_deit_recipe.py`` assembles them at a small
  size (2 layers, width 64, 32 px): whole-batch ``RandAugment`` on JAX's
  draws (bit-equal), ``ImageNetNormalization("tf")``, then either
  ``mixup_or_cutmix`` into a ViT with categorical cross-entropy on the
  soft labels (``recipe``) or the distilled ViT with hard distillation
  from a frozen ViT teacher (``distilled``). Loss and gradients within
  1e-5 of JAX's; then two AdamW updates under ``LinearWarmup
  (CosineDecay)`` (the first at learning rate 0, weight decay only) with
  the recipe's decay mask, within 1e-6 of JAX's on the same gradients and
  end to end where ``|g| > 1e-5`` (Adam's first ``g / (|g| + 1e-7)``
  amplifies ~3e-8 gradient differences where ``|g|`` is near 1e-7, as in
  ``tests/test_torch_metric_learning.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chambers_tpu.augmentations import ImageNetNormalization as JaxNorm
from chambers_tpu.augmentations import batch_augmentations as jba
from chambers_tpu.augmentations.augmentation_schemes import (
    RandAugment as JaxRandAugment,
)
from chambers_tpu.losses.categorical import (
    CategoricalCrossentropy as JaxCCE,
)
from chambers_tpu.losses.distillation import (
    DistillationLoss as JaxDistillationLoss,
)
from chambers_tpu.models.backbones import vision_transformer as jvit
from chambers_tpu.ops import image_ops as jops
from chambers_tpu.optimizers import AdamW as JaxAdamW
from chambers_tpu.schedules import CosineDecay as JaxCosine
from chambers_tpu.schedules import LinearWarmup as JaxWarmup
from chambers_tpu_torch.augmentations import (
    CutMix,
    ImageNetNormalization,
    MixUp,
    RandAugment,
    mixup_or_cutmix,
)
from chambers_tpu_torch.losses import (
    CategoricalCrossentropy,
    DistillationLoss,
)
from chambers_tpu_torch.models.backbones import vision_transformer as tvit
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from chambers_tpu_torch.optimizers import AdamW
from chambers_tpu_torch.schedules import CosineDecay, LinearWarmup
from test_torch_seq2seq import _dense_twin_init
from test_torch_package import one_torch_thread  # noqa: F401

CPU = "cpu"
_B, _SIZE, _CLASSES = 8, 32, 10
_SMALL = dict(patch_size=8, patch_dim=64, n_encoder_layers=2, n_heads=4,
              ff_dim=128)
_DECAY_EXCLUDE = ["bias", "norm", "cls", "dist"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (_B, _SIZE, _SIZE, 3))
    return (x / 127.5 - 1.0).astype(dtype) if dtype == np.float32 else (
        x.astype(dtype))


def _jax_deit(**kw):
    """The JAX DeiT and its seeded initial parameters (a flash model's
    through its dense twin, ``_dense_twin_init``)."""
    cfg = dict(_SMALL, dropout_rate=0.0, classes=_CLASSES, pooling="cls")
    cfg.update(kw)
    module = jvit.DistilledVisionTransformer(**cfg)
    params = _dense_twin_init(module, jax.random.PRNGKey(0),
                              jnp.zeros((1, _SIZE, _SIZE, 3)))
    return module, params


def _port_deit(params, **kw):
    cfg = dict(dropout_rate=0.0, classes=_CLASSES, pooling="cls")
    cfg.update(kw)
    model = tvit.DistilledVisionTransformer(
        _SMALL["patch_size"], _SMALL["patch_dim"],
        _SMALL["n_encoder_layers"], _SMALL["n_heads"], _SMALL["ff_dim"],
        image_size=(_SIZE, _SIZE), device=CPU, **cfg)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    return model.eval()


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("pooling,return_dist_token", [
    (pooling, dist) for pooling in ("cls", "avg", "max", "sum", None)
    for dist in (True, False) if pooling or dist])
def test_distilled_vit_matches_jax(pooling, return_dist_token):
    """Both heads within 1e-4; ``avg``, ``max`` and ``sum`` pool over
    everything but token 0, the distillation token included, as the JAX
    package does. Without pooling the ``predictions`` head runs on every
    token (the JAX module cannot average that with the distillation head,
    so that pair is not a case)."""
    module, params = _jax_deit(pooling=pooling,
                               return_dist_token=return_dist_token)
    x = _images()
    want = module.apply({"params": params}, jnp.asarray(x))
    model = _port_deit(params, pooling=pooling,
                       return_dist_token=return_dist_token)
    with torch.no_grad():
        got = model(_t(x))
    if return_dist_token:
        assert len(got) == 2
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            assert _max_abs(w, g) <= 1e-4
    else:
        assert tuple(got.shape) == want.shape and _max_abs(want, got) <= 1e-4


def test_token_order_and_position_table():
    """The tokens run ``[cls, dist, patches...]`` and the position table
    has two rows more than the patches: with the encoder's output read
    back, token 1 is what the distillation head sees."""
    module, params = _jax_deit()
    model = _port_deit(params)
    assert tuple(model.pos_embedding.embeddings.shape)[-2] == 16 + 2
    x = _t(_images())
    with torch.no_grad():
        seq = model.embed(x, deterministic=True)
        _, dist = model(x)
        head = model.predictions_dist(seq[:, 1])
    assert torch.allclose(dist, head, atol=1e-6)
    want = module.apply({"params": params}, jnp.asarray(_images()),
                        method=lambda m, x: m.encoder(m.pos_embedding(
                            m.add_cls_token(m.add_dist_token(
                                m.patch_embeddings(x).reshape(
                                    x.shape[0], -1, 64))))))
    assert _max_abs(want, seq) <= 1e-4


def test_distilled_vit_on_flash_matches_jax():
    """``attention_impl="flash"``: the JAX kernel in interpret mode, the
    port's plain version and its hand-written backward on the CPU;
    logits within 1e-4, gradients of the summed heads within 1e-4 (the JAX
    package's own flash-versus-dense bound)."""
    module, params = _jax_deit(attention_impl="flash")
    x = _images(1)

    def total(p):
        cls, dist = module.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(cls * dist) / 100.0, (cls, dist)

    (_, (want_cls, want_dist)), jgrads = jax.value_and_grad(
        total, has_aux=True)(params)
    model = _port_deit(params, attention_impl="flash")
    cls, dist = model(_t(x))
    (cls * dist).sum().div(100.0).backward()
    assert _max_abs(want_cls, cls.detach()) <= 1e-4
    assert _max_abs(want_dist, dist.detach()) <= 1e-4
    want_grads = state_dict_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        assert _max_abs(want_grads[name], p.grad) <= 1e-4, name


@pytest.mark.parametrize("impl,k", [("xla", 1), ("flash", 2)])
def test_routed_distilled_vit_matches_jax(impl, k):
    """The 2-layer DeiT with its second MLP routed over 4 experts: both
    heads within 1e-4, the aux loss within 1e-6 relative, the gradients of
    the heads' product plus the aux loss within 1e-4."""
    from chambers_tpu.layers.moe import moe_aux_loss as jax_moe_aux_loss
    from chambers_tpu_torch.layers.moe import MoEEncoderLayer, moe_aux_loss

    routed = dict(moe_every_n=2, moe_n_experts=4, moe_n_selected_experts=k,
                  attention_impl=impl)
    module, params = _jax_deit(**routed)
    x = _images(2)

    def total(p):
        (cls, dist), state = module.apply({"params": p}, jnp.asarray(x),
                                          mutable=["intermediates"])
        aux = jax_moe_aux_loss(state["intermediates"])
        return jnp.sum(cls * dist) / 100.0 + aux, (cls, dist, aux)

    (_, (want_cls, want_dist, aux_want)), jgrads = jax.value_and_grad(
        total, has_aux=True)(params)
    model = _port_deit(params, **routed)
    assert isinstance(model.encoder.layers[1], MoEEncoderLayer)
    cls, dist = model(_t(x))
    aux = moe_aux_loss(model)
    ((cls * dist).sum().div(100.0) + aux).backward()
    assert _max_abs(want_cls, cls.detach()) <= 1e-4
    assert _max_abs(want_dist, dist.detach()) <= 1e-4
    np.testing.assert_allclose(aux.item(), float(aux_want), rtol=1e-6)
    want_grads = state_dict_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        assert _max_abs(want_grads[name], p.grad) <= 1e-4, name


def test_distilled_vit_remat_on_flash_matches_plain():
    """``remat=True`` on the routed DeiT over the flash kernels (plain
    versions here): the same heads, aux loss and gradients as without."""
    from chambers_tpu_torch.layers.moe import moe_aux_loss

    kw = dict(attention_impl="flash", moe_every_n=2, moe_n_experts=4)
    _, params = _jax_deit(**kw)
    x = _t(_images(3))
    runs = []
    for remat in (False, True):
        model = _port_deit(params, remat=remat, **kw).train()
        cls, dist = model(x)
        aux = moe_aux_loss(model)
        ((cls * dist).sum() + aux).backward()
        runs.append((cls.detach(), dist.detach(), aux.detach(),
                     {n: p.grad for n, p in model.named_parameters()}))
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    for name, grad in runs[0][3].items():
        assert torch.equal(grad, runs[1][3][name]), name


@pytest.mark.parametrize("preset,width,depth,heads,mlp", [
    ("DeiTS16", 384, 12, 6, 1536), ("DeiTB16", 768, 12, 12, 3072)])
def test_deit_presets(preset, width, depth, heads, mlp, tmp_path,
                      monkeypatch):
    """Each preset's parameters have the JAX preset's names and shapes
    (the JAX module's shapes from ``jax.eval_shape``); the presets fix
    ``dropout_rate=0.1``, return eval mode and look for released weights
    in the cache directory, naming the missing file (nothing is
    downloaded)."""
    module = jvit.DistilledVisionTransformer(
        patch_size=16, patch_dim=width, n_encoder_layers=depth,
        n_heads=heads, ff_dim=mlp, dropout_rate=0.1, pooling="cls")
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))["params"]
    want = {_port_name(path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes)}
    model = getattr(tvit, preset)(device=CPU)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert not model.training and model.dropout_rate == 0.1
    assert model.return_dist_token
    out = getattr(tvit, preset)(input_shape=(32, 32, 3), classes=3,
                                return_dist_token=False, device=CPU)(
        torch.zeros(2, 32, 32, 3))
    assert tuple(out.shape) == (2, 3)
    monkeypatch.setenv("CHAMBERS_TPU_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError,
                       match=f"{preset.lower()}_imagenet_1000_224.h5"):
        getattr(tvit, preset)(weights="imagenet_224", device=CPU)
    # routing: the presets take it, and refuse it with weights, as JAX's
    routed = getattr(tvit, preset)(input_shape=(32, 32, 3), classes=3,
                                   moe_every_n=4, moe_n_experts=2,
                                   device=CPU)
    assert [layer.moe is not None for layer in routed.encoder.layers] == [
        i % 4 == 3 for i in range(depth)]
    with pytest.raises(ValueError, match="moe_every_n"):
        getattr(tvit, preset)(weights="imagenet_224", moe_every_n=2,
                              device=CPU)
    with pytest.raises(ValueError, match="moe_every_n"):
        getattr(jvit, preset)(weights="imagenet_224", moe_every_n=2)


def test_deit_state_dict_converts():
    """DeiT's Flax names (``add_dist_token``, ``predictions_dist``) load
    through ``state_dict_from_jax`` with no key missing or left over."""
    _, params = _jax_deit()
    state = state_dict_from_jax(jax.device_get(params))
    assert {"add_dist_token.embeddings", "predictions_dist.kernel",
            "predictions_dist.bias"} <= set(state)
    model = tvit.DistilledVisionTransformer(
        8, 64, 2, 4, 128, image_size=(_SIZE, _SIZE), classes=_CLASSES,
        device=CPU)
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not missing and not unexpected


@pytest.mark.parametrize("mode", ["tf", "torch", "caffe"])
def test_fold_normalization_into_deit(mode):
    """The folded DeiT ``state_dict`` equals the JAX package's folded
    variables, and the folded model on raw pixels follows the unfolded one
    on normalized pixels."""
    module, params = _jax_deit()
    want = jvit.fold_imagenet_normalization({"params": params}, mode)
    state = tvit.fold_imagenet_normalization(
        state_dict_from_jax(jax.device_get(params)), mode)
    for key in ("patch_embeddings.kernel", "patch_embeddings.bias"):
        node = want["params"]["patch_embeddings"][key.split(".")[1]]
        # the bias sums 192 products in another order (caffe's offsets,
        # ~100, make them large): within 1e-6 of the largest value
        node = np.asarray(node)
        np.testing.assert_allclose(state[key].numpy(), node, rtol=0,
                                   atol=1e-6 * np.abs(node).max())
    raw = _images(2, np.uint8)
    folded = _port_deit(params)
    folded.load_state_dict(state)
    plain = _port_deit(params)
    with torch.no_grad():
        a = folded(_t(raw).float())
        b = plain(ImageNetNormalization(mode)(_t(raw)))
    for x, y in zip(a, b):
        assert _max_abs(x, y) <= 1e-3


# ---------------------------------------------------------------------------
# the two train steps of the DeiT recipe
# ---------------------------------------------------------------------------

def _port_name(path):
    return ".".join(re.sub(r"^layers_(\d+)$", r"layers.\1", k.key)
                    for k in path)


def _augmented_batch(seed):
    """Whole-batch RandAugment(2, 9) in both packages on JAX's draws (the
    uint8 results held bit-equal), then 'tf' normalization."""
    images = np.random.RandomState(seed).randint(
        0, 256, (_B, _SIZE, _SIZE, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.jit(lambda x, k: JaxRandAugment(2, 9)(x, key=k))(
        images, key))
    draws = []
    for key_round in jax.random.split(key, 2):
        key_draw, key_op = jax.random.split(key_round)
        key_y, key_x = jax.random.split(key_op)
        draws.append({
            "idx": int(jax.random.randint(key_draw, (), 0, 16)),
            "sign": _t(jops.random_sign(key_op, (_B,))),
            "cy": _t(jax.random.randint(key_y, (_B,), 0, _SIZE)).long(),
            "cx": _t(jax.random.randint(key_x, (_B,), 0, _SIZE)).long()})
    got = RandAugment(2, 9).apply(_t(images), draws)
    np.testing.assert_array_equal(got.numpy(), want)
    jx = JaxNorm("tf")(jnp.asarray(want))
    tx = ImageNetNormalization("tf")(got)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    return jx, tx


def _schedules():
    return (JaxWarmup(JaxCosine(5e-4, decay_steps=8), warmup_steps=2),
            LinearWarmup(CosineDecay(5e-4, decay_steps=8), warmup_steps=2))


def _check_step(jloss, jgrads, params, loss, model):
    """Loss and gradients within 1e-5; two AdamW updates (steps 0 and 1 of
    the warmup) within 1e-6 of JAX's, on the port's gradients and end to
    end where ``|g| > 1e-5``."""
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want_grads = state_dict_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    jsched, tsched = _schedules()
    jopt = JaxAdamW(weight_decay=0.05, learning_rate=jsched,
                    decay_exclude=_DECAY_EXCLUDE)
    opt = AdamW(model.named_parameters(), weight_decay=0.05,
                learning_rate=tsched, decay_exclude=_DECAY_EXCLUDE)
    port_grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    same = jax.tree_util.tree_map_with_path(
        lambda path, _: port_grads[_port_name(path)], params)

    def two_updates(grads):
        p, state = params, jopt.init(params)
        for _ in range(2):
            updates, state = jopt.update(grads, state, p)
            p = optax.apply_updates(p, updates)
        return state_dict_from_jax(jax.device_get(p))

    on_same, end_to_end = two_updates(same), two_updates(jgrads)
    opt.step()
    opt.step()
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got, on_same[name].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
        live = np.abs(want_grads[name].numpy()) > 1e-5
        np.testing.assert_allclose(got[live], end_to_end[name].numpy()[live],
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    return opt


def _full_size_params(module_cls, **kw):
    """The parameter shapes of a full-size B/16 model of the JAX package
    (``jax.eval_shape``: nothing is computed)."""
    module = module_cls(patch_size=16, patch_dim=768, n_encoder_layers=12,
                        n_heads=12, ff_dim=3072, dropout_rate=0.0, **kw)
    return jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 224, 224, 3)))["params"]


@pytest.mark.parametrize("mode", ["recipe", "distilled"])
def test_decay_mask_matches_jax(mode):
    """The recipe's ``decay_exclude`` leaves the same parameters to decay
    in both packages, at DeiT-B/16's widths: the port's ``decay_mask`` on
    the model, JAX's on its parameters, and the list ``chip_smoke.py``
    phase 20 carries as data."""
    import chip_smoke
    from chambers_tpu import optimizers as jopt
    from chambers_tpu_torch import optimizers as topt

    if mode == "recipe":
        params = _full_size_params(jvit.VisionTransformer)
        model = tvit.VisionTransformer(16, 768, 12, 12, 3072,
                                       dropout_rate=0.0, device="meta")
    else:
        params = _full_size_params(jvit.DistilledVisionTransformer,
                                   pooling="cls")
        model = tvit.DistilledVisionTransformer(
            16, 768, 12, 12, 3072, dropout_rate=0.0, pooling="cls",
            device="meta")
    mask = jopt.decay_mask(params, decay_exclude=_DECAY_EXCLUDE)
    want = {path for path, decays in zip(
        jopt._param_paths(params), jax.tree_util.tree_leaves(mask))
        if decays}
    got = {topt.jax_path(name) for name, decays in topt.decay_mask(
        model, decay_exclude=_DECAY_EXCLUDE).items() if decays}
    assert got == want == set(chip_smoke.deit_decayed_paths())
    assert not any(re.search("cls|dist|bias|norm", path) for path in got)


def test_distilled_step_matches_jax():
    """``distilled``: hard distillation of the DeiT's two heads, the
    teacher a frozen ViT of the same width (its argmax labels equal in
    both packages)."""
    jx, tx = _augmented_batch(3)
    labels = np.arange(_B) % _CLASSES
    tcfg = dict(_SMALL, dropout_rate=0.0, classes=_CLASSES)
    jteacher = jvit.VisionTransformer(**tcfg)
    tparams = jteacher.init(jax.random.PRNGKey(7), jx[:1])["params"]
    jteacher_logits = jteacher.apply({"params": tparams}, jx)
    teacher = tvit.VisionTransformer(
        8, 64, 2, 4, 128, dropout_rate=0.0, image_size=(_SIZE, _SIZE),
        classes=_CLASSES, device=CPU)
    teacher.load_state_dict(state_dict_from_jax(jax.device_get(tparams)))
    with torch.no_grad():
        teacher_logits = teacher.eval()(tx)
    assert _max_abs(jteacher_logits, teacher_logits) <= 1e-4
    assert np.array_equal(np.asarray(jteacher_logits).argmax(-1),
                          teacher_logits.argmax(-1).numpy())

    module, params = _jax_deit()
    jl = JaxDistillationLoss("hard")

    def loss_of(p):
        out = module.apply({"params": p}, jx)
        return jl((jnp.asarray(labels), jteacher_logits), out)

    jloss, jgrads = jax.value_and_grad(loss_of)(params)
    model = _port_deit(params).train()
    out = model(tx, deterministic=True)
    loss = DistillationLoss("hard")((_t(labels), teacher_logits), out)
    loss.backward()
    assert float(jloss) > 1.0
    _check_step(jloss, jgrads, params, loss, model)


@pytest.mark.parametrize("use_cutmix", [False, True])
def test_recipe_step_matches_jax(use_cutmix):
    """``recipe``: ``mixup_or_cutmix`` (MixUp(0.8), CutMix(1.0), label
    smoothing 0.1) on JAX's draws into a ViT, categorical cross-entropy
    on the soft labels from logits."""
    jx, tx = _augmented_batch(4 + use_cutmix)
    labels = np.arange(_B) % _CLASSES
    kw = dict(num_classes=_CLASSES, label_smoothing=0.1)
    key = jax.random.PRNGKey(11)
    if use_cutmix:
        k_lam, k_y, k_x = jax.random.split(key, 3)
        draws = {"lam": float(jax.random.beta(k_lam, 1.0, 1.0)),
                 "cy": float(jax.random.uniform(k_y, (), maxval=_SIZE)),
                 "cx": float(jax.random.uniform(k_x, (), maxval=_SIZE))}
        jmixed = jba.CutMix(1.0, **kw)(jx, jnp.asarray(labels), key)
    else:
        draws = {"lam": float(jax.random.beta(key, 0.8, 0.8))}
        jmixed = jba.MixUp(0.8, **kw)(jx, jnp.asarray(labels), key)
    x, y = mixup_or_cutmix(tx, _t(labels), mixup=MixUp(0.8, **kw),
                           cutmix=CutMix(1.0, **kw),
                           draws={"use_cutmix": use_cutmix, "draws": draws})
    # float32 images within one step (tests/test_torch_batch_augmentations)
    np.testing.assert_allclose(x.numpy(), np.asarray(jmixed[0]), rtol=0,
                               atol=2.0 ** -23)
    np.testing.assert_allclose(y.numpy(), np.asarray(jmixed[1]), atol=1e-6)

    cfg = dict(_SMALL, dropout_rate=0.0, classes=_CLASSES)
    module = jvit.VisionTransformer(**cfg)
    params = module.init(jax.random.PRNGKey(0), jx[:1])["params"]
    jl = JaxCCE(from_logits=True)

    def loss_of(p):
        return jl(jmixed[1], module.apply({"params": p}, jmixed[0]))

    jloss, jgrads = jax.value_and_grad(loss_of)(params)
    model = tvit.VisionTransformer(
        8, 64, 2, 4, 128, dropout_rate=0.0, image_size=(_SIZE, _SIZE),
        classes=_CLASSES, device=CPU)
    model.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    loss = CategoricalCrossentropy(from_logits=True)(
        y, model.train()(x, deterministic=True))
    loss.backward()
    _check_step(jloss, jgrads, params, loss, model)
