"""The port's CNN backbones as whole models, and the train step of
``examples/train_cnn_classifier.py``, against the JAX package's, on the
CPU.

Full width at reduced depth (one block a stage; three BN-Inception
modules: 3a, the reduction 3c and 5b), batch 2 of seeded 64 px images.
The weights are the JAX package's init with every BatchNorm's ``scale``,
``bias``, ``mean`` and ``var`` drawn at random (``var`` positive),
converted with ``state_dict_from_jax``. Tolerances: outputs within 1e-4 of
the output's largest magnitude (float32 sums in another order through a
dozen layers), train-mode statistics within 1e-5; one SGDW step of
SE-ResNet within 1e-5 on the loss, 1e-4 of each gradient's largest
magnitude and 1e-6 on the parameters and statistics after it, two steps.
At 64 px the last stage normalizes over 2 x 2 x 2 values; at 32 px (one
value a sample) a batch of 2 leaves BatchNorm ill-conditioned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chambers_tpu import optimizers as jopt
from chambers_tpu import schedules as jsched
from chambers_tpu.models.backbones import inception as jinc
from chambers_tpu.models.backbones import resnext as jrx
from chambers_tpu.models.backbones import senet as jse
from chambers_tpu_torch import optimizers as topt
from chambers_tpu_torch import schedules as tsched
from chambers_tpu_torch.models.backbones import inception as tinc
from chambers_tpu_torch.models.backbones import resnext as trx
from chambers_tpu_torch.models.backbones import senet as tse
from chambers_tpu_torch.models.backbones.convert import (
    jax_path,
    jax_variables,
    load_jax_variables,
    state_dict_from_jax,
)
from test_torch_package import one_torch_thread  # noqa: F401


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _randomize_bn(variables, seed=1):
    """Random BatchNorm parameters and statistics: scale 1 ± 0.2, bias and
    mean ± 0.2, var in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    variables = _np(variables)

    def walk(params, stats):
        for key, child in params.items():
            if key.startswith("BatchNorm"):
                n = child["scale"].shape
                child["scale"] = (1 + 0.2 * rng.randn(*n)).astype(np.float32)
                child["bias"] = (0.2 * rng.randn(*n)).astype(np.float32)
                stats[key]["mean"] = (0.2 * rng.randn(*n)).astype(np.float32)
                stats[key]["var"] = rng.uniform(0.5, 1.5, n).astype(
                    np.float32)
            elif isinstance(child, dict):
                walk(child, stats.get(key, {}))

    walk(variables["params"], variables["batch_stats"])
    return variables


def _stats_close(module, want_stats, tol):
    got = jax_variables(module)["batch_stats"]
    leaves = jax.tree_util.tree_leaves_with_path(want_stats)
    assert leaves
    for path, want in leaves:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, want, rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------------
# whole models: full width, reduced depth
# --------------------------------------------------------------------------

def _models():
    """name -> (JAX module, port module, input px)."""
    seres = jse.MODELS_PARAMS["seresnet50"]._replace(repetitions=(1, 1, 1, 1))
    serx = jse.MODELS_PARAMS["seresnext50"]._replace(repetitions=(1, 1, 1, 1))
    s154 = jse.MODELS_PARAMS["senet154"]._replace(repetitions=(1, 1, 1, 1))

    def tparams(p):
        return tse.MODELS_PARAMS[p.model_name]._replace(
            repetitions=p.repetitions)

    inc = (jinc._MODULES[0], jinc._MODULES[2], jinc._MODULES[9])
    depths = (1, 1, 1, 1)
    return {
        "resnext_top": (
            jrx.ResNeXtModule(depths, classes=10),
            lambda: trx.ResNeXtModule(depths, classes=10, device="cpu"), 64),
        "resnext_avg": (
            jrx.ResNeXtModule(depths, include_top=False, pooling="avg"),
            lambda: trx.ResNeXtModule(depths, False, "avg", device="cpu"),
            64),
        "resnext_max": (
            jrx.ResNeXtModule(depths, include_top=False, pooling="max"),
            lambda: trx.ResNeXtModule(depths, False, "max", device="cpu"),
            64),
        "resnext_features": (
            jrx.ResNeXtModule(depths, include_top=False),
            lambda: trx.ResNeXtModule(depths, False, device="cpu"), 64),
        "seresnet_top": (
            jse.SENetModule(seres, classes=10),
            lambda: tse.SENetModule(tparams(seres), classes=10,
                                    device="cpu"), 64),
        "seresnext_top": (
            jse.SENetModule(serx, classes=10),
            lambda: tse.SENetModule(tparams(serx), classes=10,
                                    device="cpu"), 64),
        "seresnext_features": (
            jse.SENetModule(serx, include_top=False),
            lambda: tse.SENetModule(tparams(serx), include_top=False,
                                    device="cpu"), 64),
        "senet154_top": (
            jse.SENetModule(s154, classes=10),
            lambda: tse.SENetModule(tparams(s154), classes=10,
                                    device="cpu"), 64),
        "senet154_features": (
            jse.SENetModule(s154, include_top=False),
            lambda: tse.SENetModule(tparams(s154), include_top=False,
                                    device="cpu"), 64),
        "bninception": (
            jinc.BNInceptionModule(modules=inc),
            lambda: tinc.BNInceptionModule(modules=inc, device="cpu"), 64),
    }


@pytest.fixture(scope="module")
def jax_models():
    """Each model's JAX module and randomized variables, built once."""
    out = {}
    for name, (jmod, make, px) in _models().items():
        variables = jax.jit(jmod.init)(jax.random.PRNGKey(5),
                                       jnp.zeros((1, px, px, 3)))
        out[name] = (jmod, make, px, _randomize_bn(variables, 6))
    return out


# SENet-154's head has dropout, which cannot replay jax.random: its train
# mode runs without the top (senet154_features)
MODEL_CASES = [(name, train) for name in sorted(_models())
               for train in (False, True)
               if not (train and name == "senet154_top")]


@pytest.mark.parametrize("name, train", MODEL_CASES,
                         ids=[f"{n}-{'train' if t else 'eval'}"
                              for n, t in MODEL_CASES])
def test_model_matches_jax(jax_models, name, train):
    jmod, make, px, variables = jax_models[name]
    x = _x((2, px, px, 3), 12)
    kw = dict(deterministic=not train)
    if train:
        want, mutated = jmod.apply(variables, jnp.asarray(x),
                                   mutable=["batch_stats"], **kw)
    else:
        want = jmod.apply(variables, jnp.asarray(x), **kw)
    want = np.asarray(want)
    port = load_jax_variables(make(), variables).eval()
    got = port(torch.from_numpy(x), deterministic=not train)
    assert got.dtype == torch.float32
    got = got.detach().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err
    if train:
        _stats_close(port, _np(mutated["batch_stats"]), 1e-5)


def test_bf16_model_keeps_close_to_float32(jax_models):
    """bf16 convs and float32 BatchNorm statistics: the port's bf16 output
    follows its float32 one as JAX's bf16 follows JAX's float32."""
    jmod, make, px, variables = jax_models["seresnext_features"]
    x = _x((2, px, px, 3), 13)
    port32 = load_jax_variables(make(), variables)
    port16 = tse.SENetModule(port32.model_params, include_top=False,
                             dtype=torch.bfloat16, device="cpu")
    port16.load_state_dict(port32.state_dict())
    want = port32(torch.from_numpy(x), deterministic=True).detach()
    got = port16(torch.from_numpy(x), deterministic=True).detach()
    cos = float(torch.nn.functional.cosine_similarity(
        got.flatten(), want.flatten(), dim=0))
    j16 = np.asarray(jse.SENetModule(jmod.model_params, include_top=False,
                                     dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x)), np.float32)
    jcos = float(np.dot(j16.ravel(), want.numpy().ravel())
                 / np.linalg.norm(j16) / np.linalg.norm(want.numpy()))
    assert cos >= 0.99 and jcos >= 0.99, (cos, jcos)


# the port's bf16 cosine may fall this far below JAX's own: the gap
# measured on the CPU (torch 2.13, jax on XLA:CPU) with the inputs of seeds
# 13 and 14 was 0.0006 and -0.0001 (seeded: JAX 0.999268 and 0.998372,
# the port 0.998628 and 0.998437) and 0.0080 and 0.0089 (random_bn: JAX
# 0.953867 and 0.972979, the port 0.945909 and 0.964100); each margin is
# about twice the larger gap
BF16_GAP_MARGIN = {"seeded": 0.002, "random_bn": 0.02}


@pytest.fixture(scope="module")
def seresnext50_full():
    """SE-ResNeXt-50 at full depth (3, 4, 6, 3) without its top, and the
    JAX package's init at 64 px."""
    params = jse.MODELS_PARAMS["seresnext50"]
    module = jse.SENetModule(params, include_top=False)
    variables = jax.jit(module.init)(jax.random.PRNGKey(5),
                                     jnp.zeros((1, 64, 64, 3)))
    return module, variables


@pytest.mark.parametrize("init", sorted(BF16_GAP_MARGIN))
def test_full_depth_bf16_gap_follows_jax(seresnext50_full, init):
    """The bf16 CNN gap at full depth, the CPU's guard of the card's 0.98
    check on SE-ResNeXt-50's bf16 feature map (``chip_smoke.py`` phase
    21): both packages run the model in float32 and in bf16 (bf16
    convolutions, float32 BatchNorm statistics) from the same converted
    weights, the JAX package's init as it is (``seeded``) or with every
    BatchNorm drawn at random (``random_bn``), on a batch of 2 seeded 64 px
    images. The port's float32 output follows JAX's to a cosine of
    0.99999 (measured 0.99999994 and up seeded, 0.9999995 with random
    BatchNorm, where 50 layers of float32 sums in another order move the
    largest element by 0.7% of the largest magnitude), and the cosine of
    the port's bf16 output against its float32 one stays within
    ``BF16_GAP_MARGIN`` of JAX's own bf16-against-float32 cosine."""
    jmod, variables = seresnext50_full
    variables = (_randomize_bn(variables, 6) if init == "random_bn"
                 else _np(variables))
    x = _x((2, 64, 64, 3), 13)
    j32 = np.asarray(jmod.apply(variables, jnp.asarray(x)), np.float32)
    j16 = np.asarray(jse.SENetModule(
        jmod.model_params, include_top=False, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x)), np.float32)
    port32 = load_jax_variables(tse.SENetModule(
        tse.MODELS_PARAMS["seresnext50"], include_top=False, device="cpu"),
        variables).eval()
    port16 = tse.SENetModule(port32.model_params, include_top=False,
                             dtype=torch.bfloat16, device="cpu").eval()
    port16.load_state_dict(port32.state_dict())
    with torch.no_grad():
        t32 = port32(torch.from_numpy(x), deterministic=True).numpy()
        t16 = port16(torch.from_numpy(x), deterministic=True).float().numpy()

    def cosine(a, b):
        return float(np.dot(a.ravel(), b.ravel()) / np.linalg.norm(a)
                     / np.linalg.norm(b))

    assert t32.shape == j32.shape == (2, 2, 2, 2048)
    assert cosine(t32, j32) >= 0.99999
    port_cos, jax_cos = cosine(t16, t32), cosine(j16, j32)
    assert port_cos >= jax_cos - BF16_GAP_MARGIN[init], (port_cos, jax_cos)


# --------------------------------------------------------------------------
# the train step of examples/train_cnn_classifier.py, reduced depth
# --------------------------------------------------------------------------

def _cross_entropy(y_true, y_pred, np_=torch):
    """examples/train_cnn_classifier.py:34-36."""
    return -np_.mean(np_.sum(y_true * np_.log(y_pred + 1e-8), -1))


def test_seresnet_sgdw_steps_match_jax():
    params_j = jse.MODELS_PARAMS["seresnet50"]._replace(
        repetitions=(1, 1, 1, 1))
    module = jse.SENetModule(params_j, classes=10)
    variables = _randomize_bn(jax.jit(module.init)(
        jax.random.PRNGKey(7), jnp.zeros((1, 64, 64, 3))), 8)
    rng = np.random.RandomState(18)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 2)]
    exclude = ["bias", "scale"]

    def jax_loss(params, stats):
        out, mutated = module.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            deterministic=False, mutable=["batch_stats"])
        return _cross_entropy(jnp.asarray(y), out, jnp), mutated

    jopt_ = jopt.SGDW(weight_decay=1e-4, learning_rate=jsched.LinearWarmup(
        0.01, warmup_steps=5), momentum=0.9, decay_exclude=exclude)
    params, stats = variables["params"], variables["batch_stats"]
    state = jopt_.init(params)

    model = load_jax_variables(tse.SENetModule(tse.MODELS_PARAMS["seresnet50"]._replace(
        repetitions=(1, 1, 1, 1)), classes=10, device="cpu"),
        variables).train()
    opt = topt.SGDW(model.named_parameters(), weight_decay=1e-4,
                    learning_rate=tsched.LinearWarmup(0.01, warmup_steps=5),
                    momentum=0.9, decay_exclude=exclude)
    mask = jopt.decay_mask(params, decay_exclude=exclude)
    want_mask = {"/".join(k.key for k in path): bool(v) for path, v in
                 jax.tree_util.tree_leaves_with_path(mask)}
    got_mask = {jax_path(n): d for n, d in topt.decay_mask(
        model, decay_exclude=exclude).items()}
    assert got_mask == want_mask
    assert {n for n, d in got_mask.items() if d} == {
        n for n in got_mask if n.endswith("kernel")}

    for step in range(2):  # lr 0 on the first step (warmup), then 0.002
        (loss, mutated), grads = jax.value_and_grad(
            jax_loss, has_aux=True)(params, stats)
        updates, state = jopt_.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        stats = mutated["batch_stats"]

        opt.zero_grad(set_to_none=True)
        got_loss = _cross_entropy(torch.from_numpy(y),
                                  model(torch.from_numpy(x),
                                        deterministic=False))
        got_loss.backward()
        np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
        want_grads = state_dict_from_jax(_np(grads))
        for name, p in model.named_parameters():
            g, w = p.grad.numpy(), want_grads[name].numpy()
            assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(),
                                                     1e-12), name
        opt.step()
        want = state_dict_from_jax(_np(params), batch_stats=_np(stats))
        for name, value in model.state_dict().items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
