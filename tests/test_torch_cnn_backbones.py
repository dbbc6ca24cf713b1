"""The layers and blocks of the port's CNN backbones (ResNeXt, SENet,
BN-Inception) against the JAX package's, on the CPU, and the names and
creation order of every preset (whole models and the train step are in
``test_torch_cnn_models.py``).

The same seeded numpy inputs go through both; the weights are the JAX
package's init with every BatchNorm's ``scale``, ``bias``, ``mean`` and
``var`` drawn at random (``var`` positive), so that eval-mode BatchNorm
really normalizes, converted with ``state_dict_from_jax``. JAX runs op by
op, as ``module.apply`` does outside ``jit``.

Tolerances: BatchNorm outputs and updated statistics within 1e-6
(float32 and bf16, whose outputs keep JAX's dtype); convolutions, pools
and every block within 1e-5 of the output's largest magnitude (float32
sums in another order), their train-mode statistics within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from chambers_tpu.models.backbones import inception as jinc
from chambers_tpu.models.backbones import resnext as jrx
from chambers_tpu.models.backbones import senet as jse
from chambers_tpu_torch import initializers
from chambers_tpu_torch.layers import convolution as tconv
from chambers_tpu_torch.models.backbones import inception as tinc
from chambers_tpu_torch.models.backbones import resnext as trx
from chambers_tpu_torch.models.backbones import senet as tse
from chambers_tpu_torch.models.backbones.convert import (
    jax_variables,
    load_jax_variables,
    state_dict_from_jax,
)
from test_torch_package import one_torch_thread  # noqa: F401

EPS = {"resnext": jrx._BN_EPS, "senet": jse._BN_EPS,
       "inception": jinc._BN_EPS}


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

    if "batch_stats" in variables:
        walk(variables["params"], variables["batch_stats"])
    return variables


def _jax_apply(module, variables, x, mutate, **kw):
    """``(out, batch_stats after)``: JAX's forward, with the statistics'
    update when ``mutate``."""
    if mutate:
        out, mutated = module.apply(variables, x, mutable=["batch_stats"],
                                    **kw)
        return np.asarray(out), _np(mutated["batch_stats"])
    return np.asarray(module.apply(variables, x, **kw)), None


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


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
# BatchNorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(EPS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_matches_flax(family, dtype, train):
    eps, c = EPS[family], 16
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    bn = fnn.BatchNorm(use_running_average=not train, epsilon=eps,
                       momentum=0.99, dtype=jdt)
    x = _x((2, 5, 7, c), 3) * 2.0 + 0.5
    xj = jnp.asarray(x, jdt or jnp.float32)
    variables = _randomize_bn(
        {"params": {"BatchNorm_0": bn.init(jax.random.PRNGKey(0),
                                           xj)["params"]},
         "batch_stats": {"BatchNorm_0": bn.init(
             jax.random.PRNGKey(0), xj)["batch_stats"]}})
    inner = {k: v["BatchNorm_0"] for k, v in variables.items()}
    want, stats = _jax_apply(bn, inner, xj, train)

    port = tconv.BatchNorm(c, eps, dtype=tdt, device="cpu")
    port.load_state_dict(state_dict_from_jax(inner["params"],
                                             batch_stats=inner["batch_stats"]))
    got = port(torch.from_numpy(x).to(tdt or torch.float32), train)
    assert got.dtype == (tdt or torch.float32)
    _close(got.detach().float().numpy(), np.asarray(want, np.float32),
           1e-6)
    if train:
        for name in ("mean", "var"):
            np.testing.assert_allclose(getattr(port, name).numpy(),
                                       stats[name], rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(port.mean.numpy(),
                                      inner["batch_stats"]["mean"])


# --------------------------------------------------------------------------
# convolutions and pools
# --------------------------------------------------------------------------

CONVS = {
    "dense_s1_pad1": dict(k=3, s=1, g=1, pad=1),
    "dense_s2_pad3_7x7": dict(k=7, s=2, g=1, pad=3),
    "grouped_s1": dict(k=3, s=1, g=4, pad=1),
    "grouped_s2": dict(k=3, s=2, g=8, pad=1),
    "pointwise_s2_bias": dict(k=1, s=2, g=1, pad=0, bias=True),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_matches_flax(case):
    c = CONVS[case]
    cin, cout = 16, 32
    conv = fnn.Conv(cout, (c["k"], c["k"]), strides=(c["s"], c["s"]),
                    padding=((c["pad"], c["pad"]),) * 2,
                    feature_group_count=c["g"],
                    use_bias=c.get("bias", False))
    x = _x((2, 11, 10, cin), 4)
    params = _np(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)))["params"]
    if "bias" in params:
        params["bias"] = _x(params["bias"].shape, 5)
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    port = tconv.Conv(cin, cout, c["k"], c["s"], c["pad"], c["g"],
                      c.get("bias", False), device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    _close(port(torch.from_numpy(x)).detach().numpy(), want, 1e-5)


@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("strides", [1, 2])
def test_group_conv2d_matches_jax(padding, strides):
    cin, cout, groups = 8, 16, 4
    conv = jse.GroupConv2D(cout, 3, strides=strides, groups=groups,
                           padding=padding)
    x = _x((2, 9, 8, cin), 6)
    params = _np(conv.init(jax.random.PRNGKey(2), jnp.asarray(x)))["params"]
    params["bias"] = _x(params["bias"].shape, 7)
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    port = tse.GroupConv2D(cout, 3, strides=strides, groups=groups,
                           padding=padding, in_features=cin, device="cpu")
    port.load_state_dict(state_dict_from_jax(params))
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind", ["pool2", "zero_pad_max", "branch_max",
                                  "branch_avg"])
def test_pools_match_jax(kind):
    x = _x((2, 9, 8, 5), 8) - 3.0  # mostly negative: zero padding shows
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if kind == "pool2":
        want, got = jinc._pool2(xj, "max"), tinc._pool2(xt, "max")
    elif kind == "zero_pad_max":
        want = fnn.max_pool(jnp.pad(xj, ((0, 0), (1, 1), (1, 1), (0, 0))),
                            (3, 3), strides=(2, 2))
        got = tconv.max_pool(tconv.pad_hw(xt, ((1, 1), (1, 1))), 3, 2)
    elif kind == "branch_max":
        want = fnn.max_pool(xj, (3, 3), strides=(1, 1),
                            padding=((1, 1), (1, 1)))
        got = tconv.max_pool(tconv.pad_hw(xt, ((1, 1), (1, 1)),
                                          float("-inf")), 3, 1)
    else:
        want = fnn.avg_pool(xj, (3, 3), strides=(1, 1),
                            padding=((1, 1), (1, 1)),
                            count_include_pad=False)
        got = tconv.avg_pool(xt, 3, 1, 1)
    _close(got.numpy(), np.asarray(want), 1e-5)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _blocks():
    """name -> (JAX module, port module factory, input shape)."""
    return {
        "block3_shortcut": (
            jrx._Block3(filters=32, strides=2, groups=8),
            lambda: trx._Block3(24, 32, 2, 8, device="cpu"), (2, 8, 8, 24)),
        "block3_identity": (
            jrx._Block3(filters=16, groups=8, conv_shortcut=False),
            lambda: trx._Block3(128, 16, 1, 8, conv_shortcut=False,
                                device="cpu"), (2, 6, 6, 128)),
        "seresnet_bottleneck": (
            jse.SEResNetBottleneck(filters=64, strides=2),
            lambda: tse.SEResNetBottleneck(32, 64, strides=2, device="cpu"),
            (2, 8, 8, 32)),
        "seresnet_bottleneck_identity": (
            jse.SEResNetBottleneck(filters=64),
            lambda: tse.SEResNetBottleneck(64, 64, device="cpu"),
            (2, 6, 6, 64)),
        "seresnext_bottleneck": (
            jse.SEResNeXtBottleneck(filters=64, strides=2, groups=8),
            lambda: tse.SEResNeXtBottleneck(32, 64, strides=2, groups=8,
                                            device="cpu"), (2, 8, 8, 32)),
        "se_bottleneck_first": (
            jse.SEBottleneck(filters=64, groups=8, is_first=True),
            lambda: tse.SEBottleneck(32, 64, groups=8, is_first=True,
                                     device="cpu"), (2, 8, 8, 32)),
        "se_bottleneck_3x3_shortcut": (
            jse.SEBottleneck(filters=64, strides=2, groups=8),
            lambda: tse.SEBottleneck(32, 64, strides=2, groups=8,
                                     device="cpu"), (2, 8, 8, 32)),
        "inception": (
            jinc._Inception(8, 4, 6, 4, 10, 5, "avg"),
            lambda: tinc._Inception(12, 8, 4, 6, 4, 10, 5, "avg",
                                    device="cpu"), (2, 7, 7, 12)),
        "inception_max": (
            jinc._Inception(8, 4, 6, 4, 10, 5, "max"),
            lambda: tinc._Inception(12, 8, 4, 6, 4, 10, 5, "max",
                                    device="cpu"), (2, 7, 7, 12)),
        "inception_reduction": (
            jinc._Inception(None, 4, 6, 4, 10),
            lambda: tinc._Inception(12, None, 4, 6, 4, 10, device="cpu"),
            (2, 8, 8, 12)),
    }


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(_blocks()))
def test_block_matches_jax(name, train):
    jmod, make, shape = _blocks()[name]
    x = _x(shape, 9)
    variables = _randomize_bn(jmod.init(jax.random.PRNGKey(3),
                                        jnp.asarray(x), False))
    want, stats = _jax_apply(jmod, variables, jnp.asarray(x), train,
                             train=train)
    port = load_jax_variables(make(), variables)
    got = port(torch.from_numpy(x), train).detach().numpy()
    _close(got, want, 1e-5)
    if train:
        _stats_close(port, stats, 1e-6)


def test_channel_se_matches_jax():
    jmod = jse.ChannelSE(reduction=4)
    x = _x((2, 5, 5, 16), 10)
    params = _np(jmod.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    params["params"]["Conv_0"]["bias"] = _x((4,), 11)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    port = load_jax_variables(tse.ChannelSE(16, 4, device="cpu"), params)
    _close(port(torch.from_numpy(x)).detach().numpy(), want, 1e-5)


# --------------------------------------------------------------------------
# names and creation order of every preset
# --------------------------------------------------------------------------

PRESETS = {
    "resnext50": (lambda: jrx.ResNeXtModule((3, 4, 6, 3)),
                  lambda: trx.ResNeXt50(device="cpu")),
    "resnext101": (lambda: jrx.ResNeXtModule((3, 4, 23, 3)),
                   lambda: trx.ResNeXt101(device="cpu")),
    "bninception": (lambda: jinc.BNInceptionModule(),
                    lambda: tinc.BNInception(device="cpu")),
    **{name: (lambda name=name: jse.SENetModule(jse.MODELS_PARAMS[name]),
              lambda name=name: getattr(tse, {
                  "seresnet50": "SEResNet50", "seresnet101": "SEResNet101",
                  "seresnet152": "SEResNet152",
                  "seresnext50": "SEResNeXt50",
                  "seresnext101": "SEResNeXt101",
                  "senet154": "SENet154"}[name])(device="cpu"))
       for name in jse.MODELS_PARAMS},
}


def _init_shapes(module):
    """The variables of ``module.init`` in Flax's creation order, as
    zero-stride numpy stand-ins of their shapes: traced with
    ``eval_shape``, nothing compiled. (A pytree that leaves a traced
    function comes back with its dict keys sorted, so the tree is taken
    from inside the trace.)"""
    seen = {}

    def init(key, x):
        seen["variables"] = module.init(key, x)
        return jnp.zeros(())

    jax.eval_shape(init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else np.broadcast_to(np.float32(0), v.shape)
                for k, v in tree.items()}

    return walk(seen["variables"])


def _keys_and_shapes(tree, path=()):
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out.append((path + (key,), "node"))
            out += _keys_and_shapes(value, path + (key,))
        else:
            out.append((path + (key,), tuple(np.shape(value))))
    return out


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_names_and_creation_order(name):
    from chambers_tpu.models.backbones.h5_import_cnn import (
        _ordered_param_leaves as jax_leaves,
    )
    from chambers_tpu_torch.models.backbones.h5_import_cnn import (
        _ordered_param_leaves as port_leaves,
    )

    make_jax, make_port = PRESETS[name]
    want = _init_shapes(make_jax())
    got = jax_variables(make_port())
    for collection in ("params", "batch_stats"):
        assert (_keys_and_shapes(got[collection])
                == _keys_and_shapes(want[collection])), collection
    assert port_leaves(got) == jax_leaves(want)


def test_grouped_conv_param_shapes():
    """As the JAX package's test: the first SE-ResNeXt bottleneck's grouped
    conv, width 128 in 32 groups, has the kernel ``(3, 3, 4, 128)``."""
    model = tse.SEResNeXt50(input_shape=(64, 64, 3), device="cpu")
    kernel = model.SEResNeXtBottleneck_0._ConvBN_1.Conv_0.kernel
    assert tuple(kernel.shape) == (3, 3, 4, 128)


def test_senet_config_round_trip():
    module = tse.SENetModule(tse.MODELS_PARAMS["senet154"]._replace(
        repetitions=(1, 1)), classes=7, device="cpu")
    config = module.get_config()
    assert config == jse.SENetModule(jse.MODELS_PARAMS["senet154"]._replace(
        repetitions=(1, 1)), classes=7).get_config()
    again = tse.SENetModule.from_config(config, device="cpu")
    assert list(again.state_dict()) == list(module.state_dict())


def test_senet_helpers_match_jax():
    x = _x((2, 3, 3, 8), 14)
    for axis in (3, -1, 1):
        np.testing.assert_array_equal(
            tse.slice_tensor(torch.from_numpy(x), 2, 5, axis).numpy(),
            np.asarray(jse.slice_tensor(jnp.asarray(x), 2, 5, axis)))
    v = _x((2, 8), 15)
    for axis in (3, 1):
        np.testing.assert_array_equal(
            tse.expand_dims(torch.from_numpy(v), axis).numpy(),
            np.asarray(jse.expand_dims(jnp.asarray(v), axis)))
    with pytest.raises(ValueError):
        tse.slice_tensor(torch.from_numpy(x), 0, 1, 2)
    assert tse.get_bn_params(momentum=0.9) == jse.get_bn_params(momentum=0.9)
    assert tse.get_num_channels(torch.from_numpy(x)) == 8
    with pytest.raises(ValueError, match="linear"):
        tse.GroupConv2D(8, 3, activation="relu", in_features=8)


def test_preprocess_inputs_match_jax():
    x = np.random.RandomState(16).randint(0, 256, (2, 4, 4, 3)).astype(
        np.float32)
    for jfn, tfn in ((jrx.preprocess_input, trx.preprocess_input),
                     (jse.preprocess_input, tse.preprocess_input),
                     (jinc.preprocess_input, tinc.preprocess_input)):
        _close(tfn(torch.from_numpy(x)).numpy(),
               np.asarray(jfn(jnp.asarray(x))), 1e-6)


def test_with_pooling_keeps_the_names():
    model = initializers.init_module(tinc.BNInceptionModule(
        modules=(jinc._MODULES[2],), device="cpu"))
    keys = list(model.state_dict())
    x = torch.from_numpy(_x((2, 32, 32, 3), 17))
    features = model(x, deterministic=True)
    pooled = tinc.with_pooling(model, "max")
    assert pooled is model and list(pooled.state_dict()) == keys
    torch.testing.assert_close(pooled(x, deterministic=True),
                               features.amax((1, 2)))
    with pytest.raises(ValueError, match="pooling"):
        tinc.with_pooling(model, "sum")
