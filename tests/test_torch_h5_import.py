"""The port's ``.h5`` and state-dict importers against the JAX package's,
on the same synthetic files, on the CPU; and ``weights=`` of every preset.

The files are written here with ``h5py`` in the legacy Keras layout
(top-level ``layer_names``, per-layer ``weight_names``): an order-based
stream (the SENet release format), auto-named conv/BN layers
(BN-Inception's stored model), keras-applications ResNeXt names and the
reference ViT's names. Kernels are drawn at ``1/sqrt(fan_in)`` and
BatchNorm variances positive, so that a model loaded from a file computes
finite, moderate outputs.

Both packages' importers run on the same file and the same template (the
JAX package's init, converted into the port's model, whose
``jax_variables`` are the port's template): every leaf they import must be
**exactly equal**. The one exception is ResNeXt's head, which the port
loads and the JAX importer leaves at its init (it looks for ``Dense_0``;
the head is ``QuantDense_0``). Presets built from a file give the JAX
preset's output on the same file within 1e-4 of the output's largest
magnitude.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.models.backbones import h5_import as jh5
from chambers_tpu.models.backbones import h5_import_cnn as jh5c
from chambers_tpu.models.backbones import inception as jinc
from chambers_tpu.models.backbones import resnext as jrx
from chambers_tpu.models.backbones import senet as jse
from chambers_tpu.models.backbones import vision_transformer as jvit
from chambers_tpu_torch.models.backbones import h5_import as th5
from chambers_tpu_torch.models.backbones import h5_import_cnn as th5c
from chambers_tpu_torch.models.backbones import inception as tinc
from chambers_tpu_torch.models.backbones import resnext as trx
from chambers_tpu_torch.models.backbones import senet as tse
from chambers_tpu_torch.models.backbones import vision_transformer as tvit
from chambers_tpu_torch.models.backbones.convert import (
    jax_variables,
    load_jax_variables,
)
from test_torch_package import one_torch_thread  # noqa: F401

h5py = pytest.importorskip("h5py")

PATCH, DIM, LAYERS, HEADS, FF, IMG, CLASSES = 16, 48, 2, 3, 96, 32, 10
TOKENS = (IMG // PATCH) ** 2


# --------------------------------------------------------------------------
# writers of legacy Keras .h5 files
# --------------------------------------------------------------------------

def _value(leaf, shape, rng):
    """A moderate value for a weight named ``leaf``: kernels at
    ``1/sqrt(fan_in)``, BatchNorm gamma near 1, variances in [0.5, 1.5],
    the rest small."""
    shape = tuple(shape)
    if leaf in ("moving_variance", "var"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if leaf in ("gamma", "scale") and len(shape) == 1:
        return (1 + 0.2 * rng.randn(*shape)).astype(np.float32)
    if len(shape) >= 2 and leaf not in ("embeddings",):
        fan_in = int(np.prod(shape[:-1]))
        if leaf.startswith("w_") and leaf != "w_projection":
            fan_in = shape[0]
        elif leaf == "w_projection":
            fan_in = shape[0] * shape[2]
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    return (0.2 * rng.randn(*shape)).astype(np.float32)


def _write_layers(path, layers):
    """``layers``: ``{layer name: [(weight name, array), ...]}`` in file
    order."""
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [n.encode() for n in layers]
        for layer, weights in layers.items():
            g = f.create_group(layer)
            g.attrs["weight_names"] = [n.encode() for n, _ in weights]
            for name, array in weights:
                g.create_dataset(name, data=array)


def _write_stream_h5(path, arrays):
    """Arrays as one legacy layer, in order."""
    _write_layers(path, {"all": [(f"all/w_{i}:0", a)
                                 for i, a in enumerate(arrays)]})


def _write_layered_h5(path, units):
    """``(conv arrays, bn arrays)`` units as ``conv2d_N`` /
    ``batch_normalization_N`` layers."""
    layers = {}
    for i, (conv, bn) in enumerate(units):
        cname = "conv2d" if i == 0 else f"conv2d_{i}"
        bname = ("batch_normalization" if i == 0
                 else f"batch_normalization_{i}")
        layers[cname] = list(zip(
            [f"{cname}/kernel:0", f"{cname}/bias:0"][:len(conv)], conv))
        layers[bname] = [(f"{bname}/{leaf}:0", a) for leaf, a in zip(
            ("gamma", "beta", "moving_mean", "moving_variance"), bn)]
    _write_layers(path, layers)


def _stream(variables, rng):
    """A value for every leaf of ``_ordered_param_leaves``, in order."""
    return [_value(p[-1], shape, rng)
            for p, shape in th5c._ordered_param_leaves(variables)]


def _convbn_units(variables, rng):
    """BN-Inception's leaves as ((kernel, bias), (gamma, beta, mean, var))
    units."""
    arrays = _stream(variables, rng)
    return [(arrays[i:i + 2], arrays[i + 2:i + 6])
            for i in range(0, len(arrays), 6)]


def _resnext_layers(depths, rng, classes=None, groups=32):
    """A keras-applications ResNeXt file's layers (``conv1_conv``,
    ``conv{s}_block{i}_{j}_{conv,bn}``, the grouped conv as a depthwise
    kernel, ``predictions``)."""
    layers = {}

    def conv(name, shape, leaf="kernel"):
        layers[name] = [(f"{name}/{leaf}:0", _value(leaf, shape, rng))]

    def bn(name, c):
        layers[name] = [(f"{name}/{leaf}:0", _value(leaf, (c,), rng))
                        for leaf in ("gamma", "beta", "moving_mean",
                                     "moving_variance")]

    conv("conv1_conv", (7, 7, 3, 64))
    bn("conv1_bn", 64)
    cin = 64
    for s, depth in enumerate(depths):
        width = (128, 256, 512, 1024)[s]
        out = 2 * width
        for b in range(depth):
            name = f"conv{s + 2}_block{b + 1}"
            if b == 0:
                conv(f"{name}_0_conv", (1, 1, cin, out))
                bn(f"{name}_0_bn", out)
            conv(f"{name}_1_conv", (1, 1, cin, width))
            bn(f"{name}_1_bn", width)
            conv(f"{name}_2_conv", (3, 3, width, width // groups),
                 "depthwise_kernel")
            bn(f"{name}_2_bn", width)
            conv(f"{name}_3_conv", (1, 1, width, out))
            bn(f"{name}_3_bn", out)
            cin = out
    if classes:
        layers["predictions"] = [
            ("predictions/kernel:0", _value("kernel", (cin, classes), rng)),
            ("predictions/bias:0", _value("bias", (classes,), rng))]
    return layers


def _vit_layers(rng, dim=DIM, layers_=LAYERS, heads=HEADS, ff=FF,
                img=IMG, classes=CLASSES, deit=False):
    """The reference ViT's (or DeiT's) layer and weight names."""
    h = dim // heads
    tokens = (img // PATCH) ** 2 + (2 if deit else 1)
    spec = {"patch_embeddings": [
        ("patch_embeddings/embedding/kernel:0", (PATCH, PATCH, 3, dim)),
        ("patch_embeddings/embedding/bias:0", (dim,))]}
    spec["add_cls_token"] = [("add_cls_token/embeddings:0", (1, dim))]
    if deit:
        spec["add_dist_token"] = [("add_dist_token/embeddings:0", (1, dim))]
    spec["pos_embedding"] = [("pos_embedding/embeddings:0", (tokens, dim))]
    enc = []
    for i in range(layers_):
        sfx = "" if i == 0 else f"_{i}"
        base = f"encoder/encoder_layer{sfx}"
        mha = f"{base}/multi_head_attention{sfx}"
        enc += [(f"{mha}/w_query:0", (dim, heads, h)),
                (f"{mha}/b_query:0", (heads, 1, h)),
                (f"{mha}/w_value:0", (dim, heads, h)),
                (f"{mha}/b_value:0", (heads, 1, h)),
                (f"{mha}/w_key:0", (dim, heads, h)),
                (f"{mha}/b_key:0", (heads, 1, h)),
                (f"{mha}/w_projection:0", (heads, dim, h)),
                (f"{mha}/b_projection:0", (1, dim)),
                (f"{base}/layer_normalization{sfx}/gamma:0", (dim,)),
                (f"{base}/layer_normalization{sfx}/beta:0", (dim,)),
                (f"{base}/dense{sfx}/kernel:0", (dim, ff)),
                (f"{base}/dense{sfx}/bias:0", (ff,)),
                (f"{base}/dense_x{sfx}/kernel:0", (ff, dim)),
                (f"{base}/dense_x{sfx}/bias:0", (dim,)),
                (f"{base}/layer_normalization_b{sfx}/gamma:0", (dim,)),
                (f"{base}/layer_normalization_b{sfx}/beta:0", (dim,))]
    enc += [("encoder/layer_normalization_final/gamma:0", (dim,)),
            ("encoder/layer_normalization_final/beta:0", (dim,))]
    spec["encoder"] = enc
    spec["predictions"] = [("predictions/kernel:0", (dim, classes)),
                           ("predictions/bias:0", (classes,))]
    if deit:
        spec["predictions_dist"] = [
            ("predictions_dist/kernel:0", (dim, classes)),
            ("predictions_dist/bias:0", (classes,))]
    return {layer: [(n, _value(n.split("/")[-1].split(":")[0], s, rng))
                    for n, s in weights] for layer, weights in spec.items()}


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _leaves(tree, path=()):
    """``{path: array}`` of a nested dict, in order."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_leaves(value, path + (key,)))
        else:
            out[path + (key,)] = np.asarray(value)
    return out


def _assert_equal_trees(got, want, skip=(), ordered=True):
    """Equal leaves under equal paths; with ``ordered`` in the same order
    too (the CNNs register in Flax's creation order; the ViT's layers
    register their norms before their attention, and its importers go by
    name)."""
    got, want = _leaves(got), _leaves(want)
    assert (list(got) == list(want) if ordered
            else sorted(got) == sorted(want))
    for path, value in want.items():
        if any(path[:len(s)] == s for s in skip):
            continue
        assert got[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got[path], value,
                                      err_msg="/".join(path))


def _jax_init(module, px=32):
    """Flax's init, unjitted: its dicts keep creation order (a jitted init
    returns them sorted), which the order-based importers read."""
    return module.init(jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3)))


def _templates(jax_module, port_module, px=32):
    """The JAX package's init and the port's ``jax_variables`` of the same
    weights."""
    variables = _jax_init(jax_module, px)
    return variables, jax_variables(load_jax_variables(port_module,
                                                       variables))


def _seresnet(name="seresnet50", reps=(1, 1), classes=5):
    jp = jse.MODELS_PARAMS[name]._replace(repetitions=reps)
    tp = tse.MODELS_PARAMS[name]._replace(repetitions=reps)
    return (jse.SENetModule(model_params=jp, classes=classes),
            tse.SENetModule(tp, classes=classes, device="cpu"))


# --------------------------------------------------------------------------
# the order-based stream (SENet)
# --------------------------------------------------------------------------

def test_ordered_leaves_are_jax_s(tmp_path):
    want, got = _templates(*_seresnet())
    assert th5c._ordered_param_leaves(got) == jh5c._ordered_param_leaves(
        want)


def test_cnn_stream_import_equals_jax(tmp_path):
    want_vars, port_vars = _templates(*_seresnet())
    path = str(tmp_path / "senet.h5")
    _write_stream_h5(path, _stream(port_vars, np.random.RandomState(0)))
    _assert_equal_trees(th5c.load_cnn_h5_weights(path, port_vars),
                        jh5c.load_cnn_h5_weights(path, want_vars))


def test_cnn_stream_concatenates_per_group_kernels(tmp_path):
    """SE-ResNeXt's grouped kernels saved as 32 per-group kernels."""
    want_vars, port_vars = _templates(*_seresnet("seresnext50", (1,), 3))
    leaves = th5c._ordered_param_leaves(port_vars)
    arrays = _stream(port_vars, np.random.RandomState(1))
    target = next(i for i, (_, s) in enumerate(leaves)
                  if s == (3, 3, 4, 128))
    full = arrays[target]
    parts = [full[..., i * 4:(i + 1) * 4] for i in range(32)]
    path = str(tmp_path / "senext.h5")
    _write_stream_h5(path, arrays[:target] + parts + arrays[target + 1:])
    got = th5c.load_cnn_h5_weights(path, port_vars)
    _assert_equal_trees(got, jh5c.load_cnn_h5_weights(path, want_vars))
    np.testing.assert_array_equal(
        got["params"]["SEResNeXtBottleneck_0"]["_ConvBN_1"]["Conv_0"]
        ["kernel"], full)


@pytest.mark.parametrize("fault", ["truncated", "shape", "extra"])
def test_cnn_stream_mismatch_raises(tmp_path, fault):
    want_vars, port_vars = _templates(*_seresnet())
    arrays = _stream(port_vars, np.random.RandomState(2))
    if fault == "truncated":
        arrays, match = arrays[:-2], "exhausted"
    elif fault == "shape":
        arrays[0], match = np.zeros((9, 9, 9, 9), np.float32), "mismatch"
    else:
        arrays, match = arrays + [np.zeros(3, np.float32)], "unconsumed"
    path = str(tmp_path / "bad.h5")
    _write_stream_h5(path, arrays)
    for load, variables in ((th5c.load_cnn_h5_weights, port_vars),
                            (jh5c.load_cnn_h5_weights, want_vars)):
        with pytest.raises(ValueError, match=match):
            load(path, variables)


# --------------------------------------------------------------------------
# the auto-named conv/BN DAG (BN-Inception)
# --------------------------------------------------------------------------

def _inception(modules=((8, 4, 6, 4, 10, 5, "avg"),)):
    return (jinc.BNInceptionModule(modules=modules),
            tinc.BNInceptionModule(modules=modules, device="cpu"))


@pytest.mark.parametrize("order", ["in_order", "permuted"])
def test_convbn_import_equals_jax(tmp_path, order):
    """In creation order, and with distinct-shaped units permuted (the b1
    conv behind the double-3x3 branch, the pool projection before it; the
    two identical 1x1 reduces keep their relative order), as the JAX
    package's test permutes them."""
    want_vars, port_vars = _templates(*_inception(), px=64)
    units = _convbn_units(port_vars, np.random.RandomState(3))
    assert len(units) == 10
    perm = (list(range(10)) if order == "in_order"
            else [0, 1, 2, 4, 6, 9, 3, 5, 7, 8])
    path = str(tmp_path / "bninception.h5")
    _write_layered_h5(path, [units[i] for i in perm])
    got = th5c.load_convbn_h5_weights(path, port_vars)
    _assert_equal_trees(got, jh5c.load_convbn_h5_weights(path, want_vars))
    flat = [a for conv, bn in units for a in conv + bn]
    for (p, _), want in zip(th5c._ordered_param_leaves(port_vars), flat):
        node = got[p[0]]
        for k in p[1:]:
            node = node[k]
        np.testing.assert_array_equal(node, want)


def test_convbn_import_refuses_a_foreign_layer(tmp_path):
    _, port_vars = _templates(*_inception(), px=64)
    _write_layers(str(tmp_path / "x.h5"), {"dense": [
        ("dense/kernel_x:0", np.zeros((2, 2), np.float32))]})
    with pytest.raises(ValueError, match="Unrecognized layer"):
        th5c.load_convbn_h5_weights(str(tmp_path / "x.h5"), port_vars)


# --------------------------------------------------------------------------
# keras-applications ResNeXt, by name
# --------------------------------------------------------------------------

def test_depthwise_to_grouped_kernel_equals_jax():
    dw = np.random.RandomState(4).randn(3, 3, 32, 4).astype(np.float32)
    np.testing.assert_array_equal(th5c.depthwise_to_grouped_kernel(dw, 8),
                                  jh5c.depthwise_to_grouped_kernel(dw, 8))


@pytest.mark.parametrize("top", [False, True], ids=["no_top", "top"])
def test_resnext_import_equals_jax_and_loads_the_head(tmp_path, top):
    depths = (1, 1, 1, 1)
    classes = 7 if top else None
    want_vars, port_vars = _templates(
        jrx.ResNeXtModule(depths, include_top=top, classes=classes or 1000),
        trx.ResNeXtModule(depths, top, classes=classes or 1000,
                          device="cpu"))
    layers = _resnext_layers(depths, np.random.RandomState(5), classes)
    path = str(tmp_path / "resnext.h5")
    _write_layers(path, layers)
    got = th5c.load_resnext_h5_weights(path, port_vars, depths)
    want = jh5c.load_resnext_h5_weights(path, want_vars, depths)
    head = ("params", "QuantDense_0")
    _assert_equal_trees(got, want, skip=(head,))
    if top:
        # the port loads the head; the JAX importer keeps its init
        np.testing.assert_array_equal(
            got["params"]["QuantDense_0"]["kernel"],
            dict(layers["predictions"])["predictions/kernel:0"])
        np.testing.assert_array_equal(
            got["params"]["QuantDense_0"]["bias"],
            dict(layers["predictions"])["predictions/bias:0"])
        np.testing.assert_array_equal(
            np.asarray(want["params"]["QuantDense_0"]["kernel"]),
            want_vars["params"]["QuantDense_0"]["kernel"])


def test_resnext_import_names_a_missing_weight(tmp_path):
    depths = (1, 1, 1, 1)
    _, port_vars = _templates(jrx.ResNeXtModule(depths, include_top=False),
                              trx.ResNeXtModule(depths, False, device="cpu"))
    layers = _resnext_layers(depths, np.random.RandomState(6))
    del layers["conv3_block1_2_conv"]
    _write_layers(str(tmp_path / "r.h5"), layers)
    with pytest.raises(KeyError, match="conv3_block1_2_conv/depthwise"):
        th5c.load_resnext_h5_weights(str(tmp_path / "r.h5"), port_vars,
                                     depths)


# --------------------------------------------------------------------------
# ViT and DeiT
# --------------------------------------------------------------------------

def _vits(deit):
    kw = dict(patch_size=PATCH, patch_dim=DIM, n_encoder_layers=LAYERS,
              n_heads=HEADS, ff_dim=FF, dropout_rate=0.0, classes=CLASSES)
    widths = (PATCH, DIM, LAYERS, HEADS, FF)
    if deit:
        return (jvit.DistilledVisionTransformer(**kw),
                tvit.DistilledVisionTransformer(
                    *widths, dropout_rate=0.0, image_size=(IMG, IMG),
                    classes=CLASSES, device="cpu"))
    return (jvit.VisionTransformer(**kw),
            tvit.VisionTransformer(*widths, dropout_rate=0.0,
                                   image_size=(IMG, IMG), classes=CLASSES,
                                   device="cpu"))


@pytest.mark.parametrize("deit", [False, True], ids=["vit", "deit"])
def test_vit_h5_import_equals_jax(tmp_path, deit):
    want_vars, port_vars = _templates(*_vits(deit))
    path = str(tmp_path / "vit.h5")
    layers = _vit_layers(np.random.RandomState(7), deit=deit)
    _write_layers(path, layers)
    assert list(th5.load_keras_h5_weights(path)) == list(
        jh5.load_keras_h5_weights(path))
    got = th5.load_vit_h5_weights(path, port_vars)
    _assert_equal_trees(got, jh5.load_vit_h5_weights(path, want_vars),
                        ordered=False)
    np.testing.assert_array_equal(
        got["params"]["encoder"]["layers_1"]["norm2"]["scale"],
        dict(layers["encoder"])[
            "encoder/encoder_layer_1/layer_normalization_b_1/gamma:0"])


def test_vit_h5_shape_mismatch_raises(tmp_path):
    _, port_vars = _templates(*_vits(False))
    path = str(tmp_path / "vit.h5")
    _write_layers(path, _vit_layers(np.random.RandomState(8), classes=99))
    with pytest.raises(ValueError, match="Shape mismatch"):
        th5.load_vit_h5_weights(path, port_vars)


def _torch_state_dict(naming, deit, rng):
    """A ViT state dict with HuggingFace ``transformers`` or timm names."""
    d, t = DIM, TOKENS + (2 if deit else 1)

    def a(*shape):
        return torch.from_numpy(_value("kernel" if len(shape) > 1 else "b",
                                       shape, rng))

    if naming == "hf":
        sd = {"embeddings.patch_embeddings.projection.weight":
              a(d, 3, PATCH, PATCH),
              "embeddings.patch_embeddings.projection.bias": a(d),
              "embeddings.cls_token": a(1, 1, d),
              "embeddings.position_embeddings": a(1, t, d)}
        if deit:
            sd["embeddings.distillation_token"] = a(1, 1, d)
        for i in range(LAYERS):
            p = f"encoder.layer.{i}."
            for n in ("query", "key", "value"):
                sd[p + f"attention.attention.{n}.weight"] = a(d, d)
                sd[p + f"attention.attention.{n}.bias"] = a(d)
            sd.update({p + "attention.output.dense.weight": a(d, d),
                       p + "attention.output.dense.bias": a(d),
                       p + "intermediate.dense.weight": a(FF, d),
                       p + "intermediate.dense.bias": a(FF),
                       p + "output.dense.weight": a(d, FF),
                       p + "output.dense.bias": a(d),
                       p + "layernorm_before.weight": a(d),
                       p + "layernorm_before.bias": a(d),
                       p + "layernorm_after.weight": a(d),
                       p + "layernorm_after.bias": a(d)})
        sd.update({"layernorm.weight": a(d), "layernorm.bias": a(d),
                   "classifier.weight": a(CLASSES, d),
                   "classifier.bias": a(CLASSES)})
        if deit:
            sd.update({"distillation_classifier.weight": a(CLASSES, d),
                       "distillation_classifier.bias": a(CLASSES)})
        return sd
    sd = {"patch_embed.proj.weight": a(d, 3, PATCH, PATCH),
          "patch_embed.proj.bias": a(d), "cls_token": a(1, 1, d),
          "pos_embed": a(1, t, d)}
    if deit:
        sd["dist_token"] = a(1, 1, d)
    for i in range(LAYERS):
        p = f"blocks.{i}."
        sd.update({p + "attn.qkv.weight": a(3 * d, d),
                   p + "attn.qkv.bias": a(3 * d),
                   p + "attn.proj.weight": a(d, d), p + "attn.proj.bias": a(d),
                   p + "mlp.fc1.weight": a(FF, d), p + "mlp.fc1.bias": a(FF),
                   p + "mlp.fc2.weight": a(d, FF), p + "mlp.fc2.bias": a(d),
                   p + "norm1.weight": a(d), p + "norm1.bias": a(d),
                   p + "norm2.weight": a(d), p + "norm2.bias": a(d)})
    sd.update({"norm.weight": a(d), "norm.bias": a(d),
               "head.weight": a(CLASSES, d), "head.bias": a(CLASSES)})
    if deit:
        sd.update({"head_dist.weight": a(CLASSES, d),
                   "head_dist.bias": a(CLASSES)})
    return sd


@pytest.mark.parametrize("deit", [False, True], ids=["vit", "deit"])
@pytest.mark.parametrize("naming", ["hf", "timm"])
def test_torch_vit_import_equals_jax(naming, deit):
    want_vars, port_vars = _templates(*_vits(deit))
    sd = _torch_state_dict(naming, deit, np.random.RandomState(9))
    got = th5.load_torch_vit_weights(sd, port_vars, HEADS)
    _assert_equal_trees(got, jh5.load_torch_vit_weights(sd, want_vars,
                                                        HEADS),
                        ordered=False)
    # numpy arrays import as torch tensors do
    _assert_equal_trees(th5.load_torch_vit_weights(
        {k: v.numpy() for k, v in sd.items()}, port_vars, HEADS), got)


def test_per_head_split_equals_jax():
    w = np.random.RandomState(10).randn(12, 8).astype(np.float32)
    b = np.random.RandomState(11).randn(12).astype(np.float32)
    for got, want in zip(th5._to_per_head(w, b, 3),
                         jh5._to_per_head(w, b, 3)):
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# presets from a file, end to end
# --------------------------------------------------------------------------

def _close_to(got, want):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err


def _images(px, seed):
    return np.random.RandomState(seed).randn(2, px, px, 3).astype(
        np.float32)


def test_senet_from_a_file_matches_jax(tmp_path):
    reps = (1, 1, 1, 1)
    jmod, tmod = _seresnet("seresnext50", reps, classes=6)
    _, port_vars = _templates(jmod, tmod, 64)
    path = str(tmp_path / "seresnext.h5")
    _write_stream_h5(path, _stream(port_vars, np.random.RandomState(12)))
    want_model = jse.SENet(jse.MODELS_PARAMS["seresnext50"]._replace(
        repetitions=reps), input_shape=(64, 64, 3), classes=6, weights=path)
    got_model = tse.SENet(tse.MODELS_PARAMS["seresnext50"]._replace(
        repetitions=reps), input_shape=(64, 64, 3), classes=6, weights=path,
        device="cpu")
    x = _images(64, 13)
    _close_to(got_model(torch.from_numpy(x)), want_model(x))


def test_resnext50_from_a_file_matches_jax(tmp_path):
    """Without the top: with it the JAX package keeps a random head (see
    ``test_resnext_import_equals_jax_and_loads_the_head``)."""
    path = str(tmp_path / "resnext50_notop.h5")
    _write_layers(path, _resnext_layers((3, 4, 6, 3),
                                        np.random.RandomState(14)))
    x = _images(32, 15)
    kw = dict(include_top=False, pooling="avg", weights=path,
              input_shape=(32, 32, 3))
    _close_to(trx.ResNeXt50(device="cpu", **kw)(torch.from_numpy(x)),
              jrx.ResNeXt50(**kw)(x))


def test_bninception_from_a_file_matches_jax(tmp_path):
    template = jax_variables(tinc.BNInceptionModule(device="cpu"))
    path = str(tmp_path / "bninception.h5")
    _write_layered_h5(path, _convbn_units(template,
                                          np.random.RandomState(16)))
    x = _images(64, 17)
    got = tinc.BNInception(weights_path=path, pooling="avg",
                           input_shape=(64, 64, 3), device="cpu")
    want = jinc.BNInception(weights_path=path, pooling="avg",
                            input_shape=(64, 64, 3))
    _close_to(got(torch.from_numpy(x)), want(x))


@pytest.mark.parametrize("deit", [False, True], ids=["vits16", "deits16"])
def test_vit_preset_from_a_file_matches_jax(tmp_path, deit):
    path = str(tmp_path / "vit.h5")
    _write_layers(path, _vit_layers(np.random.RandomState(18), dim=384,
                                    layers_=12, heads=6, ff=1536,
                                    classes=1000, deit=deit))
    x = _images(IMG, 19)
    shape = (IMG, IMG, 3)
    if deit:
        got = tvit.DeiTS16(weights=path, input_shape=shape, device="cpu")
        want = jvit.DeiTS16(weights=path, input_shape=shape)
        for g, w in zip(got(torch.from_numpy(x)), want(x)):
            _close_to(g, w)
    else:
        got = tvit.ViTS16(weights=path, input_shape=shape, device="cpu")
        want = jvit.ViTS16(weights=path, input_shape=shape)
        _close_to(got(torch.from_numpy(x)), want(x))


# --------------------------------------------------------------------------
# weights= errors: named specs look in the cache and download nothing
# --------------------------------------------------------------------------

NAMED = {
    "vitb16": (lambda: tvit.ViTB16(weights="imagenet21k+_224",
                                   device="cpu"),
               "vitb16_imagenet_21k_1000_224.h5"),
    "vitb16_21k_no_top": (lambda: tvit.ViTB16(weights="imagenet21k",
                                              device="cpu"),
                          "vitb16_imagenet_21k_224_no_top.h5"),
    "vits16_no_top": (lambda: tvit.ViTS16(weights="imagenet_224_deit",
                                          include_top=False, device="cpu"),
                      "vits16_imagenet_1000_224_deit_no_top.h5"),
    "deitb16": (lambda: tvit.DeiTB16(weights="imagenet_384",
                                     input_shape=(384, 384, 3),
                                     device="cpu"),
                "deitb16_imagenet_1000_384.h5"),
    "resnext50": (lambda: trx.ResNeXt50(weights="imagenet", device="cpu"),
                  "resnext50.h5"),
    "resnext101_notop": (lambda: trx.ResNeXt101(
        weights="imagenet", include_top=False, device="cpu"),
        "resnext101_notop.h5"),
    "seresnet50": (lambda: tse.SEResNet50(weights="imagenet", device="cpu"),
                   "seresnet50_imagenet_1000.h5"),
    "senet154_no_top": (lambda: tse.SENet154(
        weights="imagenet", include_top=False, device="cpu"),
        "senet154_imagenet_1000_no_top.h5"),
    "bninception": (lambda: tinc.BNInception(weights_path=None,
                                             device="cpu"),
                    "bninception_imagenet_1000_no_top.h5"),
}


@pytest.mark.parametrize("name", sorted(NAMED))
def test_named_weights_without_the_file_raise(tmp_path, monkeypatch, name):
    monkeypatch.setenv("CHAMBERS_TPU_WEIGHTS_DIR", str(tmp_path))
    make, file_name = NAMED[name]
    with (pytest.warns(UserWarning, match="no top")
          if name.endswith("21k_no_top") else contextlib.nullcontext()):
        with pytest.raises(FileNotFoundError) as info:
            make()
    assert os.path.join(str(tmp_path), file_name) == os.path.join(
        tvit.weights_cache_dir(), file_name)
    assert file_name in str(info.value) and str(tmp_path) in str(info.value)


def test_named_weights_file_names_are_jax_s(tmp_path, monkeypatch):
    """The cached file a spec names is the JAX package's."""
    monkeypatch.setenv("CHAMBERS_TPU_WEIGHTS_DIR", str(tmp_path))
    for model, spec in (("vitb16", "imagenet21k+_384"),
                        ("deits16", "imagenet_224"),
                        ("vitl32", "imagenet21k")):
        for top in (True, False):
            with pytest.raises(FileNotFoundError) as want:
                jvit._resolve_weights_path(model, spec, top)
            with pytest.raises(FileNotFoundError) as got:
                tvit._resolve_weights_path(model, spec, top)
            name = str(want.value).split("expect the file ")[1].split()[0]
            assert name in str(got.value)


def test_weights_argument_checks():
    with pytest.raises(ValueError, match="classes"):
        tse.SEResNet50(weights="imagenet", classes=7, device="cpu")
    with pytest.raises(ValueError, match="input_shape"):
        tvit.ViTB16(weights="imagenet21k+_224", input_shape=(64, 64, 3),
                    device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tvit.ViTB16(weights="imagenet21k+_224", feature_dim=8, device="cpu")


@pytest.mark.parametrize("build", [
    lambda p, s: tvit.ViTS16(weights=p, input_shape=(32, 32, 3), seed=s,
                             device="cpu"),
    lambda p, s: tse.SENet(tse.MODELS_PARAMS["seresnet50"]._replace(
        repetitions=(1,)), weights=p, seed=s, device="cpu"),
    lambda p, s: tinc.BNInception(weights_path=p or False, seed=s,
                                  device="cpu"),
], ids=["vit", "senet", "bninception"])
def test_a_non_h5_file_names_the_training_harness(tmp_path, build):
    """A file that is not ``.h5`` is a ``Model.save_weights`` msgpack (the
    training harness's format, ROADMAP.md §1 item 6): it loads, and an
    empty one says it is truncated."""
    from chambers_tpu_torch.models import Model

    source = build(None, 1)
    path = tmp_path / "weights.msgpack"
    Model(source).save_weights(str(path))
    loaded = build(str(path), 0)
    for key, value in source.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key
    empty = tmp_path / "empty.msgpack"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="truncated"):
        build(str(empty), 0)
