"""Config serialization of the port (``chambers_tpu_torch.serialization``)
against the JAX package's: ``serialize_object`` gives the same
``{"class_name", "config"}`` dicts for the same objects, and every spec
round-trips through ``deserialize_object`` to an object with the same
config and behaviour."""

import json

import numpy as np
import pytest
import torch

from chambers_tpu import serialization as JS
from chambers_tpu_torch import serialization as TS
from test_torch_package import one_torch_thread  # noqa: F401

# (namespace, class, kwargs): objects both packages build from the same
# arguments; metrics take the port's ``device`` on top
_SHARED = [
    ("layers", "ScaledAttention", dict(causal=True)),
    ("layers", "L2Normalization", dict(axis=-1)),
    ("layers", "L1Distance", {}),
    ("layers", "L2Distance", {}),
    ("layers", "CosineSimilarity", {}),
    ("layers", "AngularCosineSimilarity", {}),
    ("layers", "PositionalEncoding1D", dict(temperature=5000.0)),
    ("layers", "PositionalEncoding2D", dict(normalize=True)),
    ("losses", "MultiSimilarityLoss", dict(pos_scale=3.0, neg_scale=30.0,
                                           threshold=0.4)),
    ("losses", "ContrastiveLoss", dict(positive_margin=0.9,
                                       negative_margin=0.2)),
    ("losses", "NTXentLoss", dict(temperature=0.3)),
    ("losses", "SparseCategoricalCrossentropy", dict(from_logits=True)),
    ("losses", "CategoricalCrossentropy", dict(label_smoothing=0.1)),
    ("losses", "MeanSquaredError", {}),
    ("losses", "BinaryCrossentropy", {}),
    ("losses", "SoftDiceLoss", {}),
    ("miners", "MultiSimilarityMiner", dict(margin=0.2)),
    ("schedules", "LinearWarmup", dict(learning_rate=0.1, warmup_steps=100)),
    ("schedules", "CosineDecay", dict(initial_learning_rate=0.1,
                                      decay_steps=10)),
    ("schedules", "ExponentialDecay", dict(initial_learning_rate=0.1,
                                           decay_steps=10, decay_rate=0.5)),
    ("schedules", "PiecewiseConstantDecay", dict(boundaries=[1, 2],
                                                 values=[0.1, 0.2, 0.3])),
    ("schedules", "PolynomialDecay", dict(initial_learning_rate=0.1,
                                          decay_steps=10)),
    ("augmentations", "Invert", {}),
    ("augmentations", "Brightness", dict(factor=1.4)),
    ("augmentations", "Posterize", dict(bits=3)),
    ("augmentations", "Solarize", dict(threshold=100)),
    ("augmentations", "SolarizeAdd", dict(addition=30, threshold=100)),
    ("augmentations", "Color", dict(factor=0.5)),
    ("augmentations", "Contrast", dict(factor=0.5)),
    ("augmentations", "Sharpness", dict(factor=0.5)),
    ("augmentations", "AutoContrast", {}),
    ("augmentations", "Equalize", {}),
    ("augmentations", "Rotate", dict(degrees=25.0)),
    ("augmentations", "ShearX", dict(level=0.2, interpolation="bilinear")),
    ("augmentations", "ShearY", dict(level=0.2)),
    ("augmentations", "TranslateX", dict(pixels=40, fill_value=128)),
    ("augmentations", "TranslateY", dict(pixels=40)),
    ("augmentations", "CutOut", dict(mask_size=16)),
    ("augmentations", "ImageNetNormalization", dict(mode="torch")),
    ("augmentations", "ResizingMinMax", dict(min_side=64)),
    ("metrics", "F1", dict(thresholds=0.5)),
    ("metrics", "Precision", {}),
    ("metrics", "Recall", {}),
    ("metrics", "AUC", dict(num_thresholds=50)),
    ("metrics", "BinaryAccuracy", {}),
    ("metrics", "Mean", {}),
    ("metrics", "SparseTopKCategoricalAccuracy", dict(k=3)),
    ("optimizers", "WeightDecayExtension", dict(weight_decay=0.1,
                                                decay_exclude=["bias"])),
]


def _build(package, namespace, name, kwargs):
    import importlib

    mod = importlib.import_module(f"{package}.{namespace}")
    extra = ({"device": "cpu"} if package == "chambers_tpu_torch"
             and namespace == "metrics" else {})
    return getattr(mod, name)(**kwargs, **extra)


@pytest.mark.parametrize("namespace,name,kwargs", _SHARED,
                         ids=[c[1] for c in _SHARED])
def test_serialize_object_equals_jax(namespace, name, kwargs):
    want = JS.serialize_object(_build("chambers_tpu", namespace, name,
                                      kwargs))
    got = TS.serialize_object(_build("chambers_tpu_torch", namespace, name,
                                     kwargs))
    assert got == want
    # and JSON-safe, as the JAX package's
    assert json.loads(json.dumps(got)) == got


def _port_cases():
    from chambers_tpu_torch import augmentations as A
    from chambers_tpu_torch import layers as L

    return [
        L.LearnedEmbedding0D(16, device="cpu"),
        L.LearnedEmbedding1D(7, 16, device="cpu"),
        L.GlobalGeneralizedMean(p=2.5, shared=False, channels=8,
                                device="cpu"),
        A.RandomChance(A.Invert(), probability=0.25),
        A.RandomChoice([A.Invert(), A.Brightness(1.2)], n_transforms=1),
        A.AutoAugment(),
    ]


@pytest.mark.parametrize("obj", _port_cases(), ids=lambda o: type(o).__name__)
def test_round_trip_of_port_only_configs(obj):
    spec = TS.serialize_object(obj)
    rebuilt = TS.deserialize_object(json.loads(json.dumps(spec)),
                                    device="cpu")
    assert type(rebuilt) is type(obj)
    assert TS.serialize_object(rebuilt) == spec


@pytest.mark.parametrize("namespace,name,kwargs",
                         [c for c in _SHARED if c[0] != "metrics"],
                         ids=[c[1] for c in _SHARED if c[0] != "metrics"])
def test_round_trip(namespace, name, kwargs):
    obj = _build("chambers_tpu_torch", namespace, name, kwargs)
    spec = TS.serialize_object(obj)
    rebuilt = TS.deserialize_object(json.loads(json.dumps(spec)))
    assert type(rebuilt) is type(obj)
    assert TS.serialize_object(rebuilt) == spec


def test_round_trip_preserves_loss_values():
    from chambers_tpu_torch.losses import MultiSimilarityLoss

    loss = MultiSimilarityLoss(pos_scale=3.0, neg_scale=30.0, threshold=0.4)
    rebuilt = TS.deserialize_object(TS.serialize_object(loss))
    rng = np.random.RandomState(0)
    y = torch.from_numpy(rng.randint(0, 3, 12))
    z = torch.nn.functional.normalize(torch.from_numpy(
        rng.randn(12, 8).astype(np.float32)), dim=-1)
    assert float(loss(y, z)) == float(rebuilt(y, z))


def test_dtypes_encode_as_the_jax_package_does():
    import jax.numpy as jnp

    want = JS._encode(jnp.bfloat16)
    assert TS._encode(torch.bfloat16) == want == {"__dtype__": "bfloat16"}
    assert TS._encode(np.dtype("float32")) == {"__dtype__": "float32"}
    assert TS._decode(want) is torch.bfloat16


def test_register_serializable_and_unknown_classes():
    class Custom:
        def __init__(self, a, b=2):
            self.a, self.b = a, b

    with pytest.raises(ValueError, match="not a registered"):
        TS.serialize_object(Custom(1))
    TS.register_serializable(Custom)
    spec = TS.serialize_object(Custom(5, b=7))
    assert spec == {"class_name": "Custom", "config": {"a": 5, "b": 7}}
    assert TS.deserialize_object(spec).b == 7
    with pytest.raises(ValueError, match="Unknown serializable"):
        TS.deserialize_object({"class_name": "Nope", "config": {}})

    class NoAttr:
        def __init__(self, c):
            pass

    with pytest.raises(ValueError, match="get_config"):
        TS.get_config(NoAttr(1))


def test_optimizer_config_round_trips_with_a_schedule():
    from chambers_tpu_torch.optimizers import AdamW
    from chambers_tpu_torch.schedules import LinearWarmup

    p = torch.nn.Parameter(torch.ones(2))
    opt = AdamW([p], weight_decay=1e-4, learning_rate=LinearWarmup(0.1, 5),
                mutable_lr=True)
    spec = {k: TS._encode(v) for k, v in opt.get_config().items()}
    config = {k: TS._decode(v) for k, v in spec.items()}
    rebuilt = AdamW.from_config(config, [torch.nn.Parameter(torch.ones(2))])
    assert rebuilt.get_config()["learning_rate"](3) == \
        opt.get_config()["learning_rate"](3)
    assert rebuilt.param_groups[0]["lr_scale"] == 1.0


def test_module_config_leaves_out_defaults():
    from chambers_tpu_torch.layers import PositionalEncoding1D

    assert TS.get_config(PositionalEncoding1D()) == {}
    assert TS.get_config(PositionalEncoding1D(add_to_input=False)) == {
        "add_to_input": False}
