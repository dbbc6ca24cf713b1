"""Config serialization round-trip for the public API (port of
``chambers_tpu/serialization.py``).

- ``get_config(obj)``: the object's own ``get_config()`` if it has one,
  else its ``__init__`` parameters read back from same-named attributes
  (the placement arguments ``device`` and ``generator`` are not config;
  a module leaves out values equal to their defaults, as the JAX package
  does for its Flax modules).
- ``serialize_object(obj)`` / ``deserialize_object(spec)``: the
  ``{"class_name", "config"}`` round trip over a class registry, recursing
  into nested objects and writing dtypes (numpy or torch) as
  ``{"__dtype__": name}``, the JAX package's encoding; a name decodes to
  the torch dtype.

The registry holds every public class of the port's ``augmentations``,
``layers``, ``losses``, ``metrics``, ``miners``, ``optimizers`` and
``schedules`` and the model architectures; ``register_serializable``
adds more.
"""

import inspect
from typing import Any, Dict

import numpy as np
import torch

_REGISTRY: Dict[str, type] = {}
# __init__ parameters that place an object rather than configure it
_PLACEMENT = ("self", "device", "generator")


def register_serializable(cls):
    """Register a class for ``deserialize_object`` (idempotent; decorator)."""
    _REGISTRY[cls.__name__] = cls
    return cls


def _register_public_namespaces():
    import chambers_tpu_torch.augmentations as A
    import chambers_tpu_torch.layers as L
    import chambers_tpu_torch.losses as Lo
    import chambers_tpu_torch.metrics as Me
    import chambers_tpu_torch.miners as M
    import chambers_tpu_torch.optimizers as O
    import chambers_tpu_torch.schedules as S

    for mod in (L, Lo, M, A, S, O, Me):
        for name in dir(mod):
            obj = getattr(mod, name)
            if (inspect.isclass(obj) and not name.startswith("_")
                    and obj.__module__.startswith("chambers_tpu_torch")):
                _REGISTRY.setdefault(name, obj)

    # the model architectures
    from chambers_tpu_torch.models import Seq2SeqTransformer
    from chambers_tpu_torch.models.backbones.inception import (
        BNInceptionModule,
    )
    from chambers_tpu_torch.models.backbones.resnext import ResNeXtModule
    from chambers_tpu_torch.models.backbones.senet import SENetModule
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        DistilledVisionTransformer, VisionTransformer,
    )
    from chambers_tpu_torch.models.detection import DETR

    for cls in (VisionTransformer, DistilledVisionTransformer, SENetModule,
                ResNeXtModule, BNInceptionModule, Seq2SeqTransformer, DETR):
        _REGISTRY.setdefault(cls.__name__, cls)


def _ensure_registry():
    if not _REGISTRY:
        _register_public_namespaces()


def _is_serializable_instance(value):
    _ensure_registry()
    cls = _REGISTRY.get(type(value).__name__)
    return cls is not None and isinstance(value, cls)


def _encode(value):
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, dict):
        return {k: _encode(v) for k, v in value.items()}
    if _is_serializable_instance(value):
        return serialize_object(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.integer, np.floating)):
        return value.item()
    if isinstance(value, torch.dtype):
        return {"__dtype__": str(value).rsplit(".", 1)[-1]}
    # numpy dtypes arrive as classes or np.dtype instances; JSON-encode
    # them as names (strings pass through untouched)
    if not isinstance(value, (str, int, float, bool, type(None))):
        try:
            return {"__dtype__": np.dtype(value).name}
        except TypeError:
            pass
        if callable(value):
            raise ValueError(
                f"Cannot serialize callable config value {value!r}; define "
                "an explicit get_config() on the owning class."
            )
    return value


def _decode(value):
    if isinstance(value, dict) and "__dtype__" in value:
        return getattr(torch, value["__dtype__"])
    if isinstance(value, dict) and "class_name" in value and "config" in value:
        return deserialize_object(value)
    if isinstance(value, dict):
        return {k: _decode(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_decode(v) for v in value]
    return value


def get_config(obj) -> Dict[str, Any]:
    """Constructor kwargs reproducing ``obj``."""
    explicit = getattr(type(obj), "get_config", None)
    if explicit is not None:
        return obj.get_config()
    config = {}
    # a module leaves out the values equal to their defaults, as the JAX
    # package does for its (dataclass) Flax modules
    omit_defaults = isinstance(obj, torch.nn.Module)
    sig = inspect.signature(type(obj).__init__)
    for pname, param in sig.parameters.items():
        if pname in _PLACEMENT or param.kind in (param.VAR_POSITIONAL,
                                                 param.VAR_KEYWORD):
            continue
        if not hasattr(obj, pname):
            raise ValueError(
                f"{type(obj).__name__} stores no attribute for __init__ "
                f"parameter '{pname}'; define an explicit get_config()."
            )
        value = getattr(obj, pname)
        if omit_defaults and param.default is not param.empty:
            try:
                if value is param.default or bool(value == param.default):
                    continue
            except Exception:
                pass
        config[pname] = value
    return config


def serialize_object(obj) -> Dict[str, Any]:
    """``{"class_name", "config"}`` spec (Keras serialize contract)."""
    _ensure_registry()
    name = type(obj).__name__
    if name not in _REGISTRY:
        raise ValueError(f"{name} is not a registered serializable class.")
    return {"class_name": name,
            "config": {k: _encode(v) for k, v in get_config(obj).items()}}


def deserialize_object(spec, **placement):
    """Rebuild an object from ``serialize_object`` output. ``placement``
    (``device=``, ``generator=``) goes to the constructors that take it:
    the port's modules run on CUDA unless told otherwise."""
    _ensure_registry()
    cls = _REGISTRY.get(spec["class_name"])
    if cls is None:
        raise ValueError(f"Unknown serializable class '{spec['class_name']}'")
    config = {k: _decode(v) for k, v in spec["config"].items()}
    params = inspect.signature(cls.__init__).parameters
    config.update({k: v for k, v in placement.items() if k in params})
    from_config = getattr(cls, "from_config", None)
    if from_config is not None:
        return cls.from_config(config)
    return cls(**config)
