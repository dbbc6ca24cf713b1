"""Convert between the JAX package's variables and the port's ``state_dict``.

The port names every submodule and parameter as the Flax modules do, so
the conversion flattens the nested ``variables["params"]`` dict with ``.``
and turns Flax's list naming ``<name>_<i>`` into ``<name>.<i>`` for the
list attributes in ``LIST_ATTRIBUTES``: the stacks' ``layers`` and DETR's
``bbox_head``. That covers the ViT, DETR and the ``Seq2SeqTransformer``:
its top-level ``inputs_embed``,
``targets_embed`` (Flax's ``nn.Embed`` keeps one array, ``embedding``, and so
does the port's ``Embed``), ``encoder``, ``decoder`` and ``vocab_head`` keep
their names. The CNN backbones register their submodules under Flax's
automatic names (``_ConvBN_0``, ``Conv_0``, ``BatchNorm_0``, ``_Block3_3``,
``QuantDense_0``) in Flax's creation order, so they flatten the same way.
A routed layer's ``moe`` (``w_router`` ``[d, E]``, the expert banks ``w1``
``[E, d, F]`` and ``w2`` ``[E, F, d]``, ``b1``, ``b2``) keeps JAX's layout:
no array is transposed.
It takes numpy arrays (``jax.device_get`` of the params, or ``np.asarray``
of each leaf) and imports no JAX.

The JAX package's int8 variables (``quantize_variables``) carry a ``quant``
collection that mirrors the params tree with ``<name>_scale`` leaves; pass
it as ``quant`` and its leaves become the port's ``<key>_scale`` entries
beside the int8 kernels, the ``state_dict`` that
``quantization.quantize_state_dict`` makes and
``quantization.load_quantized_state_dict`` installs. A BatchNorm model's
``batch_stats`` collection (``mean``, ``var``) goes in as ``batch_stats``
and lands in the BatchNorm buffers of the same names.

:func:`jax_variables` goes the other way: a module's parameters and
persistent buffers as ``{"params": ..., "batch_stats": ...}`` nested numpy
dicts in registration order, the template the ``.h5`` importers take where
the JAX package passes Flax's init-time variables.
"""

import re

import numpy as np
import torch

# the port's nn.ModuleList attributes that Flax names ``<name>_<i>``
LIST_ATTRIBUTES = ("layers", "bbox_head")
_LIST_ITEM = re.compile(rf"^({'|'.join(LIST_ATTRIBUTES)})_(\d+)$")


def state_dict_from_jax(params, prefix="", quant=None, batch_stats=None):
    """Nested dict of arrays -> flat ``{name: torch.Tensor}``; the scales of
    a ``quant`` collection and the statistics of a ``batch_stats`` one, if
    given, are added under their own keys."""
    out = {}
    for extra in (quant, batch_stats):
        if extra is not None:
            out.update(state_dict_from_jax(extra, prefix))
    for name, value in params.items():
        m = _LIST_ITEM.match(name)
        key = prefix + (f"{m.group(1)}.{m.group(2)}" if m else name)
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(state_dict_from_jax(value, key + "."))
        else:
            out[key] = torch.from_numpy(np.array(value))
    return out


def jax_path(name):
    """The port's parameter name as the JAX package's pytree path:
    ``encoder.layers.0.norm1.scale`` -> ``encoder/layers_0/norm1/scale``
    (the inverse of :func:`state_dict_from_jax`, over the same list
    attributes)."""
    parts, out = name.split("."), []
    for part in parts:
        if part.isdigit() and out and out[-1] in LIST_ATTRIBUTES:
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return "/".join(out)


def jax_variables(module):
    """``{"params": ..., "batch_stats": ...}``: the module's parameters and
    its persistent buffers (the BatchNorm statistics) as nested dicts of
    numpy copies under the JAX package's paths, each level in registration
    order — Flax's creation order for the modules that keep it. A module
    placed on a mesh (``parallel.sharding``) gives its parameters whole, its
    shards gathered (every rank must call)."""
    buffers = {name for name, _ in module.named_buffers()}
    whole = lambda t: t
    if getattr(module, "_mesh", None) is not None:
        from chambers_tpu_torch.parallel.sharding import full_tensor as whole
    out = {"params": {}, "batch_stats": {}}
    for key, value in module.state_dict(keep_vars=True).items():
        node = out["batch_stats" if key in buffers else "params"]
        *path, leaf = jax_path(key).split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = whole(value).detach().cpu().numpy().copy()
    return out


def load_jax_variables(module, variables):
    """Install ``{"params": ..., "batch_stats": ...}`` (nested arrays, the
    layout :func:`jax_variables` returns and the importers fill) into
    ``module``; every entry of its ``state_dict`` must be given. A module
    placed on a mesh takes whole values, each cut to this rank's shard."""
    state = state_dict_from_jax(variables["params"],
                                batch_stats=variables.get("batch_stats"))
    if getattr(module, "_mesh", None) is not None:
        from chambers_tpu_torch.parallel.sharding import slice_tensors

        state = slice_tensors(state, module.state_dict(keep_vars=True))
    module.load_state_dict(state)
    return module
