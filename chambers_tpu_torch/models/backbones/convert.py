"""Convert the JAX package's parameters to the port's ``state_dict``.

The port names every submodule and parameter as the Flax modules do, so
the conversion flattens the nested ``variables["params"]`` dict with ``.``
and turns Flax's list naming ``<name>_<i>`` into ``<name>.<i>`` for the
list attributes in ``LIST_ATTRIBUTES``: the stacks' ``layers`` and DETR's
``bbox_head``. That covers the ViT, DETR and the ``Seq2SeqTransformer``:
its top-level ``inputs_embed``,
``targets_embed`` (Flax's ``nn.Embed`` keeps one array, ``embedding``, and so
does the port's ``Embed``), ``encoder``, ``decoder`` and ``vocab_head`` keep
their names. It takes numpy arrays (``jax.device_get`` of the params, or ``np.asarray`` of each
leaf) and imports no JAX.

The JAX package's int8 variables (``quantize_variables``) carry a ``quant``
collection that mirrors the params tree with ``<name>_scale`` leaves; pass
it as ``quant`` and its leaves become the port's ``<key>_scale`` entries
beside the int8 kernels, the ``state_dict`` that
``quantization.quantize_state_dict`` makes and
``quantization.load_quantized_state_dict`` installs.
"""

import re

import numpy as np
import torch

# the port's nn.ModuleList attributes that Flax names ``<name>_<i>``
LIST_ATTRIBUTES = ("layers", "bbox_head")
_LIST_ITEM = re.compile(rf"^({'|'.join(LIST_ATTRIBUTES)})_(\d+)$")


def state_dict_from_jax(params, prefix="", quant=None):
    """Nested dict of arrays -> flat ``{name: torch.Tensor}``; the scales of
    a ``quant`` collection, if given, are added under their own keys."""
    out = {} if quant is None else state_dict_from_jax(quant, prefix)
    for name, value in params.items():
        m = _LIST_ITEM.match(name)
        key = prefix + (f"{m.group(1)}.{m.group(2)}" if m else name)
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(state_dict_from_jax(value, key + "."))
        else:
            out[key] = torch.from_numpy(np.array(value))
    return out
