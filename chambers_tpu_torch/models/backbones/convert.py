"""Convert the JAX package's parameters to the port's ``state_dict``.

The port names every submodule and parameter as the Flax modules do, so
the conversion flattens the nested ``variables["params"]`` dict with ``.``
and turns Flax's list naming ``layers_<i>`` into ``layers.<i>``. It takes
numpy arrays (``jax.device_get`` of the params, or ``np.asarray`` of each
leaf) and imports no JAX.
"""

import re

import numpy as np
import torch

_LIST_ITEM = re.compile(r"^(layers)_(\d+)$")


def state_dict_from_jax(params, prefix=""):
    """Nested dict of arrays -> flat ``{name: torch.Tensor}``."""
    out = {}
    for name, value in params.items():
        m = _LIST_ITEM.match(name)
        key = prefix + (f"{m.group(1)}.{m.group(2)}" if m else name)
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(state_dict_from_jax(value, key + "."))
        else:
            out[key] = torch.from_numpy(np.array(value))
    return out
