"""Activation functions (port of ``chambers_tpu/activations.py``).

GELU uses the exact erf form by default — part of the ViT checkpoint-parity
contract — and the tanh approximation behind ``approximate=True``.
"""

import torch

_SQRT_2 = 1.4142135623730951
_SQRT_2_OVER_PI = 0.7978845608028654


def gelu(x, approximate: bool = False):
    """``x * P(X <= x)`` with ``X ~ N(0, 1)``, computed in ``x``'s dtype."""
    if approximate:
        return 0.5 * x * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))
    # sqrt(2) rounded to x's dtype, as jnp.asarray(_SQRT_2, x.dtype); kept a
    # host scalar (a tensor made on the card would synchronise the host)
    sqrt_2 = float(torch.tensor(_SQRT_2, dtype=x.dtype))
    return 0.5 * x * (1.0 + torch.erf(x / sqrt_2))
