"""LayerNorms and L2 normalization, ``l2_normalize`` and its layer
``L2Normalization`` (port of
``chambers_tpu/layers/normalization.py`` and of ``flax.linen.LayerNorm``
as ``chambers_tpu.layers.transformer._make_norm`` uses it).

Both LayerNorms have the parameters ``scale`` and ``bias`` ``[d]`` and
return ``dtype`` when given, else the promotion of the input's and the
parameters' dtypes.
"""

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.quantization import promote_dtype


def l2_normalize(x, axis=-1, epsilon=1e-12):
    norm_sq = torch.sum(x * x, dim=axis, keepdim=True)
    return x * torch.rsqrt(torch.clamp(norm_sq, min=epsilon))


class L2Normalization:
    """Callable layer: ``l2_normalize`` along ``axis``."""

    def __init__(self, axis=-1):
        self.axis = axis

    def __call__(self, inputs):
        return l2_normalize(inputs, axis=self.axis)


class _Norm(nn.Module):
    def __init__(self, dim, epsilon=1e-6, dtype=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = initializers.new_param((dim,), param_dtype, device)
        self.bias = initializers.new_param((dim,), param_dtype, device)

    def reset_parameters(self, generator=None):
        initializers.ones(self.scale)
        initializers.zeros(self.bias)

    def _out_dtype(self, x):
        return promote_dtype(x, self.scale, self.bias, dtype=self.dtype)


class LayerNorm(_Norm):
    """``flax.linen.LayerNorm``: statistics in (at least) float32 with the
    fast variance ``E[x²] - E[x]²`` clipped at 0; ``(x - mean)`` times
    ``rsqrt(var + eps) * scale``, plus ``bias``."""

    def forward(self, x):
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xs.mean(-1, keepdim=True)
        mean2 = (xs * xs).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - mean) * mul + self.bias
        return y.to(self._out_dtype(x))


class FastLayerNorm(_Norm):
    """LayerNorm whose mean and variance run in ``stats_dtype``."""

    def __init__(self, dim, epsilon=1e-6, dtype=None,
                 param_dtype=torch.float32, stats_dtype=torch.bfloat16,
                 device=None):
        super().__init__(dim, epsilon, dtype, param_dtype, device)
        self.stats_dtype = stats_dtype

    def forward(self, x):
        sd = self.stats_dtype
        xs = x.to(sd)
        mu = xs.mean(-1, keepdim=True)
        var = ((xs - mu) ** 2).mean(-1, keepdim=True)
        eps = float(torch.tensor(self.epsilon, dtype=sd))  # rounded to sd
        y = (xs - mu) * torch.rsqrt(var + eps)
        y = y * self.scale.to(sd) + self.bias.to(sd)
        return y.to(self._out_dtype(x))
