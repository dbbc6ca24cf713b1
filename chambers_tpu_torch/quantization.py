"""``QuantDense``, float path only (port of ``chambers_tpu/quantization.py``).

The layer keeps the JAX package's parameter names and layout — ``kernel``
``[in, out]`` and ``bias`` ``[out]`` — and computes what ``flax.linen.Dense``
computes. The int8 serving path (weights and activations quantized, int32
accumulation) comes in a later slice of the port; a layer given an int8
``kernel_scale`` raises until then.
"""

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device


def promote_dtype(*tensors, dtype=None):
    """flax ``promote_dtype``: ``dtype`` if given, else the promotion of the
    operands' dtypes."""
    if dtype is None:
        dtype = tensors[0].dtype
        for t in tensors[1:]:
            if t is not None:
                dtype = torch.promote_types(dtype, t.dtype)
    return dtype


class QuantDense(nn.Module):
    def __init__(self, in_features, features, use_bias=True, dtype=None,
                 param_dtype=torch.float32, kernel_init=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.kernel_init = kernel_init or initializers.lecun_normal
        self.kernel = initializers.new_param((in_features, features),
                                             param_dtype, device)
        self.bias = (initializers.new_param((features,), param_dtype, device)
                     if use_bias else None)
        self.register_buffer("kernel_scale", None)

    def reset_parameters(self, generator=None):
        self.kernel_init(self.kernel, generator)
        if self.bias is not None:
            initializers.zeros(self.bias)

    def forward(self, x):
        if self.kernel_scale is not None:
            raise NotImplementedError(
                "QuantDense's int8 path is not ported yet; it comes with the "
                "int8 serving slice.")
        dtype = promote_dtype(x, self.kernel, self.bias, dtype=self.dtype)
        y = torch.matmul(x.to(dtype), self.kernel.to(dtype))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y
