"""What the CNN backbones take from Flax: ``Conv``, ``BatchNorm`` with
Flax's semantics, the conv-BatchNorm unit the three families share, and
the padding and pooling the JAX backbones write out (``jnp.pad``,
``nn.max_pool``, ``nn.avg_pool``).

Every forward takes and returns NHWC ``[b, H, W, c]`` tensors, as the JAX
modules do. ``Conv`` keeps Flax's kernel layout ``[kh, kw, in/groups, out]``
so names and shapes convert one to one, and hands ``F.conv2d`` the NCHW
view of its input: the view of a contiguous NHWC tensor is
``torch.channels_last`` memory, for which cuDNN picks its NHWC kernels (and
returns channels-last, whose NHWC view is contiguous again). Flax's
``feature_group_count`` and PyTorch's ``groups`` both split the output
channels contiguously, so ``kernel.permute(3, 2, 0, 1)`` is the exact OIHW
kernel of a grouped convolution.

``BatchNorm`` is ``flax.linen.BatchNorm`` (flax 0.12), not PyTorch's: the
running update is ``ra = 0.99 * ra + (1 - 0.99) * batch`` (Flax's
momentum, which the three families keep; PyTorch's momentum weighs the
other side); the train-mode variance is the biased ``E[x²] - E[x]²``
clipped at 0, computed in float32 whatever the input; the output is ``(x -
mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast to the module's
dtype. The parameters are ``scale`` and ``bias``, the statistics the
buffers ``mean`` and ``var`` (Flax's ``batch_stats``). In train mode the
forward updates the buffers in place, where Flax returns the mutated
collection.

Submodules take Flax's automatic names (``Conv_0``, ``BatchNorm_0``,
``_ConvBN_3``) through :func:`add_named`, in Flax's creation order, so a
``state_dict`` converts from and to the JAX package's variables as a plain
flatten.
"""

import torch
from torch import nn
from torch.nn import functional as F

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.quantization import promote_dtype


def add_named(parent, kind, module):
    """Register ``module`` under Flax's automatic name ``<kind>_<i>``, ``i``
    counting the children of that kind registered before it."""
    n = sum(1 for name in parent._modules if name.rsplit("_", 1)[0] == kind)
    parent.add_module(f"{kind}_{n}", module)
    return module


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def same_pads(size, window, stride):
    """XLA's ``SAME`` padding of one axis, ``(lo, hi)``: the output has
    ``ceil(size / stride)`` rows and the odd row of padding goes last."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def pad_hw(x, pads, value=0.0):
    """Pad the two spatial axes of an NHWC tensor by ``((top, bottom),
    (left, right))`` with ``value`` (``jnp.pad`` of those axes)."""
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def max_pool(x, window, strides):
    """``flax.linen.max_pool`` over NHWC with VALID padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, strides)
    return y.permute(0, 2, 3, 1)


def avg_pool(x, window, strides, padding):
    """``flax.linen.avg_pool(..., count_include_pad=False)`` over NHWC with
    symmetric padding: each window's mean over its unpadded values."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, strides, padding,
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """``flax.linen.Conv`` over NHWC: ``kernel`` ``[kh, kw, in/groups,
    out]``, optional ``bias`` ``[out]``, ``padding`` an int (symmetric),
    ``"SAME"`` or ``"VALID"``. Inputs and parameters are cast to ``dtype``
    (else their promotion) as Flax's ``promote_dtype`` does; the
    parameters are float32."""

    def __init__(self, in_features, features, kernel_size, strides=1,
                 padding=0, groups=1, use_bias=True, kernel_init=None,
                 dtype=None, device=None):
        super().__init__()
        device = resolve_device(device)
        if in_features % groups or features % groups:
            raise ValueError(f"{in_features} inputs and {features} outputs "
                             f"do not split into {groups} groups")
        kh, kw = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.kernel_init = kernel_init or initializers.lecun_normal
        self.kernel = initializers.new_param(
            (kh, kw, in_features // groups, features), torch.float32, device)
        self.bias = (initializers.new_param((features,), torch.float32,
                                            device) if use_bias else None)

    def reset_parameters(self, generator=None):
        self.kernel_init(self.kernel, generator)
        if self.bias is not None:
            initializers.zeros(self.bias)

    def _pads(self, h, w):
        if isinstance(self.padding, int):
            return (self.padding,) * 2, (self.padding,) * 2
        if self.padding.upper() == "VALID":
            return (0, 0), (0, 0)
        if self.padding.upper() == "SAME":
            kh, kw = self.kernel.shape[:2]
            return (same_pads(h, kh, self.strides[0]),
                    same_pads(w, kw, self.strides[1]))
        raise ValueError(f"unknown padding {self.padding!r}")

    def forward(self, x):
        dtype = promote_dtype(x, self.kernel, self.bias, dtype=self.dtype)
        (t, b), (l, r) = self._pads(x.shape[1], x.shape[2])
        x = x.to(dtype)
        if t != b or l != r:
            x, t, l = pad_hw(x, ((t, b), (l, r))), 0, 0
        kernel = self.kernel.permute(3, 2, 0, 1).to(
            dtype, memory_format=torch.channels_last)
        bias = None if self.bias is None else self.bias.to(dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), kernel, bias, self.strides,
                     (t, l), 1, self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the last axis of NHWC input (see the
    module docstring); ``forward(x, train)`` normalizes with the batch's
    statistics and updates the running ones when ``train``, else with the
    running ones. Under ``parallel.distributed.data_parallel`` the batch is
    this rank's rows of one sharded over ``_batch_group``, and its
    statistics are the global batch's (each rank's means all-reduced; a
    padded tail batch counts its zero rows)."""

    momentum = 0.99
    _batch_group = None

    def __init__(self, features, epsilon=1e-5, dtype=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = initializers.new_param((features,), torch.float32,
                                            device)
        self.bias = initializers.new_param((features,), torch.float32,
                                           device)
        self.register_buffer("mean", torch.zeros(
            features, dtype=torch.float32, device=device))
        self.register_buffer("var", torch.ones(
            features, dtype=torch.float32, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        initializers.ones(self.scale)
        initializers.zeros(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x, train=False):
        if train:
            xs = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = tuple(range(x.ndim - 1))
            mean, square = xs.mean(axes), (xs * xs).mean(axes)
            group = self._batch_group
            if group is not None:
                # a batch sharded over processes: the global batch's
                # statistics, as the JAX layer computes them under a mesh
                from chambers_tpu_torch.parallel.distributed import (
                    reduce_both,
                )

                n = torch.distributed.get_world_size(group)
                mean, square = reduce_both(
                    torch.stack([mean, square]), group) / n
            var = torch.clamp(square - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean
                                + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var
                               + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        y = x - mean
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = y * mul + self.bias
        return y.to(promote_dtype(x, self.scale, self.bias, dtype=self.dtype))


class ConvBN(nn.Module):
    """Conv (``Conv_0``) -> BatchNorm (``BatchNorm_0``) -> optional ReLU:
    the ``_ConvBN`` of the three JAX families, which differ in the
    epsilon, the conv's bias and its init."""

    def __init__(self, in_features, filters, kernel, strides=1, groups=1,
                 pad=0, relu=True, use_bias=False, epsilon=1e-5,
                 kernel_init=None, dtype=None, device=None):
        super().__init__()
        self.relu = relu
        add_named(self, "Conv", Conv(
            in_features, filters, kernel, strides, pad, groups, use_bias,
            kernel_init, dtype=dtype, device=device))
        add_named(self, "BatchNorm", BatchNorm(
            filters, epsilon, dtype=dtype, device=device))

    def forward(self, x, train=False):
        x = self.BatchNorm_0(self.Conv_0(x), train)
        return torch.relu(x) if self.relu else x
