"""Parameter initializers with ``flax.linen.initializers``' rules, drawn
from an explicit ``torch.Generator``.

The port's seeded init reproduces the JAX package's *distributions*, not
its numbers (``jax.random`` streams differ from torch's); equality tests
convert the JAX package's own init with ``state_dict_from_jax``.
"""

import math

import torch

# flax's truncated-normal variance scaling divides by the standard deviation
# of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fans(shape, in_axis=-2, out_axis=-1):
    receptive = math.prod(shape) // (shape[in_axis] * shape[out_axis])
    return shape[in_axis] * receptive, shape[out_axis] * receptive


@torch.no_grad()
def variance_scaling(t, scale, mode, distribution, generator=None):
    fan_in, fan_out = _fans(t.shape)
    fan = {"fan_in": fan_in, "fan_out": fan_out,
           "fan_avg": (fan_in + fan_out) / 2}[mode]
    variance = scale / max(1.0, fan)
    if distribution == "truncated_normal":
        std = math.sqrt(variance) / _TRUNC_STD
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                           generator=generator)
    if distribution == "uniform":
        limit = math.sqrt(3 * variance)
        return torch.nn.init.uniform_(t, -limit, limit, generator=generator)
    raise ValueError(f"unknown distribution {distribution!r}")


def lecun_normal(t, generator=None):
    return variance_scaling(t, 1.0, "fan_in", "truncated_normal", generator)


def glorot_uniform(t, generator=None):
    return variance_scaling(t, 1.0, "fan_avg", "uniform", generator)


def he_uniform(t, generator=None):
    return variance_scaling(t, 2.0, "fan_in", "uniform", generator)


def he_normal(t, generator=None):
    return variance_scaling(t, 2.0, "fan_in", "truncated_normal", generator)


@torch.no_grad()
def truncated_normal_002(t, generator=None):
    """flax ``truncated_normal(stddev=0.02)``: a unit normal truncated to
    [-2, 2], times 0.02."""
    return torch.nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04,
                                       generator=generator)


@torch.no_grad()
def zeros(t, generator=None):
    return t.zero_()


@torch.no_grad()
def ones(t, generator=None):
    return t.fill_(1.0)


def new_param(shape, dtype, device):
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def init_module(module, generator=None):
    """Seeded init: ``reset_parameters(generator)`` of every submodule that
    owns parameters, in module order."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
