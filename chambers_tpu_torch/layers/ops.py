"""Matmul and reduction layers (port of ``chambers_tpu/layers/ops.py``).

The reductions take numpy's arguments, ``axis`` (None for all axes, an int
or a tuple) and ``keepdims``, as the ``jnp`` functions the JAX layers wrap
do; the arg-reductions cast to ``output_type`` (int32 by default)."""

import torch


class Matmul:
    def __init__(self, transpose_a=False, transpose_b=False):
        self.transpose_a = transpose_a
        self.transpose_b = transpose_b

    def __call__(self, inputs):
        a, b = inputs
        if self.transpose_a:
            a = a.transpose(-1, -2)
        if self.transpose_b:
            b = b.transpose(-1, -2)
        return a @ b


def _axes(x, axis):
    """``axis`` as a tuple of non-negative axes, highest first."""
    if axis is None:
        axis = range(x.ndim)
    elif isinstance(axis, int):
        axis = (axis,)
    return tuple(sorted((a % x.ndim for a in axis), reverse=True))


def reduce_sum(x, axis=None, keepdims=False):
    axes = _axes(x, axis)  # an empty axis reduces nothing, as in numpy
    return torch.sum(x, dim=axes, keepdim=keepdims) if axes else x


def reduce_prod(x, axis=None, keepdims=False):
    # torch.prod takes one axis at a time: the highest first, so that the
    # others keep their numbers
    for a in _axes(x, axis):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


def reduce_max(x, axis=None, keepdims=False):
    axes = _axes(x, axis)
    return torch.amax(x, dim=axes, keepdim=keepdims) if axes else x


def reduce_min(x, axis=None, keepdims=False):
    axes = _axes(x, axis)
    return torch.amin(x, dim=axes, keepdim=keepdims) if axes else x


def argmax(x, axis=None):
    """The first maximum's index (of the flattened input for None)."""
    return torch.argmax(x, dim=axis)


def argmin(x, axis=None):
    """The first minimum's index (of the flattened input for None)."""
    return torch.argmin(x, dim=axis)


class ReduceFunctionWrapper:
    """Any ``fn(x, axis=, keepdims=)`` reduction as a layer-style callable;
    ``Sum``/``Prod``/``Max``/``Min`` are its preconfigured instances."""

    def __init__(self, reduce_fn, axis=None, keepdims=False):
        self.reduce_fn = reduce_fn
        self.axis = axis
        self.keepdims = keepdims

    def __call__(self, inputs):
        return self.reduce_fn(inputs, axis=self.axis, keepdims=self.keepdims)


class _Reduce(ReduceFunctionWrapper):
    _fn = None

    def __init__(self, axis=None, keepdims=False):
        super().__init__(type(self)._fn, axis=axis, keepdims=keepdims)


class Sum(_Reduce):
    _fn = staticmethod(reduce_sum)


class Prod(_Reduce):
    _fn = staticmethod(reduce_prod)


class Max(_Reduce):
    _fn = staticmethod(reduce_max)


class Min(_Reduce):
    _fn = staticmethod(reduce_min)


class ArgReduceFunctionWrapper:
    """Any ``fn(x, axis=)`` arg-reduction, cast to ``output_type``;
    ``Argmax``/``Argmin`` are its preconfigured instances."""

    def __init__(self, reduce_fn, axis=None, output_type=torch.int32):
        self.reduce_fn = reduce_fn
        self.axis = axis
        self.output_type = output_type

    def __call__(self, inputs):
        return self.reduce_fn(inputs, axis=self.axis).to(self.output_type)


class _ArgReduce(ArgReduceFunctionWrapper):
    _fn = None

    def __init__(self, axis=None, output_type=torch.int32):
        super().__init__(type(self)._fn, axis=axis, output_type=output_type)


class Argmax(_ArgReduce):
    _fn = staticmethod(argmax)


class Argmin(_ArgReduce):
    _fn = staticmethod(argmin)
