"""Fully-sharded data parallelism (ZeRO-3) as sharding rules (port of
``chambers_tpu/parallel/fsdp.py``).

:func:`fsdp_rules` walks the parameters once and emits one exact-path
``(regex, PartitionSpec)`` pair per parameter, sharding the largest
eligible dimension of each large weight over the mesh's data axis. The
rules plug into ``make_param_shardings`` / ``shard_params`` and
``Trainer(param_sharding_rules=...)``. A module placed by them stores each
weight's shard; its forward gathers the weight before use and its backward
reduce-scatters the gradient (``parallel.sharding``); an optimizer built
after placement keeps Adam's moments at the shard's size, 1/N.

Composes with tensor parallelism by layering: pass the TP rules as
``base_rules`` and each parameter keeps its TP axes while FSDP claims the
largest *remaining* dimension — an MLP kernel ``(d, ff)`` with TP
``P(None, 'model')`` becomes ``P('data', 'model')``.
"""

import re
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from chambers_tpu_torch.parallel.distributed import axis_size
from chambers_tpu_torch.parallel.sharding import P, _map_leaves, _match_spec


def fsdp_rules(
    params,
    mesh,
    axis: Union[str, Tuple[str, ...]] = "data",
    base_rules: Optional[Sequence[Tuple[str, P]]] = None,
    min_weight_size: int = 2 ** 18,
) -> List[Tuple[str, P]]:
    """Per-parameter FSDP sharding rules.

    For every parameter of at least ``min_weight_size`` elements, shard
    its largest dimension that (a) no matching ``base_rules`` spec claims
    and (b) divides evenly by the mesh ``axis`` size, over ``axis``; ties go
    to the earliest dimension. Smaller parameters (biases, norms) and those
    with no eligible dimension keep their base spec.

    :param params: an ``nn.Module`` or a tree of tensors (what
        ``make_param_shardings`` takes).
    :param axis: the mesh axis (or tuple of axes, sharded jointly) holding
        the shards, normally the data axis.
    :param base_rules: first-match-wins ``(regex, spec)`` rules applied
        before FSDP (e.g. ``VIT_TENSOR_PARALLEL_RULES``).
    :param min_weight_size: element count below which a parameter keeps
        its base spec (default 2**18, a 512×512 matrix).
    :returns: exact-anchored ``(regex, PartitionSpec)`` rules, one per
        parameter, on its JAX path.
    """
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in mesh.mesh_dim_names:
            raise ValueError(
                f"mesh has no axis {a!r} (axes: {mesh.mesh_dim_names})")
    n = axis_size(mesh, axes)
    base_rules = list(base_rules or [])
    entry = axes[0] if len(axes) == 1 else axes

    rules: List[Tuple[str, P]] = []

    def one(path, leaf):
        base = _match_spec(path, leaf, base_rules)
        dims = list(base) + [None] * (leaf.ndim - len(base))
        used = {a for d in dims if d is not None
                for a in ((d,) if isinstance(d, str) else tuple(d))}
        best = None
        if (int(np.prod(leaf.shape)) >= min_weight_size
                and not used.intersection(axes)):
            for i, size in enumerate(leaf.shape):
                if dims[i] is None and size % n == 0:
                    if best is None or size > leaf.shape[best]:
                        best = i
        if best is not None:
            dims[best] = entry
        if all(d is None for d in dims):
            dims = []  # fully replicated reads as P(), not P(None, ...)
        rules.append((f"^{re.escape(path)}$", P(*dims)))

    _map_leaves(params, one)
    return rules
