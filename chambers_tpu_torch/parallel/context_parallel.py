"""Sequence/context-parallel attention over a device mesh (port of
``chambers_tpu/parallel/context_parallel.py``).

The token axis of the query is sharded over a mesh axis; each rank
all-gathers the key and value shards (one collective each) and runs the
flash kernels (``chambers_tpu_torch.ops.flash_attention``: K3a forward,
K3b/K3c backward) on its own query rows against the whole sequence, so its
attention memory is O(t·h + t_local·t), never the global ``[t, t]``. The
gather's backward reduce-scatters dK and dV: every rank's rows attended to
every key.

This is the all-gather formulation, the right one at the flash kernel's
lengths where K/V are small next to the scores they make; ring attention
(streaming K/V blocks around the ranks) pays off only when even the
gathered K/V do not fit.
"""

from typing import Optional

from torch.distributed.tensor import DTensor

from chambers_tpu_torch.ops.flash_attention import flash_attention
from chambers_tpu_torch.parallel.distributed import axis_group, gather, split


def context_parallel_attention(
    query,
    value,
    key=None,
    *,
    mesh,
    axis: str = "data",
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
):
    """Flash attention with the query token axis sharded over ``axis``.

    :param query: ``[b, n, t, h]`` with ``t`` divisible by the mesh axis
        size: the global tensor (every rank passing the same; each takes its
        rows) or a ``DTensor`` sharded on the token axis.
    :param value: ``[b, n, t, h]``, as the query.
    :param key: optional ``[b, n, t, h]``; defaults to ``value``.
    :param scale: the score divisor, ``sqrt(h)`` when None.
    :param block_q: accepted for the JAX signature and ignored: the JAX
        kernel's TPU block sizes do not apply to the CUDA kernels.
    :param block_k: as ``block_q``.
    :return: ``[b, n, t, h]``: a ``DTensor`` sharded on the token axis for
        ``DTensor`` inputs, else the global tensor (gathered, every rank
        holding it; its backward hands each rank its rows' gradient).

    There is no ``causal`` argument, as in the JAX function: the kernel's
    causal diagonal sits at the end of the keys, right for exactly one
    rank's query rows; a causal form needs per-rank row offsets.
    """
    del block_q, block_k
    if key is None:
        key = value
    group = axis_group(mesh, axis)
    sharded = isinstance(query, DTensor)

    def rows(x):
        # this rank's token rows: a DTensor's shard, or a slice of the
        # global tensor whose gradient is gathered back in the backward
        return x.to_local() if isinstance(x, DTensor) else split(x, group, 2)

    q, k, v = rows(query), rows(key), rows(value)
    k_full = gather(k, group, 2, "sum")
    v_full = k_full if key is value else gather(v, group, 2, "sum")
    out = flash_attention(q, v_full, k_full, scale=scale, causal=False)
    if sharded:
        return DTensor.from_local(out, query.device_mesh, query.placements)
    return gather(out, group, 2, "slice")
