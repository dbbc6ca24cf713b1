"""Multi-process set-up and the collectives the parallel modules share
(port of ``chambers_tpu/parallel/distributed.py``).

The JAX package initialises ``jax.distributed`` and lets XLA emit every
collective. Here :func:`init_distributed` starts a ``torch.distributed``
process group (NCCL on the card, gloo for ``device="cpu"``), one process a
device, and the collectives are called by hand: the autograd functions
below each state their forward and backward.

The convention every parallel path of the port keeps: a value that is
*replicated* over a group is computed identically on each of its ranks,
the loss included, and each rank back-propagates its own copy; a
parameter's gradient is then the sum of the ranks' contributions over the
groups whose ranks hold different rows (``sharding.reduce_gradients`` over
the batch axis). The backward of each function follows from that:
gathering rows a replicated consumer reads (``gather``) hands each rank
the slice of the gradient that belongs to its rows, and splitting a
replicated value (``split``) gathers the slices' gradients back.

At world size 1 (a group of one rank) every function is the identity and
no collective runs.
"""

from __future__ import annotations

import os
import warnings
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from chambers_tpu_torch._device import resolve_device


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None) -> dict:
    """Start the ``torch.distributed`` process group of a multi-process run.

    With arguments, the group is ``num_processes`` processes meeting at
    ``coordinator_address`` (``host:port`` or a ``tcp://`` / ``file://``
    URL), this one ranked ``process_id``; failures propagate (a multi-process
    job that quietly falls back to one process trains on wrong gradients).
    Without them it reads ``torchrun``'s ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT``; in a plain single process it is a
    no-op. A group that is already up is kept.

    The backend is NCCL on CUDA (the default device) and gloo for
    ``device="cpu"``. On CUDA the process takes the card ``LOCAL_RANK``
    (else its rank modulo the cards present).

    :return: ``process_index``, ``process_count``, ``local_device_count``
        and ``global_device_count``, as the JAX function returns.
    """
    device = resolve_device(device)
    explicit = coordinator_address or num_processes
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if explicit:
            if num_processes is None or process_id is None:
                raise ValueError(
                    "init_distributed: pass num_processes and process_id "
                    "with coordinator_address")
            url = coordinator_address or "tcp://localhost:29500"
            if "://" not in url:
                url = f"tcp://{url}"
            _set_card(device, process_id)
            dist.init_process_group(backend, init_method=url,
                                    world_size=int(num_processes),
                                    rank=int(process_id))
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            _set_card(device, int(os.environ["RANK"]))
            dist.init_process_group(backend, init_method="env://")
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = torch.cuda.device_count() if device.type == "cuda" else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_device_count": local,
        "global_device_count": world,
    }


def _set_card(device, rank):
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def host_local_batch_to_global(batch, mesh, axis: str = "data",
                               batch_axis: int = 0):
    """Each process's *local* rows of a global batch as one global
    ``DTensor`` sharded over ``axis`` on dimension ``batch_axis`` (the
    counterpart of ``jax.make_array_from_process_local_data``): no data
    moves, the local rows become this rank's shard. Leaves may be numpy
    arrays or tensors, in tuples, lists or dicts; they land on the mesh's
    device."""
    from torch.distributed.tensor import DTensor

    from chambers_tpu_torch.parallel.sharding import (
        PartitionSpec,
        _placements,
    )

    spec = PartitionSpec(*([None] * batch_axis), axis)
    placements = _placements(mesh, spec)
    device = mesh_device(mesh)

    def convert(x):
        local = torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device)
        return DTensor.from_local(local, mesh, placements)

    return tree_map(convert, batch)


# ---------------------------------------------------------------------------
# meshes and groups
# ---------------------------------------------------------------------------

def mesh_device(mesh) -> torch.device:
    """The device a mesh's tensors live on in this process."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axes) -> int:
    """The number of ranks along ``axes`` (a name or a tuple of names; 1
    for an axis the mesh does not have)."""
    names = mesh.mesh_dim_names
    n = 1
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if a in names:
            n *= mesh.size(names.index(a))
    return n


def axis_index(mesh, axes) -> int:
    """This rank's coordinate along ``axes`` jointly, the first axis
    major."""
    names = mesh.mesh_dim_names
    index = 0
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if a in names:
            dim = names.index(a)
            index = index * mesh.size(dim) + mesh.get_local_rank(dim)
    return index


_GROUPS = {}

# recent torch prefers all_gather_single; the older name is the one every
# supported version has
warnings.filterwarnings(
    "ignore", message=".*all_gather_into_tensor.*is deprecated")


def axis_group(mesh, axes):
    """The process group of this rank's ranks along ``axes`` (a name or a
    tuple of names), or None when that is this rank alone. Group ranks run
    in the order of the joint coordinate :func:`axis_index`. Every rank
    must ask for the same groups in the same order (``new_group`` is
    collective)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if axis_size(mesh, axes) == 1:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = mesh.mesh_dim_names
        ranks = mesh.mesh.cpu().numpy()
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(ranks.ndim) if d not in dims]
        # rows: every combination of the other axes; columns: the joint
        # coordinate over ``axes`` (first axis major)
        table = np.transpose(ranks, rest + dims).reshape(
            -1, axis_size(mesh, axes))
        mine = None
        for row in table:
            group = dist.new_group([int(r) for r in row])
            if dist.get_rank() in row:
                mine = group
        _GROUPS[key] = mine
    return _GROUPS[key]


def _size(group):
    return 1 if group is None else dist.get_world_size(group)


def _rank(group):
    return 0 if group is None else dist.get_rank(group)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _all_gather(x, group, dim):
    n = _size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, group, dim):
    n = _size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _slice(x, group, dim):
    return x.chunk(_size(group), dim=dim)[_rank(group)].contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad):
        ctx.args = (group, dim, grad)
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, grad = ctx.args
        if grad == "sum":
            return _reduce_scatter(g, group, dim), None, None, None
        return _slice(g, group, dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _all_gather(g, group, dim), None, None


class _ReduceForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def gather(x, group, dim=0, grad="slice"):
    """All-gather ``x`` along ``dim`` over ``group`` (group-rank order).
    Backward: ``grad="slice"`` takes this rank's slice of the gradient (the
    gathered value's consumers are replicated); ``grad="sum"``
    reduce-scatters it (they differ by rank, e.g. a weight gathered for the
    rank's own rows)."""
    if _size(group) == 1:
        return x
    return _Gather.apply(x, group, dim, grad)


def split(x, group, dim=0):
    """This rank's chunk of a replicated ``x`` along ``dim``; backward
    all-gathers the chunks' gradients."""
    if _size(group) == 1:
        return x
    return _Split.apply(x, group, dim)


def reduce_forward(x, group):
    """Sum over ``group`` of the ranks' partial ``x``, for consumers that
    are the same on every rank; backward passes the gradient through
    (Megatron's g)."""
    if _size(group) == 1:
        return x
    return _ReduceForward.apply(x, group)


def reduce_backward(x, group):
    """The identity; backward sums the gradient over ``group`` (Megatron's
    f: a replicated value entering rank-local work)."""
    if _size(group) == 1:
        return x
    return _ReduceBackward.apply(x, group)


def reduce_both(x, group):
    """Sum of ``x`` over ``group`` that each rank goes on to use on its own
    rows (BatchNorm's statistics): backward sums the gradient over
    ``group`` too, every rank's rows having depended on every rank's
    ``x``."""
    if _size(group) == 1:
        return x
    return _ReduceBoth.apply(x, group)


def all_to_all(x, group):
    """``all_to_all_single`` with equal splits along dimension 0: chunk
    ``i`` goes to group rank ``i``, and the result's chunk ``j`` came from
    rank ``j``; backward sends the gradients back the same way."""
    if _size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


# ---------------------------------------------------------------------------
# the batch of a forward
# ---------------------------------------------------------------------------

_UNSET = object()


@contextmanager
def data_parallel(module, mesh, axis="data"):
    """Run ``module``'s forwards in the block on this rank's rows of a batch
    sharded over ``axis``: the layers whose result depends on other rows
    then compute over the global batch. It sets, on every submodule that
    declares them, ``_batch_group`` (the axis's process group: dropout draws
    the global batch's mask and keeps its rows, BatchNorm's statistics are
    all-reduced) and ``_batch_sharding`` (``(mesh, axis)``: the
    mixture-of-experts router's queues and load statistics), and restores
    them after. ``Trainer(mesh=)``, ``Model.predict(mesh=)`` and the
    decoders on a row-sharded batch enter it themselves."""
    values = {"_batch_group": axis_group(mesh, axis),
              "_batch_sharding": (mesh, axis)}
    saved = []
    for m in module.modules():
        for name, value in values.items():
            if hasattr(type(m), name):
                saved.append((m, name, m.__dict__.get(name, _UNSET)))
                setattr(m, name, value)
    try:
        yield
    finally:
        for m, name, value in reversed(saved):
            if value is _UNSET:
                delattr(m, name)
            else:
                setattr(m, name, value)


def local_rows(x, mesh, axis="data"):
    """This rank's rows of a global batch leaf, zero-padded so that every
    rank of ``axis`` holds as many (a tail batch that does not divide):
    numpy stays numpy on the host, a tensor stays on its device, a
    ``DTensor`` sharded over ``axis`` gives its shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.to_local()
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    n, size = x.shape[0], axis_size(mesh, axis)
    per = -(-n // size)
    i = axis_index(mesh, axis)
    rows = x[i * per:(i + 1) * per]
    short = per - rows.shape[0]
    if short:
        if isinstance(rows, torch.Tensor):
            rows = torch.cat([rows, rows.new_zeros(
                (short,) + tuple(x.shape[1:]))])
        else:
            rows = np.concatenate([rows, np.zeros(
                (short,) + x.shape[1:], x.dtype)])
    return rows


def gather_rows(y, mesh, n, axis="data"):
    """The global batch from every rank's rows ``y`` (the inverse of
    :func:`local_rows`, padding dropped): differentiable, backward hands
    each rank its rows' gradient."""
    y = gather(y, axis_group(mesh, axis), 0, "slice")
    return y[:n]


def tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree)
