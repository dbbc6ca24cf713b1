"""Pipeline parallelism: GPipe microbatching over a ``pipe`` mesh axis
(port of ``chambers_tpu/parallel/pipeline_parallel.py``).

The layer stack is split into S contiguous *stages*, one per rank along
the ``pipe`` axis, and the batch into M *microbatches* that stream through
them. Each rank holds only its own stage's weights. Activations travel to
the next stage by point-to-point sends (``batch_isend_irecv``), one
microbatch's activations a tick, over M + S - 1 ticks: at tick t stage s
runs microbatch t - s when 0 <= t - s < M (an idle rank computes nothing;
the JAX version runs garbage lanes to stay SPMD). The bubble is
(S-1)/(M+S-1): pick M >= 4·S to keep it under ~20%.

The backward runs the schedule in reverse inside one
``torch.autograd.Function``: the last stage starts from its outputs'
gradient, every stage back-propagates a microbatch through its own graph
and sends the activation's gradient to the stage before, so the
parameters' gradients accumulate over the microbatches exactly as in the
sequential run. The output is replicated over ``pipe`` by a broadcast from
the last stage; its backward takes the last stage's gradient (every rank
computes the same loss from the replicated output).
"""

from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from chambers_tpu_torch.parallel.distributed import (
    axis_group,
    axis_index,
    axis_size,
    gather,
    reduce_backward,
    split,
    tree_map,
)
from chambers_tpu_torch.parallel.sharding import NamedSharding, P, _distribute


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for t in tree.values() for leaf in _leaves(t)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def stack_pipeline_stages(stage_param_trees: Sequence[Any]):
    """Stack S per-stage parameter trees (dicts, lists or tuples of
    tensors) into one tree with a leading stage axis on every leaf, the
    layout ``pipeline_apply`` expects (leaf shape ``[S, ...]``). All stages
    must share a structure and leaf shapes."""
    trees = list(stage_param_trees)
    if not trees:
        raise ValueError("need at least one stage")
    leaves = [_leaves(t) for t in trees]
    return _unflatten(trees[0], [torch.stack(ls) for ls in zip(*leaves)])


def group_layers_into_stages(layer_param_trees: Sequence[Any], n_stages: int):
    """Group L per-layer parameter trees into ``n_stages`` stage trees whose
    leaves gain a leading ``L // n_stages`` axis, stage-stacked to
    ``[S, L/S, ...]``. A stage function receives the ``[L/S, ...]`` slice
    and loops over it."""
    layers = list(layer_param_trees)
    if len(layers) % n_stages:
        raise ValueError(
            f"{len(layers)} layers not divisible into {n_stages} stages")
    per = len(layers) // n_stages
    return stack_pipeline_stages(
        [stack_pipeline_stages(layers[i * per:(i + 1) * per])
         for i in range(n_stages)])


def shard_pipeline_params(stage_params, mesh, axis: str = "pipe"):
    """Stage-stacked parameters as ``DTensor`` leaves sharded on the stage
    axis over ``axis``: each rank holds only its own stage's weights."""
    sharding = NamedSharding(mesh, P(axis))
    return tree_map(lambda x: _distribute(x, sharding), stage_params)


def _stage_slice(leaf, stage):
    """This rank's stage of a ``[S, ...]`` leaf (a ``DTensor`` shard holds
    just it)."""
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[stage]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *params):
        fn, stage, S, M, group, ranks = run
        mb = x.shape[0] // M
        inputs, outputs = [None] * M, [None] * M
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        shape = (mb,) + tuple(x.shape[1:])
        with torch.enable_grad():
            for t in range(M + S - 1):
                m = t - stage
                if not 0 <= m < M:
                    continue
                if stage == 0:
                    act = x[m * mb:(m + 1) * mb].detach()
                else:
                    act = x.new_empty(shape)
                    _p2p([dist.P2POp(dist.irecv, act, ranks[stage - 1],
                                     group)])
                act.requires_grad_(True)
                y = fn(leaves, act)
                if stage < S - 1:
                    _p2p([dist.P2POp(dist.isend, y.detach().contiguous(),
                                     ranks[stage + 1], group)])
                inputs[m], outputs[m] = act, y
        if stage == S - 1:
            out = torch.cat([y.detach() for y in outputs])
        else:
            out = x.new_empty((M * mb,) + tuple(x.shape[1:]))
        if S > 1:
            dist.broadcast(out, src=ranks[S - 1], group=group)
        ctx.run, ctx.leaves = run, leaves
        ctx.inputs, ctx.outputs = inputs, outputs
        return out

    @staticmethod
    def backward(ctx, grad):
        fn, stage, S, M, group, ranks = ctx.run
        mb = grad.shape[0] // M
        dx = [None] * M
        for m in reversed(range(M)):
            if stage == S - 1:
                g = grad[m * mb:(m + 1) * mb]
            else:
                g = torch.empty_like(ctx.outputs[m])
                _p2p([dist.P2POp(dist.irecv, g, ranks[stage + 1], group)])
            torch.autograd.backward(ctx.outputs[m], g.contiguous())
            if stage > 0:
                _p2p([dist.P2POp(dist.isend, ctx.inputs[m].grad.contiguous(),
                                 ranks[stage - 1], group)])
            else:
                dx[m] = ctx.inputs[m].grad
        dx = torch.cat(dx) if stage == 0 else torch.zeros_like(grad)
        if S > 1:
            # the first stage's gradient of the input, on every rank
            dist.broadcast(dx, src=ranks[0], group=group)
        return (None, dx) + tuple(
            p.grad if p.grad is not None else None for p in ctx.leaves)


def _p2p(ops):
    for request in dist.batch_isend_irecv(ops):
        request.wait()


def pipeline_apply(
    stage_fn: Callable,
    stage_params,
    x,
    *,
    mesh,
    axis: str = "pipe",
    n_microbatches: int,
    batch_axis: Optional[str] = None,
    remat: bool = False,
):
    """Run ``x`` through S pipelined stages of ``stage_fn`` over the mesh.

    :param stage_fn: ``(params_for_one_stage, activations) -> activations``;
        must keep the activation's shape (true for transformer blocks).
        ``params_for_one_stage`` is ``stage_params`` with the stage axis
        removed (e.g. through ``torch.func.functional_call``).
    :param stage_params: a tree with a leading stage axis of size S =
        the ``axis`` size on every leaf (see :func:`stack_pipeline_stages`,
        :func:`group_layers_into_stages`): plain tensors, of which each rank
        uses its stage's row, or ``DTensor`` leaves from
        :func:`shard_pipeline_params`. Their gradients are the sequential
        run's (a plain leaf gets its rank's stage row).
    :param x: the global batch ``[B, ...]``, the same on every rank. B (per
        data shard, if ``batch_axis``) must divide into ``n_microbatches``.
    :param batch_axis: optional mesh axis carrying data parallelism: the
        batch is split over it and the parameters' gradients summed over it.
    :param remat: rematerialise each stage application in the backward
        (``torch.utils.checkpoint``).
    :return: ``stage_fn^S(x)``, the global batch on every rank.
    """
    S = axis_size(mesh, axis)
    M = int(n_microbatches)
    if M < 1:
        raise ValueError("n_microbatches must be >= 1")
    leaves = _leaves(stage_params)
    if leaves and leaves[0].shape[0] != S:
        raise ValueError(
            f"stage_params leading axis {leaves[0].shape[0]} != mesh "
            f"'{axis}' size {S}; stack exactly one stage per device "
            "(group_layers_into_stages folds layers within a stage)")
    stage = axis_index(mesh, axis)
    group = axis_group(mesh, axis)
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else [dist.get_rank() if dist.is_initialized() else 0])
    data_group = axis_group(mesh, batch_axis) if batch_axis else None
    x_local = split(torch.as_tensor(x), data_group, 0)
    if x_local.shape[0] % M:
        raise ValueError(
            f"per-shard batch {x_local.shape[0]} not divisible by "
            f"n_microbatches={M}")
    local = [_stage_slice(leaf, stage) for leaf in leaves]
    # the data shards' contributions to each parameter summed in the
    # backward (every rank computes the loss on the gathered output)
    local = [reduce_backward(p, data_group) for p in local]

    def fn(params, act):
        tree = _unflatten(stage_params, params)
        if remat:
            return checkpoint(stage_fn, tree, act, use_reentrant=False)
        return stage_fn(tree, act)

    out = _Pipeline.apply((fn, stage, S, M, group, ranks), x_local, *local)
    return gather(out, data_group, 0, "slice")
