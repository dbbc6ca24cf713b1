"""Expert parallelism (port of ``chambers_tpu/parallel/expert_parallel.py``).

:func:`moe_expert_parallel_rules` are the JAX rules: every expert bank's
leading (expert) axis sharded over a mesh axis, the router replicated.
Where XLA partitions the JAX layer's einsums, the port's ``MoEMLP`` runs
:func:`routed_forward` once its banks are sharded (``parallel.sharding``
marks it) or its batch is (``distributed.data_parallel`` sets its
``_batch_sharding``):

1. the ranks of the expert axis hold the same tokens; each takes its
   contiguous slice of them (the last may be short; the gradient of the
   input is gathered back);
2. the router runs on the slice; queue positions count the selections of
   the slices ahead of it over the whole token group (data × expert, in
   the global batch's order), so routing, capacity and drops are those of
   the single-device layer over the global batch;
3. each rank fills the experts' queues with its tokens and sends each
   owner its experts' queues (``all_to_all_single``); the owner sums the
   slots it received, runs its experts, and sends the results back the same
   way. What crosses ranks is tokens, ``[E, slots, d]``, never an expert
   bank;
4. the load-balancing and z losses are over the global batch (their sums
   all-reduced), and the outputs of the slices are gathered over the
   expert axis.

The router's gradient is summed over the expert axis (its ranks routed
different tokens); over the batch axis it is summed with the others by
``sharding.reduce_gradients``.
"""

from typing import List, Tuple

import torch
from torch.nn import functional as F

from chambers_tpu_torch.parallel.distributed import (
    _all_gather,
    _size,
    all_to_all,
    axis_group,
    axis_index,
    gather,
    reduce_backward,
    reduce_forward,
    split,
)
from chambers_tpu_torch.parallel.sharding import P


def moe_expert_parallel_rules(axis: str = "model") -> List[Tuple[str, P]]:
    """Param-path regex -> PartitionSpec rules sharding every MoE expert
    weight's leading (expert) axis over ``axis``.

    Compose with the TP rules when running TP x EP, or pass a dedicated
    ``expert`` mesh axis::

        rules = VIT_TENSOR_PARALLEL_RULES + moe_expert_parallel_rules("model")

    ``n_experts`` must be divisible by the mesh axis size.
    """
    # w1/b1/w2/b2/w_router are MoEMLP's names (no other layer uses them),
    # so match them at any nesting depth
    return [
        (r"(^|/)w1$", P(axis, None, None)),
        (r"(^|/)b1$", P(axis, None)),
        (r"(^|/)w2$", P(axis, None, None)),
        (r"(^|/)b2$", P(axis, None)),
        # router replicated (explicit, so composed rule lists stay readable)
        (r"(^|/)w_router$", P()),
    ]


def routed_forward(moe, inputs):
    """``moe``'s forward over sharded tokens or experts (see the module
    docstring), or None when neither is sharded here (a mesh of one)."""
    context = moe._batch_sharding
    mesh = axes = None
    if context is not None:
        mesh, data_axis = context
        axes = (data_axis,) if data_axis in mesh.mesh_dim_names else ()
    expert_axis = moe._expert_axis
    if expert_axis is not None:
        expert_mesh = moe.w1.sharding.mesh
        if mesh is not None and mesh is not expert_mesh:
            raise ValueError("data_parallel's mesh is not the one the experts "
                             "are placed on")
        mesh, axes = expert_mesh, (axes or ()) + (expert_axis,)
    experts_group = axis_group(mesh, expert_axis) if expert_axis else None
    tokens_group = axis_group(mesh, axes)
    if tokens_group is None:
        return None

    d, E = inputs.shape[-1], moe.n_experts
    dtype = moe.dtype or inputs.dtype
    x = inputs.reshape(-1, d)
    n_data = x.shape[0]
    # this expert rank's contiguous slice of the tokens (the last slices
    # may be short, or empty, when the tokens do not divide)
    owners = _size(experts_group)
    per = -(-n_data // owners)
    x = split(F.pad(x, (0, 0, 0, per * owners - n_data)), experts_group)
    n_local = min(max(n_data - axis_index(mesh, expert_axis or ()) * per, 0),
                  per)
    x = x[:n_local]
    n = n_data * _size(tokens_group) // owners
    rank = axis_index(mesh, axes)
    s = n if moe.group_size is None else min(int(moe.group_size), n)
    if n % s:
        raise ValueError(f"{n} tokens not divisible by group_size={s}")
    counts = None
    if s == n:
        # one routing group over every rank's tokens
        xg = x.reshape(1, n_local, d)

        def counts(mine):
            every = _all_gather(mine, tokens_group, 0)      # [ranks, E]
            return (every[:rank].sum(0, keepdim=True),
                    every.sum(0, keepdim=True))
    elif n_data % (owners * s):
        raise ValueError(
            f"group_size={s} neither spans the batch ({n} tokens) nor "
            f"divides each expert rank's {per}")
    else:
        xg = x.reshape(n_local // s, s, d)

    router = moe.w_router
    moe.__dict__["w_router"] = reduce_backward(router, experts_group)
    try:
        logits, probs, gates, experts = moe.route(xg)
    finally:
        moe.__dict__.pop("w_router")
    dispatch, combine, first = moe.dispatch_and_combine(
        gates, experts, moe.capacity(s), dtype, counts)
    queued = moe.enqueue(dispatch, xg.to(dtype))            # [E, slots, d]
    if experts_group is None:
        out = moe.experts(queued, dtype)
    else:
        slots = queued.shape[1]
        # chunk i of the expert axis goes to owner i; the owner sums its
        # experts' slots over the senders (each slot has one)
        mine = all_to_all(queued.reshape(owners, E // owners, slots, d),
                          experts_group).sum(0)
        done = moe.experts(mine, dtype)                     # [E/owners, ...]
        back = all_to_all(done.unsqueeze(0).expand(owners, -1, -1, -1),
                          experts_group)
        out = back.reshape(E, slots, d)
    y = moe.dequeue(combine, out)

    # the losses over the global batch: sums all-reduced over the tokens'
    # ranks, each rank back-propagating its own share
    if s == n:
        frac = reduce_forward(first.to(torch.float32).sum(dim=1),
                              tokens_group) / n             # [1, E]
        mean_probs = reduce_forward(probs.sum(dim=1), tokens_group) / n
        balance = (frac * mean_probs).sum()
    else:
        # whole groups on each rank: the mean over every rank's groups
        balance = reduce_forward(
            (first.to(torch.float32).mean(dim=1)
             * probs.mean(dim=1)).sum(), tokens_group) / (n // s)
    aux = moe.aux_loss_weight * E * balance
    if moe.router_z_loss_weight:
        z = torch.logsumexp(logits, dim=-1)
        aux = aux + moe.router_z_loss_weight * reduce_forward(
            (z * z).sum(), tokens_group) / n
    moe.aux_loss = aux
    y = F.pad(y.reshape(n_local, d), (0, 0, 0, per - n_local))
    y = gather(y, experts_group, 0, "slice")[:n_data]
    return y.reshape(inputs.shape).to(dtype)
