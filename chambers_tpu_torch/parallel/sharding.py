"""Parameter and batch sharding rules (port of
``chambers_tpu/parallel/sharding.py``).

The rules are the JAX package's: a regex on the parameter's JAX path
(``models.backbones.convert.jax_path``: ``encoder/layers_0/dense1/kernel``)
picks a :class:`PartitionSpec`, first match wins, unmatched parameters
replicate. The port keeps Flax's layouts (kernels ``[in, out]``, attention
``w_query [d, n, h]`` and ``w_projection [n, d, h]``), so a spec maps
dimension for dimension.

Two representations of a placed value:

- a tensor tree (dict of tensors) placed by :func:`shard_params`,
  :func:`shard_batch` or :func:`replicate` becomes ``DTensor`` leaves: the
  counterpart of a global ``jax.Array`` with a ``NamedSharding``
  (``.placements`` for ``.sharding``, ``.to_local()`` for a shard);
- an ``nn.Module`` placed by :func:`shard_params` (what ``Trainer(mesh=)``
  does) keeps plain parameters, each holding this rank's shard, with its
  :class:`NamedSharding` on the parameter as ``.sharding``. The port's
  optimizers, LoRA hooks and kernels then see ordinary tensors, and an
  optimizer built after placement stores its moments at the shard's size.

How a placed module computes. Three layers compute on their shards
directly, each the Megatron-style split the JAX rules describe, with the
collectives of ``parallel/distributed.py``:

- ``MultiHeadAttention`` whose query, key, value (and biases) are sharded
  on the heads axis and whose output projection on its heads axis, all over
  one axis: local heads, one all-reduce after the output projection;
- the MLP of an encoder or decoder block whose ``dense1`` is
  column-sharded and ``dense2`` row-sharded over one axis: one all-reduce
  after ``dense2``;
- ``MoEMLP`` whose expert banks are sharded on the expert axis
  (``expert_parallel``): the tokens go to the experts' owners by
  all-to-all.

Every other sharded parameter (FSDP's, a rule the layer has no split for,
the int8 layers' weights and scales) is gathered whole before its module's
forward and its gradient reduce-scattered (over the batch axis) or sliced
(over the others) in the backward: a forward pre-hook puts the gathered
tensor in the module's ``__dict__`` for the call.

The batch axis is ``"data"``: a placed module is called on this rank's rows
of a batch sharded over it; :func:`reduce_gradients` sums the gradients
over it after the backward (``Trainer(mesh=)`` calls it), for every
parameter whose spec does not name it (those reduce in their gather).

Whole values from shards, as a global ``jax.Array`` gives them:
:func:`whole_sq_norms` (each tensor's squared norm, what the optimizers'
clipping reads), :func:`gather_tensors` / :func:`slice_tensors` (a
``{name: tensor}`` dict) and :func:`gather_optimizer_state` /
:func:`slice_optimizer_state` (an optimizer's ``state_dict``), which the
Trainer's checkpointed state is made of. Every rank must call the
gathering ones; no collective runs at world size 1 or without a mesh.
:func:`write_once` writes such whole values to one file from the mesh's
first rank (checkpoints and the weight exports of ``Model`` and the
Trainer).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from chambers_tpu_torch.models.backbones.convert import jax_path
from chambers_tpu_torch.parallel.distributed import (
    axis_group,
    axis_index,
    axis_size,
    gather,
    mesh_device,
    tree_map,
)

# the mesh axes a batch is sharded over
BATCH_AXES = ("data",)


class PartitionSpec(tuple):
    """``PartitionSpec("data", None)``: one entry a tensor dimension, a mesh
    axis name, a tuple of names (sharded jointly, the first major) or None
    (not sharded). Trailing dimensions without an entry are not sharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(entry):
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _placements(mesh, spec):
    """The ``DTensor`` placements of ``spec`` over ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        index = [names.index(a) for a in _axes(entry)]
        if index != sorted(index):
            raise ValueError(
                f"{spec}: a jointly sharded dimension must name its mesh "
                f"axes in the mesh's order {names}")
        for i in index:
            out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` over a mesh (``jax.sharding.NamedSharding``'s
    counterpart): ``placements`` gives the ``DTensor`` placements."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self):
        return _placements(self.mesh, self.spec)

    def axes(self):
        """Every mesh axis the spec names."""
        return {a for entry in self.spec for a in _axes(entry)}


# Megatron-style TP rules for the transformer stack: regex on the param path
# → PartitionSpec.
VIT_TENSOR_PARALLEL_RULES: List[Tuple[str, P]] = [
    # qkv projections (d, n_heads, head_dim): shard heads (column parallel)
    (r"multi_head_attention/w_(query|key|value)$", P(None, "model", None)),
    (r"multi_head_attention/b_(query|key|value)$", P("model", None, None)),
    # output projection (n_heads, d, head_dim): row parallel over heads
    (r"multi_head_attention/w_projection$", P("model", None, None)),
    # MLP: column-parallel in, row-parallel out
    (r"dense1/kernel$", P(None, "model")),
    (r"dense1/bias$", P("model")),
    (r"dense2/kernel$", P("model", None)),
]

# The same rules for the seq2seq stack: DecoderLayer names its attention
# blocks ``multi_head_attention1`` (self) and ``multi_head_attention2``
# (cross), so the regexes take an optional digit.
SEQ2SEQ_TENSOR_PARALLEL_RULES: List[Tuple[str, P]] = [
    (r"multi_head_attention\d*/w_(query|key|value)$", P(None, "model", None)),
    (r"multi_head_attention\d*/b_(query|key|value)$", P("model", None, None)),
    (r"multi_head_attention\d*/w_projection$", P("model", None, None)),
    (r"dense1/kernel$", P(None, "model")),
    (r"dense1/bias$", P("model")),
    (r"dense2/kernel$", P("model", None)),
]


def _match_spec(path: str, leaf, rules) -> P:
    """First-match-wins rule lookup; falls back to replication. Rules whose
    spec is longer than the leaf's rank never match."""
    for pattern, spec in rules:
        if re.search(pattern, path) and len(spec) <= leaf.ndim:
            return spec
    return P()


def _validated(path: str, leaf, spec: P, mesh) -> NamedSharding:
    """Reject non-divisible shardings with a named, actionable error."""
    names = mesh.mesh_dim_names
    for dim, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in names:
                raise ValueError(
                    f"param {path!r}: its sharding rule names mesh axis "
                    f"{a!r}, which the mesh (axes {names}) does not have")
        if entry is None:
            continue
        n = axis_size(mesh, _axes(entry))
        if leaf.shape[dim] % n:
            raise ValueError(
                f"param {path!r} has shape {tuple(leaf.shape)} but its "
                f"sharding rule puts axis {dim} (size {leaf.shape[dim]}) "
                f"over mesh axis {entry!r} (size {n}), which does not "
                f"divide evenly. Pick a dimension divisible by the mesh "
                f"axis (e.g. a head count that is a multiple of the "
                f"'model' axis), shrink the mesh axis, or drop the rule "
                f"so the param replicates.")
    return NamedSharding(mesh, spec)


def _map_leaves(tree, fn, prefix=()):
    """``fn(path, leaf)`` over a module's parameters (``{name: value}``), a
    flat ``{name: tensor}`` (``state_dict`` names) or a nested dict of
    tensors (``/``-joined paths), keeping the structure."""
    if isinstance(tree, nn.Module):
        return {name: fn(jax_path(name), p)
                for name, p in tree.named_parameters()}
    if isinstance(tree, Mapping):
        return {k: (_map_leaves(v, fn, prefix + (str(k),))
                    if isinstance(v, Mapping) else
                    fn(jax_path(k) if not prefix else
                       "/".join(prefix + (str(k),)), v))
                for k, v in tree.items()}
    return fn("/".join(prefix), tree)


def make_param_shardings(params, mesh,
                         rules: Optional[Sequence[Tuple[str, P]]] = None):
    """:class:`NamedSharding` for each parameter, in ``params``' structure
    (a module gives ``{name: sharding}``): first matching rule wins;
    unmatched parameters replicate."""
    rules = list(rules or [])
    return _map_leaves(params, lambda path, leaf: _validated(
        path, leaf, _match_spec(path, leaf, rules), mesh))


def _distribute(x, sharding):
    from torch.distributed.tensor import distribute_tensor

    x = torch.as_tensor(np.asarray(x) if not isinstance(
        x, torch.Tensor) else x).to(mesh_device(sharding.mesh))
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def shard_params(params, mesh,
                 rules: Optional[Sequence[Tuple[str, P]]] = None):
    """Place params on the mesh according to ``rules`` (default: replicate).

    A tensor tree comes back as ``DTensor`` leaves. An ``nn.Module`` is
    placed in place and returned: each parameter keeps its identity and
    holds its shard (see the module docstring)."""
    if isinstance(params, nn.Module):
        return _place_module(params, mesh, rules)
    shardings = make_param_shardings(params, mesh, rules)
    return _zip_map(_distribute, params, shardings)


def _zip_map(fn, tree, other):
    if isinstance(tree, Mapping):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _scale_spec(rules, path, leaf):
    """A ``<name>_scale`` leaf keeps its weight's spec except on the axes
    the quantization reduced (size 1), which cannot be partitioned."""
    if path.endswith("_scale"):
        path = path[: -len("_scale")]
    spec = _match_spec(path, leaf, rules)
    return P(*(None if leaf.shape[i] == 1 else entry
               for i, entry in enumerate(spec)))


def shard_quantized(variables, mesh,
                    rules: Optional[Sequence[Tuple[str, P]]] = None):
    """Place int8-quantized weights (``chambers_tpu_torch.quantization``)
    on a mesh: the int8 kernels by ``rules`` (their float originals'
    paths and shapes), each ``<name>_scale`` by its weight's spec with the
    reduced (size-1) axes unsharded.

    ``variables`` is ``{"params": tree, "quant": tree, ...}`` (other
    collections replicate), or a quantized ``nn.Module``, placed in place.
    A placed int8 module gathers its weights and scales before each
    forward, so its products are the single-device ones; the GEMM operands
    it derived from the weights when they were loaded stay whole on every
    rank."""
    rules = list(rules or [])
    if isinstance(variables, nn.Module):
        return _place_module(variables, mesh, rules, quantized=True)
    out = {}
    for col, tree in variables.items():
        if col == "params":
            out[col] = shard_params(tree, mesh, rules)
        elif col == "quant":
            shardings = _map_leaves(tree, lambda path, leaf: _validated(
                path, leaf, _scale_spec(rules, path, leaf), mesh))
            out[col] = _zip_map(_distribute, tree, shardings)
        else:
            out[col] = replicate(tree, mesh)
    return out


def replicate(tree, mesh):
    """Fully replicate a tensor tree (or a module's parameters) across the
    mesh."""
    return shard_params(tree, mesh, None)


def batch_sharding(mesh, axis: str = "data") -> NamedSharding:
    """Sharding for a batch: leading axis split across ``axis``."""
    return NamedSharding(mesh, P(axis))


def shard_batch(batch, mesh, axis: str = "data"):
    """Shard every array's leading axis over the data axis: ``DTensor``
    leaves holding this rank's rows."""
    sharding = batch_sharding(mesh, axis)

    def place(x):
        _validated("batch", x, sharding.spec, mesh)
        return _distribute(x, sharding)

    return tree_map(place, batch)


# ---------------------------------------------------------------------------
# placed modules
# ---------------------------------------------------------------------------

def _local_shard(full, mesh, spec):
    """This rank's shard of ``full`` under ``spec``."""
    out = full
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if axes:
            out = out.chunk(axis_size(mesh, axes), dim=dim)[
                axis_index(mesh, axes)]
    return out.contiguous()


def _split_over(specs, layout):
    """The one non-batch mesh axis that alone shards dimension
    ``layout[name]`` of every tensor ``name`` with a dimension there, and no
    dimension of those with None, or None when there is no such axis.
    Tensors a layer does not have are skipped."""
    axis = None
    for name, dim in layout.items():
        spec = specs.get(name)
        if dim is None or spec is None:
            continue
        entry = spec[dim] if dim < len(spec) else None
        if not isinstance(entry, str) or entry in BATCH_AXES:
            return None
        if axis not in (None, entry):
            return None
        axis = entry
        if sum(axis in _axes(e) for e in spec) != 1:
            return None
    for name, dim in layout.items():
        spec = specs.get(name)
        if dim is None and spec is not None and axis in {
                a for e in spec for a in _axes(e)}:
            return None
    return axis


_HEADS = {"w_query": 1, "w_key": 1, "w_value": 1, "b_query": 0,
          "b_key": 0, "b_value": 0, "w_projection": 0, "b_projection": None}
_MLP = {"dense1.kernel": 1, "dense1.bias": 0, "dense2.kernel": 0,
        "dense2.bias": None}
_EXPERTS = {"w1": 0, "b1": 0, "w2": 0, "b2": 0}


def _local_axes(module, specs, mesh):
    """``{parameter name: axes it stays sharded over in the forward}`` for
    the layers that compute on their shards, and those layers' groups."""
    from chambers_tpu_torch.layers.attention import MultiHeadAttention
    from chambers_tpu_torch.layers.moe import MoEMLP
    from chambers_tpu_torch.layers.transformer import _Block

    local = {}
    for prefix, m in module.named_modules():
        dot = prefix + "." if prefix else ""
        mine = {n[len(dot):]: s for n, s in specs.items()
                if n.startswith(dot)}
        if isinstance(m, MultiHeadAttention):
            m._tp_group = None
            axis = _split_over(mine, _HEADS)
            if axis is not None and m.w_query_scale is None:
                m._tp_group = axis_group(mesh, axis)
                local.update({dot + n: axis for n, d in _HEADS.items()
                              if d is not None})
        elif isinstance(m, _Block) and m.moe is None:
            m._tp_group = None
            axis = _split_over(mine, _MLP)
            if (axis is not None and m.dense1.kernel_scale is None
                    and m.dense2.kernel_scale is None):
                m._tp_group = axis_group(mesh, axis)
                m.dense2._reduce_group = m._tp_group
                local.update({dot + n: axis for n, d in _MLP.items()
                              if d is not None and dot + n in specs})
        elif isinstance(m, MoEMLP):
            m._expert_axis = None
            axis = _split_over(mine, _EXPERTS)
            if axis is not None and m.w1_scale is None:
                if m.n_experts % axis_size(mesh, axis):
                    raise ValueError(
                        f"{prefix}: {m.n_experts} experts do not divide "
                        f"over mesh axis {axis!r}")
                m._expert_axis = axis
                local.update({dot + n: axis for n in _EXPERTS})
    return local


def _placed_tensors(module, quantized):
    """``(name, tensor, owner, attribute)`` of what a placement moves: the
    parameters, and an int8 module's ``*_scale`` buffers."""
    out = []
    for prefix, m in module.named_modules():
        dot = prefix + "." if prefix else ""
        for attr, p in m.named_parameters(recurse=False):
            out.append((dot + attr, p, m, attr))
        if quantized:
            for attr, b in m.named_buffers(recurse=False):
                if attr.endswith("_scale") and b is not None:
                    out.append((dot + attr, b, m, attr))
    return out


def _place_module(module, mesh, rules, quantized=False):
    if getattr(module, "_mesh", None) is not None:
        raise ValueError("the module is placed on a mesh already")
    rules = list(rules or [])
    tensors = _placed_tensors(module, quantized)
    shardings = {}
    for name, t, _, attr in tensors:
        path = jax_path(name)
        spec = (_scale_spec(rules, path, t) if attr.endswith("_scale")
                and not isinstance(t, nn.Parameter)
                else _match_spec(path, t, rules))
        shardings[name] = _validated(path, t, spec, mesh)
    local = _local_axes(module, {n: s.spec for n, s in shardings.items()},
                        mesh)
    world = dist.get_world_size()
    source = int(mesh.mesh.flatten()[0])
    gathered = {}
    with torch.no_grad():
        for name, t, owner, attr in tensors:
            sharding = shardings[name]
            full = t.detach()
            if world > 1 and mesh.size() == world:
                # every rank starts from rank 0's values, as DDP does
                full = full.contiguous()
                dist.broadcast(full, src=source)
            t.data = _local_shard(full, mesh, sharding.spec)
            t.sharding = sharding
            t.global_shape = tuple(full.shape)
            keep = local.get(name)
            plan = [(dim, _axes(entry)) for dim, entry
                    in enumerate(sharding.spec)
                    if _axes(entry) and _axes(entry) != (keep,)]
            if plan:
                gathered.setdefault(owner, []).append((attr, t, plan))
    for owner, entries in gathered.items():
        _gather_on_use(owner, entries, mesh)
    module._mesh = mesh
    return module


def _gathered(t, plan, mesh):
    """``t``'s shard gathered along ``plan`` (differentiable)."""
    x = t
    for dim, axes in reversed(plan):
        grad = "sum" if set(axes) & set(BATCH_AXES) else "slice"
        x = gather(x, axis_group(mesh, axes), dim, grad)
    return x


def _gather_on_use(owner, entries, mesh):
    """Hooks that show ``owner``'s forward the gathered tensors."""
    for handle in getattr(owner, "_gather_hooks", ()):
        handle.remove()

    def pre(module, args):
        for attr, t, plan in entries:
            module.__dict__[attr] = _gathered(t, plan, mesh)

    def post(module, args, output):
        for attr, _, _ in entries:
            module.__dict__.pop(attr, None)

    owner._gather_hooks = (
        owner.register_forward_pre_hook(pre),
        owner.register_forward_hook(post, always_call=True))


def reduce_gradients(module):
    """Sum the gradients of a placed module's parameters over the batch
    axis, after the backward of a loss computed on the global batch (see
    ``distributed.gather_rows``): each data rank's gradient then holds
    every rank's rows. Parameters sharded over the batch axis reduced
    theirs in their gather already. One all-reduce a dtype."""
    mesh = getattr(module, "_mesh", None)
    if mesh is None:
        return
    group = axis_group(mesh, BATCH_AXES)
    if group is None:
        return
    buckets = {}
    for p in module.parameters():
        sharding = getattr(p, "sharding", None)
        if (p.grad is None or sharding is None
                or sharding.axes() & set(BATCH_AXES)):
            continue
        buckets.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def full_tensor(t, sharding=None):
    """A placed module's parameter (or buffer) whole: its shards gathered
    over every axis its spec names (no autograd; every rank must call).
    ``sharding`` (default: the tensor's own) serves for a parameter's
    gradient."""
    sharding = sharding or getattr(t, "sharding", None)
    if sharding is None:
        return t
    x = t.detach()
    for dim, entry in reversed(list(enumerate(sharding.spec))):
        axes = _axes(entry)
        if axes:
            group = axis_group(sharding.mesh, axes)
            if group is not None:
                parts = [torch.empty_like(x)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, x.contiguous(), group=group)
                x = torch.cat(parts, dim=dim)
    return x


def _shard_axes(sharding):
    """The mesh axes ``sharding`` splits a tensor over, in the mesh's
    order (so that every rank asks for the same group)."""
    named = sharding.axes()
    return tuple(a for a in sharding.mesh.mesh_dim_names if a in named)


def whole_sq_norms(tensors, shardings):
    """The squared L2 norm of each whole tensor, from this rank's shards:
    a shard's ``(t * t).sum()`` summed over the ranks its sharding splits
    the tensor across, and over no others (a replicated axis holds copies,
    each counted once). ``shardings`` gives each tensor's
    :class:`NamedSharding`, or None for a tensor that is whole on every
    rank. One float32 all-reduce a group; where no group has more than one
    rank (world size 1, no mesh) the local sums come back as they are.
    Every rank must call."""
    sums = [(t * t).sum() for t in tensors]
    buckets = {}
    for i, sharding in enumerate(shardings):
        if sharding is None:
            continue
        axes = _shard_axes(sharding)
        group = axis_group(sharding.mesh, axes)
        if group is not None:
            buckets.setdefault((id(sharding.mesh), axes),
                               (group, []))[1].append(i)
    for group, index in buckets.values():
        flat = torch.stack([sums[i].float() for i in index])
        dist.all_reduce(flat, group=group)
        for j, i in enumerate(index):
            sums[i] = flat[j].to(sums[i].dtype)
    return sums


def _whole(t, p):
    """``t``, a tensor of placed parameter ``p``'s shard shape, gathered
    whole by ``p``'s sharding; anything else as it is."""
    sharding = getattr(p, "sharding", None)
    if (sharding is None or not isinstance(t, torch.Tensor)
            or tuple(t.shape) != tuple(p.shape)):
        return t
    return full_tensor(t, sharding)


def _cut(t, p):
    """``t``, a tensor of placed parameter ``p``'s whole shape, cut to this
    rank's shard; anything else (a shard already) as it is."""
    sharding = getattr(p, "sharding", None)
    if (sharding is None or not isinstance(t, torch.Tensor)
            or tuple(t.shape) != tuple(getattr(p, "global_shape", ()))):
        return t
    return _local_shard(t, sharding.mesh, sharding.spec)


def gather_tensors(tensors, params):
    """``{name: tensor}`` -> whole tensors: each tensor of a placed
    parameter's shard shape (the parameter's value, its EMA shadow, its
    accumulated gradient), ``params`` holding the parameter under the same
    name, gathered by the parameter's :class:`NamedSharding`; the others
    as they are. Every rank must call."""
    return {name: _whole(t, params.get(name)) for name, t in tensors.items()}


def slice_tensors(tensors, params):
    """The inverse of :func:`gather_tensors`, with no collective: each
    tensor of a placed parameter's whole shape cut to this rank's shard.
    A tensor of the shard's shape stays as it is, so the live values
    install back unchanged."""
    return {name: _cut(t, params.get(name)) for name, t in tensors.items()}


def _map_optimizer_state(state_dict, params, fn):
    """``state_dict`` (an optimizer's) with ``fn(value, param)`` applied to
    every state tensor of each parameter. ``params`` lists the parameters
    in the optimizer's order, the order of the indices in its
    ``param_groups``; the port's ``DecoupledWeightDecay`` nests its base's
    ``state_dict`` under ``"base"``."""
    if "state" not in state_dict:
        return {**state_dict, "base": _map_optimizer_state(
            state_dict["base"], params, fn)}
    order = [i for group in state_dict["param_groups"]
             for i in group["params"]]
    index = dict(zip(order, params))
    return {**state_dict, "state": {
        i: {key: fn(v, index.get(i)) for key, v in per.items()}
        for i, per in state_dict["state"].items()}}


def gather_optimizer_state(state_dict, params):
    """An optimizer's ``state_dict`` with each placed parameter's state
    tensors (moments, traces) gathered whole by the parameter's
    :class:`NamedSharding`; counts and other values as they are.
    ``params``: the optimizer's parameters in its order. Every rank must
    call."""
    return _map_optimizer_state(state_dict, params, _whole)


def slice_optimizer_state(state_dict, params):
    """The inverse of :func:`gather_optimizer_state`, with no collective:
    state tensors of a placed parameter's whole shape cut to this rank's
    shard, so a state saved under any mesh or none loads under this one."""
    return _map_optimizer_state(state_dict, params, _cut)


def write_once(mesh, write):
    """Call ``write()`` on the mesh's first rank alone, between two
    barriers: every rank has its whole values before the file changes, and
    none returns before it is there. Without a mesh, or in a world of one
    process, just ``write()``. Every rank must call."""
    if mesh is None or not dist.is_initialized() or \
            dist.get_world_size() == 1:
        write()
        return
    dist.barrier()
    if dist.get_rank() == int(mesh.mesh.flatten()[0]):
        write()
    dist.barrier()
