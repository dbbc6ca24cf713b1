"""Mixture-of-experts MLP and the routed transformer layers (port of
``chambers_tpu/layers/moe.py``: ``MoEMLP``, ``moe_aux_loss``,
``MoEEncoderLayer`` and ``MoEDecoderLayer``).

A learned router sends each token to its ``n_selected_experts`` most
probable expert MLPs (1: Switch Transformer routing; 2: the GShard
convention). Routing is the dense-dispatch formulation of the JAX package:
two one-hot tensors ``[groups, tokens, experts, capacity]`` (dispatch and
combine) turn the layer into three matrix products: tokens into the
experts' queues, the experts' two-layer GELU MLPs, the queues back to the
tokens. The JAX package leaves these products to XLA; here they are
``torch.matmul``/``bmm``, cuBLAS's on the card. No kernel of the port is
involved.

Capacity: every expert takes at most ``max(1, ceil(s·k/E·cf))`` tokens of
each routing group of ``s`` tokens (``s`` is every token of the call when
``group_size`` is None). Queues fill rank-major: every token's first
choice enqueues before any token's second choice, and a rank-``r``
position counts every rank-``<r`` selection of its expert, kept or
dropped. A selection past the capacity dispatches nowhere: the layer adds
zero for it, and the token rides the residual connection.

The router runs in float32 from the compute-dtype input. Top-k keeps the
lower expert index on a tie, as ``jax.lax.top_k`` does: the selection is
a stable descending sort. For k > 1 the selected gates are renormalised to
sum to 1.

**The auxiliary loss.** Flax sows the Switch load-balancing loss (plus the
ST-MoE router z-loss when ``router_z_loss_weight > 0``) into the
``intermediates`` collection. The port keeps it on the module instead:
every :class:`MoEMLP` holds its last forward's loss in ``aux_loss``, a
tensor in the autograd graph, and :func:`moe_aux_loss` sums them over a
model's modules. Read it after the forward and before the next one; add it
to the task loss to train the router. Under ``remat`` the forward's tensor
is the one the loss holds; the recompute during backward may set the
attribute again, to the same value.

**int8 serving** (``quantization.quantize_model``): the expert banks
``w1``/``w2`` become int8 with per-expert, per-output-channel scales
``w1_scale`` ``[E, 1, F]`` and ``w2_scale`` ``[E, 1, d]``; each dispatched
row quantizes on the fly and every expert's product is ``int_mm``, exact in
int32. The router and the dispatch/combine routing stay float.
"""

import math

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch import quantization as quant
from chambers_tpu_torch._device import resolve_device
from chambers_tpu_torch.activations import gelu
from chambers_tpu_torch.layers.transformer import (
    DecoderLayer,
    EncoderLayer,
    _routing,
)

_BANKS = ("w1", "w2")


class MoEMLP(nn.Module):
    """Top-k mixture-of-experts two-layer GELU MLP over ``[..., d]``.

    Parameters, under the JAX package's names: ``w_router`` ``[d, E]``,
    ``w1`` ``[E, d, F]``, ``b1`` ``[E, F]``, ``w2`` ``[E, F, d]``, ``b2``
    ``[E, d]``. ``n_selected_experts=1`` gates each token by the raw
    softmax probability of its expert; for k > 1 the k gates sum to 1.

    On a batch sharded over processes (``_batch_sharding``, the ``(mesh,
    axis)`` that ``parallel.distributed.data_parallel`` sets), or with its
    banks sharded over an expert axis (``_expert_axis``, set by
    ``parallel.sharding``), the forward is
    ``parallel.expert_parallel.routed_forward``: the same routing over the
    global batch."""

    _expert_axis = None
    _batch_sharding = None

    def __init__(self, embed_dim, ff_dim, n_experts, capacity_factor=1.25,
                 aux_loss_weight=1e-2, router_z_loss_weight=0.0,
                 n_selected_experts=1, group_size=None, kernel_init=None,
                 dtype=None, param_dtype=torch.float32,
                 gelu_approximate=False, device=None):
        super().__init__()
        device = resolve_device(device)
        d, E, f = embed_dim, n_experts, ff_dim
        k = int(n_selected_experts)
        if not 1 <= k <= E:
            raise ValueError(
                f"n_selected_experts={k} must be in [1, n_experts={E}]")
        self.n_experts = E
        self.n_selected_experts = k
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = aux_loss_weight
        self.router_z_loss_weight = router_z_loss_weight
        self.group_size = group_size
        self.dtype = dtype
        self.gelu_approximate = gelu_approximate
        self.kernel_init = kernel_init or initializers.glorot_uniform
        self.w_router = initializers.new_param((d, E), param_dtype, device)
        self.w1 = initializers.new_param((E, d, f), param_dtype, device)
        self.b1 = initializers.new_param((E, f), param_dtype, device)
        self.w2 = initializers.new_param((E, f, d), param_dtype, device)
        self.b2 = initializers.new_param((E, d), param_dtype, device)
        for name in _BANKS:
            self.register_buffer(f"{name}_scale", None)
            # the int8 bank's GEMM operands, one column-major [k8, n8] for
            # each expert (quantization.gemm_operand)
            self.register_buffer(f"_{name}_gemm", None, persistent=False)
        self.register_load_state_dict_post_hook(
            lambda module, keys: module.prepare_int8())
        self.aux_loss = None

    def reset_parameters(self, generator=None):
        for w in (self.w_router, self.w1, self.w2):
            self.kernel_init(w, generator)
        initializers.zeros(self.b1)
        initializers.zeros(self.b2)

    def prepare_int8(self):
        """Derive the GEMM operands of int8 banks (a no-op on a float
        layer)."""
        if self.w1_scale is not None:
            for name in _BANKS:
                setattr(self, f"_{name}_gemm", quant.gemm_operand(
                    getattr(self, name).detach()))

    def capacity(self, s):
        """Slots an expert has in a group of ``s`` tokens."""
        k, E = self.n_selected_experts, self.n_experts
        return max(1, math.ceil(s * k / E * self.capacity_factor))

    def route(self, xg):
        """The router on ``[g, s, d]`` tokens, in float32: ``(logits,
        probs, gates, experts)``, the last two ``[g, s, k]`` with the
        lower index first on ties."""
        logits = torch.matmul(xg.to(torch.float32),
                              self.w_router.to(torch.float32))
        probs = torch.softmax(logits, dim=-1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        k = self.n_selected_experts
        gates, experts = order.values[..., :k], order.indices[..., :k]
        if k > 1:
            gates = gates / gates.sum(dim=-1, keepdim=True)
        return logits, probs, gates, experts

    def dispatch_and_combine(self, gates, experts, capacity, dtype,
                             counts=None):
        """The dense ``[g, s, E, capacity]`` dispatch (0/1) and combine
        (gate-weighted) tensors in ``dtype``, and the first choices'
        one-hot ``[g, s, E]`` for the load-balancing loss.

        ``counts``, for tokens that are one slice of a group spread over
        processes (``parallel.expert_parallel``), maps this slice's
        selections of each expert ``[g, E]`` to ``(before, total)``: the
        selections of the slices ahead of it, and of the whole group."""
        E = self.n_experts
        ids = torch.arange(E, device=experts.device)
        slots = torch.arange(capacity, device=experts.device)
        dispatch = combine = first = used = None
        for r in range(self.n_selected_experts):
            oh = (experts[..., r, None] == ids).long()      # [g, s, E]
            # queue position: this rank's earlier tokens of the expert,
            # after every lower rank's selections of it
            pos = (oh.cumsum(dim=1) * oh).sum(-1) - 1
            mine = oh.sum(1)
            total = mine
            if counts is not None:
                before, total = counts(mine)
                pos = pos + (oh * before[:, None, :]).sum(-1)
            if r:
                pos = pos + (oh * used[:, None, :]).sum(-1)
            # pos >= capacity matches no slot: the selection is dropped
            in_slot = pos[..., None] == slots               # [g, s, c]
            disp = (oh.bool()[..., None] & in_slot[:, :, None, :]).to(dtype)
            comb = disp * gates[..., r].to(dtype)[:, :, None, None]
            if r == 0:
                first, dispatch, combine, used = oh, disp, comb, total
            else:
                dispatch, combine = dispatch + disp, combine + comb
                used = used + total
        return dispatch, combine, first

    def enqueue(self, dispatch, xg):
        """Tokens ``[g, s, d]`` into the experts' queues, ``[E, g·c, d]``:
        the dispatch product, one nonzero term a slot, exact in any
        dtype."""
        g, s, E, c = dispatch.shape
        queued = torch.matmul(dispatch.reshape(g, s, E * c).transpose(1, 2),
                              xg)
        return queued.reshape(g, E, c, -1).transpose(0, 1).reshape(
            E, g * c, -1)

    def experts(self, queued, dtype):
        """Every expert's MLP on its queue, ``[E, m, d]`` -> ``[E, m, d]``."""
        h = gelu(self.bank(queued, "w1", dtype),
                 approximate=self.gelu_approximate)
        return self.bank(h, "w2", dtype)

    def dequeue(self, combine, out):
        """The queues ``[E, g·c, d]`` back to the tokens, ``[g, s, d]``,
        each weighted by its gate: the combine product."""
        g, s, E, c = combine.shape
        out = out.reshape(E, g, c, -1).transpose(0, 1).reshape(g, E * c, -1)
        return torch.matmul(combine.reshape(g, s, E * c), out)

    def bank(self, x, name, dtype):
        """One expert bank over the experts' queued rows: ``x`` ``[E, m,
        k]`` -> ``x @ w[e] + b[e]`` ``[E, m, n]`` in ``dtype``; on an int8
        bank each row quantizes on the fly and every expert's product is
        ``int_mm``."""
        w, b = getattr(self, name), getattr(self, name.replace("w", "b"))
        if getattr(self, f"{name}_scale") is None:
            return torch.bmm(x, w.to(dtype)) + b.to(dtype)[:, None, :]
        x_q, s_x = quant.dynamic_quantize(x)                # s_x [E, m, 1]
        gemm, n = getattr(self, f"_{name}_gemm"), w.shape[-1]
        acc = torch.stack([quant.int_mm(x_q[e], gemm[e], n)
                           for e in range(self.n_experts)])
        scale = getattr(self, f"{name}_scale")              # [E, 1, n]
        return (acc * s_x * scale).to(dtype) + b.to(dtype)[:, None, :]

    def forward(self, inputs):
        if self._expert_axis is not None or self._batch_sharding is not None:
            from chambers_tpu_torch.parallel.expert_parallel import (
                routed_forward,
            )

            out = routed_forward(self, inputs)
            if out is not None:
                return out
        d, E = inputs.shape[-1], self.n_experts
        dtype = self.dtype or inputs.dtype
        x = inputs.reshape(-1, d)
        n = x.shape[0]
        # one group of every token is O(n²) in dispatch memory; a
        # group_size keeps it O(n·group_size), with the capacity (and so
        # which tokens drop) enforced per group
        s = n if self.group_size is None else min(int(self.group_size), n)
        if n % s:
            raise ValueError(f"{n} tokens not divisible by group_size={s}")
        xg = x.reshape(n // s, s, d)

        logits, probs, gates, experts = self.route(xg)
        dispatch, combine, first = self.dispatch_and_combine(
            gates, experts, self.capacity(s), dtype)
        out = self.experts(self.enqueue(dispatch, xg.to(dtype)), dtype)
        y = self.dequeue(combine, out)

        # Switch load balancing: E · sum_e (share of first choices on e ·
        # mean router probability of e), averaged over groups; 1.0 when
        # routing is uniform
        frac = first.to(torch.float32).mean(dim=1)          # [g, E]
        aux = self.aux_loss_weight * E * torch.mean(
            (frac * probs.mean(dim=1)).sum(dim=-1))
        if self.router_z_loss_weight:
            # ST-MoE router z-loss: mean squared logsumexp of the logits
            z = torch.logsumexp(logits, dim=-1)
            aux = aux + self.router_z_loss_weight * torch.mean(z * z)
        self.aux_loss = aux
        return y.reshape(inputs.shape).to(dtype)


def moe_aux_loss(module):
    """The sum of the auxiliary losses that every :class:`MoEMLP` in
    ``module`` kept from its last forward: add it to the task loss when
    training a routed model. A module without routed layers gives a float32
    zero."""
    losses = [m.aux_loss for m in module.modules()
              if isinstance(m, MoEMLP) and m.aux_loss is not None]
    if not losses:
        p = next(module.parameters(), None)
        return torch.zeros((), device=None if p is None else p.device)
    return torch.stack(losses).sum()


class MoEEncoderLayer(EncoderLayer):
    """``EncoderLayer`` with the dense MLP swapped for :class:`MoEMLP`
    (submodule ``moe``): the same attention, norms, residuals, ``pre_norm``
    orderings and dropout (the attention output's at
    ``dense_dropout_rate``)."""

    def __init__(self, embed_dim=512, num_heads=8, ff_dim=2048, n_experts=8,
                 capacity_factor=1.25, router_z_loss_weight=0.0,
                 n_selected_experts=1, group_size=None, **kwargs):
        super().__init__(embed_dim, num_heads, ff_dim, moe=_routing(
            n_experts, capacity_factor, router_z_loss_weight,
            n_selected_experts, group_size), **kwargs)


class MoEDecoderLayer(DecoderLayer):
    """``DecoderLayer`` with the dense MLP swapped for :class:`MoEMLP`, the
    GShard setting: the same self and cross attention, norms, residuals and
    orderings, the pre-norm path's shared-``norm2`` memory quirk
    included."""

    def __init__(self, embed_dim=512, num_heads=8, ff_dim=2048, n_experts=8,
                 capacity_factor=1.25, router_z_loss_weight=0.0,
                 n_selected_experts=1, group_size=None, **kwargs):
        super().__init__(embed_dim, num_heads, ff_dim, moe=_routing(
            n_experts, capacity_factor, router_z_loss_weight,
            n_selected_experts, group_size), **kwargs)
