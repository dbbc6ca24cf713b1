"""Multi-head attention with the Chambers per-head parameter layout, and
``scaled_attention``/``ScaledAttention`` (port of
``chambers_tpu/layers/attention.py``).

Per-head projections keep the checkpoint layout: ``w_query``, ``w_value``,
``w_key`` ``(d, num_heads, head_dim)`` with biases ``(num_heads, 1,
head_dim)``; ``w_projection`` ``(num_heads, d, head_dim)`` with bias
``(1, d)``. The call takes ``inputs=[q, v]`` or ``[q, v, k]``; a
self-attention call projects through one stacked ``[query, value, key]``
weight, as the JAX package does.

Two implementations, chosen by ``impl`` / ``attention_impl``:

- ``"xla"`` (the name is the JAX package's): dense attention. Scores come
  from an explicit matmul in ``score_dtype`` (float32 by default), so their
  rounding is the JAX package's — ``F.scaled_dot_product_attention`` rounds
  differently and is not used.
- ``"flash"``: the blockwise CUDA kernels of
  ``chambers_tpu_torch.ops.flash_attention``, with the causal and the key
  padding mask applied in the kernel and float32 softmax statistics (so it
  refuses ``score_dtype``). It has no attention dropout: a call with
  dropout active raises ``NotImplementedError``, from the function and from
  the module alike, where the JAX module quietly takes its dense path;
  build with ``dropout_rate=0.0``, call with ``deterministic=True`` or
  choose ``"xla"``. A query whose keys are all masked gives zeros here and
  the uniform average on the dense path.

Attention dropout is active when ``dropout_rate > 0`` and the call is not
deterministic (``deterministic=None`` reads ``not self.training``); it
draws from the ``generator`` given, else from torch's default one.

Incremental decoding passes a ``cache``, a dict of tensors that the caller
makes once (:meth:`MultiHeadAttention.init_self_cache`,
:meth:`MultiHeadAttention.init_cross_cache`) and hands to every step; the
names are the JAX module's ``cache`` collection:

- self-attention: ``cached_key``, ``cached_value`` ``[b, n, max_len, h]``,
  ``valid_mask`` ``[b, max_len]`` and ``cache_index``. A step (one query
  position) projects its token, writes key, value and the token's mask
  (all true without one) at position ``index`` (``cache_index`` when None)
  in place, and attends over the whole buffer with the validity row as the
  key mask and no causal mask: unwritten slots are invalid.
- cross attention: ``cached_key``, ``cached_value``, the memory projected
  once when the cache is made; a step projects only its query.

With ``"flash"`` a cached step runs K3a at one query row, where the JAX
module sends every cached step to dense attention.

Once quantized (``chambers_tpu_torch.quantization.quantize_model``) the
four projections are int8 with float32 scales ``w_{query,value,key}_scale``
``[1, n, h]`` and ``w_projection_scale`` ``[1, d, 1]``: activations quantize
per token, the products accumulate in int32 (``quantization.int_mm``), and
scores, softmax and the rest stay in the compute dtype, as in the JAX
package. The three input projections share one GEMM operand ``[d, 3·n·h]``
in ``[query, value, key]`` order: a self-attention call makes one product
against all of it, a cross-attention call one against each third.
"""

import math

import torch
from torch import nn
from torch.nn import functional as F

from chambers_tpu_torch import initializers
from chambers_tpu_torch import quantization as quant
from chambers_tpu_torch._device import resolve_device

_MASK_BIAS = -1e9


def keep_mask(shape, rate, generator, device, dims=()):
    """Dropout's keep mask (probability ``1 - rate``) of ``shape`` from
    ``generator``. ``dims`` are ``(dim, process group)`` pairs (a None group
    is skipped) of the dimensions this call holds one rank's share of: the
    batch rows under ``parallel.distributed.data_parallel``, tensor-parallel
    heads. Each rank draws the whole mask and keeps its share, so that the
    share is what a run without a mesh draws for those rows, when they
    divide."""
    dims = [(dim, group) for dim, group in dims if group is not None]
    whole = list(shape)
    for dim, group in dims:
        whole[dim] *= torch.distributed.get_world_size(group)
    keep = torch.empty(whole, dtype=torch.float32, device=device).bernoulli_(
        1.0 - rate, generator=generator).bool()
    for dim, group in dims:
        keep = keep.chunk(torch.distributed.get_world_size(group), dim=dim)[
            torch.distributed.get_rank(group)]
    return keep


def scaled_dot_product_attention(query, value, key=None, scale=None,
                                 causal=False, q_mask=None, v_mask=None,
                                 dropout_rate=0.0, deterministic=True,
                                 generator=None, impl="xla",
                                 score_dtype=None, dropout_dims=()):
    """Attention over ``[batch, heads, time, head_dim]``.

    :param scale: score divisor; defaults to ``sqrt(head_dim)``.
    :param causal: lower-triangular mask, diagonal aligned at the end.
    :param q_mask: ``[b, tq]`` bool; zeroes outputs of masked queries.
    :param v_mask: ``[b, tv]`` bool; excludes masked keys from the softmax.
    :param dropout_rate: dropout on the attention probabilities, applied
        unless ``deterministic``; drawn from ``generator``.
    :param score_dtype: dtype of the scores and the softmax (float32 if
        None).
    :param dropout_dims: ``(dim, process group)`` pairs of dimensions this
        call holds one rank's share of (batch rows, tensor-parallel heads);
        the dropout mask is drawn whole and sliced (:func:`keep_mask`).
    """
    if key is None:
        key = value
    use_dropout = dropout_rate > 0.0 and not deterministic
    if impl == "flash":
        if use_dropout:
            raise NotImplementedError(
                "attention_impl='flash' supports causal and padding masks "
                "but not attention dropout: set dropout_rate=0.0, call with "
                "deterministic=True (or in eval mode), or use impl='xla'.")
        from chambers_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(query, value, key, scale=scale, causal=causal,
                              kv_mask=v_mask)
        if q_mask is not None:
            out = out * q_mask[:, None, :, None].to(out.dtype)
        return out
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}; 'xla' or 'flash'")
    if scale is None:
        scale = math.sqrt(query.shape[-1])
    score_dtype = score_dtype or torch.float32
    scores = torch.matmul(query.to(score_dtype),
                          key.to(score_dtype).transpose(-1, -2))
    # the divisor rounded to score_dtype, held as a host scalar
    scale = float(torch.tensor(scale, dtype=torch.float32).to(score_dtype))
    scores = scores / scale
    if v_mask is not None:
        bias = torch.zeros(v_mask.shape, dtype=score_dtype,
                           device=scores.device)
        scores = scores + bias.masked_fill(~v_mask.bool(),
                                           _MASK_BIAS)[:, None, None, :]
    if causal:
        tq, tv = scores.shape[-2], scores.shape[-1]
        keep = torch.ones((tq, tv), dtype=torch.bool,
                          device=scores.device).tril(tv - tq)
        scores = scores.masked_fill(~keep, _MASK_BIAS)
    probs = torch.softmax(scores, dim=-1)
    if use_dropout:
        keep = keep_mask(probs.shape, dropout_rate, generator, probs.device,
                         dropout_dims)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(probs.to(value.dtype), value)
    if q_mask is not None:
        out = out * q_mask[:, None, :, None].to(out.dtype)
    return out


def _key_scale(key_dim, key):
    """``sqrt(key_dim)`` (the key's last axis if None), rounded to
    float32."""
    dim = key_dim if key_dim is not None else key.shape[-1]
    return float(torch.sqrt(torch.tensor(float(dim), dtype=torch.float32)))


def scaled_attention(query, value, key=None, key_dim=None, causal=False,
                     q_mask=None, v_mask=None):
    """Dense dot-product attention with the scores divided by
    ``sqrt(key_dim)`` (the reference's ``ScaledAttention``)."""
    if key is None:
        key = value
    return scaled_dot_product_attention(
        query, value, key, scale=_key_scale(key_dim, key), causal=causal,
        q_mask=q_mask, v_mask=v_mask)


class ScaledAttention:
    """Layer-style :func:`scaled_attention` over ``inputs = [q, v]`` or
    ``[q, v, k]`` with ``mask = [q_mask, v_mask]``. With ``dropout > 0`` a
    call with ``training=True`` drops attention probabilities with draws
    from ``generator`` (the JAX layer's ``key``), and raises without one."""

    def __init__(self, key_dim=None, causal=False, dropout=0.0):
        self.key_dim = key_dim
        self.causal = causal
        self.dropout = dropout

    def __call__(self, inputs, mask=None, generator=None, training=False):
        q, v = inputs[0], inputs[1]
        k = inputs[2] if len(inputs) > 2 else v
        q_mask, v_mask = mask if mask is not None else (None, None)
        if training and self.dropout > 0.0:
            if generator is None:
                raise ValueError(
                    "ScaledAttention(dropout>0) requires a torch.Generator "
                    "`generator` when training=True.")
            return scaled_dot_product_attention(
                q, v, k, scale=_key_scale(self.key_dim, k),
                causal=self.causal, q_mask=q_mask, v_mask=v_mask,
                dropout_rate=self.dropout, deterministic=False,
                generator=generator)
        return scaled_attention(q, v, k, key_dim=self.key_dim,
                                causal=self.causal, q_mask=q_mask,
                                v_mask=v_mask)


class MultiHeadAttention(nn.Module):
    """On a mesh (``parallel.sharding``) whose rules shard the heads of the
    four projections over one axis, the layer holds this rank's heads:
    ``_tp_group`` is that axis's group, the inputs' gradients are summed
    over it and the output projection's partial products are summed before
    its bias. Under ``parallel.distributed.data_parallel`` the batch's
    group is ``_batch_group``, over which the dropout mask is drawn."""

    _tp_group = None
    _batch_group = None

    def __init__(self, embed_dim, head_dim=64, num_heads=8, causal=False,
                 dtype=None, param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, kernel_init=None, dropout_rate=0.1,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        d, n, h = embed_dim, num_heads, head_dim
        self.causal = causal
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.score_dtype = score_dtype
        self.kernel_init = kernel_init or initializers.glorot_uniform
        for name in ("query", "value", "key"):
            setattr(self, f"w_{name}",
                    initializers.new_param((d, n, h), param_dtype, device))
            setattr(self, f"b_{name}",
                    initializers.new_param((n, 1, h), param_dtype, device))
        self.w_projection = initializers.new_param((n, d, h), param_dtype,
                                                   device)
        self.b_projection = initializers.new_param((1, d), param_dtype, device)
        for name in ("query", "value", "key", "projection"):
            self.register_buffer(f"w_{name}_scale", None)
        # GEMM operands of the int8 projections (quantization.gemm_operand)
        # and the input projections' scales stacked to match
        self.register_buffer("_qkv_gemm", None, persistent=False)
        self.register_buffer("_qkv_scale", None, persistent=False)
        self.register_buffer("_projection_gemm", None, persistent=False)
        self.register_load_state_dict_post_hook(
            lambda module, keys: module.prepare_int8())

    def reset_parameters(self, generator=None):
        for name in ("query", "value", "key", "projection"):
            self.kernel_init(getattr(self, f"w_{name}"), generator)
            initializers.zeros(getattr(self, f"b_{name}"))

    def prepare_int8(self):
        """Derive the GEMM operands of int8 projections (a no-op on a float
        layer): ``[d, 3·n·h]`` over query, value and key, each third padded
        alone, and ``[n·h, d]`` for the output projection."""
        if self.w_query_scale is None:
            return
        d, n, h = self.w_query.shape
        self._qkv_gemm = quant.gemm_operand(torch.cat([
            F.pad(w.detach().reshape(d, n * h), (0, -n * h % 8))
            for w in (self.w_query, self.w_value, self.w_key)], dim=1))
        self._qkv_scale = torch.cat([self.w_query_scale, self.w_value_scale,
                                     self.w_key_scale])  # [3, n, h]
        self._projection_gemm = quant.gemm_operand(
            self.w_projection.detach().permute(0, 2, 1).reshape(n * h, d))

    def _int8_qkv(self, x, parts):
        """The int8 input projections ``parts`` (0 query, 1 value, 2 key) of
        ``x`` ``[b, t, d]``: ``[len(parts), b, n, t, h]`` before the bias,
        in the compute dtype (``btd,sdnh->sbnth``)."""
        b, t, d = x.shape
        n, h = self.w_query.shape[1:]
        third = self._qkv_gemm.shape[1] // 3
        w = self._qkv_gemm[:, parts[0] * third:(parts[-1] + 1) * third]
        x_q, s_x = quant.dynamic_quantize(x.reshape(b * t, d))
        acc = quant.int_mm(x_q, w, w.shape[1])
        acc = acc.reshape(b, t, len(parts), third)[..., :n * h]
        s_w = self._qkv_scale[parts[0]:parts[-1] + 1]
        out = (acc.reshape(b, t, len(parts), n, h)
               * s_x.view(b, t, 1, 1, 1)              # [b, t, 1, 1, 1]
               * s_w.view(1, 1, len(parts), n, h))    # [1, 1, s, n, h]
        return out.to(x.dtype).permute(2, 0, 3, 1, 4)

    def _int8_projection(self, attention, dtype):
        """The int8 output projection ``bnth,ndh->btd`` of ``attention``
        ``[b, n, t, h]``, activations quantized over ``(n, h)``."""
        b, n, t, h = attention.shape
        a_q, s_a = quant.dynamic_quantize(attention, (1, 3))  # [b, 1, t, 1]
        a_q = a_q.permute(0, 2, 1, 3).reshape(b * t, n * h)
        d = self.w_projection.shape[1]
        acc = quant.int_mm(a_q, self._projection_gemm, d).reshape(b, t, d)
        return ((acc * s_a.view(b, t, 1)
                 * self.w_projection_scale.view(1, 1, d)).to(dtype)
                + self.b_projection.to(dtype))

    def _project(self, x, part):
        """The input projection ``part`` (0 query, 1 value, 2 key) of ``x``
        ``[b, t, d]`` in its dtype: ``[b, n, t, h]``."""
        name = ("query", "value", "key")[part]
        b = getattr(self, f"b_{name}").to(x.dtype)
        if self.w_query_scale is not None:
            return self._int8_qkv(x, (part,))[0] + b
        w = getattr(self, f"w_{name}").to(x.dtype)
        return torch.einsum("btd,dnh->bnth", x, w) + b

    def init_self_cache(self, batch, max_len, dtype, device):
        """An empty self-attention cache for ``[batch, max_len]`` targets
        whose activations are ``dtype``: every slot invalid."""
        n, h = self.w_query.shape[1:]
        dtype = self.dtype or dtype
        return {
            "cached_key": torch.zeros((batch, n, max_len, h), dtype=dtype,
                                      device=device),
            "cached_value": torch.zeros((batch, n, max_len, h), dtype=dtype,
                                        device=device),
            "valid_mask": torch.zeros((batch, max_len), dtype=torch.bool,
                                      device=device),
            "cache_index": 0,
        }

    def init_cross_cache(self, memory):
        """A cross-attention cache: ``memory`` ``[b, t, d]`` projected to
        its keys and values once."""
        memory = memory.to(self.dtype or memory.dtype)
        return {"cached_key": self._project(memory, 2),
                "cached_value": self._project(memory, 1)}

    def forward(self, inputs, mask=None, deterministic=None, generator=None,
                cache=None, index=None):
        """``inputs = [q, v]`` or ``[q, v, k]``, ``mask = [q_mask, v_mask]``.
        With a ``cache`` the call is one decode step (see the module
        docstring); a cross-attention step then ignores ``v`` and ``k``."""
        if deterministic is None:
            deterministic = not self.training
        q = inputs[0]
        v = inputs[1]
        k = inputs[2] if len(inputs) > 2 else v
        self_attention = v is q and k is v
        quantized = self.w_query_scale is not None
        group = self._tp_group
        if group is not None:
            from chambers_tpu_torch.parallel.distributed import (
                reduce_backward,
            )

            q = reduce_backward(q, group)
            if self_attention:
                v = k = q
            else:
                same = k is v
                v = reduce_backward(v, group)
                k = v if same else reduce_backward(k, group)
        dtype = self.dtype or q.dtype
        q = q.to(dtype)

        if cache is not None and not self_attention:
            query = self._project(q, 0)
            key, value = cache["cached_key"], cache["cached_value"]
        elif self_attention and quantized:
            b_qkv = torch.stack([self.b_query, self.b_value,
                                 self.b_key]).to(dtype)
            qkv = self._int8_qkv(q, (0, 1, 2)) + b_qkv[:, None]
            query, value, key = qkv[0], qkv[1], qkv[2]
        elif self_attention:
            w_qkv = torch.stack([self.w_query, self.w_value,
                                 self.w_key]).to(dtype)
            b_qkv = torch.stack([self.b_query, self.b_value,
                                 self.b_key]).to(dtype)
            qkv = torch.einsum("btd,sdnh->sbnth", q, w_qkv) + b_qkv[:, None]
            query, value, key = qkv[0], qkv[1], qkv[2]
        else:
            query = self._project(q, 0)
            value = self._project(v.to(dtype), 1)
            key = self._project(k.to(dtype), 2)

        q_mask, v_mask = mask if mask is not None else (None, None)
        causal = self.causal
        if cache is not None and self_attention:
            if query.shape[2] != 1:
                raise ValueError(
                    "cached decode expects one query position per step, "
                    f"got {query.shape[2]}")
            i = cache["cache_index"] if index is None else index
            cache["cached_key"][:, :, i] = key[:, :, 0]
            cache["cached_value"][:, :, i] = value[:, :, 0]
            cache["valid_mask"][:, i] = (True if v_mask is None
                                         else v_mask[:, 0])
            cache["cache_index"] = i + 1
            key, value = cache["cached_key"], cache["cached_value"]
            v_mask, causal = cache["valid_mask"], False
        # flash computes float32 softmax statistics and cannot honour
        # score_dtype
        if self.attention_impl == "flash" and self.score_dtype is not None:
            raise ValueError(
                "attention_impl='flash' always uses float32 softmax "
                "statistics; score_dtype is an option of the dense path — "
                "set one or the other.")
        attention = scaled_dot_product_attention(
            query, value, key, causal=causal, q_mask=q_mask,
            v_mask=v_mask, dropout_rate=self.dropout_rate,
            deterministic=deterministic, generator=generator,
            impl=self.attention_impl, score_dtype=self.score_dtype,
            dropout_dims=((0, self._batch_group), (1, group)))
        if quantized:
            return self._int8_projection(attention, dtype)
        out = torch.einsum("bnth,ndh->btd", attention,
                           self.w_projection.to(dtype))
        if group is not None:
            from chambers_tpu_torch.parallel.distributed import (
                reduce_forward,
            )

            out = reduce_forward(out, group)
        return out + self.b_projection.to(dtype)
