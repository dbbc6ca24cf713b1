"""Multi-head attention with the Chambers per-head parameter layout
(port of ``chambers_tpu/layers/attention.py``).

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
draws from the ``generator`` given, else from torch's default one. The
incremental decode cache comes with generation, in a later slice.
"""

import math

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device

_MASK_BIAS = -1e9


def scaled_dot_product_attention(query, value, key=None, scale=None,
                                 causal=False, q_mask=None, v_mask=None,
                                 dropout_rate=0.0, deterministic=True,
                                 generator=None, impl="xla",
                                 score_dtype=None):
    """Attention over ``[batch, heads, time, head_dim]``.

    :param scale: score divisor; defaults to ``sqrt(head_dim)``.
    :param causal: lower-triangular mask, diagonal aligned at the end.
    :param q_mask: ``[b, tq]`` bool; zeroes outputs of masked queries.
    :param v_mask: ``[b, tv]`` bool; excludes masked keys from the softmax.
    :param dropout_rate: dropout on the attention probabilities, applied
        unless ``deterministic``; drawn from ``generator``.
    :param score_dtype: dtype of the scores and the softmax (float32 if
        None).
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
        keep = torch.empty_like(probs, dtype=torch.float32).bernoulli_(
            1.0 - dropout_rate, generator=generator).bool()
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(probs.to(value.dtype), value)
    if q_mask is not None:
        out = out * q_mask[:, None, :, None].to(out.dtype)
    return out


class MultiHeadAttention(nn.Module):
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

    def reset_parameters(self, generator=None):
        for name in ("query", "value", "key", "projection"):
            self.kernel_init(getattr(self, f"w_{name}"), generator)
            initializers.zeros(getattr(self, f"b_{name}"))

    def forward(self, inputs, mask=None, deterministic=None, generator=None):
        if deterministic is None:
            deterministic = not self.training
        q = inputs[0]
        v = inputs[1]
        k = inputs[2] if len(inputs) > 2 else v
        self_attention = v is q and k is v
        dtype = self.dtype or q.dtype
        q, v, k = (x.to(dtype) for x in (q, v, k))

        def project(x, w, b):
            return (torch.einsum("btd,dnh->bnth", x, w.to(dtype))
                    + b.to(dtype))

        if self_attention:
            w_qkv = torch.stack([self.w_query, self.w_value,
                                 self.w_key]).to(dtype)
            b_qkv = torch.stack([self.b_query, self.b_value,
                                 self.b_key]).to(dtype)
            qkv = torch.einsum("btd,sdnh->sbnth", q, w_qkv) + b_qkv[:, None]
            query, value, key = qkv[0], qkv[1], qkv[2]
        else:
            query = project(q, self.w_query, self.b_query)
            value = project(v, self.w_value, self.b_value)
            key = project(k, self.w_key, self.b_key)

        q_mask, v_mask = mask if mask is not None else (None, None)
        # flash computes float32 softmax statistics and cannot honour
        # score_dtype
        if self.attention_impl == "flash" and self.score_dtype is not None:
            raise ValueError(
                "attention_impl='flash' always uses float32 softmax "
                "statistics; score_dtype is an option of the dense path — "
                "set one or the other.")
        attention = scaled_dot_product_attention(
            query, value, key, causal=self.causal, q_mask=q_mask,
            v_mask=v_mask, dropout_rate=self.dropout_rate,
            deterministic=deterministic, generator=generator,
            impl=self.attention_impl, score_dtype=self.score_dtype)
        return (torch.einsum("bnth,ndh->btd", attention,
                             self.w_projection.to(dtype))
                + self.b_projection.to(dtype))
