"""Multi-head attention with the Chambers per-head parameter layout
(port of ``chambers_tpu/layers/attention.py``, ``impl="xla"`` only).

Per-head projections keep the checkpoint layout: ``w_query``, ``w_value``,
``w_key`` ``(d, num_heads, head_dim)`` with biases ``(num_heads, 1,
head_dim)``; ``w_projection`` ``(num_heads, d, head_dim)`` with bias
``(1, d)``. The call takes ``inputs=[q, v]`` or ``[q, v, k]``; a
self-attention call projects through one stacked ``[query, value, key]``
weight, as the JAX package does.

Scores come from an explicit matmul in ``score_dtype`` (float32 by
default), so their rounding is the JAX package's —
``F.scaled_dot_product_attention`` rounds differently and is not used. The
blockwise flash kernel (``attention_impl="flash"``) and attention dropout
come in later slices; this module computes inference.
"""

import math

import torch
from torch import nn

from chambers_tpu_torch import initializers
from chambers_tpu_torch._device import resolve_device

_MASK_BIAS = -1e9


def scaled_dot_product_attention(query, value, key=None, scale=None,
                                 causal=False, q_mask=None, v_mask=None,
                                 impl="xla", score_dtype=None):
    """Attention over ``[batch, heads, time, head_dim]``.

    :param scale: score divisor; defaults to ``sqrt(head_dim)``.
    :param causal: lower-triangular mask, diagonal aligned at the end.
    :param q_mask: ``[b, tq]`` bool; zeroes outputs of masked queries.
    :param v_mask: ``[b, tv]`` bool; excludes masked keys from the softmax.
    :param score_dtype: dtype of the scores and the softmax (float32 if
        None).
    """
    if impl != "xla":
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported yet; the flash kernel "
            "comes in a later slice.")
    if key is None:
        key = value
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
    probs = torch.softmax(scores, dim=-1).to(value.dtype)
    out = torch.matmul(probs, value)
    if q_mask is not None:
        out = out * q_mask[:, None, :, None].to(out.dtype)
    return out


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, head_dim=64, num_heads=8, causal=False,
                 dtype=None, param_dtype=torch.float32, attention_impl="xla",
                 score_dtype=None, kernel_init=None, device=None):
        super().__init__()
        device = resolve_device(device)
        d, n, h = embed_dim, num_heads, head_dim
        self.causal = causal
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

    def forward(self, inputs, mask=None):
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
        attention = scaled_dot_product_attention(
            query, value, key, causal=self.causal, q_mask=q_mask,
            v_mask=v_mask, impl=self.attention_impl,
            score_dtype=self.score_dtype)
        return (torch.einsum("bnth,ndh->btd", attention,
                             self.w_projection.to(dtype))
                + self.b_projection.to(dtype))
