"""Blockwise (flash) attention: the wrapper, the autograd function and the
plain PyTorch versions of the CUDA kernels of the ``flash_attention``
library, whose three sources are ``csrc/flash_attention.cu``,
``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``.

Port of ``chambers_tpu/ops/flash_attention.py``:

- K3a ``flash_fwd`` replaces ``_flash_forward``: ``o = softmax(q kᵀ ·
  scale) v`` by key tiles with float32 running max ``m`` and sum ``l``;
  returns ``o, l, m``.
- K3b ``flash_bwd_dkv`` replaces the dK/dV call of ``_flash_backward``.
- K3c ``flash_bwd_dq`` replaces its dQ call.

Each is two kernels behind one C function, chosen by the operands' type:
bfloat16 takes the tensor-core kernels, ``flash_fwd_tc_kernel`` of
``flash_attention_fwd.cu`` and ``flash_bwd_dkv_tc_kernel``,
``flash_bwd_dq_tc_kernel`` of ``flash_attention_bwd.cu`` (both built on
``flash_tiles.cuh``); float32 takes the FMA kernels ``flash_fwd_kernel``,
``flash_bwd_dkv_kernel`` and ``flash_bwd_dq_kernel`` of
``flash_attention.cu``, which also holds the C interface. See the notes at
the top of the CUDA sources for what bounds the kernels on the card and
for their design. :func:`flash_attention` is the public
function, ``[batch, heads, t, head_dim]`` in and out, argument order as the
JAX function's. It goes through :class:`FlashAttentionFunction`, which
saves ``q, k, v, o, l, m`` and the mask and launches K3a in ``forward`` and
K3b and K3c in ``backward``. The three ``launch_*`` functions are the only
places where a kernel starts, and each adds one to its entry of
``flash_attention.launches`` there. ``di = Σ o·do`` is
computed with torch ops before the backward launches, as the JAX package
computes it outside its kernels.

On CPU tensors the function runs :func:`flash_forward_plain` and
:func:`flash_backward_plain`, which state the kernels' semantics in
PyTorch: zeros for a row whose keys are all masked (with ``l == 0`` and
``m`` at the mask value), the causal diagonal at the sequence end, scores
from the input type with float32 accumulation, ``l`` summed from the
unrounded float32 probabilities, probabilities cast to ``v``'s type before
``p v``, a backward that recomputes ``p`` from the saved ``l, m`` in
float32 and rounds ``p`` and ``ds`` to the operands' type before the
products that consume them. On a CUDA tensor it launches the kernels or
raises: there is no fallback.

The kernels take contiguous operands: the wrapper makes ``q, k, v`` and the
incoming gradient contiguous (a copy when a projection hands over a
permuted view; none for the slices of a stacked self-attention projection
that is already contiguous).
"""

import ctypes
import functools
import math

import numpy as np
import torch

from chambers_tpu_torch.ops import _build

LIBRARY = ("flash_attention",
           ["flash_attention.cu", "flash_attention_fwd.cu",
            "flash_attention_bwd.cu", "flash_tiles.cuh"], _build.FMA_FLAGS)
HEAD_SIZES = (64,)              # head_dim the CUDA kernels are built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# masked scores: finite, so that exp(m_prev - m_next) never sees inf - inf
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(*LIBRARY)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32] * 5 + [f32, i32, i32, ptr]  # bn tq tk h n_heads | scale ...
    lib.flash_fwd.argtypes = [ptr] * 7 + tail
    lib.flash_bwd_dkv.argtypes = [ptr] * 10 + tail
    lib.flash_bwd_dq.argtypes = [ptr] * 9 + tail
    lib.flash_tile_products.argtypes = [ptr] * 5
    for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq,
               lib.flash_tile_products):
        fn.restype = i32
    return lib


_ptr, _check_launch = _build.ptr, _build.check_launch


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _keep_mask(tq, tk, causal, kv_mask, n_heads, device):
    """Which (row, key) pairs take part: ``[bn or 1, tq or 1, tk]`` bool, or
    None when every pair does."""
    keep = None
    if kv_mask is not None:
        keep = (kv_mask > 0).repeat_interleave(n_heads, dim=0)[:, None, :]
    if causal:
        tri = torch.ones((tq, tk), dtype=torch.bool,
                         device=device).tril(tk - tq)[None]
        keep = tri if keep is None else keep & tri
    return keep


def delta(o, do):
    """``di = Σ_h o·do`` in float32, ``[bn, tq, 1]``."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def _scores(q, k, scale):
    # bf16 products are exact in float32: this is q kᵀ in the input type
    # with float32 accumulation
    return torch.matmul(q.float(), k.float().transpose(1, 2)) * scale


def flash_forward_plain(q, k, v, scale, causal=False, kv_mask=None,
                        n_heads=1):
    """K3a in PyTorch over ``[bn, t, h]``: returns ``(o, l, m)`` with
    ``l, m`` float32 ``[bn, tq, 1]``. ``scale`` multiplies the scores;
    ``kv_mask`` is ``[bn // n_heads, tk]`` float (positive = attend)."""
    keep = _keep_mask(q.shape[1], k.shape[1], causal, kv_mask, n_heads,
                      q.device)
    s = _scores(q, k, scale)
    if keep is not None:
        s = torch.where(keep, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, 0.0)  # a fully masked row sums to l == 0
    l = p.sum(dim=-1, keepdim=True)
    l_inv = torch.where(l == 0, 1.0, 1.0 / l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) * l_inv
    return o.to(q.dtype), l, m


def flash_backward_plain(q, k, v, o, l, m, do, scale, causal=False,
                         kv_mask=None, n_heads=1):
    """K3b and K3c in PyTorch: ``(dq, dk, dv)`` from the saved ``l, m``.
    ``p`` and ``ds`` are computed in float32 and rounded to the operands'
    type before ``pᵀ do``, ``dsᵀ q`` and ``ds k`` (a tensor-core product in
    bfloat16 takes bfloat16 on both sides; the identity for float32), the
    products accumulate in float32, and the results are cast to the
    inputs' types at the end."""
    keep = _keep_mask(q.shape[1], k.shape[1], causal, kv_mask, n_heads,
                      q.device)
    do32 = do.float()
    l_safe = torch.where(l == 0, 1.0, l)
    p = torch.exp(_scores(q, k, scale) - m) / l_safe
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    ds = p * (torch.matmul(do32, v.float().transpose(1, 2)) - delta(o, do))
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.matmul(p.transpose(1, 2), do32)
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * scale
    dq = torch.matmul(ds, k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_operands(q, k, v, kv_mask, n_heads):
    for name, t in (("query", q), ("key", k), ("value", v)):
        if not isinstance(t, torch.Tensor) or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention takes float32 or bfloat16 "
                            f"tensors, got {name} "
                            f"{getattr(t, 'dtype', type(t))}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be [bn, t, h], got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("query, key and value must share one dtype and "
                             "one device")
    bn, _, h = q.shape
    if k.shape != v.shape or k.shape[0] != bn or k.shape[2] != h:
        raise ValueError(f"shapes disagree: query {tuple(q.shape)}, key "
                         f"{tuple(k.shape)}, value {tuple(v.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CPU or CUDA, not "
                         f"{q.device}")
    if q.device.type == "cuda" and h not in HEAD_SIZES:
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_SIZES}, "
                         f"got {h}")
    if kv_mask is not None:
        if bn % n_heads or tuple(kv_mask.shape) != (bn // n_heads,
                                                    k.shape[1]):
            raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != "
                             f"(batch, tv) = {(bn // n_heads, k.shape[1])}")
        if kv_mask.dtype != torch.float32 or kv_mask.device != q.device:
            raise ValueError("kv_mask must be float32 on the operands' "
                             "device")


def _operand(t):
    """Contiguous and 16-byte aligned, as the kernels' vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _tail(q, k, scale, causal, n_heads):
    bn, tq, h = q.shape
    return (bn, tq, k.shape[1], h, n_heads, float(scale), int(bool(causal)),
            DTYPES[q.dtype], _build.stream(q.device))


def launch_forward(q, k, v, kv_mask, scale, causal, n_heads):
    """Launch K3a alone on checked, contiguous CUDA operands: ``(o, l, m)``.
    bfloat16 operands run ``flash_fwd_tc_kernel``, float32
    ``flash_fwd_kernel``."""
    lib = _library()
    bn, tq, _ = q.shape
    o = torch.empty_like(q)
    l = torch.empty((bn, tq, 1), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    with torch.cuda.device(q.device):
        code = lib.flash_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(kv_mask),
                             _ptr(o), _ptr(l), _ptr(m),
                             *_tail(q, k, scale, causal, n_heads))
    _check_launch(lib, code, "flash_fwd_kernel")
    flash_attention.launches["fwd"] += 1
    return o, l, m


def launch_backward_dkv(q, k, v, do, l, m, di, kv_mask, scale, causal,
                        n_heads):
    """Launch K3b alone: ``(dk, dv)``. bfloat16 operands run
    ``flash_bwd_dkv_tc_kernel``, float32 ``flash_bwd_dkv_kernel``."""
    lib = _library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dkv(_ptr(q), _ptr(k), _ptr(v), _ptr(do),
                                 _ptr(l), _ptr(m), _ptr(di), _ptr(kv_mask),
                                 _ptr(dk), _ptr(dv),
                                 *_tail(q, k, scale, causal, n_heads))
    _check_launch(lib, code, "flash_bwd_dkv_kernel")
    flash_attention.launches["dkv"] += 1
    return dk, dv


def launch_backward_dq(q, k, v, do, l, m, di, kv_mask, scale, causal,
                       n_heads):
    """Launch K3c alone: ``dq``. bfloat16 operands run
    ``flash_bwd_dq_tc_kernel``, float32 ``flash_bwd_dq_kernel``."""
    lib = _library()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dq(_ptr(q), _ptr(k), _ptr(v), _ptr(do),
                                _ptr(l), _ptr(m), _ptr(di), _ptr(kv_mask),
                                _ptr(dq),
                                *_tail(q, k, scale, causal, n_heads))
    _check_launch(lib, code, "flash_bwd_dq_kernel")
    flash_attention.launches["dq"] += 1
    return dq


def tile_products(x, y):
    """The two products the bfloat16 backward kernels are built from, alone,
    for a check on the card: ``x [128, 64]`` and ``y [64, 64]`` bfloat16
    CUDA tensors give ``x yᵀ`` and ``bf16(x yᵀ) y`` as float32
    ``[128, 64]``, through the kernels' own copies into shared memory,
    fragments and tensor-core products."""
    if (x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16
            or tuple(x.shape) != (128, 64) or tuple(y.shape) != (64, 64)
            or x.device.type != "cuda" or y.device != x.device):
        raise ValueError("tile_products takes bfloat16 CUDA tensors "
                         "[128, 64] and [64, 64]")
    lib = _library()
    x, y = _operand(x), _operand(y)
    nt = torch.empty((128, 64), dtype=torch.float32, device=x.device)
    tn = torch.empty_like(nt)
    with torch.cuda.device(x.device):
        code = lib.flash_tile_products(_ptr(x), _ptr(y), _ptr(nt), _ptr(tn),
                                       _build.stream(x.device))
    _check_launch(lib, code, "flash_tile_products_kernel")
    return nt, tn


class FlashAttentionFunction(torch.autograd.Function):
    """``o = attention(q, k, v)`` over ``[bn, t, h]`` with a hand-written
    backward; ``scale`` multiplies the scores."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, causal, n_heads):
        _check_operands(q, k, v, kv_mask, n_heads)
        if q.device.type == "cpu":
            o, l, m = flash_forward_plain(q, k, v, scale, causal, kv_mask,
                                          n_heads)
        else:
            q, k, v = _operand(q), _operand(k), _operand(v)
            if kv_mask is not None:
                kv_mask = _operand(kv_mask)
            o, l, m = launch_forward(q, k, v, kv_mask, scale, causal, n_heads)
        ctx.save_for_backward(q, k, v, o, l, m, kv_mask)
        ctx.attention = (scale, causal, n_heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m, kv_mask = ctx.saved_tensors
        scale, causal, n_heads = ctx.attention
        if q.device.type == "cpu":
            dq, dk, dv = flash_backward_plain(q, k, v, o, l, m, do, scale,
                                              causal, kv_mask, n_heads)
        else:
            do = _operand(do)
            args = (q, k, v, do, l, m, delta(o, do), kv_mask, scale, causal,
                    n_heads)
            dk, dv = launch_backward_dkv(*args)
            dq = launch_backward_dq(*args)
        return dq, dk, dv, None, None, None, None


def flash_attention(query, value, key=None, scale=None, causal=False,
                    kv_mask=None):
    """Blockwise attention over ``[batch, heads, t, head_dim]`` tensors,
    differentiable in ``query``, ``value`` and ``key``.

    :param scale: score divisor; ``None`` means ``sqrt(head_dim)``.
    :param causal: lower-triangular mask with the diagonal at the sequence
        end (row ``r`` attends keys ``<= r + tv - tq``).
    :param kv_mask: optional ``[batch, tv]`` key-validity mask (True =
        attend), shared by the heads. Masked keys get exactly zero
        probability, forward and backward; a row with no valid key returns
        zeros (the dense path returns the uniform average instead).
    """
    if key is None:
        key = value
    if query.ndim != 4:
        raise ValueError(f"query must be [batch, heads, t, head_dim], got "
                         f"{tuple(query.shape)}")
    b, n, tq, h = query.shape
    tk = value.shape[2]
    scale = 1.0 / math.sqrt(h) if scale is None else 1.0 / float(scale)
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, tk):
            raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != "
                             f"(batch, tv) = {(b, tk)}")
        kv_mask = kv_mask.to(device=query.device, dtype=torch.float32)

    def fold(x):
        return x.reshape(b * n, x.shape[2], h)

    out = FlashAttentionFunction.apply(fold(query), fold(key), fold(value),
                                       kv_mask, scale, bool(causal), n)
    return out.reshape(b, n, tq, h)


flash_attention.launches = {"fwd": 0, "dkv": 0, "dq": 0}
