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
bfloat16 and float16 take the tensor-core kernels, ``flash_fwd_tc_kernel``
of ``flash_attention_fwd.cu`` (at head size 64 over 64 to 256 queries and
1 to 256 keys, ViT lengths, its ``flash_fwd_short_kernel``, which keeps a
head's Q, K and V resident) and ``flash_bwd_dkv_tc_kernel``,
``flash_bwd_dq_tc_kernel`` of ``flash_attention_bwd.cu`` (both built on
``flash_tiles.cuh``, templated on the type); float32 takes the FMA kernels
``flash_fwd_kernel``, ``flash_bwd_dkv_kernel`` and ``flash_bwd_dq_kernel``
of ``flash_attention.cu`` (from head size 256 on their ``_cols`` forms),
which also holds the C interface. Above head size 256 the 16-bit types take
the sliced tensor-core kernels ``flash_fwd_sliced_kernel`` and
``flash_bwd_dq_sliced_kernel``, which give each block one slice of the
head's output columns, and the cluster kernel
``flash_bwd_dkv_cluster_kernel``, whose blocks each own a slice of the
columns and sum their terms of the score products over a thread-block
cluster. See the notes at
the top of the CUDA sources for what bounds the kernels on the card and
for their design. :func:`flash_attention` is the public
function, ``[batch, heads, t, head_dim]`` in and out, argument order as the
JAX function's. It goes through :class:`FlashAttentionFunction`, which
saves ``q, k, v, o, l, m`` and the mask and launches K3a in ``forward`` and
K3b and K3c in ``backward``. The three ``launch_*`` functions are the only
places where a kernel starts, and each adds one to its entry of
``flash_attention.launches`` there (K3a also to the kernel that ran, in
``flash_attention.forward_launches``; :func:`launch_shape` names the
kernel the library's dispatch picks for a call). ``di = Σ o·do`` is
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

Head sizes. The kernels work on whole 64-column panels: up to 256 at
``HEAD_SIZES`` = 64, 128 and 256, above it at any multiple of 64 (the
sliced and cluster kernels, and the float32 ``_cols`` kernels, take the
head size at run time). On a CUDA tensor any other head size is zero-padded to the
next size the kernels take (:func:`kernel_head_size`, :func:`pad_head`):
zero columns add nothing to ``q kᵀ``, the padded columns of ``o``, dQ, dK
and dV are dropped, the scale comes from the true head size, and ``di`` is
computed from the unpadded ``o`` and ``do``, so the padded call computes
the unpadded one's function (the CPU tests hold the plain versions to that
bit for bit). On CPU tensors the plain versions take any head size
unpadded.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from chambers_tpu_torch.ops import _build

LIBRARY = ("flash_attention",
           ["flash_attention.cu", "flash_attention_fwd.cu",
            "flash_attention_bwd.cu", "flash_tiles.cuh"], _build.FMA_FLAGS)
HEAD_SIZES = (64, 128, 256)     # head_dim the CUDA kernels are built for
PANEL = 64                      # above HEAD_SIZES[-1]: any multiple of it
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# masked scores: finite, so that exp(m_prev - m_next) never sees inf - inf
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
# each family's kernels, in the order of the library's flash_launch_shape:
# float32 (FMA, then from head size 256 the _cols form), then the 16-bit
# tensor-core kernels
KERNEL_NAMES = {
    "fwd": ("flash_fwd_kernel", "flash_fwd_cols_kernel",
            "flash_fwd_tc_kernel", "flash_fwd_short_kernel",
            "flash_fwd_sliced_kernel"),
    "dkv": ("flash_bwd_dkv_kernel", "flash_bwd_dkv_cols_kernel",
            "flash_bwd_dkv_tc_kernel", "flash_bwd_dkv_cluster_kernel"),
    "dq": ("flash_bwd_dq_kernel", "flash_bwd_dq_cols_kernel",
           "flash_bwd_dq_tc_kernel", "flash_bwd_dq_sliced_kernel"),
}


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(*LIBRARY)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32] * 5 + [f32, i32, i32, ptr]  # bn tq tk h n_heads | scale ...
    lib.flash_fwd.argtypes = [ptr] * 7 + tail
    lib.flash_bwd_dkv.argtypes = [ptr] * 10 + tail
    lib.flash_bwd_dq.argtypes = [ptr] * 9 + tail
    lib.flash_tile_products.argtypes = [ptr] * 5
    lib.flash_launch_shape.argtypes = [i32] * 5 + [ptr]
    for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq,
               lib.flash_tile_products, lib.flash_launch_shape):
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


def kernel_head_size(h):
    """The head size the CUDA kernels run a call of head size ``h`` at: the
    smallest of ``HEAD_SIZES`` that holds it, and above the largest the
    next multiple of ``PANEL`` (the sliced and cluster kernels')."""
    for size in HEAD_SIZES:
        if h <= size:
            return size
    return -(-h // PANEL) * PANEL


def pad_head(x, size):
    """``x`` with its last (head) dimension zero-padded to ``size`` (``x``
    itself when it has that size)."""
    h = x.shape[-1]
    return x if h == size else torch.nn.functional.pad(x, (0, size - h))


def _scores(q, k, scale):
    # products of bf16 or float16 values are exact in float32: this is
    # q kᵀ in the input type with float32 accumulation
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
                         kv_mask=None, n_heads=1, di=None):
    """K3b and K3c in PyTorch: ``(dq, dk, dv)`` from the saved ``l, m``.
    ``p`` and ``ds`` are computed in float32 and rounded to the operands'
    type before ``pᵀ do``, ``dsᵀ q`` and ``ds k`` (a tensor-core product in
    bfloat16 or float16 takes that type on both sides; the identity for
    float32), the
    products accumulate in float32, and the results are cast to the
    inputs' types at the end. ``di`` (default :func:`delta` of ``o`` and
    ``do``) is what the kernels are handed: a padded call passes the
    unpadded operands' one."""
    keep = _keep_mask(q.shape[1], k.shape[1], causal, kv_mask, n_heads,
                      q.device)
    do32 = do.float()
    l_safe = torch.where(l == 0, 1.0, l)
    p = torch.exp(_scores(q, k, scale) - m) / l_safe
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    if di is None:
        di = delta(o, do)
    ds = p * (torch.matmul(do32, v.float().transpose(1, 2)) - di)
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
            raise TypeError(f"flash_attention takes float32, bfloat16 or "
                            f"float16 tensors, got {name} "
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
    if kernel_head_size(h) != h:
        raise ValueError(f"the kernels take head_dim {HEAD_SIZES} and any "
                         f"multiple of {PANEL} above, got {h}: pad it "
                         f"(pad_head, kernel_head_size)")
    return (bn, tq, k.shape[1], h, n_heads, float(scale), int(bool(causal)),
            DTYPES[q.dtype], _build.stream(q.device))


def launch_forward(q, k, v, kv_mask, scale, causal, n_heads):
    """Launch K3a alone on checked, contiguous CUDA operands of a head size
    the kernels take: ``(o, l, m)``. bfloat16 and float16 operands run
    ``flash_fwd_short_kernel`` at head size 64 when a head's queries (64 to
    256) and keys (1 to 256) fit in shared memory whole,
    ``flash_fwd_tc_kernel`` otherwise (above 256 ``flash_fwd_sliced_kernel``),
    float32 ``flash_fwd_kernel`` (from 256 on ``flash_fwd_cols_kernel``).
    The launch counts in ``flash_attention.launches["fwd"]`` and under its
    kernel's name in ``flash_attention.forward_launches``."""
    tail = _tail(q, k, scale, causal, n_heads)
    lib = _library()
    bn, tq, h = q.shape
    kernel = forward_kernel(q.dtype, h, tq, k.shape[1])
    o = torch.empty_like(q)
    l = torch.empty((bn, tq, 1), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    with torch.cuda.device(q.device):
        code = lib.flash_fwd(_ptr(q), _ptr(k), _ptr(v), _ptr(kv_mask),
                             _ptr(o), _ptr(l), _ptr(m), *tail)
    _check_launch(lib, code, kernel)
    flash_attention.launches["fwd"] += 1
    flash_attention.forward_launches[kernel] += 1
    return o, l, m


def launch_backward_dkv(q, k, v, do, l, m, di, kv_mask, scale, causal,
                        n_heads):
    """Launch K3b alone: ``(dk, dv)``. bfloat16 and float16 operands run
    ``flash_bwd_dkv_tc_kernel`` (above 256 ``flash_bwd_dkv_cluster_kernel``),
    float32 ``flash_bwd_dkv_kernel`` (from 256 on
    ``flash_bwd_dkv_cols_kernel``)."""
    tail = _tail(q, k, scale, causal, n_heads)
    lib = _library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dkv(_ptr(q), _ptr(k), _ptr(v), _ptr(do),
                                 _ptr(l), _ptr(m), _ptr(di), _ptr(kv_mask),
                                 _ptr(dk), _ptr(dv), *tail)
    _check_launch(lib, code, "flash_bwd_dkv_kernel")
    flash_attention.launches["dkv"] += 1
    return dk, dv


def launch_backward_dq(q, k, v, do, l, m, di, kv_mask, scale, causal,
                       n_heads):
    """Launch K3c alone: ``dq``. bfloat16 and float16 operands run
    ``flash_bwd_dq_tc_kernel`` (above 256 ``flash_bwd_dq_sliced_kernel``),
    float32 ``flash_bwd_dq_kernel`` (from 256 on
    ``flash_bwd_dq_cols_kernel``)."""
    tail = _tail(q, k, scale, causal, n_heads)
    lib = _library()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dq(_ptr(q), _ptr(k), _ptr(v), _ptr(do),
                                _ptr(l), _ptr(m), _ptr(di), _ptr(kv_mask),
                                _ptr(dq), *tail)
    _check_launch(lib, code, "flash_bwd_dq_kernel")
    flash_attention.launches["dq"] += 1
    return dq


def launch_shape(kernel, dtype, h, tq, tk):
    """How a launch of ``kernel`` ("fwd", "dkv" or "dq") at head size ``h``
    (one the kernels take) in ``dtype`` over ``tq`` queries and ``tk`` keys
    is shaped, as its launcher shapes it: ``kernel_name``, the kernel of
    the family the dispatch picks, ``threads`` a block, the block's dynamic
    shared memory ``smem_bytes``, ``slices``, the blocks that split the
    head's output columns, ``cluster``, the blocks of a thread-block
    cluster (1: none), ``max_active_clusters``, how many such clusters the
    current card holds at once (0 without clusters), and for K3a
    ``resident_blocks``, how many of its blocks the current card holds at
    once (the short kernel launches that many, or one a head if fewer)."""
    shape = (ctypes.c_int * 7)()
    code = _library().flash_launch_shape(
        ("fwd", "dkv", "dq").index(kernel), h, DTYPES[dtype], tq, tk, shape)
    _check_launch(_library(), code, "flash_launch_shape")
    out = {"kernel_name": KERNEL_NAMES[kernel][shape[5]],
           "threads": shape[0], "smem_bytes": shape[1], "slices": shape[2],
           "cluster": shape[3], "max_active_clusters": shape[4]}
    if kernel == "fwd":
        out["resident_blocks"] = shape[6]
    return out


@functools.lru_cache(maxsize=None)
def forward_kernel(dtype, h, tq, tk):
    """The name of the kernel a K3a launch at these type, head size and
    lengths runs, as the library's dispatch picks it."""
    return launch_shape("fwd", dtype, h, tq, tk)["kernel_name"]


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


@torch.library.custom_op("chambers_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: Optional[torch.Tensor], scale: float, causal: bool,
              n_heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3a as the operator ``torch.ops.chambers_tpu_torch.flash_fwd``:
    ``(o, l, m)`` over checked ``[bn, t, h]`` operands. On CUDA tensors it
    launches the kernel (:func:`launch_forward`); on CPU tensors it runs
    :func:`flash_forward_plain`.

    Being an operator, it survives ``torch.export``: an exported flash
    model carries this call, not a copy of either body, and its fake
    registration gives the tracer the outputs' shapes without running
    anything. ``torch.export.load`` of such a program needs the operator
    registered, that is ``chambers_tpu_torch.ops.flash_attention``
    imported first."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, scale, causal, kv_mask, n_heads)
    q, k, v = _operand(q), _operand(k), _operand(v)
    if kv_mask is not None:
        kv_mask = _operand(kv_mask)
    return launch_forward(q, k, v, kv_mask, scale, causal, n_heads)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, kv_mask, scale, causal, n_heads):
    stats = q.new_empty((q.shape[0], q.shape[1], 1), dtype=torch.float32)
    return torch.empty_like(q), stats, torch.empty_like(stats)


class FlashAttentionFunction(torch.autograd.Function):
    """``o = attention(q, k, v)`` over ``[bn, t, h]`` with a hand-written
    backward; ``scale`` multiplies the scores. The forward is the
    :func:`flash_fwd` operator. On CUDA tensors a head size the kernels do
    not take is zero-padded to the next one (:func:`kernel_head_size`,
    :func:`pad_head`): the padded ``q, k, v, o`` are saved, the incoming
    gradient is padded and the padded columns of every output are
    dropped."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, causal, n_heads):
        _check_operands(q, k, v, kv_mask, n_heads)
        h = q.shape[-1]
        size = kernel_head_size(h) if q.device.type == "cuda" else h
        # contiguous here, so that the operator and the backward share one
        # copy; the alignment is checked where a kernel launches (a traced
        # tensor has no address)
        q, k, v = (pad_head(x, size).contiguous() for x in (q, k, v))
        o, l, m = flash_fwd(q, k, v, kv_mask, scale, causal, n_heads)
        ctx.save_for_backward(q, k, v, o, l, m, kv_mask)
        ctx.attention = (scale, causal, n_heads, h)
        return o if size == h else o[..., :h]

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m, kv_mask = ctx.saved_tensors
        scale, causal, n_heads, h = ctx.attention
        if q.device.type == "cpu":
            dq, dk, dv = flash_backward_plain(q, k, v, o, l, m, do, scale,
                                              causal, kv_mask, n_heads)
        else:
            q, k, v, do = _operand(q), _operand(k), _operand(v), _operand(do)
            # di of the unpadded o and do: what the unpadded call computes
            di = delta(o[..., :h], do)
            do = pad_head(do, q.shape[-1])
            if kv_mask is not None:
                kv_mask = _operand(kv_mask)
            args = (q, k, v, do, l, m, di, kv_mask, scale, causal, n_heads)
            dk, dv = launch_backward_dkv(*args)
            dq = launch_backward_dq(*args)
            if q.shape[-1] != h:
                dq, dk, dv = dq[..., :h], dk[..., :h], dv[..., :h]
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
# K3a's launches by the kernel that ran
flash_attention.forward_launches = dict.fromkeys(KERNEL_NAMES["fwd"], 0)
