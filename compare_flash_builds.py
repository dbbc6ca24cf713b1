#!/usr/bin/env python3
"""Hold this checkout's flash attention kernels to another checkout's, on
one CUDA card: bit-equal at head sizes up to 256, within the card tests'
tolerance above it.

    python3 compare_flash_builds.py OTHER_CHECKOUT

Builds the ``flash_attention`` library from ``OTHER_CHECKOUT``'s
``chambers_tpu_torch/ops/csrc`` beside this checkout's, both with this
checkout's flags into its ``build/`` (``ops/_build.py``), and runs K3a
(``flash_fwd``), K3b (``flash_bwd_dkv``) and K3c (``flash_bwd_dq``) of both
libraries on the same seeded inputs at head sizes 64, 128 and 256: the
seq2seq train step's tokens (``[128, 512, 64]``, ``[64, 512, 128]``,
``[32, 512, 256]``) with its ragged key mask, causal and not, ViT-B/16's
197 tokens, cross lengths 130 x 260 and 260 x 130 under the causal mask,
63 x 65 with a scattered key mask, one query row against 512 and 300
keys, in bf16 (the tensor-core kernels) and float32 (the FMA kernels; at
256 the ``_cols`` kernels). Every output (``o, l, m, dk, dv, dq``) of the
two must be the same bits. At head sizes 512 and 1024 (``WIDE_HEADS``),
where the two checkouts may sum the score products in other orders, it
runs the train step's tokens over one head (``[16, 512, h]``) with the
ragged key mask, causal and not, and the cross and scattered-mask cases
above, in bf16 and float16, and holds every output of this library to the
other's within ``tests/test_torch_cuda_kernels.py``'s tolerance for the
type. At head size 2112 (``PLAIN_HEADS``) it runs the card tests' cases
there in bf16 (``tests/test_torch_cuda_kernels.py``'s ``WIDE_CASES``, on
``_flash_inputs``' seeded inputs) through both libraries and reports how
far each library's dQ, dK and dV are from the plain versions, by that
test's measure, on the plain forward's ``o, l, m`` (as the test holds
them) and on the library's own forward's. Then it times each kernel of
both libraries at the train step's tokens at each head size (at 512 and
1024 over one head), causal and not, with CUDA events over launches
queued behind a backlog, the two libraries in turns (other, this, this,
other, three rounds), on inputs cycled beyond the 50 MB L2. At ViT
lengths (``SHORT_CASES``, head size 64, at most 256 keys: DeiT-B/16's 198
tokens over 1536 heads, the served ViT-B/16's 197 over 384, in bf16 and
float16, and the edges of the short forward and dK/dV kernels: causal
cross lengths with rows that see no key or keys above every row's
diagonal, a scattered key mask whose last batch item keeps none, one
query row, one key, a last query tile of one row, 256 keys) every output,
``dk`` and ``dv`` among them, must be the same bits too, and K3a and K3b
are timed at the two ViT shapes in turns (other, this, this, other, three
rounds) beside ``F.scaled_dot_product_attention`` on the same operands
(its forward beside K3a, its whole backward beside K3b). At head sizes 8,
16 and 32 (``NARROW_HEADS``) each library runs K3a, K3b and K3c at the
head size its dispatch takes for each (``head_size``: 32 where the library
has that kernel's narrow form, else 64), as its wrapper pads them, on the
same inputs, in bf16 and float16 (``NARROW_CASES``: the seq2seq step
at 16 heads of 32 with its ragged key mask, causal and not, the cross
lengths, a scattered key mask whose last batch item keeps none, one key,
one query row, DeiT's 198 tokens); every output, cut to the head size,
must be the same bits. K3a, K3b and K3c are timed there at ``[256, 512,
32]`` in bf16 and float16, each library at its own size, in turns, and K3a
also at ``[1536, 198, 32]`` with no mask (``NARROW_SHAPE``). The libraries
share the C interface that ``ops/flash_attention.py`` calls, for the types
and head sizes both take. Prints one JSON line last and exits non-zero on
any difference beyond those.

    python3 compare_flash_builds.py OTHER_CHECKOUT --only short
    python3 compare_flash_builds.py OTHER_CHECKOUT --only narrow
    python3 compare_flash_builds.py OTHER_CHECKOUT --only wide
    python3 compare_flash_builds.py OTHER_CHECKOUT --only cluster
    python3 compare_flash_builds.py OTHER_CHECKOUT --only producer
    python3 compare_flash_builds.py OTHER_CHECKOUT --only producer256
    python3 compare_flash_builds.py OTHER_CHECKOUT --only dq_cluster

    python3 compare_flash_builds.py OTHER_CHECKOUT --turns 1216,2112 \
        [--kernel fwd] [--also DIR,DIR]

times one kernel ("fwd", "dkv" or "dq") of this checkout's library,
OTHER's and each of ``--also``'s (another checkout, or a copy of ``csrc``
with one edit: an ablation) in turns, at each head size's
``time_both`` shape with its ragged key mask, causal and not, and prints
each library's largest difference from this one's output (``time_turns``).
Or one part alone: the ``SHORT_CASES`` and their times, the narrow cases
and their times, the cases at ``WIDE_HEADS`` and K3a's times there in
bf16 and float16, the same cases (and one query row against 512 keys) at
``CLUSTER_HEADS``, above the wide K3a's sizes, where this library's K3a
is held to the plain version at the card tests' tolerances (the two
libraries' differences reported beside), and K3a timed there in bf16 and
float16 beside
``F.scaled_dot_product_attention`` (its forward with the same key mask, in
each round), or the cases at head size 128, held bit for bit, and K3b
timed there (``[64, 512, 128]``, causal and not, bf16 and float16), or
the same at head size 256 (``producer256``: K3b at ``[32, 512, 256]``),
or the cases at ``DQ_CLUSTER_HEADS`` (K3c on its cluster kernel, within
the card tests' tolerance of the other library) and K3c timed there in
bf16 and float16, causal and not, beside SDPA's whole backward with the
same key mask (the report says which outputs are bit-equal).
"""

import ctypes
import json
import sys
from pathlib import Path


def load(path):
    """A built ``flash_attention`` library with the argument types of
    ``ops/flash_attention.py``'s ``_library``."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32] * 5 + [f32, i32, i32, ptr]
    lib.flash_fwd.argtypes = [ptr] * 7 + tail
    lib.flash_bwd_dkv.argtypes = [ptr] * 10 + tail
    lib.flash_bwd_dq.argtypes = [ptr] * 9 + tail
    lib.flash_launch_shape.argtypes = [i32] * 5 + [ptr]
    for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq,
               lib.flash_launch_shape):
        fn.restype = i32
    return lib


def head_size(torch, fa, lib, kernel, h, dtype):
    """The head size ``lib`` runs ``kernel`` ("fwd", "dkv" or "dq") of head
    size ``h`` at, as its wrapper pads it: 32 for ``h <= 32`` in bf16 and
    float16 where its dispatch takes 32 for that kernel (the narrow
    kernels), else 64; above 32 ``kernel_head_size``."""
    if h > 32 or dtype == torch.float32:
        return fa.kernel_head_size(h, dtype)
    shape = (ctypes.c_int * 7)()
    taken = lib.flash_launch_shape(("fwd", "dkv", "dq").index(kernel), 32,
                                   fa.DTYPES[dtype], 1, 1, shape) == 0
    return 32 if taken else 64


def run(torch, fa, lib, q, k, v, do, mask, scale, causal, n_heads):
    """K3a, then K3b and K3c on K3a's own ``o, l, m``, through ``lib``:
    ``{name: output}``. The operands are padded as ``lib``'s wrapper pads
    them (``head_size``: K3a and the backward apart where ``lib`` takes 32
    for one and not the other), and the outputs come back cut to the head
    size, their padded columns checked to be zeros."""
    from chambers_tpu_torch.ops import _build

    ptr = _build.ptr
    bn, tq, h = q.shape
    size, back = (head_size(torch, fa, lib, "fwd", h, q.dtype),
                  head_size(torch, fa, lib, "dkv", h, q.dtype))

    def tail(n):
        return (bn, tq, k.shape[1], n, n_heads, float(scale), int(causal),
                fa.DTYPES[q.dtype], _build.stream(q.device))

    qp, kp, vp = (fa.pad_head(x, size).contiguous() for x in (q, k, v))
    o = torch.empty_like(qp)
    l = torch.empty((bn, tq, 1), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    codes = [lib.flash_fwd(ptr(qp), ptr(kp), ptr(vp), ptr(mask), ptr(o),
                           ptr(l), ptr(m), *tail(size))]
    di = fa.delta(o[..., :h], do)
    qb, kb, vb, dob = (fa.pad_head(x, back).contiguous()
                       for x in (q, k, v, do))
    dk, dv, dq = (torch.empty_like(x) for x in (kb, vb, qb))
    codes.append(lib.flash_bwd_dkv(ptr(qb), ptr(kb), ptr(vb), ptr(dob),
                                   ptr(l), ptr(m), ptr(di), ptr(mask),
                                   ptr(dk), ptr(dv), *tail(back)))
    codes.append(lib.flash_bwd_dq(ptr(qb), ptr(kb), ptr(vb), ptr(dob),
                                  ptr(l), ptr(m), ptr(di), ptr(mask),
                                  ptr(dq), *tail(back)))
    if any(codes):
        raise RuntimeError(f"a launch failed: CUDA errors {codes}")
    torch.cuda.synchronize()
    if any(bool(x[..., h:].any()) for x in (o, dk, dv, dq)):
        raise RuntimeError(f"padded columns not zero at head size {h}")
    return {"o": o[..., :h], "l": l, "m": m, "dk": dk[..., :h],
            "dv": dv[..., :h], "dq": dq[..., :h]}


def launch_one(torch, fa, lib, kernel, args):
    """One launch of ``kernel`` ("fwd", "dkv" or "dq") through ``lib`` on
    ``args`` = (q, k, v, do, l, m, di, mask, scale, causal, n_heads, outs),
    ``outs`` preallocated outputs."""
    from chambers_tpu_torch.ops import _build

    ptr = _build.ptr
    q, k, v, do, l, m, di, mask, scale, causal, n, outs = args
    bn, tq, h = q.shape
    tail = (bn, tq, k.shape[1], h, n, float(scale), int(causal),
            fa.DTYPES[q.dtype], _build.stream(q.device))
    if kernel == "fwd":
        return lib.flash_fwd(ptr(q), ptr(k), ptr(v), ptr(mask),
                             ptr(outs[0]), ptr(outs[1]), ptr(outs[2]), *tail)
    if kernel == "dkv":
        return lib.flash_bwd_dkv(ptr(q), ptr(k), ptr(v), ptr(do), ptr(l),
                                 ptr(m), ptr(di), ptr(mask), ptr(outs[3]),
                                 ptr(outs[4]), *tail)
    return lib.flash_bwd_dq(ptr(q), ptr(k), ptr(v), ptr(do), ptr(l), ptr(m),
                            ptr(di), ptr(mask), ptr(outs[5]), *tail)


HEADS = (64, 128, 256)
WIDE_HEADS = (512, 1024)
# K3a above the wide kernel's sizes (h 1152), on its cluster kernel: one
# cluster of three blocks, of three and of five
CLUSTER_HEADS = (1216, 1536, 2112)
# K3c on its cluster kernel: one block (320, 512), clusters of two
# (576, 1024), three (1216) and five (2112)
DQ_CLUSTER_HEADS = (320, 512, 576, 1024, 1216, 2112)
NARROW_HEADS = (32, 16, 8)
# the narrow kernels' cases (label, bn, n_heads, tq, tk, dtype name,
# causal, mask kind), at each of NARROW_HEADS
NARROW_CASES = [
    ("seq2seq step at 16 heads, key mask", 256, 16, 512, 512, "bfloat16",
     False, "ragged"),
    ("seq2seq step at 16 heads, causal + key mask", 256, 16, 512, 512,
     "bfloat16", True, "ragged"),
    ("float16, seq2seq step at 16 heads, causal + key mask", 256, 16, 512,
     512, "float16", True, "ragged"),
    ("cross 130x260 causal", 4, 2, 130, 260, "bfloat16", True, None),
    ("cross 260x130 causal, rows with no key", 4, 2, 260, 130, "float16",
     True, None),
    ("70x150 scattered key mask, an item with none", 6, 2, 70, 150,
     "bfloat16", False, "dead"),
    ("63x65 scattered key mask", 2, 1, 63, 65, "float16", False,
     "scattered"),
    ("64 rows against one key", 4, 2, 64, 1, "bfloat16", False, None),
    ("one query row against 300 keys", 4, 2, 1, 300, "float16", False,
     "scattered"),
    ("DeiT-B/16 198 tokens", 48, 12, 198, 198, "bfloat16", False, None),
    ("causal 129x129", 6, 3, 129, 129, "bfloat16", True, None),
]
# K3a's second timed shape at head size 32: DeiT-B/16's 198 tokens over
# 1536 heads of 32 columns (bn, n_heads, t)
NARROW_SHAPE = (1536, 12, 198)
PLAIN_HEADS = (2112,)
# tests/test_torch_cuda_kernels.py's WIDE_CASES: (b, n, tq, tk, causal,
# masked)
PLAIN_CASES = ((2, 2, 257, 257, True, True), (1, 2, 130, 260, True, False),
               (1, 2, 260, 130, True, False), (3, 2, 70, 150, False, True))


# K3a's and K3b's short kernels' shapes (head size 64, at most 256 keys and
# queries): (label, bn, n_heads, tq, tk, dtype name, causal, mask kind); the
# first four are timed
SHORT_CASES = [
    ("DeiT-B/16 198 tokens", 1536, 12, 198, 198, "bfloat16", False, None),
    ("DeiT-B/16 198 tokens", 1536, 12, 198, 198, "float16", False, None),
    ("served ViT-B/16 197", 384, 12, 197, 197, "bfloat16", False, None),
    ("served ViT-B/16 197", 384, 12, 197, 197, "float16", False, None),
    ("causal 250x120, rows with no key", 4, 2, 250, 120, "bfloat16", True,
     None),
    ("causal 100x256, key mask", 6, 2, 100, 256, "float16", True, "ragged"),
    ("198x198 scattered key mask, an item with none", 6, 3, 198, 198,
     "bfloat16", False, "dead"),
    ("causal 256x256, key mask", 8, 4, 256, 256, "bfloat16", True,
     "ragged"),
    ("64 rows against one key", 4, 2, 64, 1, "float16", False, None),
    ("causal 120x250, keys above every row", 4, 2, 120, 250, "bfloat16",
     True, None),
    ("causal 200x136, scattered key mask", 6, 2, 200, 136, "float16", True,
     "dead"),
    ("one query row against 200 keys", 4, 2, 1, 200, "bfloat16", False,
     "scattered"),
    ("193x193, a last query tile of one row", 3, 3, 193, 193, "float16",
     False, None),
]
SHORT_TIMED = 4


def time_short(torch, fa, libs, dev, bn, n, t, dtype, kernel="fwd"):
    """ms a launch of K3a (``kernel`` "fwd") or K3b ("dkv") of each library
    at ``[bn, t, 64]`` with no mask, in turns (other, this, this, other,
    three rounds), and once a round of ``F.scaled_dot_product_attention``
    on the same operands, its forward beside K3a and its whole backward
    (dQ, dK and dV) beside K3b: ``{library or "sdpa": [ms of each
    round]}``."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(19)
    h, scale = 64, 64 ** -0.5
    # q, k, v and o; for K3b q, k, v, do, dk and dv
    per_set = (4 if kernel == "fwd" else 6) * bn * t * h * 2
    sets = []
    for _ in range(max(2, -(-3 * 50 * 2 ** 20 // per_set))):  # 3 x the L2
        q, k, v, do = (torch.randn((bn, t, h), device=dev, generator=gen)
                       .to(dtype) for _ in range(4))
        if kernel == "fwd":
            sets.append((q, k, v, None, None, None, None))
            continue
        o, l, m = fa.flash_forward_plain(q, k, v, scale, False, None, n)
        sets.append((q, k, v, do, l, m, fa.delta(o, do)))
    l = torch.empty((bn, t, 1), dtype=torch.float32, device=dev)
    outs = (torch.empty_like(sets[0][0]), l, torch.empty_like(l),
            torch.empty_like(sets[0][1]), torch.empty_like(sets[0][2]))
    graphs = []  # SDPA's forward of each set, for its backward
    if kernel == "dkv":
        for q, k, v, do, *_ in sets:
            leaves = [x.view(bn // n, n, t, h).detach().requires_grad_()
                      for x in (q, k, v)]
            graphs.append((F.scaled_dot_product_attention(*leaves), leaves,
                           do.view(bn // n, n, t, h)))

    def timed(call):
        for i in range(len(sets)):
            call(i)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # queue the launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(30):
            call(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 30

    def sdpa(i):
        if kernel == "dkv":
            out, leaves, do = graphs[i % len(graphs)]
            return torch.autograd.grad(out, leaves, do, retain_graph=True)
        q, k, v = (x.view(bn // n, n, t, h) for x in sets[i % len(sets)][:3])
        return F.scaled_dot_product_attention(q, k, v)

    times = {"other": [], "this": [], "sdpa": []}
    for _ in range(3):
        for name in ("other", "this", "this", "other"):
            times[name].append(timed(
                lambda i, lib=libs[name]: launch_one(
                    torch, fa, lib, kernel,
                    (*sets[i % len(sets)], None, scale, False, n, outs))))
        times["sdpa"].append(timed(sdpa))
    del graphs
    return times


def close(got, ref, dtype):
    """Whether ``got`` is within the card tests' tolerance of ``ref``
    (``_assert_close`` there): bf16 rtol 2^-7, atol 2^-8 and a relative rms
    of 2^-8; float16 2^-10, 2^-10 and 2^-11; float32 statistics ``l, m``
    rtol 1e-5."""
    got, ref = got.float(), ref.float()
    if dtype is None:  # float32 row statistics
        return bool(((got - ref).abs() <= 1e-5 * ref.abs() + 1e-6).all())
    rtol, atol, rms = ((2.0 ** -10, 2.0 ** -10, 2.0 ** -11)
                       if dtype == "float16" else
                       (2.0 ** -7, 2.0 ** -8, 2.0 ** -8))
    d = (got - ref).abs()
    norm = float(ref.norm())
    return (float((d - rtol * ref.abs()).max()) <= atol
            and float(d.norm()) / (norm if norm else 1.0) <= rms)


def test_inputs(torch, dev, b, n, tq, tk, h, dtype, masked):
    """The card tests' ``_flash_inputs`` at seed 0: ``q, k, v, do`` and a
    scattered key mask whose last batch item keeps no key."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(t):
        return torch.randn((b * n, t, h), device=dev, generator=g).to(dtype)

    q, k, v, do = rand(tq), rand(tk), rand(tk), rand(tq)
    mask = None
    if masked:
        mask = (torch.rand((b, tk), device=dev, generator=g) > 0.3).float()
        mask[:, 0] = 1.0
        mask[-1] = 0.0
    return q, k, v, do, mask


def past_tolerance(got, ref):
    """The card tests' bf16 measure: the largest |got - ref| - 2^-7 |ref|,
    which they hold to 2^-8."""
    return float(((got.float() - ref.float()).abs()
                  - 2.0 ** -7 * ref.float().abs()).max())


def plain_errors(torch, fa, libs, dev):
    """For each case of ``PLAIN_CASES`` at each of ``PLAIN_HEADS``, in
    bf16: each library's dQ, dK, dV against the plain backward, by
    ``past_tolerance``, with the plain backward on the plain forward's ``o,
    l, m`` (``plain``, as the card test holds them) and on the library's
    own forward's (``own_forward``)."""
    out = []
    for h in PLAIN_HEADS:
        for b, n, tq, tk, causal, masked in PLAIN_CASES:
            q, k, v, do, mask = test_inputs(torch, dev, b, n, tq, tk, h,
                                            torch.bfloat16, masked)
            scale = h ** -0.5
            o_p, l_p, m_p = fa.flash_forward_plain(q, k, v, scale, causal,
                                                   mask, n)
            want = fa.flash_backward_plain(q, k, v, o_p, l_p, m_p, do, scale,
                                           causal, mask, n)
            case = {"case": [b, n, tq, tk, h], "causal": causal,
                    "masked": masked, "atol": 2.0 ** -8}
            for key, lib in libs.items():
                got = run(torch, fa, lib, q, k, v, do, mask, scale, causal, n)
                own = fa.flash_backward_plain(q, k, v, got["o"], got["l"],
                                              got["m"], do, scale, causal,
                                              mask, n)
                case[key] = {
                    ref_name: {x: past_tolerance(got[x], r)
                               for x, r in zip(("dq", "dk", "dv"), refs)}
                    for ref_name, refs in (("plain", want),
                                           ("own_forward", own))}
            out.append(case)
            print(f"plain at [{b * n}, {tq}x{tk}, {h}] bf16 causal {causal} "
                  f"masked {masked}: "
                  + "; ".join(f"{key} {case[key]}" for key in libs),
                  flush=True)
    return out


def time_both(torch, fa, libs, dev, h, dtype=None,
              kernels=("fwd", "dkv", "dq"), shape=None, masked=True,
              causals=(False, True), sdpa=False):
    """ms a launch of ``kernels`` of K3a-c of each library at ``[128 * 64
    / h, 512, h]`` in ``dtype`` (bf16 unless given; the train step's tokens
    and FLOPs; above 256 ``[16, 512, h]``, its tokens over one head), or at
    ``shape`` = ``(bn, n_heads, t)``, with a ragged key mask if ``masked``,
    at each of ``causals``, each library on operands padded to the size it
    runs the kernel at: ``{kernel/causal: {library: [ms of each
    round]}}``. With ``sdpa``, each kernel without the causal mask also
    times ``F.scaled_dot_product_attention`` on the same operands and key
    mask once a round (``"sdpa"``): its forward beside K3a, its whole
    backward (dQ, dK and dV) beside K3b and K3c."""
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(16)
    bn, n, t = shape or (max(16, 128 * 64 // h), max(1, 512 // h), 512)
    keep = t * (0.7 + 0.1 * torch.rand((bn // n, 1), device=dev,
                                       generator=gen))
    mask = ((torch.arange(t, device=dev) < keep.long()).float() if masked
            else None)
    sets = []
    for _ in range(3):  # 3 x 34 MB: beyond the L2
        q, k, v, do = (torch.randn((bn, t, h), device=dev, generator=gen)
                       .to(dtype) for _ in range(4))
        o, l, m = fa.flash_forward_plain(q, k, v, h ** -0.5, False, mask,
                                         n)
        sets.append((q, k, v, do, l, m, fa.delta(o, do), mask, h ** -0.5))
    size = {name: {kernel: head_size(torch, fa, lib, kernel, h, dtype)
                   for kernel in ("fwd", "dkv", "dq")}
            for name, lib in libs.items()}
    padded = {}  # (set, head size): q, k, v, do padded to it
    for i, (q, k, v, do, *_) in enumerate(sets):
        for n_cols in {x for by in size.values() for x in by.values()}:
            padded[i, n_cols] = tuple(fa.pad_head(x, n_cols).contiguous()
                                      for x in (q, k, v, do))
    # the outputs, written by every launch: o, l, m, dk, dv, dq
    outs = {n_cols: (torch.empty_like(x[0]), torch.empty_like(l),
                     torch.empty_like(m), torch.empty_like(x[1]),
                     torch.empty_like(x[2]), torch.empty_like(x[0]))
            for (i, n_cols), x in padded.items() if i == 0}
    def timed(call):
        for i in range(3):
            call(i)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)  # queue the launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(30):
            call(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 30

    def sdpa_forward(i, grad=False):
        q, k, v = (x.view(bn // n, n, t, h).detach().requires_grad_(grad)
                   for x in sets[i % 3][:3])
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=None if mask is None
            else mask.bool()[:, None, None, :]), (q, k, v)

    graphs = []  # SDPA's forward of each set, for its backward

    def library_call(i, kernel):
        if kernel == "fwd":
            return sdpa_forward(i)[0]
        out, leaves, do = graphs[i % 3]
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    if sdpa and set(kernels) - {"fwd"}:
        for i in range(3):
            graphs.append((*sdpa_forward(i, True),
                           sets[i][3].view(bn // n, n, t, h)))

    times = {}
    for kernel in kernels:
        for causal in causals:
            key = f"{kernel}{' causal' if causal else ''}"
            with_sdpa = sdpa and not causal
            times[key] = {"other": [], "this": [],
                          **({"sdpa": []} if with_sdpa else {})}
            for _ in range(3):
                for name in ("other", "this", "this", "other"):
                    n_cols = size[name][kernel]

                    def call(i, lib=libs[name], n_cols=n_cols):
                        launch_one(torch, fa, lib, kernel,
                                   (*padded[i % 3, n_cols], *sets[i % 3][4:],
                                    causal, n, outs[n_cols]))

                    times[key][name].append(timed(call))
                if with_sdpa:
                    times[key]["sdpa"].append(timed(
                        lambda i, kernel=kernel: library_call(i, kernel)))
    del graphs
    return times


def forward_near_plain(torch, fa, got, q, k, v, mask, causal, n):
    """Whether K3a's ``o, l, m`` in ``got`` are within the card tests'
    tolerances of ``flash_forward_plain`` on the same inputs
    (``_hold_kernels_to_plain``: ``o`` by ``_assert_close``'s measure,
    ``m`` rtol 1e-5, atol 1e-5, ``l`` rtol 1e-4, atol 1e-6), with the
    largest difference of each."""
    o, l, m = fa.flash_forward_plain(q, k, v, q.shape[-1] ** -0.5, causal,
                                     mask, n)
    type_name = str(q.dtype).split(".")[-1]
    ok = (close(got["o"], o, type_name)
          and bool(torch.allclose(got["m"], m, rtol=1e-5, atol=1e-5))
          and bool(torch.allclose(got["l"], l, rtol=1e-4, atol=1e-6)))
    return ok, {x: float((got[x].float() - ref.float()).abs().max())
                for x, ref in (("o", o), ("l", l), ("m", m))}


def hold_cases(torch, fa, libs, dev, items, against_plain=False):
    """Run each ``((label, bn, n, tq, tk, dtype, causal, mask kind), h)``
    of ``items`` through both libraries on the same seeded inputs: a report
    a case, and whether every output is the same bits (up to head size 256)
    or within the card tests' tolerance (above it). With
    ``against_plain`` (K3a where the two libraries' kernels sum the score
    products in other orders, each an approximation of the same sums) the
    verdict is instead whether this library's forward is within the card
    tests' tolerances of the plain version (``forward_near_plain``); the
    differences from the other library are reported all the same."""
    gen = torch.Generator(device=dev).manual_seed(15)
    report, same = [], True
    for (label, bn, n, tq, tk, dtype, causal, kind), h in items:
        q, do = (torch.randn((bn, tq, h), device=dev, generator=gen)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((bn, tk, h), device=dev, generator=gen)
                .to(dtype) for _ in range(2))
        b = bn // n
        mask = None
        if kind == "ragged":
            keep = tk * (0.7 + 0.1 * torch.rand((b, 1), device=dev,
                                                generator=gen))
            mask = (torch.arange(tk, device=dev) < keep.long()).float()
        elif kind in ("scattered", "dead"):
            mask = (torch.rand((b, tk), device=dev, generator=gen)
                    > 0.3).float()
            mask[:, 0] = 1.0
            if kind == "dead":  # the last batch item keeps no key
                mask[-1] = 0.0
        outs = {key: run(torch, fa, lib, q, k, v, do, mask, h ** -0.5,
                         causal, n)
                for key, lib in libs.items()}
        type_name = str(dtype).split(".")[-1]
        differ = [x for x in outs["this"]
                  if not torch.equal(outs["this"][x], outs["other"][x])]
        beyond = differ if h <= 256 else [
            x for x in differ
            if not close(outs["this"][x], outs["other"][x],
                         None if x in ("l", "m") else type_name)]
        entry = {"case": label, "shape": [bn, tq, tk, h],
                 "dtype": type_name, "bit_equal": not differ,
                 "differing": differ, "beyond_tolerance": beyond,
                 "max_abs_diff": {
                     x: float((outs["this"][x].float()
                               - outs["other"][x].float()).abs().max())
                     for x in differ}}
        verdict = ""
        if against_plain:
            near, err = forward_near_plain(torch, fa, outs["this"], q, k, v,
                                           mask, causal, n)
            same = same and near
            entry.update(forward_near_plain=near, forward_plain_err=err)
            verdict = (f"; this library's forward within the card tests' "
                       f"tolerances of the plain version: {near} ({err})")
        else:
            same = same and not beyond
        report.append(entry)
        print(f"{label} [{bn}, {tq}x{tk}, {h}] {type_name}: "
              + ("bit-equal" if not differ else
                 f"differ in {differ}, beyond tolerance in {beyond}")
              + verdict, flush=True)
    return report, same


def main(other, only=None):
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chambers_tpu_torch.ops import _build
    from chambers_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("compare_flash_builds: no CUDA device", file=sys.stderr)
        return 2
    name, sources, flags = fa.LIBRARY
    csrc = Path(other).resolve() / "chambers_tpu_torch" / "ops" / "csrc"
    libs = {"this": load(_build.build(name, sources, flags)),
            "other": load(_build.compile_library(
                name, [csrc / s for s in sources], flags, _build._nvcc))}
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    # (label, bn, n_heads, tq, tk, dtype, causal, mask kind)
    cases = [
        ("seq2seq step, key mask", 128, 8, 512, 512, bf16, False, "ragged"),
        ("seq2seq step, causal + key mask", 128, 8, 512, 512, bf16, True,
         "ragged"),
        ("ViT-B/16 197 tokens", 24, 12, 197, 197, bf16, False, None),
        ("cross 130x260 causal", 2, 2, 130, 260, bf16, True, None),
        ("cross 260x130 causal", 2, 2, 260, 130, bf16, True, None),
        ("63x65 scattered key mask", 2, 1, 63, 65, bf16, False,
         "scattered"),
        ("one query row, 512 keys", 128, 8, 1, 512, bf16, False, "ragged"),
        ("one query row, 300 keys", 4, 2, 1, 300, bf16, False, "scattered"),
        ("float32, 197 tokens", 6, 3, 197, 197, f32, False, None),
        ("float32, cross 130x260 causal, key mask", 4, 2, 130, 260, f32,
         True, "scattered"),
    ]
    f16 = torch.float16
    wide_cases = [
        ("seq2seq step over one head, key mask", 16, 1, 512, 512, bf16,
         False, "ragged"),
        ("seq2seq step over one head, causal + key mask", 16, 1, 512, 512,
         bf16, True, "ragged"),
        ("float16, one head, causal + key mask", 16, 1, 512, 512, f16,
         True, "ragged"),
        ("cross 130x260 causal", 2, 2, 130, 260, bf16, True, None),
        ("cross 260x130 causal", 2, 2, 260, 130, bf16, True, None),
        ("63x65 scattered key mask", 2, 1, 63, 65, f16, False, "scattered"),
    ]
    short_cases = [(label, bn, n, tq, tk, getattr(torch, dtype), causal,
                    kind)
                   for label, bn, n, tq, tk, dtype, causal, kind
                   in SHORT_CASES]
    narrow_cases = [(label, bn, n, tq, tk, getattr(torch, dtype), causal,
                     kind)
                    for label, bn, n, tq, tk, dtype, causal, kind
                    in NARROW_CASES]
    # each part: the cases it holds, and what it times (keys of the JSON
    # line); --only runs one part, no flag every part, the cases at HEADS,
    # the plain versions' distances and K3a-c's times at HEADS and
    # WIDE_HEADS besides
    parts = {
        "short": ([(case, 64) for case in short_cases],
                  lambda: {"short_times_ms": time_short_cases(
                      torch, fa, libs, dev, short_cases[:SHORT_TIMED])}),
        "narrow": ([(case, h) for h in NARROW_HEADS for case in narrow_cases],
                   lambda: {"narrow_times_ms": time_narrow(torch, fa, libs,
                                                           dev)}),
        "wide": ([(case, h) for h in WIDE_HEADS for case in wide_cases],
                 lambda: {"times_ms": time_heads(
                     torch, fa, libs, dev, WIDE_HEADS, (bf16, f16),
                     ("fwd",))}),
        "cluster": ([(case, h) for h in CLUSTER_HEADS
                     for case in wide_cases + [
                         ("one query row, 512 keys", 16, 1, 1, 512, bf16,
                          False, "ragged")]],
                    lambda: {"times_ms": time_heads(
                        torch, fa, libs, dev, CLUSTER_HEADS, (bf16, f16),
                        ("fwd",), sdpa=True)}),
        "producer": ([(case, 128) for case in cases],
                     lambda: {"times_ms": time_heads(
                         torch, fa, libs, dev, (128,), (bf16, f16),
                         ("dkv",))}),
        "producer256": ([(case, 256) for case in cases],
                        lambda: {"times_ms": time_heads(
                            torch, fa, libs, dev, (256,), (bf16, f16),
                            ("dkv",), sdpa=True)}),
        "dq_cluster": ([(case, h) for h in DQ_CLUSTER_HEADS
                        for case in wide_cases],
                       lambda: {"times_ms": time_heads(
                           torch, fa, libs, dev, DQ_CLUSTER_HEADS,
                           (bf16, f16), ("dq",), sdpa=True)}),
    }
    against_plain = only == "cluster"
    if only:
        items, timed = parts[only]
    else:
        items = [(case, h) for h in HEADS for case in cases] + [
            x for part in ("wide", "short", "narrow") for x in parts[part][0]]

        def timed():
            return {**parts["narrow"][1](), **parts["short"][1](),
                    "plain": plain_errors(torch, fa, libs, dev),
                    "times_ms": time_heads(torch, fa, libs, dev,
                                           HEADS + WIDE_HEADS, (bf16,),
                                           ("fwd", "dkv", "dq"))}
    report, same = hold_cases(torch, fa, libs, dev, items, against_plain)
    results = {"plain": [], "times_ms": {}, "short_times_ms": {},
               "narrow_times_ms": {}, **timed()}
    print(json.dumps({"compare_flash_builds": report, **results,
                      "other": str(other),
                      "card": torch.cuda.get_device_name(0),
                      "same_within_tolerance": same}))
    return 0 if same else 1


def time_turns(torch, fa, dirs, heads, kernel):
    """``kernel`` of the libraries built from each of ``dirs`` (checkouts),
    the first this one, in turns (each in order, then in reverse, two
    rounds) at ``[16, 512, h]`` bf16 (up to h 256 the train step's
    ``[128 * 64 / h, 512, h]``) with the ragged key mask, causal and not:
    prints each library's largest difference from the first's output and
    its median µs and rounds; returns ``{label: {dir: [µs]}}``."""
    from chambers_tpu_torch.ops import _build

    name, sources, flags = fa.LIBRARY
    libs = {}
    for d in dirs:
        csrc = Path(d).resolve() / "chambers_tpu_torch" / "ops" / "csrc"
        libs[d] = load(_build.compile_library(
            name, [csrc / x for x in sources], flags, _build._nvcc))
    dev = torch.device("cuda")
    times = {}
    for h in heads:
        for causal in (False, True):
            gen = torch.Generator(device=dev).manual_seed(16)
            bn, n, t = ((16, 1, 512) if h > 256 else
                        (128 * 64 // h, 512 // h, 512))
            keep = t * (0.7 + 0.1 * torch.rand((bn // n, 1), device=dev,
                                               generator=gen))
            mask = (torch.arange(t, device=dev) < keep.long()).float()
            sets = []
            for _ in range(3):
                q, k, v, do = (torch.randn((bn, t, h), device=dev,
                                           generator=gen).bfloat16()
                               for _ in range(4))
                o, l, m = fa.flash_forward_plain(q, k, v, h ** -0.5, False,
                                                 mask, n)
                sets.append((q, k, v, do, l, m, fa.delta(o, do), mask,
                             h ** -0.5))
            outs = (torch.empty_like(q), torch.empty_like(l),
                    torch.empty_like(m), torch.empty_like(k),
                    torch.empty_like(v), torch.empty_like(q))
            at = {"fwd": 0, "dkv": 3, "dq": 5}[kernel]
            first = None
            for d, lib in libs.items():
                launch_one(torch, fa, lib, kernel, (*sets[0], causal, n, outs))
                torch.cuda.synchronize()
                got = outs[at].clone()
                first = got if first is None else first
                print(f"  {d} h {h} causal {causal}: max |d| from "
                      f"{dirs[0]} {float((got.float() - first.float()).abs().max()):.3g}",
                      flush=True)
            label = f"{kernel} h {h}{' causal' if causal else ''}"
            times[label] = {d: [] for d in libs}
            for _ in range(2):
                for d in list(libs) + list(libs)[::-1]:
                    def call(i, lib=libs[d]):
                        launch_one(torch, fa, lib, kernel,
                                   (*sets[i % 3], causal, n, outs))

                    for i in range(3):
                        call(i)
                    torch.cuda.synchronize()
                    torch.cuda._sleep(50_000_000)  # queue the launches
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for i in range(30):
                        call(i)
                    end.record()
                    end.synchronize()
                    times[label][d].append(start.elapsed_time(end) / 30 * 1e3)
            for d, v in times[label].items():
                print(f"{label} {d}: {sorted(v)[len(v) // 2]:.1f} us "
                      f"({', '.join(f'{x:.1f}' for x in v)})", flush=True)
    return times


def rounds(by):
    """Each library's median ms and its rounds, as printed."""
    return ", ".join(f"{name} {sorted(v)[len(v) // 2] * 1e3:.1f} us "
                     f"(rounds {', '.join(f'{x * 1e3:.1f}' for x in v)})"
                     for name, v in by.items())


def time_narrow(torch, fa, libs, dev):
    """K3a at ``NARROW_SHAPE`` with no mask, and K3a-c at ``[256, 512,
    32]`` with the ragged key mask, causal and not, in bf16 and float16,
    each library at the head size its dispatch takes."""
    times = {}
    for dtype in (torch.bfloat16, torch.float16):
        type_name = str(dtype).split(".")[-1]
        for key, by in time_both(torch, fa, libs, dev, 32, dtype, ("fwd",),
                                 NARROW_SHAPE, masked=False,
                                 causals=(False,)).items():
            times[f"{key} h32 [1536, 198] {type_name}"] = by
            print(f"{key} [1536, 198, 32] {type_name} no mask: {rounds(by)}",
                  flush=True)
        for key, by in time_both(torch, fa, libs, dev, 32, dtype).items():
            kernel = key.split()[0]
            times[f"{key} h32 {type_name}"] = by
            print(f"{key} [256, 512, 32] {type_name} key mask, each library "
                  f"at its own head size (this "
                  f"{head_size(torch, fa, libs['this'], kernel, 32, dtype)}, "
                  f"other "
                  f"{head_size(torch, fa, libs['other'], kernel, 32, dtype)}"
                  f"): {rounds(by)}", flush=True)
    return times


def time_short_cases(torch, fa, libs, dev, timed_cases):
    """K3a and K3b at each of ``timed_cases`` (the first ``SHORT_CASES``)
    beside SDPA, with the bytes bound."""
    times = {}
    for kernel in ("fwd", "dkv"):
        for label, bn, n, t, _, dtype, _, _ in timed_cases:
            by = time_short(torch, fa, libs, dev, bn, n, t, dtype, kernel)
            type_name = str(dtype).split(".")[-1]
            times[f"{kernel} {label} [{bn}, {t}, 64] {type_name}"] = by
            # bytes the kernel must move: K3a q, k, v read, o written, l
            # and m; K3b q, k, v, do read, dk, dv written, l, m and di
            bound_us = ((4 * bn * t * 64 * 2 + 2 * bn * t * 4)
                        if kernel == "fwd" else
                        (6 * bn * t * 64 * 2 + 3 * bn * t * 4)) / 3.35e12 * 1e6
            print(f"{kernel} {label} [{bn}, {t}, 64] {type_name} no mask: "
                  f"{rounds(by)}; bytes bound {bound_us:.2f} us", flush=True)
    return times


def time_heads(torch, fa, libs, dev, heads, dtypes, kernels, sdpa=False):
    """``kernels`` of K3a-c at the train step's tokens at each of
    ``heads`` (``time_both``, with SDPA beside K3a if ``sdpa``), in each of
    ``dtypes``."""
    times = {}
    for h in heads:
        for dtype in dtypes:
            type_name = str(dtype).split(".")[-1]
            for key, by in time_both(torch, fa, libs, dev, h, dtype,
                                     kernels, sdpa=sdpa).items():
                times[f"{key} h{h} {type_name}"] = by
                print(f"{key} [{max(16, 128 * 64 // h)}, 512, {h}] "
                      f"{type_name} key mask: {rounds(by)}", flush=True)
    return times


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0])
    parser.add_argument("other", help="the other checkout")
    parser.add_argument("--only", choices=("short", "narrow", "wide",
                                           "cluster", "producer",
                                           "producer256", "dq_cluster"),
                        help="hold and time one part alone")
    parser.add_argument("--turns", help="time one kernel of this, the "
                        "other and --also's libraries in turns at these "
                        "head sizes (comma-separated)")
    parser.add_argument("--kernel", default="fwd",
                        choices=("fwd", "dkv", "dq"))
    parser.add_argument("--also", default="",
                        help="more checkouts for --turns (comma-separated)")
    args = parser.parse_args()
    if args.turns:
        import torch

        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from chambers_tpu_torch.ops import flash_attention as fa

        if not torch.cuda.is_available():
            print("compare_flash_builds: no CUDA device", file=sys.stderr)
            sys.exit(2)
        print(torch.cuda.get_device_name(0), flush=True)
        times = time_turns(
            torch, fa, [str(Path(__file__).resolve().parent), args.other,
                        *[d for d in args.also.split(",") if d]],
            [int(h) for h in args.turns.split(",")], args.kernel)
        print(json.dumps({"turns_us": times,
                          "card": torch.cuda.get_device_name(0)}))
        sys.exit(0)
    sys.exit(main(args.other, args.only))
