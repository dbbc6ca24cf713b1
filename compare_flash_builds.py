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
float16, and the edges of the short forward kernel: causal cross lengths
with rows that see no key, a scattered key mask whose last batch item
keeps none, one key, 256 keys) every output must be the same bits too, and
K3a is timed at the two ViT shapes in turns (other, this, this, other,
three rounds) beside ``F.scaled_dot_product_attention`` on the same
operands. The libraries share the C interface that
``ops/flash_attention.py`` calls, for the types and head sizes both take.
Prints one JSON line last and exits non-zero on any difference beyond
those.

    python3 compare_flash_builds.py OTHER_CHECKOUT --short

runs the ``SHORT_CASES`` and their times only.
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
    for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq):
        fn.restype = i32
    return lib


def run(torch, fa, lib, q, k, v, do, mask, scale, causal, n_heads):
    """K3a, then K3b and K3c on K3a's own ``o, l, m``, through ``lib``:
    ``{name: output}``."""
    from chambers_tpu_torch.ops import _build

    ptr = _build.ptr
    bn, tq, h = q.shape
    tail = (bn, tq, k.shape[1], h, n_heads, float(scale), int(causal),
            fa.DTYPES[q.dtype], _build.stream(q.device))
    o = torch.empty_like(q)
    l = torch.empty((bn, tq, 1), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    codes = [lib.flash_fwd(ptr(q), ptr(k), ptr(v), ptr(mask), ptr(o),
                           ptr(l), ptr(m), *tail)]
    di = fa.delta(o, do)
    dk, dv, dq = (torch.empty_like(x) for x in (k, v, q))
    codes.append(lib.flash_bwd_dkv(ptr(q), ptr(k), ptr(v), ptr(do), ptr(l),
                                   ptr(m), ptr(di), ptr(mask), ptr(dk),
                                   ptr(dv), *tail))
    codes.append(lib.flash_bwd_dq(ptr(q), ptr(k), ptr(v), ptr(do), ptr(l),
                                  ptr(m), ptr(di), ptr(mask), ptr(dq),
                                  *tail))
    if any(codes):
        raise RuntimeError(f"a launch failed: CUDA errors {codes}")
    torch.cuda.synchronize()
    return {"o": o, "l": l, "m": m, "dk": dk, "dv": dv, "dq": dq}


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
PLAIN_HEADS = (2112,)
# tests/test_torch_cuda_kernels.py's WIDE_CASES: (b, n, tq, tk, causal,
# masked)
PLAIN_CASES = ((2, 2, 257, 257, True, True), (1, 2, 130, 260, True, False),
               (1, 2, 260, 130, True, False), (3, 2, 70, 150, False, True))


# K3a's short kernel's shapes (head size 64, at most 256 keys and queries):
# (label, bn, n_heads, tq, tk, dtype name, causal, mask kind); the first
# four are timed
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
]
SHORT_TIMED = 4


def time_short(torch, fa, libs, dev, bn, n, t, dtype):
    """ms a launch of K3a of each library at ``[bn, t, 64]`` with no mask,
    in turns (other, this, this, other, three rounds), and of
    ``F.scaled_dot_product_attention`` on the same operands once a round:
    ``{library or "sdpa": [ms of each round]}``."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(19)
    h, scale = 64, 64 ** -0.5
    per_set = 4 * bn * t * h * 2  # q, k, v and o
    sets = []
    for _ in range(max(2, -(-3 * 50 * 2 ** 20 // per_set))):  # 3 x the L2
        sets.append(tuple(torch.randn((bn, t, h), device=dev, generator=gen)
                          .to(dtype) for _ in range(3)))
    l = torch.empty((bn, t, 1), dtype=torch.float32, device=dev)
    outs = (torch.empty_like(sets[0][0]), l, torch.empty_like(l))

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
        q, k, v = (x.view(bn // n, n, t, h) for x in sets[i % len(sets)])
        return F.scaled_dot_product_attention(q, k, v)

    times = {"other": [], "this": [], "sdpa": []}
    for _ in range(3):
        for name in ("other", "this", "this", "other"):
            times[name].append(timed(
                lambda i, lib=libs[name]: launch_one(
                    torch, fa, lib, "fwd",
                    (*sets[i % len(sets)], None, None, None, None, None,
                     scale, False, n, outs))))
        times["sdpa"].append(timed(sdpa))
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


def time_both(torch, fa, libs, dev, h):
    """ms a launch of K3a-c of each library at ``[128 * 64 / h, 512, h]``
    bf16 (the train step's tokens and FLOPs; above 256 ``[16, 512, h]``,
    its tokens over one head) with a ragged key mask, causal and not:
    ``{kernel/causal: {library: [ms of each round]}}``."""
    gen = torch.Generator(device=dev).manual_seed(16)
    bn, n, t = max(16, 128 * 64 // h), max(1, 512 // h), 512
    keep = t * (0.7 + 0.1 * torch.rand((bn // n, 1), device=dev,
                                       generator=gen))
    mask = (torch.arange(t, device=dev) < keep.long()).float()
    sets = []
    for _ in range(3):  # 3 x 34 MB: beyond the L2
        q, k, v, do = (torch.randn((bn, t, h), device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        o, l, m = fa.flash_forward_plain(q, k, v, h ** -0.5, False, mask,
                                         n)
        sets.append((q, k, v, do, l, m, fa.delta(o, do), mask, h ** -0.5))
    # the outputs, written by every launch: o, l, m, dk, dv, dq
    outs = (torch.empty_like(q), torch.empty_like(l), torch.empty_like(m),
            torch.empty_like(k), torch.empty_like(v), torch.empty_like(q))
    times = {}
    for kernel in ("fwd", "dkv", "dq"):
        for causal in (False, True):
            key = f"{kernel}{' causal' if causal else ''}"
            times[key] = {"other": [], "this": []}
            for _ in range(3):
                for name in ("other", "this", "this", "other"):
                    def call(i, lib=libs[name]):
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
                    times[key][name].append(start.elapsed_time(end) / 30)
    return times


def hold_cases(torch, fa, libs, dev, items):
    """Run each ``((label, bn, n, tq, tk, dtype, causal, mask kind), h)``
    of ``items`` through both libraries on the same seeded inputs: a report
    a case, and whether every output is the same bits (at ``HEADS`` and for
    the short cases) or within the card tests' tolerance (``WIDE_HEADS``)."""
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
        beyond = differ if h not in WIDE_HEADS else [
            x for x in differ
            if not close(outs["this"][x], outs["other"][x],
                         None if x in ("l", "m") else type_name)]
        same = same and not beyond
        report.append({"case": label, "shape": [bn, tq, tk, h],
                       "dtype": type_name, "bit_equal": not differ,
                       "differing": differ, "beyond_tolerance": beyond,
                       "max_abs_diff": {
                           x: float((outs["this"][x].float()
                                     - outs["other"][x].float()).abs().max())
                           for x in differ}})
        print(f"{label} [{bn}, {tq}x{tk}, {h}] {type_name}: "
              + ("bit-equal" if not differ else
                 f"differ in {differ}, beyond tolerance in {beyond}"),
              flush=True)
    return report, same


def main(other, short=False):
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
    items = [] if short else [(case, h) for h in HEADS for case in cases] + [
        (case, h) for h in WIDE_HEADS for case in wide_cases]
    items += [(case, 64) for case in short_cases]
    report, same = hold_cases(torch, fa, libs, dev, items)
    short_times = {}
    for label, bn, n, t, _, dtype, _, _ in short_cases[:SHORT_TIMED]:
        by = time_short(torch, fa, libs, dev, bn, n, t, dtype)
        type_name = str(dtype).split(".")[-1]
        short_times[f"fwd {label} [{bn}, {t}, 64] {type_name}"] = by
        # bytes K3a must move: q, k, v read, o written, l and m
        bound_us = (4 * bn * t * 64 * 2 + 2 * bn * t * 4) / 3.35e12 * 1e6
        print(f"fwd {label} [{bn}, {t}, 64] {type_name} no mask: "
              + ", ".join(
                  f"{key} {sorted(v)[len(v) // 2] * 1e3:.1f} us "
                  f"(rounds {', '.join(f'{x * 1e3:.1f}' for x in v)})"
                  for key, v in by.items())
              + f"; bytes bound {bound_us:.2f} us", flush=True)
    plain = [] if short else plain_errors(torch, fa, libs, dev)
    times = {}
    for h in () if short else HEADS + WIDE_HEADS:
        for key, by in time_both(torch, fa, libs, dev, h).items():
            times[f"{key} h{h}"] = by
            print(f"{key} [{max(16, 128 * 64 // h)}, 512, {h}] bf16 key "
                  "mask: "
                  + ", ".join(
                      f"{name} {sorted(v)[len(v) // 2] * 1e3:.1f} us "
                      f"(rounds {', '.join(f'{x * 1e3:.1f}' for x in v)})"
                      for name, v in by.items()), flush=True)
    print(json.dumps({"compare_flash_builds": report, "plain": plain,
                      "times_ms": times, "short_times_ms": short_times,
                      "other": str(other),
                      "card": torch.cuda.get_device_name(0),
                      "same_within_tolerance": same}))
    return 0 if same else 1


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) not in (1, 2) or (len(args) == 2 and args[1] != "--short"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
    sys.exit(main(args[0], short=len(args) == 2))
