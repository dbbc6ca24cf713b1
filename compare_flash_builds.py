#!/usr/bin/env python3
"""Hold this checkout's flash attention kernels bit-equal to another
checkout's, on one CUDA card.

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
two must be the same bits. Then it times each kernel of both libraries at
the train step's tokens at each head size, causal and not, with CUDA
events over launches queued behind a backlog, the two libraries in turns
(other, this, this, other, three rounds), on inputs cycled beyond the 50
MB L2. The libraries share the C interface that ``ops/flash_attention.py``
calls, for the types and head sizes both take.
Prints one JSON line last and exits non-zero on any difference.
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


def time_both(torch, fa, libs, dev, h):
    """ms a launch of K3a-c of each library at ``[128 * 64 / h, 512, h]``
    bf16 (the train step's tokens and FLOPs) with a ragged key mask, causal
    and not: ``{kernel/causal: {library: [ms of each round]}}``."""
    gen = torch.Generator(device=dev).manual_seed(16)
    bn, n, t = 128 * 64 // h, 512 // h, 512
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


def main(other):
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
    gen = torch.Generator(device=dev).manual_seed(15)
    report, same = [], True
    for (label, bn, n, tq, tk, dtype, causal, kind), h in (
            (case, h) for h in HEADS for case in cases):
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
        elif kind == "scattered":
            mask = (torch.rand((b, tk), device=dev, generator=gen)
                    > 0.3).float()
            mask[:, 0] = 1.0
        outs = {key: run(torch, fa, lib, q, k, v, do, mask, h ** -0.5,
                         causal, n)
                for key, lib in libs.items()}
        differ = [x for x in outs["this"]
                  if not torch.equal(outs["this"][x], outs["other"][x])]
        same = same and not differ
        report.append({"case": label, "shape": [bn, tq, tk, h],
                       "dtype": str(dtype).split(".")[-1],
                       "bit_equal": not differ, "differing": differ})
        print(f"{label} [{bn}, {tq}x{tk}, {h}] {str(dtype).split('.')[-1]}: "
              f"{'bit-equal' if not differ else f'differ in {differ}'}",
              flush=True)
    times = {}
    for h in HEADS:
        for key, by in time_both(torch, fa, libs, dev, h).items():
            times[f"{key} h{h}"] = by
            print(f"{key} [{128 * 64 // h}, 512, {h}] bf16 key mask: "
                  + ", ".join(
                      f"{name} {sorted(v)[len(v) // 2] * 1e3:.1f} us "
                      f"(rounds {', '.join(f'{x * 1e3:.1f}' for x in v)})"
                      for name, v in by.items()), flush=True)
    print(json.dumps({"compare_flash_builds": report, "times_ms": times,
                      "other": str(other),
                      "card": torch.cuda.get_device_name(0),
                      "bit_equal": same}))
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
