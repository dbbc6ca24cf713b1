#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``chambers_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. In order, it:

1. prints the card's name and power limit;
2. builds the two CUDA libraries (``warp`` with ``--fmad=false``,
   ``flash_attention`` with FMAs, from its three sources and their header)
   from ``chambers_tpu_torch/ops/csrc`` with nvcc, both at once;
3. holds kernel K2 (the separable warp) bit-equal to its plain PyTorch
   version at ``[32, 224, 224, 3]``;
4. holds kernel K1 (the fused RandAugment round) bit-equal to its plain
   version with all five op classes, at magnitudes 10 and 9 and with
   per-image factors;
5. holds RandAugment(2, 10)'s two compositions (fused over K1, masked over
   K2) bit-equal on the same draws;
6. drives the main path — per-image RandAugment(2, 10) into ViT-B/16 in
   bf16 with bf16 scores, batch 32 at 224 px, random seeded weights, three
   timed runs of 20 steps — and
   the masked-composition path, each with the launch counters set to 0
   just before and read just after; checks the logits against float32
   references, times the steps with CUDA events and profiles three steps;
7. times K1, K2 and their plain versions at the main path's shapes;
8. holds the flash attention kernels K3a (forward), K3b (dK/dV) and K3c
   (dQ) against their plain versions, through ``flash_attention`` and its
   backward as the paths call them, at the train step's three uses
   (``[16, 8, 512, 64]`` bf16 with a ragged key mask, causal and not),
   ViT-B/16's shape, cross lengths 130 x 260 and 260 x 130 with the
   diagonal at the end, 63 x 65, 257 x 257 and 70 x 150 with key masks, one
   key, one query against 300 keys, and a batch item with no valid key, in
   bf16 (the tensor-core kernels) and in float32 (the FMA ones); two
   launches of each kernel must give the same bits, the profiler must show
   the tensor-core forward for bf16 and the FMA one for float32, and the
   two matrix products the bf16 backward is built from are held alone
   against ``torch.matmul``;
9. drives the second main path — the padded ``Seq2SeqTransformer`` train
   step with ``attention_impl="flash"`` at full width (vocabulary 1024,
   width 512, 8 heads, 4 + 4 layers, bf16, batch 16, lengths 512, 20-30%
   ragged padding, AdamW): first step's loss and logits against the dense
   attention path, 2 warm-up steps and three timed runs of 5 steps with
   the launch counters set to 0 just before and read just after, and a
   profile of two steps;
10. runs a ViT-B/16-wide, 2-layer ``VisionTransformer`` on the flash kernel
    against the dense path in float32;
11. times K3a-c at ``[128, 512, 64]`` bf16 beside their plain versions and
    ``F.scaled_dot_product_attention`` (a yardstick the port never calls),
    and their float32 instances (the FMA kernels) once;
12. prints one ``kernels`` JSON line with all five kernels, the card line,
    and last ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the last line. It
imports nothing of JAX or of ``chambers_tpu``.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

BATCH, SIZE = 32, 224
WARMUP, STEPS, REPEATS, MASKED_STEPS = 3, 20, 3, 5
FILL, PAD = 128, 32
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
# the seq2seq train step, as the JAX package's tools/bench_seq2seq_flash.py
S2S = dict(vocab=1024, t=512, batch=16, dim=512, heads=8, layers=4)
S2S_WARMUP, S2S_STEPS, S2S_REPEATS = 2, 5, 3
CARD = ""
# a flash kernel's name in a profiler key, mangled or not
FLASH_KERNEL = r"(flash_(?:fwd|bwd_dkv|bwd_dq)(?:_tc)?_kernel)"


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(*parts):
    print(*parts, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, backlog=False):
    """Mean ms per call of ``fn`` over ``iters`` calls, by CUDA events,
    after a short warm-up. With ``backlog`` the card first spins for ~30 ms
    so that all ``iters`` launches are queued before the first runs: the
    events then time the kernels back to back, not the host's launch
    rate."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if backlog:
        torch.cuda._sleep(50_000_000)  # GPU clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def warp_matrices(torch, iops, b, device):
    """Identity, ±30° rotations, ±0.3 shears, ±100 px translations and a
    1000 px translation that fills everything, cycled over the batch."""
    rad = math.radians(30.0)
    kinds = [
        iops.identity_matrices(1, device),
        iops.rotation_matrices(torch.tensor([rad], device=device), SIZE, SIZE),
        iops.rotation_matrices(torch.tensor([-rad], device=device), SIZE,
                               SIZE),
    ]
    for build in (iops.shear_x_matrices, iops.shear_y_matrices):
        kinds += [build(torch.tensor([v], device=device)) for v in (.3, -.3)]
    for build in (iops.translate_x_matrices, iops.translate_y_matrices):
        kinds += [build(torch.tensor([v], device=device)) for v in (100., -100.)]
    kinds.append(iops.translate_x_matrices(torch.tensor([1000.0],
                                                        device=device)))
    return torch.cat([kinds[i % len(kinds)] for i in range(b)])


def kernel_name(mangled):
    """``_ZN..16flash_fwd_kernelIfLi64EE..`` -> ``flash_fwd_kernel<f32,
    64>``, ``..flash_bwd_dq_tc_kernelILi2EE..`` -> ``flash_bwd_dq_tc_kernel<2
    warpgroups>``; a name it cannot read comes back as it is."""
    found = re.search(r"\d{2}([a-z][a-z_]*_kernel)(?:I(\w+?)Li(\d+)E)?",
                      mangled)
    if not found:
        return mangled
    if not found.group(2):
        groups = re.search(r"_kernelILi(\d)EE", mangled)
        return found.group(1) + (f"<{groups.group(1)} warpgroups>"
                                 if groups else "")
    dtype = "bf16" if "bfloat" in found.group(2) else "f32"
    return f"{found.group(1)}<{dtype}, {found.group(3)}>"


def max_abs_diff(a, b):
    return int((a.int() - b.int()).abs().max())


def ragged_mask(torch, b, t, dev, seed=0):
    """``[b, t]`` bool key mask with 20-30% trailing padding per row."""
    import numpy as np

    rng = np.random.RandomState(seed)
    keep = (t * (0.70 + 0.10 * rng.rand(b))).astype(int)
    return torch.arange(t, device=dev)[None, :] < torch.tensor(
        keep, device=dev)[:, None]


def scattered_mask(torch, b, t, dev, seed):
    """``[b, t]`` bool key mask that drops about 30% of the keys anywhere
    and keeps the first."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    keep = torch.rand((b, t), device=dev, generator=gen) > 0.3
    keep[:, 0] = True
    return keep


def closeness(got, ref, rtol):
    """``(max |d|, max (|d| - rtol |ref|), ||d|| / ||ref||)`` of two tensors,
    in float32: the largest error, the absolute tolerance that an
    element-wise check at ``rtol`` needs, and the relative rms error."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    norm = float(ref.norm())
    return (float(d.max()), float((d - rtol * ref.abs()).max()),
            float(d.norm()) / norm if norm else float(d.norm()))


def flash_tolerance(torch, dtype, ref, gradient):
    """``(rtol, atol, rms)``: each element is held to ``|d| <= atol + rtol
    |ref|`` and the relative rms error to ``rms``.

    float32: kernel and plain version sum in another order; 2e-5 on outputs
    as the JAX package's tests hold its kernel, gradients 1e-4 of their
    largest value, and 1e-5 rms (a few hundred float32 roundings).

    bf16: rtol is one step of the output type (2^-7 of the value at most):
    the two round the same float32 sum, up to its order, to neighbouring
    values. atol is for the probabilities, which the kernel rounds to bf16
    at the running max and the plain version at the final one: every term
    p v moves by up to 2^-9 of itself on each side, and the weights sum to
    one over values of size ~1, so 2^-8. A gradient takes the same: its
    di = sum(o do) comes from the kernel's own o. Rounding errors are spread
    evenly, so their rms is under half a step: 2^-8 of the reference's rms
    catches a fault in the low bits that no maximum can."""
    if dtype == torch.float32:
        atol = 1e-4 * max(1.0, float(ref.abs().max())) if gradient else 2e-5
        return 0.0, atol, 1e-5
    return 2.0 ** -7, 2.0 ** -8, 2.0 ** -8


def check_flash_kernels(torch, fa, dev):
    """Phase 8: K3a-c against their plain versions on the card, through the
    wrapper the paths call: ``flash_attention`` forward and its backward,
    so the operand checks and copies, the fold, the scale's reciprocal and
    the chain of saved tensors (the backward kernels read the forward
    kernel's own o, l, m) are held as well. Returns the max abs errors at
    the train step's shape, by kernel."""
    f32, bf16 = torch.float32, torch.bfloat16
    b, n, t, h = S2S["batch"], S2S["heads"], S2S["t"], 64
    path_mask = ragged_mask(torch, b, t, dev)
    dead = path_mask[:2].clone()
    dead[1] = False
    # (label, b, n, tq, tk, dtype, causal, mask, layout of q, k, v)
    cases = [
        ("path: encoder self / cross, key mask", b, n, t, t, bf16, False,
         path_mask, "permuted"),
        ("path: decoder self, causal + key mask", b, n, t, t, bf16, True,
         path_mask, "stacked"),
        ("ViT-B/16 shape bf16", 2, 12, 197, 197, bf16, False, None, "plain"),
        ("ViT shape float32", 2, 3, 197, 197, f32, False, None, "stacked"),
        ("cross lengths 130x260 causal float32", 1, 2, 130, 260, f32, True,
         None, "plain"),
        ("cross lengths 260x130 causal float32, 130 rows with no key", 1, 2,
         260, 130, f32, True, None, "plain"),
        ("batch item with no valid key", 2, n, t, t, bf16, False, dead,
         "permuted"),
        # the same edges for the bf16 backward kernels
        ("cross lengths 130x260 causal bf16", 1, 2, 130, 260, bf16, True,
         None, "plain"),
        ("cross lengths 260x130 causal bf16, 130 rows with no key", 1, 2,
         260, 130, bf16, True, None, "plain"),
        ("63x65 bf16, key mask", 2, 1, 63, 65, bf16, False,
         scattered_mask(torch, 2, 65, dev, 11), "plain"),
        ("257x257 causal bf16, key mask", 2, 5, 257, 257, bf16, True,
         scattered_mask(torch, 2, 257, dev, 12), "stacked"),
        ("70x150 bf16, key mask", 3, 2, 70, 150, bf16, False,
         scattered_mask(torch, 3, 150, dev, 13), "permuted"),
        ("one key bf16", 2, 2, 64, 1, bf16, False, None, "plain"),
        ("one query against 300 keys bf16, key mask", 2, 2, 1, 300, bf16,
         False, scattered_mask(torch, 2, 300, dev, 14), "plain"),
    ]
    gen = torch.Generator(device=dev).manual_seed(1)
    path_err = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for label, b_, n_, tq, tk, dtype, causal, mask, layout in cases:
        def rand(tt):
            if layout == "permuted":  # as a projection's einsum may hand over
                return torch.randn((b_, tt, n_, h), device=dev,
                                   generator=gen).to(dtype).permute(0, 2, 1, 3)
            return torch.randn((b_, n_, tt, h), device=dev,
                               generator=gen).to(dtype)

        if layout == "stacked":  # slices of one self-attention projection
            q, v, k = torch.randn((3, b_, n_, tq, h), device=dev,
                                  generator=gen).to(dtype)
        else:
            q, v, k = rand(tq), rand(tk), rand(tk)
        do = rand(tq)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = fa.flash_attention(q, v, k, causal=causal, kv_mask=mask)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
        again = torch.autograd.grad(o, (q, k, v), do)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
              f"the backward kernels repeat ({label})")

        def fold(x):
            return x.detach().reshape(b_ * n_, x.shape[2], h)

        fq, fk, fv, fdo = fold(q), fold(k), fold(v), fold(do)
        fmask = None if mask is None else mask.float()
        scale = h ** -0.5
        o_p, l_p, m_p = fa.flash_forward_plain(fq, fk, fv, scale, causal,
                                               fmask, n_)
        dq_p, dk_p, dv_p = fa.flash_backward_plain(
            fq, fk, fv, o_p, l_p, m_p, fdo, scale, causal, fmask, n_)
        # the statistics the wrapper saved: the same launch gives them
        # again, to the bit, twice
        o_again, l, m = fa.launch_forward(fq, fk, fv, fmask, scale, causal, n_)
        third = fa.launch_forward(fq, fk, fv, fmask, scale, causal, n_)
        torch.cuda.synchronize()
        check(torch.equal(o_again, fold(o))
              and all(torch.equal(a, b) for a, b in zip(third,
                                                        (o_again, l, m))),
              f"the forward kernel repeats ({label})")

        pairs = {"o": (o, o_p), "dq": (dq, dq_p), "dk": (dk, dk_p),
                 "dv": (dv, dv_p)}
        errs, report = {}, []
        for name, (got, ref) in pairs.items():
            got = fold(got)
            check(got.dtype == dtype and tuple(got.shape) == tuple(ref.shape),
                  f"{name} has the inputs' type and shape ({label})")
            rtol, atol, rms_limit = flash_tolerance(torch, dtype, ref,
                                                    name != "o")
            errs[name], needs, rms = closeness(got, ref, rtol)
            check(needs <= atol, f"K3 {name} within atol {atol:.3g} + rtol "
                                 f"{rtol:.3g} per element ({label})")
            if tk == 1 and name in ("dq", "dk"):
                # With one key p = 1 and ds = do . v - di = 0: what is left
                # is the difference of two float32 sums of 64 products of
                # size ~1 taken in two orders, ~1e-6, on either side. A
                # relative error of that says nothing, so both are held to
                # 2e-5 in absolute value instead.
                top = max(float(got.abs().max()), float(ref.abs().max()))
                closeness_note = f"both |x| <= {top:.3g} <= 2e-05"
                check(top <= 2e-5, f"K3 {name} cancels to zero ({label})")
            else:
                closeness_note = f"rms {rms:.3g} <= {rms_limit:.3g}"
                check(rms <= rms_limit, f"K3 {name} rms error ({label})")
            report.append(
                f"{name} {errs[name]:.3g} (over rtol {max(needs, 0.0):.3g} "
                f"<= {atol:.3g}, {closeness_note})")
            check(bool(torch.isfinite(got).all()), f"finite {name} ({label})")
        log(f"K3 vs plain [{label}] [{b_ * n_}, {tq}x{tk}, {h}] "
            f"{str(dtype).split('.')[-1]} {layout}: max |d| "
            + ", ".join(report))
        check(bool(torch.isfinite(l).all()) and bool(torch.isfinite(m).all()),
              f"finite l, m ({label})")
        check(bool(torch.allclose(l, l_p, rtol=1e-4, atol=1e-6))
              and bool(torch.allclose(m, m_p, rtol=1e-5, atol=1e-5)),
              f"saved l, m agree ({label})")
        if mask is dead:  # batch item 1: rows n_ .. 2 n_ - 1 of l, m
            check(not any(bool(x[1].any()) for x in (o, dq, dk, dv))
                  and not bool(l[n_:].any())
                  and bool((m[n_:] == fa.MASK_VALUE).all()),
                  "a batch item with no valid key gives exact zeros, l = 0 "
                  "and m at the mask value")
        if causal and tq > tk:
            check(not bool(o[:, :, :tq - tk].any())
                  and not bool(dq[:, :, :tq - tk].any())
                  and not bool(l[:, :tq - tk].any())
                  and bool((m[:, :tq - tk] == fa.MASK_VALUE).all()),
                  "rows above the end-aligned diagonal give exact zeros, "
                  "l = 0 and m at the mask value")
        if label.startswith("path"):
            path_err["fwd"] = max(path_err["fwd"], errs["o"])
            path_err["dkv"] = max(path_err["dkv"], errs["dk"], errs["dv"])
            path_err["dq"] = max(path_err["dq"], errs["dq"])
    return path_err


def check_tile_products(torch, fa, dev):
    """The two matrix products of the bf16 backward kernels' tiling alone
    against ``torch.matmul``: ``x yᵀ`` from two tiles in shared memory, and
    its bf16 rounding times ``y`` read along its rows, with the first
    product's accumulator as the register operand. Holds the fragment
    layout, the swizzle and the descriptors apart from the softmax. Sums
    of 64 bf16 products in float32 in another order: 1e-5 of the largest
    value."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((128, 64), device=dev, generator=gen).bfloat16()
    y = torch.randn((64, 64), device=dev, generator=gen).bfloat16()
    nt, tn = fa.tile_products(x, y)
    torch.cuda.synchronize()
    nt_ref = x.float() @ y.float().T
    tn_ref = nt.bfloat16().float() @ y.float()
    for name, got, ref in (("x y^T", nt, nt_ref), ("bf16(x y^T) y", tn,
                                                   tn_ref)):
        d, top = float((got - ref).abs().max()), float(ref.abs().max())
        log(f"tile product {name} vs torch.matmul: max |d| {d:.3g} of "
            f"{top:.3g}")
        check(d <= 1e-5 * top, f"tile product {name} agrees with matmul")


def check_forward_kernel_names(torch, fa, dev):
    """Which kernel each type's forward launches, read from the profiler:
    bf16 runs ``flash_fwd_tc_kernel`` (tensor cores), float32
    ``flash_fwd_kernel`` (FMAs)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(8)
    for dtype, want, other in ((torch.bfloat16, "flash_fwd_tc_kernel",
                                "flash_fwd_kernel"),
                               (torch.float32, "flash_fwd_kernel",
                                "flash_fwd_tc_kernel")):
        q, k, v = (torch.randn((4, 96, 64), device=dev,
                               generator=gen).to(dtype) for _ in range(3))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.launch_forward(q, k, v, None, 0.125, False, 2)
            torch.cuda.synchronize()
        names = {found.group(1) for e in prof.key_averages()
                 if (found := re.search(FLASH_KERNEL, e.key))}
        log(f"profiler: {str(dtype).split('.')[-1]} forward runs "
            f"{sorted(names)}")
        check(want in names and other not in names,
              f"{str(dtype).split('.')[-1]} forward runs {want}")


def seq2seq_tokens(torch, dev):
    """Source and target tokens with 20-30% ragged trailing padding (id 0),
    as tools/bench_seq2seq_flash.py of the JAX package makes them."""
    import numpy as np

    rng = np.random.RandomState(0)
    b, t, vocab = S2S["batch"], S2S["t"], S2S["vocab"]
    src = rng.randint(1, vocab, (b, t)).astype(np.int64)
    tgt = rng.randint(1, vocab, (b, t)).astype(np.int64)
    for row in range(b):
        keep = int(t * (0.70 + 0.10 * rng.rand()))
        src[row, keep:] = 0
        tgt[row, keep:] = 0
    return torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)


def seq2seq_loss(torch, model, src, tgt):
    """Masked cross-entropy on the next token; padding labels excluded."""
    logits = model([src, tgt], deterministic=True)
    labels = torch.roll(tgt, -1, dims=1)
    mask = (labels != 0).float().flatten()
    ce = torch.nn.functional.cross_entropy(
        logits.float().flatten(0, 1), labels.flatten(), reduction="none")
    return (ce * mask).sum() / mask.sum(), logits


def device_time_by_kind(torch, events):
    """Self device time in ms of a profile, split into the flash kernels,
    matrix products and everything else, with the names of the flash
    kernels that ran under each of their kinds."""
    kinds = {"flash_fwd": 0.0, "flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0,
             "gemm": 0.0, "other": 0.0}
    counts = dict.fromkeys(kinds, 0)
    names = {k: set() for k in kinds}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = e.key.lower()
        kind = next((k for k in kinds if k in key), None)
        if kind is None:
            kind = "gemm" if any(w in key for w in (
                "gemm", "nvjet", "cutlass", "xmma", "cublas")) else "other"
        elif found := re.search(FLASH_KERNEL, key):
            names[kind].add(found.group(1))
        kinds[kind] += e.self_device_time_total / 1e3
        counts[kind] += e.count
    return kinds, counts, names


def seq2seq_path(torch, fa, dev):
    """Phase 9: the padded Seq2SeqTransformer train step on the flash
    kernels at full width. Returns the launch counts of the timed steps."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models import Seq2SeqTransformer

    def build(impl):
        model = Seq2SeqTransformer(
            input_vocab_size=S2S["vocab"], output_vocab_size=S2S["vocab"],
            embed_dim=S2S["dim"], num_heads=S2S["heads"],
            dim_feedforward=4 * S2S["dim"],
            num_encoder_layers=S2S["layers"],
            num_decoder_layers=S2S["layers"], dropout_rate=0.0,
            dtype=torch.bfloat16, attention_impl=impl, device=dev)
        return initializers.init_module(
            model, torch.Generator(device=dev).manual_seed(0)).train()

    model = build("flash")
    dense = build("xla")
    dense.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    src, tgt = seq2seq_tokens(torch, dev)
    vocab = S2S["vocab"]

    def tokens_of(i):
        # varied per step, padding kept
        return torch.where(src > 0, (src + i) % (vocab - 1) + 1, 0), tgt

    # first step's loss and logits against the dense attention path: both
    # models are bf16 with float32 softmax statistics and differ in where
    # the probabilities are rounded, so 1e-2 relative on the loss and a
    # cosine of 0.999 over the logits of the real (non-padding) positions
    with torch.no_grad():
        loss_f, logits_f = seq2seq_loss(torch, model, *tokens_of(0))
        loss_d, logits_d = seq2seq_loss(torch, dense, *tokens_of(0))
    real = (tgt != 0)
    a, b = logits_f[real].float().flatten(), logits_d[real].float().flatten()
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    rel = abs(float(loss_f) - float(loss_d)) / abs(float(loss_d))
    log(f"seq2seq first step, flash vs dense attention: loss "
        f"{float(loss_f):.5f} vs {float(loss_d):.5f} (rel {rel:.2e}), logits "
        f"cosine {cos:.6f}, max |d| {float((a - b).abs().max()):.4f}")
    check(tuple(logits_f.shape) == (S2S["batch"], S2S["t"], vocab),
          "logits [16, 512, 1024]")
    check(rel <= 1e-2 and cos >= 0.999,
          "flash train step's first loss and logits follow the dense path")
    del dense, logits_f, logits_d

    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4,
                            betas=(0.9, 0.999), eps=1e-8)

    def step(i):
        opt.zero_grad(set_to_none=True)
        loss, _ = seq2seq_loss(torch, model, *tokens_of(i))
        loss.backward()
        opt.step()
        return loss.detach()

    for i in range(S2S_WARMUP):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.flash_attention.launches:
        fa.flash_attention.launches[key] = 0
    losses, runs, host_runs = [], [], []
    for r in range(S2S_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses += [step(S2S_WARMUP + r * S2S_STEPS + i)
                   for i in range(S2S_STEPS)]
        end.record()
        end.synchronize()
        host_runs.append((time.perf_counter() - t0) * 1e3 / S2S_STEPS)
        runs.append(start.elapsed_time(end) / S2S_STEPS)
    launches = dict(fa.flash_attention.launches)
    n_steps = S2S_STEPS * S2S_REPEATS
    ms = sorted(runs)[len(runs) // 2]
    losses = [float(x) for x in losses]
    positions = S2S["batch"] * 2 * S2S["t"]
    real_tokens = int((src != 0).sum() + (tgt != 0).sum())
    log(f"seq2seq train step ({n_params / 1e6:.1f} M parameters, batch "
        f"{S2S['batch']}, {S2S['t']} + {S2S['t']} tokens a row, bf16): median "
        f"of {S2S_REPEATS} runs of {S2S_STEPS} steps {ms:.3f} ms/step (CUDA "
        f"events; runs {', '.join(f'{x:.3f}' for x in runs)}; host clock "
        f"{', '.join(f'{x:.3f}' for x in host_runs)}), "
        f"{positions / (ms / 1e3):.0f} tokens/s with padding, "
        f"{real_tokens / (ms / 1e3):.0f} without, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on {CARD}")
    log(f"seq2seq losses: {[round(x, 4) for x in losses]}; launches over "
        f"{n_steps} steps: {launches}")
    per_step = 3 * S2S["layers"]
    check(all(launches[k] == per_step * n_steps for k in launches),
          "K3a, K3b and K3c each launched 12 times per train step")
    check(all(math.isfinite(x) for x in losses), "finite losses")
    check(losses[-1] <= losses[0] * 1.02, "losses falling or flat")

    from torch.profiler import ProfilerActivity, profile

    n_prof = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_prof):
            step(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    log(events.table(sort_by="self_device_time_total", row_limit=12))
    kinds, counts, names = device_time_by_kind(torch, events)
    busy = sum(kinds.values()) / n_prof
    log(f"seq2seq profile, device ms per step on {CARD}: " + ", ".join(
        f"{' '.join([k, *sorted(names[k])])} {v / n_prof:.3f} "
        f"({counts[k] // n_prof} launches)" for k, v in kinds.items()))
    check(names["flash_fwd"] == {"flash_fwd_tc_kernel"},
          "the bf16 train step runs the tensor-core forward")
    log(f"seq2seq profile: {busy:.3f} ms of device time per step against "
        f"{ms:.3f} ms/step unprofiled: device busy {100 * busy / ms:.1f}%, "
        f"flash kernels {100 * sum(v for k, v in kinds.items() if 'flash' in k) / n_prof / ms:.1f}% "
        f"of a step, on {CARD}")
    return launches


def vit_on_flash(torch, fa, dev, images):
    """Phase 10: a ViT-B/16-wide VisionTransformer on the flash kernel
    against the dense path, float32, two layers."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    def build(impl):
        return VisionTransformer(16, 768, 2, 12, 3072, attention_impl=impl,
                                 device=dev)

    flash = initializers.init_module(
        build("flash"), torch.Generator(device=dev).manual_seed(2)).eval()
    dense = build("xla").eval()
    dense.load_state_dict(flash.state_dict())
    before = fa.flash_attention.launches["fwd"]
    with torch.inference_mode():
        x = images[:4].float() / 127.5 - 1.0
        got, want = flash(x), dense(x)
    torch.cuda.synchronize()
    count = fa.flash_attention.launches["fwd"] - before
    d = float((got - want).abs().max())
    log(f"ViT (width 768, 12 heads, 2 layers, 197 tokens) float32, flash vs "
        f"dense attention: max |d logit| {d:.3g} of range "
        f"{float(want.max() - want.min()):.3g}; {count} forward launches")
    check(count == 2, "one K3a launch per encoder layer")
    check(d < 1e-3 and bool(torch.isfinite(got).all()),
          "ViT on the flash kernel matches the dense path")


def time_flash_kernels(torch, fa, dev, launches, errors):
    """Phase 11: K3a-c at the train step's shape, [128, 512, 64] bf16 with
    the ragged key mask (encoder self-attention and cross attention: 8 of a
    step's 12 launches of each kernel; the causal use is timed beside it),
    and the float32 instances of K3a-c, which are other kernels, at
    the same shape. Returns the three rows of the ``kernels`` line."""
    F = torch.nn.functional
    b, n, t, h = S2S["batch"], S2S["heads"], S2S["t"], 64
    bn, scale = b * n, h ** -0.5
    mask = ragged_mask(torch, b, t, dev)
    fmask = mask.float()
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand():
        return torch.randn((bn, t, h), device=dev,
                           generator=gen).to(torch.bfloat16)

    # cycle over sets larger together than the 50 MB L2
    sets = []
    for _ in range(3):
        q, k, v, do = rand(), rand(), rand(), rand()
        o, l, m = fa.flash_forward_plain(q, k, v, scale, False, fmask, n)
        sets.append((q, k, v, do, o, l, m, fa.delta(o, do)))
    turn = iter(range(10 ** 9))

    def nxt():
        return sets[next(turn) % len(sets)]

    def bwd_args(causal):
        q, k, v, do, _, l, m, di = nxt()
        return (q, k, v, do, l, m, di, fmask, scale, causal, n)

    def plain_bwd():
        q, k, v, do, o, l, m, _ = nxt()
        return fa.flash_backward_plain(q, k, v, o, l, m, do, scale, False,
                                       fmask, n)

    def four(x):
        return x.view(b, n, t, h)

    attn_mask = mask[:, None, None, :]

    def sdpa():
        q, k, v = nxt()[:3]
        return F.scaled_dot_product_attention(four(q), four(k), four(v),
                                              attn_mask=attn_mask)

    q0, k0, v0, do0 = (four(x).clone().requires_grad_(i < 3)
                       for i, x in enumerate(sets[0][:4]))
    out0 = F.scaled_dot_product_attention(q0, k0, v0, attn_mask=attn_mask)

    def sdpa_bwd():
        return torch.autograd.grad(out0, (q0, k0, v0), do0,
                                   retain_graph=True)

    def wrapped():
        q, k, v = (four(x) for x in nxt()[:3])
        return fa.flash_attention(q, v, k, kv_mask=mask)

    # the float32 backward: one set (the inputs alone are 67 MB)
    q32, k32, v32, do32 = (x.float() for x in sets[0][:4])
    o32, l32, m32 = fa.flash_forward_plain(q32, k32, v32, scale, False, fmask,
                                           n)
    args32 = (q32, k32, v32, do32, l32, m32, fa.delta(o32, do32), fmask,
              scale, False, n)
    float32_ms = {
        "fwd": cuda_ms(torch, lambda: fa.launch_forward(
            q32, k32, v32, fmask, scale, False, n), 10, backlog=True),
        "dkv": cuda_ms(torch, lambda: fa.launch_backward_dkv(*args32), 10,
                       backlog=True),
        "dq": cuda_ms(torch, lambda: fa.launch_backward_dq(*args32), 10,
                      backlog=True)}
    del q32, k32, v32, do32, o32, l32, m32, args32
    source = {"fwd": "flash_attention_fwd.cu", "dkv": "flash_attention_bwd.cu",
              "dq": "flash_attention_bwd.cu"}

    elem = 2  # bytes of a bf16 value
    qkv = 3 * bn * t * h * elem
    stats = bn * t * 4                       # one float32 row statistic
    pairs = bn * t * t * h                   # multiply-adds of one product
    plain_fwd_ms = cuda_ms(torch, lambda: fa.flash_forward_plain(
        *nxt()[:3], scale, False, fmask, n), 10)
    plain_bwd_ms = cuda_ms(torch, plain_bwd, 10)
    lib_fwd_ms = cuda_ms(torch, sdpa, 20, backlog=True)
    lib_bwd_ms = cuda_ms(torch, sdpa_bwd, 20, backlog=True)
    wrapper_ms = cuda_ms(torch, wrapped, 20)
    specs = (
        ("flash_fwd", "fwd", lambda c: fa.launch_forward(
            *nxt()[:3], fmask, scale, c, n),
         qkv + bn * t * h * elem + 2 * stats + b * t * 4, 4 * pairs,
         "chambers_tpu/ops/flash_attention.py:190 _flash_forward",
         plain_fwd_ms, lib_fwd_ms),
        ("flash_bwd_dkv", "dkv", lambda c: fa.launch_backward_dkv(
            *bwd_args(c)),
         qkv + bn * t * h * elem + 3 * stats + b * t * 4
         + 2 * bn * t * h * elem, 8 * pairs,
         "chambers_tpu/ops/flash_attention.py:387 _flash_backward (dK/dV)",
         plain_bwd_ms, lib_bwd_ms),
        ("flash_bwd_dq", "dq", lambda c: fa.launch_backward_dq(
            *bwd_args(c)),
         qkv + bn * t * h * elem + 3 * stats + b * t * 4
         + bn * t * h * elem, 6 * pairs,
         "chambers_tpu/ops/flash_attention.py:418 _flash_backward (dQ)",
         plain_bwd_ms, lib_bwd_ms),
    )
    rows = []
    for name, key, bare, nbytes, ops, replaces, plain_ms, lib_ms in specs:
        kernel_ms = cuda_ms(torch, lambda: bare(False), 20, backlog=True)
        causal_ms = cuda_ms(torch, lambda: bare(True), 20, backlog=True)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        causal_bound_ms = max(bytes_ms, ops_ms / 2)
        rows.append({
            "name": name, "route": "cuda",
            "source": "chambers_tpu_torch/ops/csrc/" + source[key],
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errors[key], "bit_equal": False,
            "ms": kernel_ms, "plain_ms": plain_ms,
            "wrapper_ms": wrapper_ms if key == "fwd" else None,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms, "causal_ms": causal_ms,
            "causal_bound_ms": causal_bound_ms,
            "achieved_tflops": ops / (kernel_ms / 1e3) / 1e12,
            "float32_ms": float32_ms[key],
            "note": ("plain_ms and library_ms are the whole backward, dK/dV "
                     "and dQ together" if key != "fwd" else
                     "library_ms is F.scaled_dot_product_attention with the "
                     "same key mask"),
            "card": CARD,
        })
        log(f"{name} [128, 512, 64] bf16 key mask: kernel "
            f"{kernel_ms * 1e3:.1f} us ({rows[-1]['achieved_tflops']:.1f} "
            f"TFLOP/s), causal {causal_ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({rows[-1]['bound_by']}; causal "
            f"{causal_bound_ms * 1e3:.2f} us)"
            + f", float32 operands (the FMA kernel) "
              f"{float32_ms[key] * 1e3:.1f} us on {CARD}")
    log(f"flash_attention wrapper call, forward: {wrapper_ms * 1e3:.1f} us "
        f"on {CARD}")
    torch.cuda.synchronize()
    return rows


def main():
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chambers_tpu_torch.augmentations.augmentation_schemes import (
        RandAugment,
    )
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        ViTB16,
        VisionTransformer,
        fold_imagenet_normalization,
    )
    from chambers_tpu_torch.ops import _build
    from chambers_tpu_torch.ops import flash_attention as fa
    from chambers_tpu_torch.ops import image_ops as iops
    from chambers_tpu_torch.ops import warp_kernels as wk

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    # 1. the card
    CARD = card_line()
    log(f"card: {CARD} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")

    # 2. build
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(library):
        t0 = time.perf_counter()
        return _build.build(*library), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as jobs:  # one nvcc each, started together
        built = list(jobs.map(timed_build, (wk.LIBRARY, fa.LIBRARY)))
    log(f"build: {time.perf_counter() - t0:.1f} s for both libraries")
    no_fma = []
    for path, seconds in built:
        report = path.with_suffix(".log").read_text().splitlines()
        no_fma.append("--fmad=false" in report[0])  # the nvcc command line
        log(f"build: {seconds:.1f} s -> {path.name} "
            f"({'--fmad=false' if no_fma[-1] else 'FMAs allowed'})")
        kernel = spills = ""
        for line in report:
            if "Compiling entry" in line:
                kernel = kernel_name(line.split("'")[1])
            if "bytes spill" in line:
                spills = line.strip()
            if "registers" in line:
                log(f"  nvcc {kernel}: {line.split(':')[-1].strip()}; "
                    f"{spills}")
    check(no_fma == [True, False], "warp is built with --fmad=false, "
                                   "flash_attention with FMAs")

    def rand_images(n=BATCH):
        return torch.randint(0, 256, (n, SIZE, SIZE, 3), dtype=torch.uint8,
                             device=dev, generator=gen)

    results = {}

    # 3. K2 against its plain version
    imgs = rand_images()
    mats = warp_matrices(torch, iops, BATCH, dev)
    got = wk.transform_affine_separable(imgs, mats, FILL, PAD)
    n1, n2, n3 = wk._shift_vectors(mats, BATCH, SIZE, SIZE, PAD)
    want = wk.warp_plain(imgs, n1, n2, n3, FILL, PAD)
    torch.cuda.synchronize()
    k2_diff = int((got != want).sum())
    log(f"K2 vs plain: {k2_diff} differing bytes of {got.numel()}")
    check(k2_diff == 0, "K2 bit-equal to its plain version")
    check(bool((got[11] == FILL).all()), "1000 px translation fills all")
    results["warp"] = {"max_abs_err": max_abs_diff(got, want),
                       "bit_equal": True}

    # 4. K1 against its plain version: all five classes
    op_class = torch.arange(BATCH, device=dev, dtype=torch.int32) % 5
    cy = torch.randint(0, SIZE, (BATCH,), device=dev, generator=gen)
    cx = torch.randint(0, SIZE, (BATCH,), device=dev, generator=gen)
    per_image = torch.rand(BATCH, device=dev, generator=gen) * 1.8 + 0.1
    k1_err = 0
    for label, fc, fs in (("magnitude 10", 1.9, 1.9),
                          ("magnitude 9", 1.72, 1.72),
                          ("per-image", per_image, per_image.flip(0))):
        kw = dict(fill_value=FILL, pad=PAD, color_factor=fc, sharp_factor=fs,
                  cut_half=40, cut_fill=FILL)
        got = wk.fused_round(imgs, mats, op_class, cy, cx, **kw)
        want = wk.fused_round_plain(
            imgs, *wk.fused_round_args(imgs, mats, op_class, cy, cx, **kw))
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        log(f"K1 vs plain ({label}): {diff} differing bytes")
        check(diff == 0, f"K1 bit-equal to its plain version ({label})")
        k1_err = max(k1_err, max_abs_diff(got, want))
    results["fused_round"] = {"max_abs_err": k1_err, "bit_equal": True}

    # 5. the two compositions of RandAugment on the same draws
    for magnitude in (10, 9):
        fused = RandAugment(2, magnitude, elementwise=True)
        masked = RandAugment(2, magnitude, elementwise=True,
                             fused_round_kernel=False)
        draws = fused.sample(BATCH, (SIZE, SIZE), gen, dev)
        a, b = fused.apply(imgs, draws), masked.apply(imgs, draws)
        torch.cuda.synchronize()
        diff = int((a != b).sum())
        log(f"RandAugment(2,{magnitude}) fused vs masked: {diff} differing "
            f"bytes; {int((a != imgs).sum())} bytes changed by the policy")
        check(diff == 0, "fused and masked compositions bit-equal")

    # 6. the main path: RandAugment(2, 10) -> ViT-B/16 bf16
    model = ViTB16(dtype=torch.bfloat16, score_dtype=torch.bfloat16, seed=0,
                   device=dev)
    model.load_state_dict(fold_imagenet_normalization(model.state_dict()))
    aug = RandAugment(2, 10, elementwise=True)
    masked_aug = RandAugment(2, 10, elementwise=True,
                             fused_round_kernel=False)
    pool = [rand_images() for _ in range(STEPS)]

    def step(i, policy=aug):
        draws = policy.sample(BATCH, (SIZE, SIZE), gen, dev)
        return model(policy.apply(pool[i % len(pool)], draws))

    with torch.inference_mode():
        for i in range(WARMUP):
            step(i)
        torch.cuda.synchronize()
        wk.fused_round.launches = 0
        wk.transform_affine_separable.launches = 0
        runs = []
        for _ in range(REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for i in range(STEPS):
                logits = step(i)
            end.record()
            end.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / STEPS
            runs.append(start.elapsed_time(end) / STEPS)
            check(tuple(logits.shape) == (BATCH, 1000), "logits [32, 1000]")
            check(bool(torch.isfinite(logits).all()), "finite logits")
            log(f"main path: {BATCH / (runs[-1] / 1e3):.1f} img/s, "
                f"{runs[-1]:.3f} ms/batch (CUDA events over {STEPS} steps; "
                f"host clock {host_ms:.3f} ms/batch), batch {BATCH}, {SIZE} "
                f"px on {CARD}")
        launches = {"fused_round": wk.fused_round.launches,
                    "warp": wk.transform_affine_separable.launches}
        log(f"main path launches: {launches}")
        check(launches["fused_round"] == 2 * STEPS * REPEATS,
              "K1 launched twice per step on the main path")
        ms = sorted(runs)[len(runs) // 2]
        log(f"main path median of {REPEATS}: {BATCH / (ms / 1e3):.1f} img/s, "
            f"{ms:.3f} ms/batch (spread {min(runs):.3f}-{max(runs):.3f}) on "
            f"{CARD}")

        # the masked composition path, which runs K2
        wk.fused_round.launches = 0
        wk.transform_affine_separable.launches = 0
        for i in range(MASKED_STEPS):
            masked_logits = step(i, masked_aug)
        torch.cuda.synchronize()
        masked_launches = {"fused_round": wk.fused_round.launches,
                           "warp": wk.transform_affine_separable.launches}
        log(f"masked path launches: {masked_launches}")
        check(masked_launches["warp"] == 2 * MASKED_STEPS
              and masked_launches["fused_round"] == 0,
              "K2 launched twice per step on the masked path")
        check(bool(torch.isfinite(masked_logits).all()), "finite logits")

        # where a step's time goes: augmentation alone, model alone
        draws = aug.sample(BATCH, (SIZE, SIZE), gen, dev)
        aug_ms = cuda_ms(torch, lambda: aug.apply(pool[0], draws), 20)
        x_aug = aug.apply(pool[0], draws)
        vit_ms = cuda_ms(torch, lambda: model(x_aug), 20)
        log(f"breakdown: RandAugment(2,10) {aug_ms:.3f} ms, ViT-B/16 bf16 "
            f"{vit_ms:.3f} ms per batch of {BATCH} on {CARD}")

        # reference on a small input: a 2-layer ViT in float32 on the card
        # against the same weights on the CPU, the path the CPU tests hold
        # to the JAX package; BASELINE.md's logit gate, 1e-3
        tiny = dict(image_size=(32, 32), classes=10)
        tiny_cpu = initializers.init_module(
            VisionTransformer(16, 48, 2, 3, 96, device="cpu", **tiny),
            torch.Generator().manual_seed(1))
        tiny_gpu = VisionTransformer(16, 48, 2, 3, 96, device=dev, **tiny)
        tiny_gpu.load_state_dict(tiny_cpu.state_dict())
        x_small = x_aug[:4, :32, :32].contiguous()
        d_tiny = float((tiny_gpu(x_small).cpu()
                        - tiny_cpu(x_small.cpu())).abs().max())
        log(f"tiny ViT f32, card vs CPU: max |d logit| {d_tiny:.3g}")
        check(d_tiny < 1e-3, "tiny ViT on the card matches the CPU path")

        # ViT-B/16 bf16 against the same weights in float32
        ref = ViTB16(seed=0, device=dev)
        ref.load_state_dict(model.state_dict())
        f32_scores = ViTB16(dtype=torch.bfloat16, seed=0, device=dev)
        f32_scores.load_state_dict(model.state_dict())
        want = ref(x_aug[:8]).flatten()
        for label, m in (("bf16, bf16 scores", model),
                         ("bf16, f32 scores", f32_scores)):
            got = m(x_aug[:8]).flatten()
            rel = float((got - want).norm() / want.norm())
            cos = float(torch.nn.functional.cosine_similarity(got, want,
                                                              dim=0))
            span = float(want.max() - want.min())
            log(f"ViT-B/16 {label} vs f32: rel L2 {rel:.4f}, cosine "
                f"{cos:.5f}, max |d| {float((got - want).abs().max()):.4f} "
                f"of range {span:.4f}")
            check(cos >= 0.98, f"{label} logits follow the f32 ones")
        del ref, f32_scores

    # device time by kernel over 3 main-path steps (the profiler's own
    # host cost inflates the wall time here; the device time is what to
    # read, against the unprofiled ms/batch above)
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            step(i)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(events.table(sort_by="self_device_time_total", row_limit=15))
    for e in events:
        name = next((k for k in ("fused_round_kernel", "warp_kernel")
                     if k in e.key), None)
        if name and e.device_type == torch.autograd.DeviceType.CUDA:
            log(f"profile: {name} {e.count} launches, "
                f"{e.self_device_time_total / e.count:.1f} us each on the "
                f"main path's data, on {CARD}")
    busy = busy_ms / 3
    log(f"profile: {busy:.3f} ms of device time per step against {ms:.3f} "
        f"ms/batch unprofiled: device busy {100 * busy / ms:.1f}% on {CARD}")

    # 7. kernel and plain-version times at the main path's shapes: the
    # bare launch, the plain version, and the whole wrapper call (shift
    # vectors and argument checks included), cycling over inputs larger
    # than the 50 MB L2 so each launch reads from device memory
    cold = [rand_images() for _ in range(16)]  # 77 MB
    turn = iter(range(10 ** 9))

    def nxt():
        return cold[next(turn) % len(cold)]

    d0 = draws[0]
    round_kw = aug.fused_round_args(
        cold[0], aug.round_matrices(d0["idx"], d0["sign"], SIZE, SIZE),
        d0["idx"], d0["cy"], d0["cx"])
    del round_kw["images"]
    k1_args = wk.fused_round_args(cold[0], **round_kw)
    out = torch.empty_like(cold[0])
    classes = k1_args[3]
    kinds = {name: int((classes == k).sum()) for name, k in (
        ("warp", wk.WARP), ("color", wk.COLOR), ("sharpness", wk.SHARPNESS),
        ("cutout", wk.CUTOUT), ("passthrough", wk.PASSTHROUGH))}
    log(f"timed round's op classes: {kinds}")

    img_bytes = BATCH * SIZE * SIZE * 3
    wp = SIZE + 2 * PAD
    shift_bytes = 4 * BATCH * (2 * SIZE + wp)
    # operations per output byte, by class (integer and float32 ALU work):
    # passthrough 1, warp ~10 index ops, color ~12, sharpness ~20, cutout ~6
    per_byte = {"passthrough": 1, "warp": 10, "color": 12, "sharpness": 20,
                "cutout": 6}
    k1_ops = sum(per_byte[k] * n for k, n in kinds.items()) * SIZE * SIZE * 3
    cases = (
        ("fused_round",
         lambda: wk.launch_fused_round(nxt(), out, *k1_args),
         lambda: wk.fused_round_plain(nxt(), *k1_args),
         lambda: wk.fused_round(nxt(), **round_kw),
         2 * img_bytes + shift_bytes + 4 * 5 * BATCH, k1_ops,
         "chambers_tpu/ops/warp_pallas.py:317 fused_round_pallas",
         launches["fused_round"]),
        ("warp",
         lambda: wk.launch_warp(nxt(), out, n1, n2, n3, FILL, PAD),
         lambda: wk.warp_plain(nxt(), n1, n2, n3, FILL, PAD),
         lambda: wk.transform_affine_separable(nxt(), mats, FILL, PAD),
         2 * img_bytes + shift_bytes, 10 * img_bytes,
         "chambers_tpu/ops/warp_pallas.py:144 "
         "transform_affine_separable_pallas",
         masked_launches["warp"]),
    )
    rows = []
    for name, bare, plain, wrapped, nbytes, ops, replaces, count in cases:
        kernel_ms = cuda_ms(torch, bare, 50, backlog=True)
        plain_ms = cuda_ms(torch, plain, 10)
        wrapper_ms = cuda_ms(torch, wrapped, 20)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows.append({
            "name": name, "route": "cuda",
            "source": "chambers_tpu_torch/ops/csrc/warp.cu",
            "replaces": replaces, "launches": count,
            "max_abs_err": results[name]["max_abs_err"],
            "bit_equal": results[name]["bit_equal"],
            "ms": kernel_ms, "plain_ms": plain_ms, "wrapper_ms": wrapper_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "card": CARD,
        })
        log(f"{name}: kernel {kernel_ms * 1e3:.1f} us, wrapper call "
            f"{wrapper_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
            f"bound {bound_ms * 1e3:.2f} us ({rows[-1]['bound_by']}) on "
            f"{CARD}")
    torch.cuda.synchronize()
    del cold, pool, model

    # 8-11. flash attention: kernels against plain versions, the seq2seq
    # train step, a ViT on the kernel, kernel times
    flash_errors = check_flash_kernels(torch, fa, dev)
    check_tile_products(torch, fa, dev)
    check_forward_kernel_names(torch, fa, dev)
    flash_launches = seq2seq_path(torch, fa, dev)
    vit_on_flash(torch, fa, dev, imgs)
    rows += time_flash_kernels(torch, fa, dev, flash_launches, flash_errors)

    log(json.dumps({"kernels": rows}))
    log(CARD)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
