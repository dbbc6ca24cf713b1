#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``chambers_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit. In order, it:

1. prints the card's name and power limit;
2. builds the CUDA kernels from ``chambers_tpu_torch/ops/csrc`` with nvcc;
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
7. times each kernel and its plain version at the main path's shapes;
8. prints one ``kernels`` JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the last line. It
imports nothing of JAX or of ``chambers_tpu``.
"""

import json
import math
import os
import subprocess
import sys
import time

BATCH, SIZE = 32, 224
WARMUP, STEPS, REPEATS, MASKED_STEPS = 3, 20, 3, 5
FILL, PAD = 128, 32
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
CARD = ""


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


def max_abs_diff(a, b):
    return int((a.int() - b.int()).abs().max())


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
    t0 = time.perf_counter()
    path = _build.build(*wk.LIBRARY)
    log(f"build: {time.perf_counter() - t0:.1f} s -> {path.name}")
    report = path.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  nvcc:", line.strip())

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

    log(json.dumps({"kernels": rows}))
    log(CARD)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
