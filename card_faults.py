#!/usr/bin/env python3
"""The port's two faults seen on the card, measured on one CUDA card.

    python3 card_faults.py h2112 OUT_DIR
    python3 card_faults.py int8-vit DRAWS OUT_DIR

``h2112``: the bf16 card case of
``tests/test_torch_cuda_kernels.py::test_flash_kernels_above_256_match_plain``
at head size 2112 (b 2, n 2, tq = tk = 257, causal, a key mask that drops
about 30% of the keys and all of the last batch item's). On inputs made
from a numpy seed (``h2112_inputs``, the same bits on any machine) it runs
K3a, then K3b and K3c on K3a's own ``o, l, m``, as the autograd function
chains them, and writes their outputs to ``OUT_DIR/h2112_card.npz`` (the
16-bit ones as their raw bits), for ``tests/flash_h2112_reference.py``,
which holds them, JAX's Pallas backward in interpret mode and the port's
plain versions to a float64 reference on the CPU. On the card it also
gives the test's own inputs' distances (``_flash_inputs`` at seed 0, drawn
on the card): the kernels, the plain versions and the plain backward on
the kernels' forward, each from a float64 reference of the same function
computed on the card, by the test's measure.

``int8-vit``: the comparison of
``test_quantized_vit_on_the_card_matches_the_cpu`` (a 2-layer int8 ViT,
card against CPU within 1e-4 relative) on ``DRAWS`` fresh draws of its
input from the global generator, unseeded, as the test draws it. For
each draw it records the relative error and, for every activation that
``dynamic_quantize`` turns into int8 codes, how many codes differ between
the card and the CPU and by how much, and, at the first activation whose
codes differ, how far the quotients the codes were rounded from lay from a
rounding boundary and how far the card's were from the CPU's; draws that
miss 1e-4 are written to ``OUT_DIR/int8_vit_misses.npz``.

Prints one JSON line last.
"""

import json
import sys
from pathlib import Path

import numpy as np

# WIDE_CASES[0] of tests/test_torch_cuda_kernels.py at head size 2112
H2112 = dict(b=2, n=2, t=257, h=2112, causal=True)


def h2112_inputs(torch, seed=2112):
    """``q, k, v, do`` bf16 ``[b n, t, h]`` and the float32 ``[b, t]`` key
    mask of the h 2112 case, from a numpy seed, on the CPU."""
    b, n, t, h = H2112["b"], H2112["n"], H2112["t"], H2112["h"]
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(b * n, t, h).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    mask = (rng.rand(b, t) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1] = 0.0  # the last batch item has no valid key
    return q, k, v, do, torch.from_numpy(mask)


def reference64(torch, q, k, v, do, mask, causal, n_heads):
    """``o, dq, dk, dv`` of softmax attention in float64 from the operands'
    values: the function the kernels compute, with a row that no key
    reaches giving zeros, and ``di`` from the exact ``o``."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    tq, tk, h = q.shape[1], k.shape[1], q.shape[2]
    scale = h ** -0.5
    keep = (mask > 0).repeat_interleave(n_heads, dim=0)[:, None, :]
    if causal:
        keep = keep & torch.ones((tq, tk), dtype=torch.bool,
                                 device=q.device).tril(tk - tq)[None]
    s = torch.where(keep, q @ k.transpose(1, 2) * scale, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - torch.where(m.isfinite(), m, 0.0)),
                    0.0)
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l == 0, 1.0, l)
    o = p @ v
    ds = p * (do @ v.transpose(1, 2) - (do * o).sum(-1, keepdim=True))
    return (o, ds @ k * scale, ds.transpose(1, 2) @ q * scale,
            p.transpose(1, 2) @ do)


def distances(got, ref):
    """How far ``got`` is from the float64 ``ref``: the largest |d|, the
    card tests' bf16 measure (the largest |d| - 2^-7 |ref|, held there to
    2^-8) and the relative rms."""
    d = (got.double() - ref).abs()
    norm = float(ref.norm())
    return {"max_abs": float(d.max()),
            "past_rtol": float((d - 2.0 ** -7 * ref.abs()).max()),
            "rel_rms": float(d.norm()) / (norm if norm else 1.0)}


def to_bits(torch, x):
    """A bf16 tensor's raw bits as numpy uint16."""
    return x.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)


def h2112(torch, fa, dev, out_dir):
    b, n, t, h, causal = (H2112[x] for x in ("b", "n", "t", "h", "causal"))
    scale = h ** -0.5
    q, k, v, do, mask = (x.to(dev) for x in h2112_inputs(torch))
    o, l, m = fa.launch_forward(q, k, v, mask, scale, causal, n)
    args = (q, k, v, do, l, m, fa.delta(o, do), mask, scale, causal, n)
    dk, dv = fa.launch_backward_dkv(*args)
    dq = fa.launch_backward_dq(*args)
    torch.cuda.synchronize()
    np.savez_compressed(
        out_dir / "h2112_card.npz",
        **{name: to_bits(torch, x) for name, x in (
            ("o", o), ("dq", dq), ("dk", dk), ("dv", dv))},
        l=l.cpu().numpy(), m=m.cpu().numpy())
    result = {"numpy_seed_case": "outputs in h2112_card.npz"}

    # the test's own inputs: _flash_inputs at seed 0, drawn on the card
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(rows):
        return torch.randn((b * n, rows, h), device=dev,
                           generator=g).to(torch.bfloat16)

    q, k, v, do = rand(t), rand(t), rand(t), rand(t)
    mask = (torch.rand((b, t), device=dev, generator=g) > 0.3).float()
    mask[:, 0] = 1.0
    mask[-1] = 0.0
    o, l, m = fa.launch_forward(q, k, v, mask, scale, causal, n)
    args = (q, k, v, do, l, m, fa.delta(o, do), mask, scale, causal, n)
    kernels = (fa.launch_backward_dq(*args), *fa.launch_backward_dkv(*args))
    o_p, l_p, m_p = fa.flash_forward_plain(q, k, v, scale, causal, mask, n)
    plain = fa.flash_backward_plain(q, k, v, o_p, l_p, m_p, do, scale,
                                    causal, mask, n)
    on_kernel_o = fa.flash_backward_plain(q, k, v, o, l, m, do, scale,
                                          causal, mask, n)
    o64, *grads64 = reference64(torch, q, k, v, do, mask, causal, n)
    names = ("dq", "dk", "dv")
    own = {
        "kernels": {x: distances(g_, r) for x, g_, r in
                    zip(names, kernels, grads64)},
        "plain": {x: distances(g_, r) for x, g_, r in
                  zip(names, plain, grads64)},
        "plain_on_kernel_forward": {x: distances(g_, r) for x, g_, r in
                                    zip(names, on_kernel_o, grads64)},
        "kernels_vs_plain": {x: distances(g_, r.double()) for x, g_, r in
                             zip(names, kernels, plain)},
        "o": {"kernel": distances(o, o64), "plain": distances(o_p, o64),
              "kernel_vs_plain_bits_differ": int((o != o_p).sum())},
        "di_kernel_vs_plain_max_abs": float(
            (fa.delta(o, do) - fa.delta(o_p, do)).abs().max())}
    result["test_inputs_on_the_card"] = own
    for key, by in own.items():
        print(f"h 2112 test inputs, {key}: {by}", flush=True)
    return result


def int8_vit(torch, dev, draws, out_dir):
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch import quantization as tq
    from chambers_tpu_torch.models.backbones.vision_transformer import (
        VisionTransformer,
    )

    kw = dict(image_size=(32, 32), classes=10)
    cpu = initializers.init_module(
        VisionTransformer(16, 64, 2, 4, 128, device="cpu", **kw),
        torch.Generator().manual_seed(3)).eval()
    tq.quantize_model(cpu)
    card = VisionTransformer(16, 64, 2, 4, 128, device=dev, **kw).eval()
    tq.load_quantized_state_dict(card, cpu.state_dict())

    quantize = tq.dynamic_quantize
    seen = []

    def recording(x, reduce_axes=(-1,)):
        x_q, s_x = quantize(x, reduce_axes)
        # the codes and the float32 quotients they were rounded from
        seen.append((x_q.cpu(), (x.float() / s_x).cpu()))
        return x_q, s_x

    tq.dynamic_quantize = recording
    rows, misses = [], []
    try:
        for _ in range(draws):
            x = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8)
            with torch.inference_mode():
                seen.clear()
                want = cpu(x)
                codes_cpu = list(seen)
                seen.clear()
                got = card(x.to(dev)).cpu()
                codes_card = list(seen)
            rel = float((got - want).norm() / want.norm())
            flips = [int((a[0] != b[0]).sum()) for a, b in
                     zip(codes_cpu, codes_card)]
            row = {"rel": rel, "flipped_codes": sum(flips),
                   "flips_by_call": flips,
                   "largest_code_step": max(
                       int((a[0].int() - b[0].int()).abs().max())
                       for a, b in zip(codes_cpu, codes_card))}
            first = next((i for i, f in enumerate(flips) if f), None)
            if first is not None:
                # at the first activation whose codes differ: how far its
                # quotients were from a rounding boundary (a half-integer)
                # on the CPU, and how far the card's were from the CPU's
                (c_cpu, x_cpu), (c_card, x_card) = (codes_cpu[first],
                                                    codes_card[first])
                at = c_cpu != c_card
                row["first_flip"] = {
                    "call": first,
                    "quotient_from_half_max": float(
                        ((x_cpu[at] - x_cpu[at].floor()) - 0.5).abs().max()),
                    "card_minus_cpu_quotient_max": float(
                        (x_card[at] - x_cpu[at]).abs().max())}
            rows.append(row)
            if rel > 1e-4:
                misses.append(x.numpy())
    finally:
        tq.dynamic_quantize = quantize
    if misses:
        np.savez_compressed(out_dir / "int8_vit_misses.npz",
                            inputs=np.stack(misses))
    missed = [r for r in rows if r["rel"] > 1e-4]
    within = [r for r in rows if r["rel"] <= 1e-4]
    flipped = [r for r in rows if r["flipped_codes"]]
    rels = sorted(r["rel"] for r in rows)

    def mean(rs, value):
        return sum(value(r) for r in rs) / len(rs) if rs else None

    result = {
        "draws": draws, "misses": len(missed),
        "miss_rate": len(missed) / draws,
        "rel_median": rels[len(rels) // 2], "rel_max": rels[-1],
        "codes_a_draw": sum(a[0].numel() for a in codes_cpu),
        "misses_with_a_flip": mean(missed, lambda r: r["flipped_codes"] > 0),
        "flipped_codes_a_miss": mean(missed, lambda r: r["flipped_codes"]),
        "draws_within_with_a_flip": mean(
            within, lambda r: r["flipped_codes"] > 0),
        "flipped_codes_a_draw_within": mean(
            within, lambda r: r["flipped_codes"]),
        "rel_without_a_flip_max": max(
            (r["rel"] for r in rows if not r["flipped_codes"]),
            default=None),
        "first_flip_from_half_max": max(
            (r["first_flip"]["quotient_from_half_max"] for r in flipped),
            default=None),
        "first_flip_card_minus_cpu_max": max(
            (r["first_flip"]["card_minus_cpu_quotient_max"]
             for r in flipped), default=None),
        "largest_code_step": max(r["largest_code_step"] for r in rows),
        "missed": missed[:10]}
    print(f"int8 ViT, {draws} unseeded draws: {len(missed)} miss 1e-4; "
          f"{result}", flush=True)
    return result


def main(args):
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chambers_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("card_faults: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out_dir = Path(args[-1])
    out_dir.mkdir(parents=True, exist_ok=True)
    if args[0] == "h2112":
        result = {"h2112": h2112(torch, fa, dev, out_dir)}
    else:
        result = {"int8_vit": int8_vit(torch, dev, int(args[1]), out_dir)}
    result["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if not ((len(args) == 2 and args[0] == "h2112")
            or (len(args) == 3 and args[0] == "int8-vit")):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
    sys.exit(main(args))
