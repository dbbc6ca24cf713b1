"""The h 2112 bf16 card case against a float64 reference, on the CPU (a
script, not a test module: pytest does not collect it).

    JAX_PLATFORMS=cpu python tests/flash_h2112_reference.py CARD_NPZ

``CARD_NPZ`` is what ``python3 card_faults.py h2112 OUT_DIR`` wrote on the
card (``OUT_DIR/h2112_card.npz``): the port's K3a-c outputs on
``card_faults.h2112_inputs``. On the same inputs this computes

- JAX's ``_flash_backward`` Pallas kernels in interpret mode over JAX's
  own forward (``chambers_tpu.ops.flash_attention.flash_attention`` and
  its VJP, as the JAX package's tests run it on the CPU);
- the port's plain versions, ``flash_forward_plain`` then
  ``flash_backward_plain``; ``flash_backward_plain`` on the card kernels'
  ``o, l, m``, with ``di`` from the float64 ``o``, and on float32 operands
  (``p`` and ``ds`` not rounded to bf16 before the second products, as in
  JAX's kernels);
- ``card_faults.reference64``, the function in float64;

and prints each one's dQ, dK and dV distances from float64
(``card_faults.distances``: the largest |d|, the card tests' bf16 measure
and the relative rms), with the card kernels', and of each ``o``, as one
JSON line.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from card_faults import H2112, distances, h2112_inputs, reference64  # noqa: E402
from chambers_tpu.ops import flash_attention as jflash  # noqa: E402
from chambers_tpu_torch.ops import flash_attention as tflash  # noqa: E402


def from_bits(bits):
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def main(card_npz):
    jax.config.update("jax_platforms", "cpu")
    b, n, t, h, causal = (H2112[x] for x in ("b", "n", "t", "h", "causal"))
    scale = h ** -0.5
    q, k, v, do, mask = h2112_inputs(torch)
    o64, *grads64 = reference64(torch, q, k, v, do, mask, causal, n)
    names = ("dq", "dk", "dv")

    def four(x):
        return jnp.asarray(x.float().numpy().reshape(b, n, t, h),
                           jnp.bfloat16)

    def jax_attention(q_, k_, v_):
        return jflash.flash_attention(q_, v_, k_, causal=causal,
                                      kv_mask=jnp.asarray(mask.numpy() > 0),
                                      interpret=True)

    o_j, vjp = jax.vjp(jax_attention, four(q), four(k), four(v))
    grads_j = [torch.from_numpy(np.asarray(g, np.float32).reshape(b * n, t,
                                                                  h))
               for g in vjp(four(do))]
    o_j = torch.from_numpy(np.asarray(o_j, np.float32).reshape(b * n, t, h))

    o_p, l_p, m_p = tflash.flash_forward_plain(q, k, v, scale, causal, mask,
                                               n)
    plain = tflash.flash_backward_plain(q, k, v, o_p, l_p, m_p, do, scale,
                                        causal, mask, n)
    card = np.load(card_npz)
    o_c = from_bits(card["o"])
    l_c, m_c = torch.from_numpy(card["l"]), torch.from_numpy(card["m"])
    kernels = [from_bits(card[x]) for x in names]
    on_kernel_o = tflash.flash_backward_plain(q, k, v, o_c, l_c, m_c, do,
                                              scale, causal, mask, n)
    # the plain backward with di from the exact o: what is left is the
    # rounding of p, ds and the outputs
    di64 = (do.double() * o64).sum(-1, keepdim=True).float()
    exact_di = tflash.flash_backward_plain(q, k, v, o_p, l_p, m_p, do, scale,
                                           causal, mask, n, di=di64)
    # the plain backward on float32 operands (the same values): p and ds
    # stay float32 into the second products, as in JAX's kernels, and only
    # the outputs are rounded to bf16
    unrounded = [x.to(torch.bfloat16) for x in tflash.flash_backward_plain(
        q.float(), k.float(), v.float(), o_p.float(), l_p, m_p, do.float(),
        scale, causal, mask, n)]

    result = {"case": {**H2112, "dtype": "bfloat16", "numpy_seed": 2112},
              "o": {name: distances(x, o64) for name, x in (
                  ("jax_interpret", o_j), ("port_plain", o_p),
                  ("card_kernels", o_c))}}
    for label, grads in (("jax_interpret", grads_j), ("port_plain", plain),
                         ("card_kernels", kernels),
                         ("port_plain_on_card_forward", on_kernel_o),
                         ("port_plain_di_from_float64_o", exact_di),
                         ("port_plain_p_ds_unrounded", unrounded)):
        result[label] = {x: distances(g, r) for x, g, r in
                         zip(names, grads, grads64)}
    result["card_kernels_vs_port_plain"] = {
        x: distances(g, r.double()) for x, g, r in zip(names, kernels, plain)}
    result["o_bits_differ"] = {
        "card_vs_plain": int((o_c != o_p).sum()),
        "jax_vs_plain": int((o_j.to(torch.bfloat16) != o_p).sum())}
    for key, by in result.items():
        print(f"{key}: {by}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
