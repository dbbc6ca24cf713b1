"""The port's flash attention on the CPU (its plain versions, through the
hand-written autograd function) against the JAX package's Pallas kernels
run in interpret mode, on the same numpy inputs.

Tolerances are those of ``tests/test_flash_attention.py``: float32 outputs
2e-5 (sums run in another order), bf16 outputs 3e-2 (the rounding of the
output type at |o| of a few units), gradients atol 1e-3 / rtol 1e-3, and
5e-3 under the padding mask. The saved softmax statistics ``l, m`` are held
to ``_flash_forward``'s at rtol 1e-5. bf16 and float16 at any head size
follow ``_close_half``, derived from each type's unit roundoff; the float16
``Seq2SeqTransformer`` states its own."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chambers_tpu.layers.attention import MultiHeadAttention as JaxMHA
from chambers_tpu.ops import flash_attention as jflash
from chambers_tpu_torch.layers.attention import (
    MultiHeadAttention,
    scaled_dot_product_attention,
)
from chambers_tpu_torch.models.backbones.convert import state_dict_from_jax
from chambers_tpu_torch.ops import flash_attention as tflash
from test_torch_seq2seq import _dense_twin_init
from test_torch_package import one_torch_thread  # noqa: F401

CPU = "cpu"


def _qkv(seed, shape_q, shape_kv=None, dtype=np.float32):
    rng = np.random.RandomState(seed)
    shape_kv = shape_kv or shape_q
    return (rng.randn(*shape_q).astype(dtype),
            rng.randn(*shape_kv).astype(dtype),
            rng.randn(*shape_kv).astype(dtype))


def _mask(seed, b, t, keep_first, drop=0.25):
    mask = np.random.RandomState(seed).rand(b, t) > drop
    mask[:, :keep_first] = True
    return mask


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _f32(t):
    return t.detach().to(torch.float32).numpy()


# name: (q shape, kv shape, causal, mask (seed, keep_first, drop), "zeros"
# (no valid key), "dead" (batch item 1 has no valid key), ("ragged", seed)
# (20-30% trailing padding) or None, bf16)
FORWARD_CASES = {
    "vit_197": ((2, 3, 197, 64), None, False, None, False),
    "vit_197_causal": ((2, 3, 197, 64), None, True, None, False),
    "non_multiple_577": ((1, 2, 577, 64), None, False, None, False),
    "cross_130x260": ((1, 2, 130, 64), (1, 2, 260, 64), False, None, False),
    "bf16_197": ((2, 3, 197, 64), None, False, None, True),
    "kv_mask": ((2, 3, 197, 64), None, False, (7, 2, 0.25), False),
    "kv_mask_causal": ((2, 3, 197, 64), None, True, (7, 2, 0.25), False),
    "kv_mask_cross_70x150": ((2, 2, 70, 32), (2, 2, 150, 32), False,
                             (9, 1, 0.3), False),
    "kv_mask_bf16_causal": ((2, 2, 140, 64), None, True, (11, 2, 0.25),
                            True),
    "fully_masked_rows": ((1, 2, 130, 16), None, False, "zeros", False),
    "causal_cross_4x8": ((1, 2, 4, 64), (1, 2, 8, 64), True, None, False),
    "causal_cross_130x260": ((1, 1, 130, 64), (1, 1, 260, 64), True, None,
                             False),
    # the semantics the bf16 tensor-core forward follows, at its edges
    "bf16_path_512_ragged": ((2, 2, 512, 64), None, False, ("ragged", 3),
                             True),
    "bf16_decode_1x300_kv_mask": ((2, 2, 1, 64), (2, 2, 300, 64), False,
                                  (5, 1, 0.3), True),
    "bf16_causal_cross_260x130": ((1, 2, 260, 64), (1, 2, 130, 64), True,
                                  None, True),
    "bf16_causal_cross_130x260": ((1, 2, 130, 64), (1, 2, 260, 64), True,
                                  None, True),
    "bf16_dead_batch_item": ((2, 2, 96, 64), None, False, "dead", True),
    "bf16_one_key": ((2, 2, 64, 64), (2, 2, 1, 64), False, None, True),
    "bf16_kv_mask_cross_70x150": ((2, 2, 70, 64), (2, 2, 150, 64), False,
                                  (9, 1, 0.3), True),
    "bf16_kv_mask_63x65": ((2, 1, 63, 64), (2, 1, 65, 64), False,
                           (13, 1, 0.3), True),
    "bf16_causal_kv_mask_257": ((2, 2, 257, 64), None, True, (12, 1, 0.3),
                                True),
    # the short bf16 forward's edges (a head's queries and keys resident):
    # DeiT-B/16's 198 tokens, causal cross lengths with rows that see no
    # key, a batch item with no valid key, 256 keys under both masks
    "bf16_short_198": ((2, 3, 198, 64), None, False, None, True),
    "bf16_short_causal_cross_250x120": ((1, 2, 250, 64), (1, 2, 120, 64),
                                        True, None, True),
    "bf16_short_dead_batch_item_198": ((2, 2, 198, 64), None, False, "dead",
                                       True),
    "bf16_short_causal_kv_mask_256": ((2, 2, 256, 64), None, True,
                                      (14, 1, 0.3), True),
}


def _case(name):
    shape_q, shape_kv, causal, mask, bf16 = FORWARD_CASES[name]
    q, k, v = _qkv(len(name), shape_q, shape_kv)
    b, tk = shape_q[0], (shape_kv or shape_q)[2]
    if mask == "zeros":
        mask = np.zeros((b, tk), bool)
    elif mask == "dead":
        mask = np.ones((b, tk), bool)
        mask[1] = False
    elif mask is not None and mask[0] == "ragged":
        keep = tk * (0.7 + 0.1 * np.random.RandomState(mask[1]).rand(b))
        mask = np.arange(tk)[None, :] < keep.astype(int)[:, None]
    elif mask is not None:
        mask = _mask(mask[0], b, tk, mask[1], mask[2])
    return q, k, v, causal, mask, bf16


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_forward_matches_jax_kernel(name):
    """The plain forward, through the autograd function, against the Pallas
    forward in interpret mode: outputs 2e-5 (float32) or 3e-2 (bf16), the
    saved ``m`` to 1e-5 and ``l`` to 1e-4 of ``_flash_forward``'s.

    Under the causal mask with more queries than keys, the first ``tq - tk``
    rows see no key. The port gives them exact zeros, ``l == 0`` and ``m``
    at the mask value, as for any row with no valid key; the JAX kernel
    averages their values instead (a known difference, ROADMAP §3). So
    those rows are held to the port's rule and the others to JAX."""
    q, k, v, causal, mask, bf16 = _case(name)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                            torch.float32)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want = jflash.flash_attention(
        jq, jv, jk, causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask))
    got = tflash.flash_attention(
        _t(q, tdt), _t(v, tdt), _t(k, tdt), causal=causal,
        kv_mask=None if mask is None else _t(mask))
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    b, n, tq, h = q.shape
    tk = k.shape[2]
    above = tq - tk if causal and tq > tk else 0  # rows that see no key
    np.testing.assert_allclose(_f32(got)[:, :, above:],
                               np.asarray(want, np.float32)[:, :, above:],
                               atol=3e-2 if bf16 else 2e-5)
    assert not got[:, :, :above].any()
    if name == "fully_masked_rows":
        assert np.array_equal(_f32(got), np.zeros(q.shape, np.float32))
    if name in ("bf16_dead_batch_item", "bf16_short_dead_batch_item_198"):
        assert not got[1].any() and got[0].any()

    # the saved statistics against _flash_forward's
    fold = lambda x: x.reshape(b * n, x.shape[2], h)
    scale = 1.0 / math.sqrt(h)
    block_q, block_k = jflash._auto_block(tq), jflash._auto_block(tk)
    _, l_want, m_want = jflash._flash_forward(
        fold(jq), fold(jk), fold(jv), scale, causal, block_q, block_k, True,
        kv_mask=None if mask is None else jnp.asarray(mask, jnp.float32),
        n_heads=n)
    _, l_got, m_got = tflash.flash_forward_plain(
        fold(_t(q, tdt)), fold(_t(k, tdt)), fold(_t(v, tdt)), scale, causal,
        None if mask is None else _t(mask, torch.float32), n)
    assert l_got.dtype == m_got.dtype == torch.float32
    assert tuple(l_got.shape) == tuple(m_got.shape) == (b * n, tq, 1)
    np.testing.assert_allclose(m_got.numpy()[:, above:],
                               np.asarray(m_want)[:, above:], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l_got.numpy()[:, above:],
                               np.asarray(l_want)[:, above:], rtol=1e-4,
                               atol=1e-6)
    assert not l_got[:, :above].any()
    assert bool((m_got[:, :above] == tflash.MASK_VALUE).all())


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_forward_plain_rounds_p_only_before_pv(causal):
    """The two roundings of the bf16 forward, against a float64 reference:
    ``l`` sums the unrounded probabilities, and ``p`` is rounded to bf16
    before ``p v`` (as the Pallas kernel casts it before its product), whose
    float32 sum is rounded to bf16 once at the end. ``l`` and ``m`` are held
    to 1e-5. The output is held to the float64 one rounded to bf16: at most
    1% of the elements one step apart (a float32 sum that lands on the
    other side of a rounding boundary); without the rounding of ``p`` a
    third of them would move, so the check tells the two rules apart."""
    b, n, t, h = 1, 3, 70, 64
    q, k, v = (_t(x, torch.bfloat16).reshape(b * n, t, h)
               for x in _qkv(21, (b, n, t, h)))
    mask = _mask(22, b, t, 1)
    o, l, m = tflash.flash_forward_plain(q, k, v, 0.125, causal,
                                         _t(mask, torch.float32), n)

    keep = np.broadcast_to(mask[:, None, :], (b * n, t, t))
    if causal:
        keep = keep & np.tri(t, dtype=bool)
    q64, k64, v64 = (x.double().numpy() for x in (q, k, v))
    s = np.where(keep, q64 @ k64.transpose(0, 2, 1) * 0.125, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    l64 = p.sum(axis=-1, keepdims=True)
    np.testing.assert_allclose(l.numpy(), l64, rtol=1e-5)
    np.testing.assert_allclose(m.numpy(), s.max(axis=-1, keepdims=True),
                               rtol=1e-5)

    def bf16(x):
        return _f32(torch.from_numpy(x).to(torch.bfloat16))

    p16 = bf16(p).astype(np.float64)
    want, unrounded = bf16(p16 @ v64 / l64), bf16(p @ v64 / l64)
    got = _f32(o)
    step = 2.0 ** -7 * np.abs(want)
    assert np.all(np.abs(got - want) <= step)
    assert np.mean(got != want) <= 0.01
    assert np.mean(unrounded != want) >= 0.1


# name: (q shape, kv shape, causal, mask, atol, rtol)
GRAD_CASES = {
    "plain_64": ((2, 1, 64, 64), None, False, None, 1e-3, 1e-3),
    "causal_130": ((1, 1, 130, 64), None, True, None, 1e-3, 1e-3),
    "kv_mask_197": ((2, 3, 197, 64), None, False, (8, 2, 0.25), 5e-3, 1e-3),
    "kv_mask_causal_140": ((2, 2, 140, 32), None, True, (12, 2, 0.25), 5e-3,
                           1e-3),
    "causal_cross_4x8": ((1, 2, 4, 64), (1, 2, 8, 64), True, None, 1e-3,
                         1e-3),
    "cross_70x150_mask": ((2, 2, 70, 32), (2, 2, 150, 32), False,
                          (9, 1, 0.3), 5e-3, 1e-3),
}


def _torch_grads(fn, q, k, v):
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    fn(tq, tk, tv).pow(2).sum().backward()
    return [_f32(x.grad) for x in (tq, tk, tv)]


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_gradients_match_jax_kernel_and_dense_autograd(name):
    shape_q, shape_kv, causal, mask, atol, rtol = GRAD_CASES[name]
    q, k, v = _qkv(100 + len(name), shape_q, shape_kv)
    if mask is not None:
        mask = _mask(mask[0], shape_q[0], k.shape[2], mask[1], mask[2])
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else _t(mask)

    want = jax.grad(
        lambda q, k, v: jnp.sum(jflash.flash_attention(
            q, v, k, causal=causal, kv_mask=jmask) ** 2),
        argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    got = _torch_grads(
        lambda q, k, v: tflash.flash_attention(q, v, k, causal=causal,
                                               kv_mask=tmask), q, k, v)
    dense = _torch_grads(
        lambda q, k, v: scaled_dot_product_attention(
            q, v, k, causal=causal, v_mask=tmask), q, k, v)
    for g, w, d in zip(got, want, dense):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol)
        np.testing.assert_allclose(g, d, atol=atol, rtol=rtol)


# name: (q shape, kv shape, causal, mask (seed, keep_first, drop) or "dead")
BF16_BACKWARD_CASES = {
    "plain_130": ((2, 2, 130, 64), None, False, None),
    "causal_197": ((1, 2, 197, 64), None, True, None),
    "kv_mask_140": ((2, 3, 140, 64), None, False, (8, 2, 0.25)),
    "causal_kv_mask_cross_70x150": ((2, 2, 70, 64), (2, 2, 150, 64), True,
                                    (9, 1, 0.3)),
    "dead_batch_item_96": ((2, 2, 96, 64), None, False, "dead"),
    # ViT lengths, the shapes K3b's short kernel takes on the card:
    # DeiT-B/16's 198 tokens (a last query tile of 6 rows, a last key tile
    # of 6 keys), the served ViT-B/16's 197 under a key mask, a last query
    # tile of one row and of eight, causal with tq != tk, fewer than 64 keys
    "vit_198": ((1, 2, 198, 64), None, False, None),
    "vit_197_kv_mask": ((1, 3, 197, 64), None, False, (15, 1, 0.25)),
    "dead_batch_item_198": ((2, 2, 198, 64), None, False, "dead"),
    "last_query_tile_one_row_193": ((1, 2, 193, 64), None, False, None),
    "causal_cross_200x136": ((1, 2, 200, 64), (1, 2, 136, 64), True, None),
    "causal_cross_120x250": ((1, 4, 120, 64), (1, 4, 250, 64), True, None),
    "keys_below_64_130x40": ((1, 2, 130, 64), (1, 2, 40, 64), False, None),
}


@pytest.mark.parametrize("name", sorted(BF16_BACKWARD_CASES))
def test_bf16_backward_plain_matches_jax_kernels(name):
    """``flash_backward_plain`` in bf16 against the Pallas dK/dV and dQ
    kernels in interpret mode, on the same bf16 ``q, k, v, do`` and the
    same saved ``o, l, m`` (``_flash_forward``'s), so only the backward
    differs.

    The plain version states the CUDA kernels' arithmetic: ``p`` and ``ds``
    are rounded to bf16 before ``pᵀ do``, ``dsᵀ q`` and ``ds k``, because a
    bf16 tensor-core product takes bf16 on both sides. The Pallas kernels
    keep them in float32. Tolerance: rtol 2^-7 is one step of the bf16
    output (both round a float32 sum to a neighbouring value); atol is 2^-8
    of the gradient's largest value, since every term of a sum moves by up
    to 2^-9 of itself, twice over for ``ds`` (its own rounding on top of
    the output's), and the terms cancel, so the error follows the
    gradient's scale and not the element's; the relative rms error stays
    under 2^-8 (measured 2.5e-3 to 2.8e-3: two independent bf16 roundings
    of the output). A batch item with no valid key gives exact zeros on
    both sides."""
    shape_q, shape_kv, causal, mask = BF16_BACKWARD_CASES[name]
    shape_kv = shape_kv or shape_q
    rng = np.random.RandomState(len(name))
    q, do = (rng.randn(*shape_q).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(*shape_kv).astype(np.float32) for _ in range(2))
    b, n, tq, h = shape_q
    tk = shape_kv[2]
    if mask == "dead":
        mask = np.ones((b, tk), bool)
        mask[1] = False
    elif mask is not None:
        mask = _mask(mask[0], b, tk, mask[1], mask[2])

    def fold(x):
        return x.reshape(b * n, x.shape[2], h)

    jq, jk, jv, jdo = (jnp.asarray(fold(x), jnp.bfloat16)
                       for x in (q, k, v, do))
    jmask = None if mask is None else jnp.asarray(mask, jnp.float32)
    scale = 1.0 / math.sqrt(h)
    blocks = dict(block_q=jflash._auto_block(tq),
                  block_k=jflash._auto_block(tk))
    o, l, m = jflash._flash_forward(
        jq, jk, jv, scale, causal, blocks["block_q"], blocks["block_k"],
        True, kv_mask=jmask, n_heads=n)
    want = jflash._flash_backward(
        jq, jk, jv, o, l, m, jdo, scale=scale, causal=causal, interpret=True,
        kv_mask=jmask, n_heads=n, **blocks)

    def bf16(x):
        return _t(np.asarray(x, np.float32), torch.bfloat16)

    got = tflash.flash_backward_plain(
        bf16(jq), bf16(jk), bf16(jv), bf16(o), _t(np.array(l)),
        _t(np.array(m)), bf16(jdo), scale, causal,
        None if mask is None else _t(mask).float(), n)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = _f32(g), np.asarray(w, np.float32)
        d = np.abs(g - w)
        atol = 2.0 ** -8 * max(1.0, float(np.abs(w).max()))
        assert float((d - 2.0 ** -7 * np.abs(w)).max()) <= atol
        assert np.linalg.norm(d) <= 2.0 ** -8 * np.linalg.norm(w)
        if name.startswith("dead"):
            per_item = g.reshape(b, n, -1)
            assert np.array_equal(per_item[1], np.zeros_like(per_item[1]))
            assert np.abs(per_item[0]).max() > 0


HEAD_SIZES = [8, 32, 80, 128, 160, 256, 320, 512, 640]
# the spacing of the type's values at 1: 2^-7 for bfloat16, 2^-10 for
# float16 (unit roundoffs 2^-8 and 2^-11)
STEP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _close_half(got, want, dtype="bfloat16"):
    """A 16-bit result against JAX's: each element within rtol ``step``
    (one step of the output: both round a float32 sum, to neighbouring
    values at worst) plus ``step / 2`` of the largest value, and the
    relative rms error under ``step / 2``. The port rounds ``p`` and ``ds``
    to the operand type before the backward's products (as the tensor-core
    kernels must), JAX keeps them in float32: every term of a sum moves by
    up to one unit roundoff (``step / 2``) of itself, and the terms cancel,
    so the error follows the result's scale and not the element's. bf16:
    rtol 2^-7, atol and rms 2^-8 (measured rms 2.5e-3 to 2.8e-3); float16:
    rtol 2^-10, atol and rms 2^-11 = 4.9e-4 (measured rms 3.1e-4 to
    3.5e-4, the largest element 2.1e-4 past its rtol)."""
    step = STEP[dtype]
    got, want = _f32(got), np.asarray(want, np.float32)
    d = np.abs(got - want)
    atol = step / 2 * max(1.0, float(np.abs(want).max()))
    assert float((d - step * np.abs(want)).max()) <= atol
    assert np.linalg.norm(d) <= step / 2 * max(np.linalg.norm(want), 1e-30)


TYPES = {"float32": (jnp.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16),
         "float16": (jnp.float16, torch.float16)}


# every head size in the three types, 1088 (past one cluster of K3b's
# blocks on the card) and 1216 (past the wide K3a, on its cluster kernel on
# the card) in bf16, the type the card's kernels run them in
HEAD_CASES = [(h, dtype) for h in HEAD_SIZES
              for dtype in ("float32", "bfloat16", "float16")] + [
                  (1088, "bfloat16"), (1216, "bfloat16")]


@pytest.mark.parametrize("h,dtype", HEAD_CASES)
def test_head_sizes_match_jax_kernel(h, dtype):
    """The port's ``flash_attention`` at head sizes other than 64 (its plain
    versions, through the autograd function) against JAX's
    ``flash_attention`` in interpret mode, causal with a key mask and cross
    lengths 100 x 120: the output and the gradients of a random cotangent.
    float32 to 1e-5 (outputs) and 1e-4 (gradients), bf16 and float16 as
    ``_close_half``. On the card the kernels run these sizes at 64, 128,
    256 or the next multiple of 64 above 256 (320, 512, 640, 1088: the
    wide K3a, the sliced K3c and K3b's cluster kernel, whose clusters end
    in a part past the head at 320, 640 and 1088), at 32 in bfloat16 and
    float16 (the narrow kernels), zero-padded where the size is not one of
    them
    (``test_padded_plain_call_is_bit_equal``)."""
    rng = np.random.RandomState(h)
    shape_q, shape_kv = (2, 2, 100, h), (2, 2, 120, h)
    q, do = (rng.randn(*shape_q).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(*shape_kv).astype(np.float32) for _ in range(2))
    mask = _mask(h + 1, 2, 120, 2)
    jdt, tdt = TYPES[dtype]

    def jax_attention(q, k, v):
        return jflash.flash_attention(q, v, k, causal=True,
                                      kv_mask=jnp.asarray(mask))

    jin = [jnp.asarray(x, jdt) for x in (q, k, v)]
    want, vjp = jax.vjp(jax_attention, *jin)
    want_grads = vjp(jnp.asarray(do, jdt))
    tin = [_t(x, tdt).requires_grad_() for x in (q, k, v)]
    got = tflash.flash_attention(tin[0], tin[2], tin[1], causal=True,
                                 kv_mask=_t(mask))
    got_grads = torch.autograd.grad(got, tin, _t(do, tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape_q
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), np.asarray(want), atol=1e-5)
        for g, w in zip(got_grads, want_grads):
            np.testing.assert_allclose(_f32(g), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)
    else:
        _close_half(got, want, dtype)
        for g, w in zip(got_grads, want_grads):
            assert g.dtype == tdt
            _close_half(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", [8, 32, 80, 100, 160, 200, 288, 300, 16])
def test_padded_plain_call_is_bit_equal(h, dtype):
    """What the wrapper does on the card at a head size the kernels are not
    built at, in the plain versions: ``q, k, v`` and ``do`` zero-padded to
    ``kernel_head_size(h, dtype)`` (h 8 and 16 to 32 in bfloat16 and
    float16, on the narrow kernels, forward and backward alike; 64 in
    float32), the scale from the true ``h``, ``di`` from the unpadded ``o``
    and ``do``. Every output equals the unpadded call's bit for bit, and
    the padded columns are exact zeros. The backward runs on the padded
    forward's own ``o``, as the wrapper saves it: the same."""
    size = tflash.kernel_head_size(h, dtype)
    assert size == (32 if h <= 32 and dtype != torch.float32
                    else 64 if h <= 64 else 128 if h <= 128
                    else 256 if h <= 256 else -(-h // 64) * 64)
    g = torch.Generator().manual_seed(h)
    q, do = (torch.randn(6, 97, h, generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(6, 131, h, generator=g).to(dtype) for _ in range(2))
    mask = (torch.rand(2, 131, generator=g) > 0.3).float()
    pad = lambda x, n=size: tflash.pad_head(x, n)  # noqa: E731
    for causal in (False, True):
        args = (h ** -0.5, causal, mask, 3)
        o, l, m = tflash.flash_forward_plain(q, k, v, *args)
        po, pl, pm = tflash.flash_forward_plain(pad(q), pad(k), pad(v), *args)
        assert torch.equal(po[..., :h], o) and not po[..., h:].any()
        assert torch.equal(pl, l) and torch.equal(pm, m)
        want = tflash.flash_backward_plain(q, k, v, o, l, m, do, *args)
        got = tflash.flash_backward_plain(
            pad(q), pad(k), pad(v), po, pl, pm, pad(do), *args,
            di=tflash.delta(po[..., :h], do))
        for a, b in zip(got, want):
            assert a.dtype == dtype and a.shape[-1] == size
            assert torch.equal(a[..., :h], b) and not a[..., h:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_backward_head_size(dtype):
    """The one head size the kernels run a call at, forward and backward
    alike (``kernel_head_size``): K3a, K3b and K3c take head size 32 in
    bfloat16 and float16 (the narrow kernels), so the wrapper pads a
    smaller head only to 32 there and 32 itself not at all; float32 pads
    it to 64. Above 32 the types agree: the next built size, above 256 the
    next multiple of 64."""
    heads = (1, 8, 16, 32, 33, 48, 64, 100, 320)
    sizes = [tflash.kernel_head_size(h, dtype) for h in heads]
    narrow = dtype != torch.float32
    assert tflash.NARROW == 32
    assert sizes == ([32, 32, 32, 32] if narrow else [64] * 4) + [
        64, 64, 64, 128, 320]


def test_kernel_head_sizes_and_the_limit():
    """The kernels are built at 64, 128 and 256, and above 256 take every
    multiple of 64 (the sliced kernels): a size up to 256 runs padded to
    the next built one, a larger one to the next multiple of 64. There is
    no upper limit."""
    assert tflash.HEAD_SIZES == (64, 128, 256) and tflash.PANEL == 64
    f32 = torch.float32
    assert [tflash.kernel_head_size(h, f32) for h in (1, 8, 32, 64, 65, 80,
                                                      128, 129, 200, 256)] == [
        64, 64, 64, 64, 128, 128, 128, 256, 256, 256]
    for dtype in (f32, torch.bfloat16, torch.float16):
        assert [tflash.kernel_head_size(h, dtype)
                for h in (257, 288, 320, 321, 384, 512, 1000, 1024,
                          4000)] == [
            320, 320, 320, 384, 384, 512, 1024, 1024, 4032]
    x = torch.ones(2, 3, 5)
    assert tflash.pad_head(x, 5) is x
    assert tuple(tflash.pad_head(x, 64).shape) == (2, 3, 64)


def test_fully_masked_rows_have_zero_finite_gradients():
    q, k, v = _qkv(3, (2, 2, 40, 16))
    mask = np.ones((2, 40), bool)
    mask[1] = False  # batch item 1 has no valid key at all
    got = _torch_grads(
        lambda q, k, v: tflash.flash_attention(q, v, k, kv_mask=_t(mask)),
        q, k, v)
    for g in got:
        assert np.isfinite(g).all()
        assert np.array_equal(g[1], np.zeros_like(g[1]))
        assert np.abs(g[0]).max() > 0


def test_causal_rows_above_the_end_aligned_diagonal_are_zero():
    """More queries than keys: the first ``tq - tk`` rows see no key and
    give zeros, with ``l == 0`` and ``m`` at the mask value."""
    tq, tk = 9, 4
    q, k, v = _qkv(8, (1, 2, tq, 16), (1, 2, tk, 16))
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    out = tflash.flash_attention(ts[0], ts[2], ts[1], causal=True)
    out.pow(2).sum().backward()
    assert not out[:, :, :tq - tk].any() and out[:, :, tq - tk:].any()
    assert all(bool(torch.isfinite(t.grad).all()) for t in ts)
    assert not ts[0].grad[:, :, :tq - tk].any()
    dense = scaled_dot_product_attention(_t(q), _t(v), _t(k), causal=True)
    np.testing.assert_allclose(_f32(out[:, :, tq - tk:]),
                               _f32(dense[:, :, tq - tk:]), atol=2e-5)
    _, l, m = tflash.flash_forward_plain(
        *(_t(x).reshape(2, -1, 16) for x in (q, k, v)), 0.25, True)
    assert not l[:, :tq - tk].any()
    assert bool((m[:, :tq - tk] == tflash.MASK_VALUE).all())


def test_bf16_gradients_have_input_dtype_and_follow_float32():
    q, k, v = _qkv(4, (1, 2, 70, 64))
    mask = _t(_mask(5, 1, 70, 2))
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        ts = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
        out = tflash.flash_attention(ts[0], ts[2], ts[1], causal=True,
                                     kv_mask=mask)
        out.float().pow(2).sum().backward()
        assert all(t.grad.dtype == dtype for t in ts)
        grads[dtype] = [_f32(t.grad) for t in ts]
    for g16, g32 in zip(grads[torch.bfloat16], grads[torch.float32]):
        # bf16 inputs, probabilities and outputs: ~3 significant digits
        assert np.abs(g16 - g32).max() <= 0.05 * np.abs(g32).max()


def test_scale_is_a_divisor_and_key_defaults_to_value():
    q, k, v = _qkv(6, (1, 1, 9, 8))
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(v), scale=3.0)
    got = tflash.flash_attention(_t(q), _t(v), scale=3.0)
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=2e-5)
    dense = scaled_dot_product_attention(_t(q), _t(v), scale=3.0)
    np.testing.assert_allclose(_f32(got), _f32(dense), atol=2e-5)


def test_wrapper_rejects_what_it_does_not_take():
    q, k, v = (_t(x) for x in _qkv(7, (2, 2, 5, 8)))
    with pytest.raises(ValueError, match="kv_mask shape"):
        tflash.flash_attention(q, v, k, kv_mask=torch.ones(2, 4).bool())
    with pytest.raises(ValueError, match="kv_mask shape"):
        jflash.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(v.numpy()),
                               kv_mask=jnp.ones((2, 4), bool))
    with pytest.raises(TypeError, match="float16"):
        tflash.flash_attention(q.double(), v.double(), k.double())
    with pytest.raises(ValueError):
        tflash.flash_attention(q, v[:, :, :4], k)
    assert set(tflash.flash_attention.launches) == {"fwd", "dkv", "dq"}


def test_cpu_calls_count_no_kernel_launch():
    """The launch counters belong to the kernels: a call on CPU tensors runs
    the plain versions, forward and backward, and counts nothing. K3a's
    counter by kernel holds every forward kernel the library's dispatch
    names, in its order, K3b's every dK/dV kernel and K3c's every dQ
    kernel."""
    counts = tflash.flash_attention.forward_launches
    backward = tflash.flash_attention.backward_launches
    dq = tflash.flash_attention.dq_launches
    assert tuple(counts) == tflash.KERNEL_NAMES["fwd"]
    assert tuple(backward) == tflash.KERNEL_NAMES["dkv"]
    assert tuple(dq) == tflash.KERNEL_NAMES["dq"]
    assert "flash_fwd_short_kernel" in counts
    assert "flash_fwd_narrow_kernel" in counts
    assert "flash_bwd_dkv_short_kernel" in backward
    assert "flash_bwd_dkv_narrow_kernel" in backward
    assert "flash_bwd_dq_narrow_kernel" in dq
    before = (dict(tflash.flash_attention.launches), dict(counts),
              dict(backward), dict(dq))
    for h in (64, 32):  # 32: the narrow kernels' size on the card
        q, k, v = (_t(x, torch.bfloat16).requires_grad_()
                   for x in _qkv(19, (1, 2, 198, h)))
        tflash.flash_attention(q, v, k).float().pow(2).sum().backward()
        assert q.grad is not None
        assert bool(torch.isfinite(q.grad.float()).all())
    assert (dict(tflash.flash_attention.launches), dict(counts),
            dict(backward), dict(dq)) == before


@pytest.mark.parametrize("kind", ["self_masked", "cross_causal_masked"])
def test_multi_head_attention_flash_matches_jax_module(kind):
    rng = np.random.RandomState(0)
    b, t, d, n = 2, 140, 32, 4
    x = rng.randn(b, t, d).astype(np.float32)
    mask = rng.rand(b, t) > 0.25
    mask[:, 0] = True
    causal = kind != "self_masked"
    if causal:
        mem = rng.randn(b, t, d).astype(np.float32)
        jin, tin = [x, mem, mem], [_t(x), _t(mem), _t(mem)]
        tin[2] = tin[1]
    else:
        jin, tin = [x, x], [_t(x)] * 3
    jmod = JaxMHA(head_dim=d // n, num_heads=n, dropout_rate=0.0,
                  causal=causal, attention_impl="flash")
    params = jmod.init(jax.random.PRNGKey(0), jin)["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.random.RandomState(1).randn(*a.shape).astype(
            np.float32), params)
    want = jmod.apply({"params": params}, jin, mask=[mask, mask])
    port = MultiHeadAttention(d, d // n, n, causal=causal,
                              attention_impl="flash", device=CPU)
    port.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    got = port.eval()(tin, mask=[_t(mask), _t(mask)])
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=2e-5)


def test_multi_head_attention_flash_refuses_score_dtype():
    x = _t(_qkv(0, (1, 4, 8))[0])
    with pytest.raises(ValueError, match="score_dtype"):
        MultiHeadAttention(8, 4, 2, attention_impl="flash",
                           score_dtype=torch.bfloat16, device=CPU)([x, x, x])
    jx = jnp.asarray(x.numpy())
    jmod = JaxMHA(head_dim=4, num_heads=2, attention_impl="flash",
                  score_dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="score_dtype"):
        jmod.init(jax.random.PRNGKey(0), [jx, jx])


def test_attention_dropout_keep_share_scaling_and_dense_switch():
    rate, t = 0.25, 64
    q = torch.zeros(1, 1, t, 4)          # uniform probabilities 1 / t
    v = torch.ones(1, 1, t, 4)
    gen = torch.Generator().manual_seed(0)
    out = scaled_dot_product_attention(q, v, dropout_rate=rate,
                                       deterministic=False, generator=gen)
    # each row sums kept probabilities (1/t) / (1 - rate): the keep share
    kept = out[0, 0, :, 0] * (1 - rate)
    assert abs(float(kept.mean()) - (1 - rate)) < 0.03
    assert float(kept.min()) < 1.0 and bool(
        torch.allclose(kept * t, (kept * t).round(), atol=1e-4))
    same = scaled_dot_product_attention(q, v, dropout_rate=rate,
                                        deterministic=True)
    assert bool(torch.allclose(same, torch.ones_like(same)))
    with pytest.raises(NotImplementedError):
        scaled_dot_product_attention(q, v, dropout_rate=rate,
                                     deterministic=False, impl="flash")

    # the module never gives way to the dense path on its own: with
    # attention_impl="flash" an active dropout raises, and the kernel path
    # runs whenever dropout is off
    x = _t(_qkv(2, (2, 10, 16))[0])
    mha = MultiHeadAttention(16, 8, 2, attention_impl="flash",
                             dropout_rate=rate, device=CPU)
    mha.reset_parameters(torch.Generator().manual_seed(1))
    dense = MultiHeadAttention(16, 8, 2, dropout_rate=rate, device=CPU)
    dense.load_state_dict(mha.state_dict())
    with pytest.raises(NotImplementedError, match="dropout"):
        mha.train()([x, x, x], generator=torch.Generator().manual_seed(3))
    b = dense.train()([x, x, x], generator=torch.Generator().manual_seed(3))
    c = mha.eval()([x, x, x])
    assert not torch.equal(b, c)
    assert torch.equal(mha.train()([x, x, x], deterministic=True), c)
    np.testing.assert_allclose(_f32(c), _f32(dense.eval()([x, x, x])),
                               atol=2e-5)


def test_float16_seq2seq_on_flash_matches_jax():
    """A small float16 ``Seq2SeqTransformer`` on flash attention (2 + 2
    layers, width 64, 4 heads of 16, vocabulary 64, ragged padding) built
    under ``use_mixed_precision("float16")`` in both packages from the same
    converted (perturbed) weights: logits, masked cross-entropy and the
    float32 parameters' gradients against JAX's with its flash kernels in
    interpret mode.

    Tolerance: every layer rounds its activations to float16 (unit
    roundoff 2^-11), after sums taken in another order in the two
    frameworks, and the port rounds ``p`` and ``ds`` in the backward where
    JAX does not (``_close_half``); over the dozen roundings on the path a
    logit moves by a few float16 steps. Logits within 2^-8 of the largest
    logit (measured 4.4e-3 at |logit| <= 3.54 against 1.38e-2), the loss to
    rtol 2^-10 (measured 2.3e-5), each gradient within 2^-8 of the largest
    gradient (measured 1.5e-4 at 0.12 against 4.7e-4)."""
    from chambers_tpu.models import Seq2SeqTransformer as JaxSeq2Seq
    from chambers_tpu.utils.generic import use_mixed_precision as jax_policy
    from chambers_tpu_torch.models import Seq2SeqTransformer
    from chambers_tpu_torch.utils.generic import use_mixed_precision
    import optax

    vocab = 64
    rng = np.random.RandomState(3)
    src, tgt = (rng.randint(1, vocab, (4, 24)) for _ in range(2))
    src[1, 17:] = 0
    tgt[2, 15:] = 0
    kw = dict(input_vocab_size=vocab, output_vocab_size=vocab, embed_dim=64,
              num_heads=4, dim_feedforward=128, num_encoder_layers=2,
              num_decoder_layers=2, dropout_rate=0.0, attention_impl="flash")
    jmodel = JaxSeq2Seq(dtype=jax_policy("float16"), **kw)
    port = Seq2SeqTransformer(device=CPU, dtype=use_mixed_precision(
        "float16"), **kw)
    params = _dense_twin_init(jmodel, jax.random.PRNGKey(0), (src, tgt))
    leaves, tree = jax.tree_util.tree_flatten(params)
    noise = np.random.RandomState(5)
    params = jax.tree_util.tree_unflatten(
        tree, [a + 0.05 * noise.randn(*a.shape).astype(np.float32)
               for a in leaves])
    port.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    port.eval()

    def jax_loss(p):
        logits = jmodel.apply({"params": p}, (src, tgt), deterministic=True)
        labels = jnp.roll(tgt, -1, axis=1)
        mask = (labels != 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), labels)
        return jnp.sum(ce * mask) / jnp.sum(mask), logits

    (loss_want, logits_want), grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    tsrc, ttgt = torch.from_numpy(src), torch.from_numpy(tgt)
    logits = port([tsrc, ttgt], deterministic=True)
    labels = torch.roll(ttgt, -1, dims=1)
    mask = (labels != 0).float()
    ce = torch.nn.functional.cross_entropy(
        logits.float().flatten(0, 1), labels.flatten().long(),
        reduction="none")
    loss = (ce * mask.flatten()).sum() / mask.sum()
    loss.backward()

    assert logits.dtype == torch.float16 and logits_want.dtype == jnp.float16
    want = np.asarray(logits_want, np.float32)
    np.testing.assert_allclose(_f32(logits), want,
                               atol=2.0 ** -8 * np.abs(want).max())
    np.testing.assert_allclose(loss.item(), float(loss_want), rtol=2.0 ** -10)
    want_grads = state_dict_from_jax(jax.device_get(grads))
    named = dict(port.named_parameters())
    assert set(named) == set(want_grads)
    largest = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in named.items():
        assert p.grad.dtype == torch.float32
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=2.0 ** -8 * largest, err_msg=name)


def test_float16_flash_exports_through_the_operator():
    """A float16 flash call traces: ``torch.export`` of a causal, masked
    ``flash_attention`` on float16 operands calls the K3a operator
    ``chambers_tpu_torch::flash_fwd`` once (its fake registration gives the
    tracer float16 ``o`` and float32 ``l, m``), and the program gives the
    eager call's bits."""

    class Attend(torch.nn.Module):
        def forward(self, q, k, v, mask):
            return tflash.flash_attention(q, v, k, causal=True, kv_mask=mask)

    q, k, v = (_t(x, torch.float16) for x in _qkv(9, (2, 2, 24, 32)))
    mask = _t(_mask(10, 2, 24, 1))
    with torch.no_grad():
        program = torch.export.export(Attend(), (q, k, v, mask))
        want = Attend()(q, k, v, mask)
        got = program.module()(q, k, v, mask)
    calls = [n for n in program.graph.nodes if n.op == "call_function"
             and "chambers_tpu_torch.flash_fwd" in str(n.target)]
    assert len(calls) == 1
    assert got.dtype == torch.float16 and torch.equal(got, want)


def test_one_head_seq2seq_at_width_320_matches_jax():
    """The slice as a whole on the CPU: a float32 ``Seq2SeqTransformer`` on
    flash attention over one head of width 320 (2 + 2 layers, vocabulary
    64, ragged padding), a head size that runs on the card in the sliced
    kernels, with weights from the JAX package's init through
    ``state_dict_from_jax``: logits, the masked cross-entropy and every
    parameter's gradient against JAX's with its flash kernels in interpret
    mode. float32 sums taken in other orders: logits and the loss to 1e-5,
    gradients to 1e-4 of the largest gradient."""
    from chambers_tpu.models import Seq2SeqTransformer as JaxSeq2Seq
    from chambers_tpu_torch.models import Seq2SeqTransformer
    import optax

    vocab = 64
    rng = np.random.RandomState(4)
    src, tgt = (rng.randint(1, vocab, (3, 20)) for _ in range(2))
    src[1, 13:] = 0
    tgt[2, 11:] = 0
    kw = dict(input_vocab_size=vocab, output_vocab_size=vocab,
              embed_dim=320, num_heads=1, dim_feedforward=128,
              num_encoder_layers=2, num_decoder_layers=2, dropout_rate=0.0,
              attention_impl="flash")
    jmodel = JaxSeq2Seq(**kw)
    port = Seq2SeqTransformer(device=CPU, **kw)
    params = _dense_twin_init(jmodel, jax.random.PRNGKey(1), (src, tgt))
    port.load_state_dict(state_dict_from_jax(jax.device_get(params)))
    port.eval()

    def jax_loss(p):
        logits = jmodel.apply({"params": p}, (src, tgt), deterministic=True)
        labels = jnp.roll(tgt, -1, axis=1)
        mask = (labels != 0).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return jnp.sum(ce * mask) / jnp.sum(mask), logits

    (loss_want, logits_want), grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    tsrc, ttgt = torch.from_numpy(src), torch.from_numpy(tgt)
    logits = port([tsrc, ttgt], deterministic=True)
    labels = torch.roll(ttgt, -1, dims=1)
    mask = (labels != 0).float()
    ce = torch.nn.functional.cross_entropy(
        logits.flatten(0, 1), labels.flatten().long(), reduction="none")
    loss = (ce * mask.flatten()).sum() / mask.sum()
    loss.backward()

    assert logits.dtype == torch.float32 and logits.shape == (3, 20, vocab)
    np.testing.assert_allclose(_f32(logits), np.asarray(logits_want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(loss_want), rtol=1e-5)
    want_grads = state_dict_from_jax(jax.device_get(grads))
    named = dict(port.named_parameters())
    assert set(named) == set(want_grads)
    largest = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-4 * largest, err_msg=name)
