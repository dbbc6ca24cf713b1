"""The CUDA kernels K1, K2 and K3a-c (flash attention forward, dK/dV, dQ)
against their plain PyTorch versions on the card, at odd sizes the main
paths do not reach. Each of K3a, K3b, K3c is two kernels: bf16 operands
take the tensor-core one, float32 the FMA one. Marked ``cuda``:
they skip on a machine without a card. On the card:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import math

import pytest
import torch

from chambers_tpu_torch.augmentations.augmentation_schemes import RandAugment
from chambers_tpu_torch.ops import flash_attention as fa
from chambers_tpu_torch.ops import image_ops as iops
from chambers_tpu_torch.ops import warp_kernels as wk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU path is held to the JAX "
                    "package in test_torch_warp_kernels.py")
    return torch.device("cuda")


def _mats(b, h, w, dev):
    rad = torch.tensor([math.radians(29.0), -math.radians(17.0)], device=dev)
    kinds = torch.cat([
        iops.identity_matrices(1, dev), iops.rotation_matrices(rad, h, w),
        iops.shear_x_matrices(torch.tensor([0.27], device=dev)),
        iops.shear_y_matrices(torch.tensor([-0.3], device=dev)),
        iops.translate_x_matrices(torch.tensor([-7.5], device=dev)),
        iops.translate_y_matrices(torch.tensor([500.0], device=dev)),
    ])
    return kinds[torch.arange(b, device=dev) % kinds.shape[0]]


@pytest.mark.parametrize("b,h,w,c,pad", [(7, 37, 29, 3, 10), (5, 64, 48, 1, 9),
                                         (3, 5, 300, 4, 2)])
def test_warp_kernel_matches_plain(dev, b, h, w, c, pad):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (b, h, w, c), dtype=torch.uint8, device=dev,
                      generator=g)
    mats = _mats(b, h, w, dev)
    got = wk.transform_affine_separable(x, mats, 77, pad)
    n1, n2, n3 = wk._shift_vectors(mats, b, h, w, pad)
    assert torch.equal(got, wk.warp_plain(x, n1, n2, n3, 77, pad))


@pytest.mark.parametrize("factor", [1.72, 1.9, "per_image"])
def test_fused_round_kernel_matches_plain(dev, factor):
    g = torch.Generator(device=dev).manual_seed(1)
    b, h, w = 15, 41, 33
    x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=dev,
                      generator=g)
    if factor == "per_image":
        factor = torch.rand(b, device=dev, generator=g) * 1.8 + 0.1
    op_class = torch.arange(b, device=dev) % 5
    cy = torch.randint(-5, h + 5, (b,), device=dev, generator=g)
    cx = torch.randint(-5, w + 5, (b,), device=dev, generator=g)
    kw = dict(fill_value=128, pad=8, color_factor=factor,
              sharp_factor=factor, cut_half=9, cut_fill=3)
    mats = _mats(b, h, w, dev)
    got = wk.fused_round(x, mats, op_class, cy, cx, **kw)
    want = wk.fused_round_plain(
        x, *wk.fused_round_args(x, mats, op_class, cy, cx, **kw))
    assert torch.equal(got, want)


def test_randaugment_compositions_equal(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randint(0, 256, (16, 64, 64, 3), dtype=torch.uint8, device=dev,
                      generator=g)
    for magnitude in (10, 9, 0):
        fused = RandAugment(2, magnitude, elementwise=True)
        masked = RandAugment(2, magnitude, elementwise=True,
                             fused_round_kernel=False)
        draws = fused.sample(16, (64, 64), g, dev)
        cpu_draws = [{k: v.cpu() for k, v in d.items()} for d in draws]
        got = fused.apply(x, draws)
        assert torch.equal(got, masked.apply(x, draws))
        assert torch.equal(got.cpu(), fused.apply(x.cpu(), cpu_draws))


def test_kernel_wrappers_count_and_reject(dev):
    x = torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device=dev)
    ident = iops.identity_matrices(2, dev)
    before = wk.transform_affine_separable.launches
    assert torch.equal(wk.transform_affine_separable(x, ident, 0, 2), x)
    assert wk.transform_affine_separable.launches == before + 1
    with pytest.raises(ValueError):
        wk.transform_affine_separable(x.permute(0, 2, 1, 3), ident, 0, 2)
    with pytest.raises(TypeError):
        wk.fused_round(x.float(), ident, 0, 0, 0, fill_value=0, pad=2,
                       color_factor=1.0, sharp_factor=1.0, cut_half=0,
                       cut_fill=0)


# (b, n, tq, tk, h, dtype, causal, masked): ragged edges, one tile and many,
# cross lengths with the diagonal at the end (more keys than queries and
# fewer), bn not a multiple of anything; masked is False, True (about 30%
# of the keys dropped anywhere, the last batch item none kept) or "ragged"
# (20-30% trailing padding, as the train step's batches)
FLASH_CASES = [
    (2, 3, 197, 197, 64, torch.float32, False, False),
    (1, 2, 130, 260, 64, torch.float32, True, False),
    (1, 2, 4, 8, 64, torch.float32, True, True),
    (3, 2, 70, 150, 64, torch.float32, False, True),
    (2, 5, 257, 257, 64, torch.bfloat16, True, True),
    (1, 1, 63, 65, 64, torch.bfloat16, False, True),
    (2, 2, 64, 1, 64, torch.float32, False, False),
    (1, 2, 260, 130, 64, torch.float32, True, False),  # rows with no key
    # the same edges for the bf16 backward kernels (tiles of 64 rows, one
    # warpgroup a block in K3b, two in K3c): the last batch item of a masked case has no
    # valid key, the others do
    (1, 2, 130, 260, 64, torch.bfloat16, True, False),
    (1, 2, 260, 130, 64, torch.bfloat16, True, False),
    (2, 1, 63, 65, 64, torch.bfloat16, False, True),
    (3, 2, 70, 150, 64, torch.bfloat16, False, True),
    (2, 2, 64, 1, 64, torch.bfloat16, False, False),
    (2, 12, 197, 197, 64, torch.bfloat16, False, False),
    (2, 3, 300, 200, 64, torch.bfloat16, True, True),
    # the bf16 forward kernel's own edges: one query row, the train step's
    # shape cut in batch, and queries so far past the keys under the causal
    # mask that whole blocks see no key
    (2, 2, 1, 300, 64, torch.bfloat16, False, True),
    (8, 8, 512, 512, 64, torch.bfloat16, False, "ragged"),
    (1, 2, 500, 100, 64, torch.bfloat16, True, False),
]


def _flash_inputs(dev, b, n, tq, tk, h, dtype, masked, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(t):
        return torch.randn((b * n, t, h), device=dev, generator=g).to(dtype)

    q, k, v, do = rand(tq), rand(tk), rand(tk), rand(tq)
    mask = None
    if masked == "ragged":
        keep = tk * (0.7 + 0.1 * torch.rand((b, 1), device=dev, generator=g))
        mask = (torch.arange(tk, device=dev) < keep.long()).float()
    elif masked:
        mask = (torch.rand((b, tk), device=dev, generator=g) > 0.3).float()
        mask[:, 0] = 1.0
        mask[-1] = 0.0  # the last batch item has no valid key
    return q, k, v, do, mask


def _assert_close(got, ref, dtype, grad=False, cancels=False):
    """Element-wise |d| <= atol + rtol |ref| and a relative rms limit.
    float32: sums run in another order (2e-5 on outputs, 1e-4 of a
    gradient's largest value, rms 1e-5). bf16: rtol is one step of the
    output type, atol the two roundings of the probabilities (2^-9 of each
    term p v on either side), and the rms of evenly spread rounding errors
    stays under half a step. ``cancels``: the value is zero analytically
    (with one key p = 1 and ds = do . v - di = 0, so dq = dk = 0) and what
    is left on either side is the difference of two float32 sums of 64
    products taken in two orders, ~1e-6; a relative error of that says
    nothing, so both sides are held to 2e-5 in absolute value instead."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    if dtype == torch.float32:
        rtol, rms = 0.0, 1e-5
        atol = 1e-4 * max(1.0, float(ref.abs().max())) if grad else 2e-5
    else:
        rtol, atol, rms = 2.0 ** -7, 2.0 ** -8, 2.0 ** -8
    assert float((d - rtol * ref.abs()).max()) <= atol
    if cancels:
        assert max(float(got.abs().max()), float(ref.abs().max())) <= 2e-5
    else:  # a reference of exact zeros (no valid key) takes exact zeros
        norm = float(ref.norm())
        assert float(d.norm()) / (norm if norm else 1.0) <= rms


@pytest.mark.parametrize("b,n,tq,tk,h,dtype,causal,masked", FLASH_CASES)
def test_flash_kernels_match_plain(dev, b, n, tq, tk, h, dtype, causal,
                                   masked):
    q, k, v, do, mask = _flash_inputs(dev, b, n, tq, tk, h, dtype, masked)
    scale = h ** -0.5
    o, l, m = fa.launch_forward(q, k, v, mask, scale, causal, n)
    o_p, l_p, m_p = fa.flash_forward_plain(q, k, v, scale, causal, mask, n)
    torch.cuda.synchronize()
    _assert_close(o, o_p, dtype)
    assert bool(torch.isfinite(m).all())
    assert torch.allclose(m, m_p, rtol=1e-5, atol=1e-5)
    assert torch.allclose(l, l_p, rtol=1e-4, atol=1e-6)
    # no atomics in the forward either: a second launch gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(
        fa.launch_forward(q, k, v, mask, scale, causal, n), (o, l, m)))
    if masked is True:  # the last batch item has no valid key
        assert not o[-n:].any() and not l[-n:].any()
        assert bool((m[-n:] == fa.MASK_VALUE).all())

    # the backward kernels on the forward kernel's own saved o, l, m, as
    # the autograd function chains them
    args = (q, k, v, do, l, m, fa.delta(o, do), mask, scale, causal, n)
    dk, dv = fa.launch_backward_dkv(*args)
    dq = fa.launch_backward_dq(*args)
    want = fa.flash_backward_plain(q, k, v, o_p, l_p, m_p, do, scale, causal,
                                   mask, n)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        _assert_close(got, ref, dtype, grad=True,
                      cancels=tk == 1 and name != "dv")
    # each output is written once by one block, no atomics: the same bits
    again = (fa.launch_backward_dq(*args), *fa.launch_backward_dkv(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
    if masked is True:
        assert not dq[-n:].any() and not dk[-n:].any() and not dv[-n:].any()
    if causal and tq > tk:  # rows above the end-aligned diagonal
        assert not o[:, :tq - tk].any() and not dq[:, :tq - tk].any()
        assert not l[:, :tq - tk].any()
        assert bool((m[:, :tq - tk] == fa.MASK_VALUE).all())


def test_tile_products_match_matmul(dev):
    """One product of each kind of the bf16 backward's tiling, alone: ``x
    yᵀ`` from two swizzled tiles in shared memory, and its bf16 rounding
    times ``y`` read along its rows with the first accumulator as the
    register operand. Sums of 64 bf16 products in float32, in another order
    than ``torch.matmul``'s: 1e-5 of the largest value. Known values first:
    with ``y`` the identity both products return ``x``."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((128, 64), device=dev, generator=g).bfloat16()
    nt, tn = fa.tile_products(x, torch.eye(64, device=dev).bfloat16())
    torch.cuda.synchronize()
    assert torch.equal(nt, x.float()) and torch.equal(tn, x.float())
    y = torch.randn((64, 64), device=dev, generator=g).bfloat16()
    nt, tn = fa.tile_products(x, y)
    torch.cuda.synchronize()
    nt_ref = x.float() @ y.float().T
    tn_ref = nt.bfloat16().float() @ y.float()
    assert float((nt - nt_ref).abs().max()) <= 1e-5 * float(nt_ref.abs().max())
    assert float((tn - tn_ref).abs().max()) <= 1e-5 * float(tn_ref.abs().max())
    with pytest.raises(ValueError):
        fa.tile_products(x.float(), y)


def _kernel_names(fn):
    """The names of the kernels ``fn`` launches, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages())


def test_forward_dtype_chooses_the_kernels(dev):
    """bf16 operands run the tensor-core forward, float32 the FMA one: read
    from the profiler's kernel names."""
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _, mask = _flash_inputs(dev, 1, 2, 96, 80, 64, dtype, True)
        names[dtype] = _kernel_names(
            lambda: fa.launch_forward(q, k, v, mask, 0.125, False, 2))
    assert "flash_fwd_kernel" in names[torch.float32]
    assert "_tc_kernel" not in names[torch.float32]
    assert "flash_fwd_tc_kernel" in names[torch.bfloat16]
    assert "flash_fwd_kernel" not in names[torch.bfloat16]


def test_backward_dtype_chooses_the_kernels(dev):
    """bf16 operands run the tensor-core kernels, float32 the FMA kernels:
    read from the profiler's kernel names."""
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, _ = _flash_inputs(dev, 1, 2, 96, 80, 64, dtype, False)
        o, l, m = fa.launch_forward(q, k, v, None, 0.125, False, 2)
        args = (q, k, v, do, l, m, fa.delta(o, do), None, 0.125, False, 2)
        names[dtype] = _kernel_names(lambda: (fa.launch_backward_dkv(*args),
                                              fa.launch_backward_dq(*args)))
    assert "flash_bwd_dkv_kernel" in names[torch.float32]
    assert "flash_bwd_dq_kernel" in names[torch.float32]
    assert "_tc_kernel" not in names[torch.float32]
    assert "flash_bwd_dkv_tc_kernel" in names[torch.bfloat16]
    assert "flash_bwd_dq_tc_kernel" in names[torch.bfloat16]


def test_flash_attention_autograd_counts_and_rejects(dev):
    b, n, t, h = 2, 2, 100, 64
    g = torch.Generator(device=dev).manual_seed(3)
    # slices of one stacked projection, as the attention layer hands over
    qkv = torch.randn((3, b, n, t, h), device=dev, generator=g,
                      requires_grad=True)
    mask = torch.rand((b, t), device=dev, generator=g) > 0.2
    mask[:, 0] = True
    before = dict(fa.flash_attention.launches)
    out = fa.flash_attention(qkv[0], qkv[1], qkv[2], causal=True,
                             kv_mask=mask)
    out.pow(2).sum().backward()
    after = fa.flash_attention.launches
    assert {k: after[k] - before[k] for k in after} == {
        "fwd": 1, "dkv": 1, "dq": 1}
    cpu = qkv.detach().cpu().requires_grad_()
    ref = fa.flash_attention(cpu[0], cpu[1], cpu[2], causal=True,
                             kv_mask=mask.cpu())
    ref.pow(2).sum().backward()
    assert float((out.detach().cpu() - ref.detach()).abs().max()) <= 2e-5
    assert float((qkv.grad.cpu() - cpu.grad).abs().max()) <= 1e-3
    # permuted views are copied, not refused; other head sizes are refused
    perm = torch.randn((b, t, n, h), device=dev, generator=g).permute(
        0, 2, 1, 3)
    got = fa.flash_attention(perm, perm)
    want = fa.flash_attention(perm.cpu(), perm.cpu())
    assert float((got.cpu() - want).abs().max()) <= 2e-5
    bad = torch.randn((1, 1, 8, 48), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(bad, bad)
