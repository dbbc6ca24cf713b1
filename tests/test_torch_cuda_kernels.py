"""The CUDA kernels K1, K2 and K3a-c (flash attention forward, dK/dV, dQ)
against their plain PyTorch versions on the card, at odd sizes the main
paths do not reach. Each of K3a, K3b, K3c is two kernels: bf16 and float16
operands take the tensor-core one, float32 the FMA one (at head size 256
its ``_cols`` form). Marked ``cuda``:
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


def _round_inputs(dev, b, h, w, seed, op_class=None, mats=None,
                  cy=None, cx=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=dev,
                      generator=g)
    if op_class is None:
        op_class = torch.arange(b, device=dev, dtype=torch.int32) % 5
    if cy is None:
        cy = torch.randint(-5, h + 5, (b,), device=dev, generator=g)
        cx = torch.randint(-5, w + 5, (b,), device=dev, generator=g)
    if mats is None:
        mats = _mats(b, h, w, dev)
    return x, mats, op_class, cy, cx


def _round_matches_plain(x, mats, op_class, cy, cx, **kw):
    """K1 against its plain version, twice (the same bits both times)."""
    got = wk.fused_round(x, mats, op_class, cy, cx, **kw)
    again = wk.fused_round(x, mats, op_class, cy, cx, **kw)
    want = wk.fused_round_plain(
        x, *wk.fused_round_args(x, mats, op_class, cy, cx, **kw))
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, got)
    return got


ROUND_KW = dict(fill_value=128, pad=8, color_factor=1.72, sharp_factor=1.9,
                cut_half=9, cut_fill=3)


def test_fused_round_kernel_at_384px(dev):
    """All five classes over rounds of a batch of 4 at 384 px, the size of
    the AutoAugment ViT-L/16 config, with its padding."""
    for shift in range(5):
        op = (torch.arange(4, device=dev, dtype=torch.int32) + shift) % 5
        x, mats, op, cy, cx = _round_inputs(dev, 4, 384, 384, shift,
                                            op_class=op)
        _round_matches_plain(x, mats, op, cy, cx, **dict(ROUND_KW, pad=54))


@pytest.mark.parametrize("h", [1, 2, 3])
def test_kernels_on_images_of_few_rows(dev, h):
    """Fewer rows than a block takes, and Sharpness with no interior."""
    x, mats, op, cy, cx = _round_inputs(dev, 10, h, 64, h)
    _round_matches_plain(x, mats, op, cy, cx, **ROUND_KW)
    got = wk.transform_affine_separable(x, mats, 77, 8)
    n1, n2, n3 = wk._shift_vectors(mats, 10, h, 64, 8)
    assert torch.equal(got, wk.warp_plain(x, n1, n2, n3, 77, 8))


def test_fused_round_fills_and_cutout_outside(dev):
    """A 1000 px translation fills every byte; cutout centres outside the
    image change nothing, centres on its corners cut a quarter square."""
    b, h, w = 6, 64, 48
    far = iops.translate_x_matrices(torch.full((b,), 1000.0, device=dev))
    op = torch.full((b,), wk.WARP, dtype=torch.int32, device=dev)
    x, mats, op, cy, cx = _round_inputs(dev, b, h, w, 5, op_class=op,
                                        mats=far)
    assert bool((_round_matches_plain(x, mats, op, cy, cx, **ROUND_KW)
                 == 128).all())
    op = torch.full((b,), wk.CUTOUT, dtype=torch.int32, device=dev)
    cy = torch.tensor([-50, h + 50, -9, h + 9, 0, h], device=dev)
    cx = torch.tensor([3, 3, -9, w + 9, 0, w], device=dev)
    got = _round_matches_plain(x, iops.identity_matrices(b, dev), op, cy, cx,
                               **ROUND_KW)
    assert torch.equal(got[:4], x[:4])
    assert bool((got[4, :9, :9] == 3).all()) and torch.equal(got[4, 9:],
                                                             x[4, 9:])


@pytest.mark.parametrize("c", [1, 3, 4, 2])
@pytest.mark.parametrize("shape,offset", [((41, 33), 0), ((40, 48), 1)])
def test_warp_kernel_any_channels_unaligned(dev, c, shape, offset):
    """Planes of odd sizes, and a batch that starts one byte past a 16-byte
    boundary: the byte path, for every channel count."""
    b, (h, w) = 5, shape
    g = torch.Generator(device=dev).manual_seed(c)
    n = b * h * w * c
    store = torch.randint(0, 256, (n + offset,), dtype=torch.uint8,
                          device=dev, generator=g)
    x = store[offset:].view(b, h, w, c)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    mats = _mats(b, h, w, dev)
    got = wk.transform_affine_separable(x, mats, 77, 9)
    again = wk.transform_affine_separable(x, mats, 77, 9)
    n1, n2, n3 = wk._shift_vectors(mats, b, h, w, 9)
    want = wk.warp_plain(x, n1, n2, n3, 77, 9)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, got)


def test_image_beyond_the_limit_raises(dev):
    """An image of 2^31 bytes or more is beyond the kernels' 32-bit offsets:
    refused with the limit named, and counted as no launch."""
    x = torch.zeros((1, 46341, 46341, 1), dtype=torch.uint8, device=dev)
    before = wk.transform_affine_separable.launches
    with pytest.raises(ValueError, match="at most 2147483647 bytes"):
        wk.transform_affine_separable(x, iops.identity_matrices(1, dev), 0, 4)
    assert wk.transform_affine_separable.launches == before


def test_fused_round_is_one_launch(dev):
    """With the per-image inputs on the device in the kernel's types, a
    call launches one CUDA kernel and nothing else."""
    from torch.profiler import ProfilerActivity, profile

    x, mats, op, cy, cx = _round_inputs(dev, 8, 64, 64, 6)
    wk.fused_round(x, mats, op, cy, cx, **ROUND_KW)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wk.fused_round(x, mats, op, cy, cx, **ROUND_KW)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [e.name for e in kernels if "fused_round_kernel" in e.name]
    assert len(kernels) == 1, [e.name for e in kernels]


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


# (b, n, tq, tk, dtype, causal, masked), each at every head size of HEADS:
# ragged edges, one tile and many,
# cross lengths with the diagonal at the end (more keys than queries and
# fewer), bn not a multiple of anything; masked is False, True (about 30%
# of the keys dropped anywhere, the last batch item none kept) or "ragged"
# (20-30% trailing padding, as the train step's batches)
FLASH_CASES = [
    (2, 3, 197, 197, torch.float32, False, False),
    (1, 2, 130, 260, torch.float32, True, False),
    (1, 2, 4, 8, torch.float32, True, True),
    (3, 2, 70, 150, torch.float32, False, True),
    (2, 5, 257, 257, torch.bfloat16, True, True),
    (1, 1, 63, 65, torch.bfloat16, False, True),
    (2, 2, 64, 1, torch.float32, False, False),
    (1, 2, 260, 130, torch.float32, True, False),  # rows with no key
    # the same edges for the bf16 backward kernels (tiles of 64 rows, one
    # warpgroup a block in K3b, two in K3c): the last batch item of a masked
    # case has no valid key, the others do
    (1, 2, 130, 260, torch.bfloat16, True, False),
    (1, 2, 260, 130, torch.bfloat16, True, False),
    (2, 1, 63, 65, torch.bfloat16, False, True),
    (3, 2, 70, 150, torch.bfloat16, False, True),
    (2, 2, 64, 1, torch.bfloat16, False, False),
    (2, 12, 197, 197, torch.bfloat16, False, False),
    # DeiT-B/16's 198 tokens with no key mask: the last key tile holds 6
    # keys of 64, covered by the kernels' bounds alone
    (2, 12, 198, 198, torch.bfloat16, False, False),
    (2, 3, 300, 200, torch.bfloat16, True, True),
    # the bf16 forward kernel's own edges: one query row, the train step's
    # shape cut in batch, and queries so far past the keys under the causal
    # mask that whole blocks see no key
    (2, 2, 1, 300, torch.bfloat16, False, True),
    (8, 8, 512, 512, torch.bfloat16, False, "ragged"),
    (1, 2, 500, 100, torch.bfloat16, True, False),
    # float16 on the same tensor-core kernels: the edges above, the train
    # step's shape and whole blocks with no key
    (2, 5, 257, 257, torch.float16, True, True),
    (1, 2, 130, 260, torch.float16, True, False),
    (1, 2, 260, 130, torch.float16, True, False),
    (3, 2, 70, 150, torch.float16, False, True),
    (2, 2, 64, 1, torch.float16, False, False),
    (2, 2, 1, 300, torch.float16, False, True),
    (8, 8, 512, 512, torch.float16, False, "ragged"),
    (1, 2, 500, 100, torch.float16, True, False),
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
    stays under half a step. float16 in its own steps, eight times finer:
    rtol 2^-10 (one step), atol 2^-10 (each term p v moves by up to
    float16's unit roundoff 2^-11 of itself on either side) and rms 2^-11.
    ``cancels``: the value is zero analytically
    (with one key p = 1 and ds = do . v - di = 0, so dq = dk = 0) and what
    is left on either side is the difference of two float32 sums of 64
    products taken in two orders, ~1e-6; a relative error of that says
    nothing, so both sides are held to 2e-5 in absolute value instead."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    if dtype == torch.float32:
        rtol, rms = 0.0, 1e-5
        atol = 1e-4 * max(1.0, float(ref.abs().max())) if grad else 2e-5
    elif dtype == torch.float16:
        rtol, atol, rms = 2.0 ** -10, 2.0 ** -10, 2.0 ** -11
    else:
        rtol, atol, rms = 2.0 ** -7, 2.0 ** -8, 2.0 ** -8
    assert float((d - rtol * ref.abs()).max()) <= atol
    if cancels:
        assert max(float(got.abs().max()), float(ref.abs().max())) <= 2e-5
    else:  # a reference of exact zeros (no valid key) takes exact zeros
        norm = float(ref.norm())
        assert float(d.norm()) / (norm if norm else 1.0) <= rms


# head sizes: the three the kernels are built at, and one the wrapper pads
HEADS = [32, 64, 128, 256]


@pytest.mark.parametrize("h", HEADS)
@pytest.mark.parametrize("b,n,tq,tk,dtype,causal,masked", FLASH_CASES)
def test_flash_kernels_match_plain(dev, b, n, tq, tk, h, dtype, causal,
                                   masked):
    """The kernels at a built head size against the plain versions at the
    true one. A head size between them goes in zero-padded, as the wrapper
    pads it: the padded columns of every output come back exact zeros and
    are dropped, ``di`` is the unpadded operands'."""
    _hold_kernels_to_plain(dev, b, n, tq, tk, h, dtype, causal, masked)


SIXTEEN_BIT = (torch.bfloat16, torch.float16)

# head sizes above 256, on the cluster kernels of K3a, K3b and K3c
# (float32: the _cols kernels with the head size at run time): 288
# padded to 320, 384, 512 (K3a and K3c one block), 576 (K3a and K3c a
# cluster of 5 + 4 panels), 640 (the last block of K3b's cluster runs past
# the head), 1024, 1088 (K3b's clusters of five), 1216 (K3a's and K3c's
# clusters of 7 + 6 + 6 panels), 2112 (two clusters along the head for
# K3b, each computing the other's panels' score terms; K3a and K3c one
# cluster of five) and 4160 (K3a and K3c two clusters of five, each
# computing the other's panels' score terms); the edges of FLASH_CASES at
# small shapes, and the train step's ragged key mask
WIDE_HEADS = [288, 384, 512, 576, 640, 1024, 1088, 1216, 2112, 4160]
WIDE_CASES = [
    (2, 2, 257, 257, True, True),    # causal + key mask, an item with none
    (1, 2, 130, 260, True, False),
    (1, 2, 260, 130, True, False),   # rows with no key
    (3, 2, 70, 150, False, True),
    (2, 1, 200, 200, False, "ragged"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("h", WIDE_HEADS)
@pytest.mark.parametrize("b,n,tq,tk,causal,masked", WIDE_CASES)
def test_flash_kernels_above_256_match_plain(dev, b, n, tq, tk, h, dtype,
                                             causal, masked):
    """The kernels at head sizes above 256 against the plain versions, as
    ``test_flash_kernels_match_plain`` holds them."""
    _hold_kernels_to_plain(dev, b, n, tq, tk, h, dtype, causal, masked)


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("h", [512, 1088, 2112])
def test_cluster_kernels_repeat_their_bits(dev, h, dtype):
    """K3a, K3b and K3c above 256 sum their blocks' terms of the score
    products over a cluster in rank order, with no atomics: at phase 9's
    tokens over one head (``[16, 512, h]``, the ragged key mask, causal and
    not; at 2112 two clusters along the head for K3b, one of five blocks
    for K3a and K3c), where many clusters run at once, three launches give
    the same bits."""
    q, k, v, do, mask = _flash_inputs(dev, 16, 1, 512, 512, h, dtype,
                                      "ragged", seed=5)
    for causal in (False, True):
        o, l, m = fa.launch_forward(q, k, v, mask, h ** -0.5, causal, 1)
        args = (q, k, v, do, l, m, fa.delta(o, do), mask, h ** -0.5, causal,
                1)
        first = (o, l, m, *fa.launch_backward_dkv(*args),
                 fa.launch_backward_dq(*args))
        for _ in range(2):
            again = (*fa.launch_forward(q, k, v, mask, h ** -0.5, causal, 1),
                     *fa.launch_backward_dkv(*args),
                     fa.launch_backward_dq(*args))
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(again, first))
        assert all(bool(torch.isfinite(x).all()) for x in first)


@pytest.mark.parametrize("h", range(320, 2113, 64))
def test_cluster_launch_shapes_fit_the_card(dev, h):
    """Above 256 the blocks of K3b (two warpgroups) own 256 columns each,
    in clusters along z of at most 8 blocks, as few clusters as that
    allows: the shape the launcher reports, and that the card holds at
    least one such cluster at once in both 16-bit types. K3c's cluster
    kernel's blocks (two consumer warpgroups and a producer's, 384
    threads, at most 8 panels of dQ each, one block an SM) form clusters
    along z of as few blocks as hold a chunk of the head (one block, no
    cluster, up to h 512), as few chunks as the portable size of 8 blocks
    allows, in shared memory the card gives a block."""
    panels = h // 64
    clusters = -(-panels // 32)
    blocks = -(-panels // (clusters * 4))
    dq_clusters = -(-panels // 64)
    dq_blocks = -(-(-(-panels // dq_clusters)) // 8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in SIXTEEN_BIT:
        shape = fa.launch_shape("dkv", dtype, h, 512, 512)
        assert shape["kernel_name"] == "flash_bwd_dkv_cluster_kernel"
        assert shape["threads"] == 256
        assert shape["cluster"] == blocks <= 8
        assert shape["slices"] == blocks * clusters
        assert shape["max_active_clusters"] > 0
        dq = fa.launch_shape("dq", dtype, h, 512, 512)
        assert dq["kernel_name"] == "flash_bwd_dq_cluster_kernel"
        assert dq["threads"] == 3 * 128
        assert dq["cluster"] == dq_blocks <= 8
        assert dq["slices"] == dq_blocks * dq_clusters
        if dq_blocks == 1:  # 0 without a cluster, as launch_shape reports it
            assert dq["max_active_clusters"] == 0
        else:
            assert 0 < dq["max_active_clusters"] <= sms // dq_blocks
        assert dq["resident_blocks"] == sms
        assert dq["smem_bytes"] <= 227 * 1024
    for kernel in ("dkv", "dq"):
        assert fa.launch_shape(kernel, torch.float32, h, 512,
                               512)["cluster"] == 1


@pytest.mark.parametrize("h", range(320, 2113, 64))
def test_wide_forward_launch_shapes_fit_the_card(dev, h):
    """Above 256 K3a runs its cluster kernel: blocks of two consumer
    warpgroups over 64 query rows and at most 8 panels of O, Q's panels
    resident, and a producer warpgroup (384 threads), one block an SM, in
    clusters along z of as few blocks as hold the head's panels (one block,
    no cluster, up to h 512), the panels balanced over them: the shape the
    launcher reports, and that the card holds such clusters at once, at
    any lengths, in both 16-bit types."""
    panels = h // 64
    blocks = -(-panels // 8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in SIXTEEN_BIT:
        for tq, tk in ((512, 512), (1, 512), (198, 198)):
            shape = fa.launch_shape("fwd", dtype, h, tq, tk)
            assert shape["kernel_name"] == "flash_fwd_cluster_kernel"
            assert shape["threads"] == 3 * 128
            assert shape["resident_blocks"] == sms
            assert shape["slices"] == shape["cluster"] == blocks
            # 0 without a cluster, as launch_shape reports it
            assert (shape["max_active_clusters"] > 0) == (blocks > 1)


@pytest.mark.parametrize("h,blocks,clusters", [(512, 1, 1), (1216, 3, 1),
                                               (2112, 5, 1), (4160, 5, 2)])
def test_cluster_forward_launch_shapes_fit_the_card(dev, h, blocks,
                                                    clusters):
    """K3a's cluster kernel's blocks (two consumer warpgroups and a
    producer's, 384 threads, at most 8 panels of O each) form clusters
    along z over each chunk of the head, as few clusters as the portable
    size of 8 blocks allows (h 4160, 65 panels: the first size past one
    cluster, two chunks of 33 and 32 panels), each chunk balanced over its
    cluster's blocks: the shape the launcher reports, and that the card
    holds clusters of it at once in both 16-bit types (at h 512 one block
    and no cluster: 0 clusters, as launch_shape reports it)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in SIXTEEN_BIT:
        shape = fa.launch_shape("fwd", dtype, h, 512, 512)
        assert shape["kernel_name"] == "flash_fwd_cluster_kernel"
        assert shape["threads"] == 3 * 128
        assert shape["cluster"] == blocks
        assert shape["slices"] == blocks * clusters
        if blocks == 1:
            assert shape["max_active_clusters"] == 0
        else:
            assert 0 < shape["max_active_clusters"] <= sms // blocks
        assert shape["resident_blocks"] == sms
        assert fa.launch_shape("fwd", torch.float32, h, 512,
                               512)["cluster"] == 1


def _hold_kernels_to_plain(dev, b, n, tq, tk, h, dtype, causal, masked):
    """K3a, K3b and K3c on operands padded to ``kernel_head_size`` (at h 32
    in the 16-bit types unpadded, on the narrow kernels), as the wrapper
    pads them."""
    q, k, v, do, mask = _flash_inputs(dev, b, n, tq, tk, h, dtype, masked)
    scale = h ** -0.5
    size = back = fa.kernel_head_size(h, dtype)
    qp, kp, vp = (fa.pad_head(x, size) for x in (q, k, v))
    o_full, l, m = fa.launch_forward(qp, kp, vp, mask, scale, causal, n)
    o = o_full[..., :h]
    o_p, l_p, m_p = fa.flash_forward_plain(q, k, v, scale, causal, mask, n)
    torch.cuda.synchronize()
    assert not o_full[..., h:].any()
    _assert_close(o, o_p, dtype)
    assert bool(torch.isfinite(m).all())
    assert torch.allclose(m, m_p, rtol=1e-5, atol=1e-5)
    assert torch.allclose(l, l_p, rtol=1e-4, atol=1e-6)
    # no atomics in the forward either: a second launch gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(
        fa.launch_forward(qp, kp, vp, mask, scale, causal, n),
        (o_full, l, m)))
    if masked is True:  # the last batch item has no valid key
        assert not o[-n:].any() and not l[-n:].any()
        assert bool((m[-n:] == fa.MASK_VALUE).all())

    # the backward kernels on the forward kernel's own saved o, l, m, as
    # the autograd function chains them
    args = (*(fa.pad_head(x, back) for x in (q, k, v, do)), l, m,
            fa.delta(o, do), mask, scale, causal, n)
    padded = (*fa.launch_backward_dkv(*args), fa.launch_backward_dq(*args))
    assert all(x.shape[-1] == back for x in padded)
    dk, dv, dq = (x[..., :h] for x in padded)
    want = fa.flash_backward_plain(q, k, v, o_p, l_p, m_p, do, scale, causal,
                                   mask, n)
    torch.cuda.synchronize()
    assert not any(x[..., h:].any() for x in padded)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        _assert_close(got, ref, dtype, grad=True,
                      cancels=tk == 1 and name != "dv")
    # each output is written once by one block, no atomics: the same bits
    again = (*fa.launch_backward_dkv(*args), fa.launch_backward_dq(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, padded))
    if masked is True:
        assert not dq[-n:].any() and not dk[-n:].any() and not dv[-n:].any()
    if causal and tq > tk:  # rows above the end-aligned diagonal
        assert not o[:, :tq - tk].any() and not dq[:, :tq - tk].any()
        assert not l[:, :tq - tk].any()
        assert bool((m[:, :tq - tk] == fa.MASK_VALUE).all())


# the short forward kernel's edges at head size 64: (b, n, tq, tk, causal,
# masked); tk 257 and tq 257 take the whole-tile kernel
SHORT_CASES = [
    *((2, 3, 198, tk, False, False)
      for tk in (1, 63, 64, 65, 197, 198, 255, 256, 257)),
    (2, 2, 250, 120, True, False),      # causal: 130 rows see no key
    (2, 2, 100, 256, True, "ragged"),
    (2, 2, 257, 200, True, False),
    (3, 2, 198, 198, False, True),      # the last batch item keeps no key
    (2, 2, 64, 64, True, True),
    (2, 4, 256, 256, True, True),
    (1, 1, 198, 198, False, False),     # one head
    (7, 19, 197, 197, False, False),    # 133 heads: more than the SMs
    (128, 12, 198, 198, False, False),  # DeiT-B/16's 1536 heads
]


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("b,n,tq,tk,causal,masked", SHORT_CASES)
def test_short_forward_kernel_matches_plain(dev, b, n, tq, tk, causal,
                                            masked, dtype):
    """K3a's short kernel (a head's queries and keys resident, persistent
    blocks) against the plain forward: ``o`` within the type's tolerance,
    ``l`` and ``m`` as ``test_flash_kernels_match_plain`` holds them, rows
    with no key (a batch item the mask empties, rows above the causal
    diagonal) exact zeros with ``l == 0`` and ``m`` at the mask value, the
    same bits from a second launch, and the launch counted under the kernel
    that ran."""
    q, k, v, _, mask = _flash_inputs(dev, b, n, tq, tk, 64, dtype, masked)
    scale = 64 ** -0.5
    short = 64 <= tq <= 256 and 1 <= tk <= 256
    want_kernel = "flash_fwd_short_kernel" if short else "flash_fwd_tc_kernel"
    before = dict(fa.flash_attention.forward_launches)
    o, l, m = fa.launch_forward(q, k, v, mask, scale, causal, n)
    after = fa.flash_attention.forward_launches
    assert {key: after[key] - before[key] for key in after} == {
        key: int(key == want_kernel) for key in after}
    o_p, l_p, m_p = fa.flash_forward_plain(q, k, v, scale, causal, mask, n)
    torch.cuda.synchronize()
    _assert_close(o, o_p, dtype)
    assert torch.allclose(m, m_p, rtol=1e-5, atol=1e-5)
    assert torch.allclose(l, l_p, rtol=1e-4, atol=1e-6)
    again = fa.launch_forward(q, k, v, mask, scale, causal, n)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(again, (o, l, m)))
    if masked is True:  # the last batch item has no valid key
        assert not o[-n:].any() and not l[-n:].any()
        assert bool((m[-n:] == fa.MASK_VALUE).all())
    if causal and tq > tk:  # rows above the end-aligned diagonal
        assert not o[:, :tq - tk].any() and not l[:, :tq - tk].any()
        assert bool((m[:, :tq - tk] == fa.MASK_VALUE).all())


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
def test_short_kernel_repeats_its_bits(dev, dtype):
    """At DeiT-B/16's ``[1536, 198, 64]`` and the served ViT-B/16's
    ``[384, 197, 64]``, where each block walks many heads through its two
    buffers, five launches give the same bits."""
    for bn, t in ((1536, 198), (384, 197)):
        q, k, v, _, _ = _flash_inputs(dev, bn // 12, 12, t, t, 64, dtype,
                                      False, seed=9)
        first = fa.launch_forward(q, k, v, None, 0.125, False, 12)
        for _ in range(4):
            again = fa.launch_forward(q, k, v, None, 0.125, False, 12)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(again, first))
        assert bool(torch.isfinite(first[0]).all())


# K3b's short kernel's edges at head size 64: (b, n, tq, tk, causal,
# masked). It takes 1 to 256 queries over 129 to 256 keys; tk 1 to 128 and
# 257 take the whole-tile kernel.
SHORT_BACKWARD_CASES = [
    *((2, 3, 198, tk, False, False)
      for tk in (1, 63, 64, 128, 129, 197, 198, 255, 256, 257)),
    (2, 2, 250, 200, True, False),      # causal: 50 rows see no key
    (2, 2, 120, 250, True, False),      # causal, fewer queries than keys
    (2, 2, 100, 256, True, "ragged"),
    (2, 2, 1, 200, False, True),        # one query row
    (2, 2, 193, 193, False, False),     # a last query tile of one row
    (3, 2, 198, 198, False, True),      # the last batch item keeps no key
    (2, 4, 256, 256, True, True),
    (1, 1, 198, 198, False, False),     # one head
    (7, 19, 197, 197, False, False),    # 133 heads: more than the SMs
    (128, 12, 198, 198, False, False),  # DeiT-B/16's 1536 heads
]


def _short_dkv(tq, tk):
    return 1 <= tq <= 256 and 128 < tk <= 256


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("b,n,tq,tk,causal,masked", SHORT_BACKWARD_CASES)
def test_short_backward_dkv_matches_plain(dev, b, n, tq, tk, causal, masked,
                                          dtype):
    """K3b's short kernel (a head's Q and dO resident, persistent blocks,
    a warpgroup a key tile) against the plain backward: dK and dV within
    the type's tolerance on the forward kernel's own ``l, m``, exact zeros
    for the keys the mask drops and for a batch item it empties, the same
    bits from a second launch, and the launch counted under the kernel that
    ran."""
    q, k, v, do, mask = _flash_inputs(dev, b, n, tq, tk, 64, dtype, masked)
    scale = 64 ** -0.5
    want_kernel = ("flash_bwd_dkv_short_kernel" if _short_dkv(tq, tk)
                   else "flash_bwd_dkv_tc_kernel")
    assert fa.backward_kernel(dtype, 64, tq, tk) == want_kernel
    o, l, m = fa.launch_forward(q, k, v, mask, scale, causal, n)
    args = (q, k, v, do, l, m, fa.delta(o, do), mask, scale, causal, n)
    before = dict(fa.flash_attention.backward_launches)
    dk, dv = fa.launch_backward_dkv(*args)
    after = fa.flash_attention.backward_launches
    assert {key: after[key] - before[key] for key in after} == {
        key: int(key == want_kernel) for key in after}
    o_p, l_p, m_p = fa.flash_forward_plain(q, k, v, scale, causal, mask, n)
    _, dk_p, dv_p = fa.flash_backward_plain(q, k, v, o_p, l_p, m_p, do,
                                            scale, causal, mask, n)
    torch.cuda.synchronize()
    for name, got, ref in (("dk", dk, dk_p), ("dv", dv, dv_p)):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        _assert_close(got, ref, dtype, grad=True,
                      cancels=tk == 1 and name == "dk")
    again = fa.launch_backward_dkv(*args)
    torch.cuda.synchronize()
    assert torch.equal(again[0], dk) and torch.equal(again[1], dv)
    if mask is not None:  # a key the mask drops has no kept query
        dropped = (mask <= 0).repeat_interleave(n, dim=0)
        assert not dk[dropped].any() and not dv[dropped].any()
    if masked is True:  # the last batch item has no valid key
        assert not dk[-n:].any() and not dv[-n:].any()


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
def test_short_dkv_kernel_repeats_its_bits(dev, dtype):
    """At DeiT-B/16's ``[1536, 198, 64]`` and the served ViT-B/16's
    ``[384, 197, 64]``, where each block walks many heads through its two
    query buffers and its groups refill their key tiles, five launches of
    K3b's short kernel give the same bits."""
    for bn, t in ((1536, 198), (384, 197)):
        q, k, v, do, _ = _flash_inputs(dev, bn // 12, 12, t, t, 64, dtype,
                                       False, seed=9)
        o, l, m = fa.launch_forward(q, k, v, None, 0.125, False, 12)
        args = (q, k, v, do, l, m, fa.delta(o, do), None, 0.125, False, 12)
        assert (fa.backward_kernel(dtype, 64, t, t)
                == "flash_bwd_dkv_short_kernel")
        first = fa.launch_backward_dkv(*args)
        for _ in range(4):
            again = fa.launch_backward_dkv(*args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(again, first))
        assert all(bool(torch.isfinite(x).all()) for x in first)


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
    """The names of the kernels three calls of ``fn`` launch, from the
    profiler's device kernel records only (events whose device type is
    CUDA; the host's runtime calls, ``cudaLaunchKernelExC`` among them, are
    no kernel). The profiler can drop a kernel's record: three calls make
    a name missing from all of them unlikely. A window in which CUPTI lost
    every kernel record is thrown away and the three calls are profiled
    again, up to five windows; only when every window came back
    empty does it fail, and say so: the profiler then saw no kernel, which
    says nothing of the dispatch."""
    from torch.profiler import ProfilerActivity, profile

    windows = 5
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = " ".join(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        if names:
            return names
    raise AssertionError(
        f"the profiler recorded no kernel over three calls in each of "
        f"{windows} windows: it did not trace the card (CUPTI), the "
        f"dispatch is not what failed")


# (tq, tk) of K3a's calls and the kernel a 16-bit one takes at head size
# 64: the short kernel from 64 to 256 queries over 1 to 256 keys, the
# whole-tile kernel outside (one query row, 257 keys or queries, fewer than
# 64 queries)
FORWARD_LENGTHS = [((96, 80), "flash_fwd_short_kernel"),
                   ((198, 198), "flash_fwd_short_kernel"),
                   ((64, 1), "flash_fwd_short_kernel"),
                   ((256, 256), "flash_fwd_short_kernel"),
                   ((1, 300), "flash_fwd_tc_kernel"),
                   ((1, 128), "flash_fwd_tc_kernel"),
                   ((63, 65), "flash_fwd_tc_kernel"),
                   ((198, 257), "flash_fwd_tc_kernel"),
                   ((257, 198), "flash_fwd_tc_kernel")]


@pytest.mark.parametrize("h", [64, 128, 256, 512, 32, 1216])
def test_forward_dtype_chooses_the_kernels(dev, h):
    """bf16 and float16 operands run the tensor-core forward (at head size
    64 over at most 256 queries and keys its short form, above 256 its
    cluster form, at 32 its narrow form at any lengths), float32 the FMA
    one
    (its ``_cols`` form from 256 on; at 32 padded to 64): read from the
    profiler's kernel names, the launch counter by kernel and
    ``launch_shape``, which names the kernel the dispatch picks. Each
    assertion on the profiler's names prints the names it saw."""
    names, size = {}, {}
    for dtype in (torch.float32, *SIXTEEN_BIT):
        size[dtype] = fa.kernel_head_size(h, dtype)
        q, k, v, _, mask = _flash_inputs(dev, 1, 2, 96, 80, size[dtype],
                                         dtype, True)
        names[dtype] = _kernel_names(
            lambda: fa.launch_forward(q, k, v, mask, 0.125, False, 2))
    fma = "flash_fwd_cols_kernel" if h >= 256 else "flash_fwd_kernel"
    seen = names[torch.float32]
    assert fma in seen, seen
    for other in ("_tc_kernel", "_short_kernel", "_cluster_kernel",
                  "_narrow_kernel", "_wide_kernel"):
        assert other not in seen, seen
    tc = ("flash_fwd_short_kernel" if h == 64 else
          "flash_fwd_narrow_kernel" if h == 32 else
          "flash_fwd_cluster_kernel" if h > 256 else "flash_fwd_tc_kernel")
    for dtype in SIXTEEN_BIT:
        seen = names[dtype]
        assert tc in seen, seen
        assert "flash_fwd_kernel" not in seen, seen
        assert "_cols_kernel" not in seen, seen
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (tq, tk), short_or_tc in FORWARD_LENGTHS:
        for dtype in (torch.float32, *SIXTEEN_BIT):
            want = (fma if dtype == torch.float32 else
                    short_or_tc if h == 64 else tc)
            shape = fa.launch_shape("fwd", dtype, size[dtype], tq, tk)
            assert shape["kernel_name"] == want
            assert shape["resident_blocks"] > 0
            if want == "flash_fwd_short_kernel":
                # one block an SM: four warpgroups over two buffers of a
                # head's Q, K and V
                assert shape["threads"] == 4 * 128
                assert shape["smem_bytes"] > 2 * 3 * 32 * 1024
                assert shape["resident_blocks"] == sms
            q, k, v, _, _ = _flash_inputs(dev, 1, 2, tq, tk, size[dtype],
                                          dtype, False)
            before = dict(fa.flash_attention.forward_launches)
            fa.launch_forward(q, k, v, None, 0.125, False, 2)
            after = fa.flash_attention.forward_launches
            assert {key: after[key] - before[key] for key in after} == {
                key: int(key == want) for key in after}


# (tq, tk) of K3b's calls and the kernel a 16-bit one takes at head size
# 64: the short kernel from 1 to 256 queries over 129 to 256 keys, the
# whole-tile kernel outside
BACKWARD_LENGTHS = [((198, 198), "flash_bwd_dkv_short_kernel"),
                    ((197, 197), "flash_bwd_dkv_short_kernel"),
                    ((1, 200), "flash_bwd_dkv_short_kernel"),
                    ((96, 129), "flash_bwd_dkv_short_kernel"),
                    ((256, 256), "flash_bwd_dkv_short_kernel"),
                    ((96, 128), "flash_bwd_dkv_tc_kernel"),
                    ((64, 1), "flash_bwd_dkv_tc_kernel"),
                    ((198, 257), "flash_bwd_dkv_tc_kernel"),
                    ((257, 198), "flash_bwd_dkv_tc_kernel")]


@pytest.mark.parametrize("h", [64, 128, 256, 512])
def test_backward_dtype_chooses_the_kernels(dev, h):
    """bf16 and float16 operands run the tensor-core kernels (above 256
    K3b's and K3c's ``_cluster`` kernels; at head size 64 over at most 256
    queries and 129 to 256 keys K3b's short one; at 128 and 256 K3b's
    ``_producer`` kernel: two consumer warpgroups, at 128 of 64 keys each,
    128 keys a block, at 256 over the same 64 keys, two panels each, and a
    third whose first warp feeds them, one block an SM),
    float32
    the FMA kernels (``_cols`` from 256 on): read from the profiler's kernel
    names, and for K3b at each of ``BACKWARD_LENGTHS`` from
    ``launch_shape``, which names the kernel the dispatch picks, and the
    launch counter by kernel."""
    names = {}
    for dtype in (torch.float32, *SIXTEEN_BIT):
        q, k, v, do, _ = _flash_inputs(dev, 1, 2, 96, 80, h, dtype, False)
        o, l, m = fa.launch_forward(q, k, v, None, 0.125, False, 2)
        args = (q, k, v, do, l, m, fa.delta(o, do), None, 0.125, False, 2)
        names[dtype] = _kernel_names(lambda: (fa.launch_backward_dkv(*args),
                                              fa.launch_backward_dq(*args)))
    cols = "_cols" if h >= 256 else ""
    assert f"flash_bwd_dkv{cols}_kernel" in names[torch.float32]
    assert f"flash_bwd_dq{cols}_kernel" in names[torch.float32]
    assert "_tc_kernel" not in names[torch.float32]
    assert "_sliced_kernel" not in names[torch.float32]
    assert "_cluster_kernel" not in names[torch.float32]
    dkv, dq = (("_cluster", "_cluster") if h > 256 else
               ("_producer", "_tc") if h in (128, 256) else ("_tc", "_tc"))
    for dtype in SIXTEEN_BIT:
        assert f"flash_bwd_dkv{dkv}_kernel" in names[dtype]
        assert f"flash_bwd_dq{dq}_kernel" in names[dtype]
        assert "_sliced_kernel" not in names[dtype]
        assert "_short_kernel" not in names[dtype]  # 80 keys: not short
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (tq, tk), short_or_tc in BACKWARD_LENGTHS:
        for dtype in (torch.float32, *SIXTEEN_BIT):
            want = (f"flash_bwd_dkv{cols}_kernel" if dtype == torch.float32
                    else short_or_tc if h == 64
                    else f"flash_bwd_dkv{dkv}_kernel")
            shape = fa.launch_shape("dkv", dtype, h, tq, tk)
            assert shape["kernel_name"] == want
            assert fa.backward_kernel(dtype, h, tq, tk) == want
            assert shape["resident_blocks"] > 0
            if want == "flash_bwd_dkv_short_kernel":
                # one block an SM: three warpgroups over two buffers of a
                # head's Q and dO beside four key tiles of K and V
                assert shape["threads"] == 3 * 128
                assert shape["smem_bytes"] > 2 * 2 * 32 * 1024 + 64 * 1024
                assert shape["resident_blocks"] == sms
            if want == "flash_bwd_dkv_producer_kernel":
                # one block an SM: the block's K and V tiles (64 KB)
                # beside a ring of Q and dO (four stages of 32 KB at h 128,
                # two of 64 KB at 256)
                assert shape["threads"] == 3 * 128
                assert shape["smem_bytes"] > 64 * 1024 + 4 * 32 * 1024
                assert shape["slices"] == shape["cluster"] == 1
                assert shape["resident_blocks"] == sms
            q, k, v, do, _ = _flash_inputs(dev, 1, 2, tq, tk, h, dtype,
                                           False)
            o, l, m = fa.launch_forward(q, k, v, None, 0.125, False, 2)
            before = dict(fa.flash_attention.backward_launches)
            fa.launch_backward_dkv(q, k, v, do, l, m, fa.delta(o, do), None,
                                   0.125, False, 2)
            after = fa.flash_attention.backward_launches
            assert {key: after[key] - before[key] for key in after} == {
                key: int(key == want) for key in after}


@pytest.mark.parametrize("h", [8, 16, 32])
def test_narrow_backward_kernels_at_head_size_32(dev, h):
    """At head sizes up to 32 bf16 and float16 run K3b and K3c on the
    narrow kernels at 32 (one warpgroup of 64 rows a block, four blocks an
    SM, 32-column tiles), float32 on the FMA kernels at 64:
    ``launch_shape`` names them, the launch counters by kernel count them
    through the autograd function, which pads the backward's operands to
    32 only (at 32 not at all) and slices nothing at 32, and its gradients
    hold to the CPU's; a launch at a head size the backward does not take
    is refused; K3a at 32 takes its own narrow kernel
    (``test_narrow_forward_kernel_at_head_size_32``)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in SIXTEEN_BIT:
        assert fa.kernel_head_size(h, dtype) == 32
        dkv = fa.launch_shape("dkv", dtype, 32, 512, 512)
        dq = fa.launch_shape("dq", dtype, 32, 512, 512)
        assert dkv["kernel_name"] == "flash_bwd_dkv_narrow_kernel"
        assert dq["kernel_name"] == "flash_bwd_dq_narrow_kernel"
        for shape in (dkv, dq):
            assert (shape["threads"], shape["slices"], shape["cluster"]) == (
                128, 1, 1)
            assert shape["resident_blocks"] == 4 * sms
        assert fa.backward_kernel(dtype, 32, 198, 198) == (
            "flash_bwd_dkv_narrow_kernel")
        assert fa.dq_kernel(dtype, 32) == "flash_bwd_dq_narrow_kernel"
        assert fa.launch_shape("fwd", dtype, 64, 512, 512)[
            "kernel_name"] == "flash_fwd_tc_kernel"
        assert fa.launch_shape("fwd", dtype, 32, 512, 512)[
            "kernel_name"] == "flash_fwd_narrow_kernel"
    assert fa.kernel_head_size(h, torch.float32) == 64
    for kernel in ("fwd", "dkv"):
        with pytest.raises(RuntimeError):
            fa.launch_shape(kernel, torch.float32, 32, 512, 512)
    for dtype in (*SIXTEEN_BIT, torch.float32):
        q, k, v, do, mask = _flash_inputs(dev, 2, 3, 130, 150, h, dtype, True)
        q, k, v = (x.view(2, 3, -1, h).requires_grad_() for x in (q, k, v))
        before = (dict(fa.flash_attention.launches),
                  dict(fa.flash_attention.backward_launches),
                  dict(fa.flash_attention.dq_launches))
        out = fa.flash_attention(q, v, k, causal=True, kv_mask=mask)
        grads = torch.autograd.grad(out, (q, k, v), do.view(2, 3, -1, h))
        after = (fa.flash_attention.launches,
                 fa.flash_attention.backward_launches,
                 fa.flash_attention.dq_launches)
        assert {key: after[0][key] - before[0][key] for key in after[0]} == {
            "fwd": 1, "dkv": 1, "dq": 1}
        wide = dtype == torch.float32
        for counts, was, kernel in (
                (after[1], before[1], "flash_bwd_dkv_kernel" if wide
                 else "flash_bwd_dkv_narrow_kernel"),
                (after[2], before[2], "flash_bwd_dq_kernel" if wide
                 else "flash_bwd_dq_narrow_kernel")):
            assert {key: counts[key] - was[key] for key in counts} == {
                key: int(key == kernel) for key in counts}
        cpu = [x.detach().cpu().requires_grad_() for x in (q, k, v)]
        ref = fa.flash_attention(cpu[0], cpu[2], cpu[1], causal=True,
                                 kv_mask=mask.cpu())
        want = torch.autograd.grad(ref, cpu, do.view(2, 3, -1, h).cpu())
        for got, ref_grad in zip(grads, want):
            assert got.dtype == dtype and got.shape[-1] == h
            _assert_close(got.cpu(), ref_grad, dtype, grad=True)
    bad = torch.randn((2, 8, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.launch_backward_dq(bad, bad, bad, bad, None, None, None, None,
                              0.1, False, 1)


# the narrow forward kernel's cases at h 8, 16 and 32: (b, n, tq, tk,
# causal, masked); one key, one query row, DeiT's 198 tokens, causal cross
# lengths (rows that see no key), a batch item the mask empties, the train
# step's shape with its ragged mask
NARROW_FORWARD_CASES = [
    (2, 2, 64, 1, False, False),
    (2, 2, 1, 300, False, True),
    (2, 3, 198, 198, False, False),
    (1, 2, 130, 260, True, False),
    (1, 2, 260, 130, True, False),
    (3, 2, 70, 150, False, True),
    (4, 4, 512, 512, True, "ragged"),
]


@pytest.mark.parametrize("h", [8, 16, 32])
def test_narrow_forward_kernel_at_head_size_32(dev, h):
    """At head sizes up to 32 bf16 and float16 run K3a on its narrow kernel
    at 32 (one warpgroup over 64 query rows a block, six blocks an SM,
    32-column tiles), never padded to 64: ``launch_shape`` names it, the
    counters by kernel count it through the autograd function (which pads h
    8 and 16 to 32 and 32 not at all), ``o`` within the type's tolerance
    of the plain forward and ``l``, ``m`` as the other kernels' tests hold
    them, rows with no key exact zeros, a second launch the same bits, and
    the gradients through the wrapper held to the CPU's; a launch at head
    size 48 is refused."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in SIXTEEN_BIT:
        shape = fa.launch_shape("fwd", dtype, 32, 512, 512)
        assert shape["kernel_name"] == "flash_fwd_narrow_kernel"
        assert (shape["threads"], shape["slices"], shape["cluster"]) == (
            128, 1, 1)
        assert shape["resident_blocks"] == 6 * sms
        for tq, tk in ((1, 300), (198, 198), (96, 80)):
            assert fa.forward_kernel(dtype, 32, tq, tk) == (
                "flash_fwd_narrow_kernel")
        for b, n, tq, tk, causal, masked in NARROW_FORWARD_CASES:
            q, k, v, do, mask = _flash_inputs(dev, b, n, tq, tk, h, dtype,
                                              masked)
            scale = h ** -0.5
            qp, kp, vp = (fa.pad_head(x, 32) for x in (q, k, v))
            before = dict(fa.flash_attention.forward_launches)
            o_full, l, m = fa.launch_forward(qp, kp, vp, mask, scale, causal,
                                             n)
            after = fa.flash_attention.forward_launches
            assert {key: after[key] - before[key] for key in after} == {
                key: int(key == "flash_fwd_narrow_kernel") for key in after}
            o = o_full[..., :h]
            o_p, l_p, m_p = fa.flash_forward_plain(q, k, v, scale, causal,
                                                   mask, n)
            torch.cuda.synchronize()
            assert not o_full[..., h:].any()
            _assert_close(o, o_p, dtype)
            assert torch.allclose(m, m_p, rtol=1e-5, atol=1e-5)
            assert torch.allclose(l, l_p, rtol=1e-4, atol=1e-6)
            again = fa.launch_forward(qp, kp, vp, mask, scale, causal, n)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b_) for a, b_ in zip(again,
                                                           (o_full, l, m)))
            if masked is True:  # the last batch item has no valid key
                assert not o[-n:].any() and not l[-n:].any()
                assert bool((m[-n:] == fa.MASK_VALUE).all())
            if causal and tq > tk:  # rows above the end-aligned diagonal
                assert not o[:, :tq - tk].any() and not l[:, :tq - tk].any()
                assert bool((m[:, :tq - tk] == fa.MASK_VALUE).all())
        # through the autograd function: one K3a launch on the narrow
        # kernel, gradients held to the CPU's
        q, k, v, do, mask = _flash_inputs(dev, 2, 3, 130, 150, h, dtype, True)
        q, k, v = (x.view(2, 3, -1, h).requires_grad_() for x in (q, k, v))
        before = dict(fa.flash_attention.forward_launches)
        out = fa.flash_attention(q, v, k, causal=True, kv_mask=mask)
        grads = torch.autograd.grad(out, (q, k, v), do.view(2, 3, -1, h))
        after = fa.flash_attention.forward_launches
        assert {key: after[key] - before[key] for key in after} == {
            key: int(key == "flash_fwd_narrow_kernel") for key in after}
        cpu = [x.detach().cpu().requires_grad_() for x in (q, k, v)]
        ref = fa.flash_attention(cpu[0], cpu[2], cpu[1], causal=True,
                                 kv_mask=mask.cpu())
        want = torch.autograd.grad(ref, cpu, do.view(2, 3, -1, h).cpu())
        assert out.dtype == dtype and out.shape[-1] == h
        _assert_close(out.detach().cpu(), ref.detach(), dtype)
        for got, ref_grad in zip(grads, want):
            assert got.dtype == dtype and got.shape[-1] == h
            _assert_close(got.cpu(), ref_grad, dtype, grad=True)
    bad = torch.randn((2, 8, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.launch_forward(bad, bad, bad, None, 0.1, False, 1)


@pytest.mark.parametrize("h", HEADS + [288, 512])
def test_flash_attention_autograd_counts_and_rejects(dev, h):
    b, n, t = 2, 2, 100
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
    # permuted views are copied, not refused; a launch at a head size the
    # kernels do not take (300: the wrapper pads it to 320) is refused
    perm = torch.randn((b, t, n, h), device=dev, generator=g).permute(
        0, 2, 1, 3)
    got = fa.flash_attention(perm, perm)
    want = fa.flash_attention(perm.cpu(), perm.cpu())
    assert float((got.cpu() - want).abs().max()) <= 2e-5
    bad = torch.randn((1, 1, 8, 300), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.launch_forward(bad[0], bad[0], bad[0], None, 0.1, False, 1)


@pytest.mark.parametrize("m,k,n", [(8, 768, 1000), (6304, 768, 2304),
                                   (40, 36, 20)])
@pytest.mark.parametrize("layout", ["column-major", "row-major"])
def test_int_mm_exact_on_the_card(dev, m, k, n, layout):
    """``quantization.int_mm`` (cuBLASLt's int8 GEMM through
    ``torch._int_mm``) against the int32 product in float64, exact: every
    partial sum is an integer under 2^53. m = 8 and k, n = 36, 20 are
    padded with zeros; 6304 x 768 x 2304 is ViT-B/16's stacked projection
    at batch 32, unpadded."""
    from chambers_tpu_torch import quantization as tq

    g = torch.Generator(device=dev).manual_seed(m)
    x = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), device=dev, generator=g,
                      dtype=torch.int8)
    operand = tq.gemm_operand(w)
    if layout == "row-major":
        operand = operand.contiguous()
    acc = tq.int_mm(x, operand, n)
    want = x.double() @ w.double()
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    assert torch.equal(acc.double(), want)


def test_quantized_vit_on_the_card_matches_the_cpu(dev):
    """A 2-layer float32 int8 ViT with a 10-class head (padded to 16
    columns, 4 rows padded to 17): card against CPU within 1e-4 relative;
    the accumulators are exact on both, the float work around them sums
    in other orders."""
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
    assert card.predictions.kernel.dtype == torch.int8
    x = torch.randint(0, 256, (4, 32, 32, 3), dtype=torch.uint8)
    with torch.inference_mode():
        want = cpu(x)
        got = card(x.to(dev)).cpu()
    assert float((got - want).norm() / want.norm()) <= 1e-4


@pytest.mark.parametrize("fused", [True, False])
def test_autoaugment_compositions_equal_at_384px(dev, fused):
    """AutoAugment's stage through K1 or through K2 and the whole-batch
    Color, against the CPU's plain versions on the same draws."""
    from chambers_tpu_torch.augmentations.augmentation_schemes import (
        AutoAugment,
    )

    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randint(0, 256, (12, 384, 384, 3), dtype=torch.uint8,
                      device=dev, generator=g)
    aug = AutoAugment(elementwise=True, fused_round_kernel=fused)
    draws = aug.sample(12, g, dev)
    cpu_draws = {"policy_idx": draws["policy_idx"].cpu(),
                 "stages": [{k: v.cpu() for k, v in s.items()}
                            for s in draws["stages"]]}
    launches = (wk.fused_round.launches,
                wk.transform_affine_separable.launches)
    got = aug.apply(x, draws)
    ran = (wk.fused_round.launches - launches[0],
           wk.transform_affine_separable.launches - launches[1])
    assert ran == ((2, 0) if fused else (0, 2))
    other = AutoAugment(elementwise=True, fused_round_kernel=not fused)
    assert torch.equal(got, other.apply(x, draws))
    assert torch.equal(got.cpu(), aug.apply(x.cpu(), cpu_draws))


@pytest.mark.parametrize("channels", [1, 4])
def test_randaugment_other_channel_counts_on_the_card(dev, channels):
    """A batch that is not RGB takes the masked composition, over K2, by
    default, and matches the CPU's plain versions."""
    g = torch.Generator(device=dev).manual_seed(channels)
    x = torch.randint(0, 256, (16, 64, 64, channels), dtype=torch.uint8,
                      device=dev, generator=g)
    aug = RandAugment(2, 10, elementwise=True)
    draws = aug.sample(16, (64, 64), g, dev)
    cpu_draws = [{k: v.cpu() for k, v in d.items()} for d in draws]
    k1 = wk.fused_round.launches
    got = aug.apply(x, draws)
    assert wk.fused_round.launches == k1
    assert torch.equal(got.cpu(), aug.apply(x.cpu(), cpu_draws))


@pytest.mark.parametrize("h", HEADS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind,tk", [("cross", 512), ("self", 128)])
def test_flash_forward_at_one_query_row(dev, kind, tk, dtype, h):
    """K3a at a cached decode step's shapes: q ``[128, 1, 64]`` against
    k/v ``[128, 512, 64]`` with a ragged source mask (cross attention) and
    ``[128, 128, 64]`` with validity rows written to different depths, one
    of them a single slot (self attention), through the wrapper a step
    calls, against ``flash_forward_plain``."""
    b, n = 16, 8
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((b, n, t, h), device=dev, generator=g).to(dtype)
               for t in (1, tk, tk))
    if kind == "cross":
        keep = tk * (0.7 + 0.1 * torch.rand((b, 1), device=dev, generator=g))
    else:
        keep = torch.randint(1, tk + 1, (b, 1), device=dev, generator=g)
        keep[0] = 1
    mask = torch.arange(tk, device=dev) < keep
    before = fa.flash_attention.launches["fwd"]
    got = fa.flash_attention(q, v, k, kv_mask=mask)
    assert fa.flash_attention.launches["fwd"] == before + 1
    fold = (lambda x: x.reshape(b * n, x.shape[2], h))
    want = fa.flash_forward_plain(fold(q), fold(k), fold(v), h ** -0.5,
                                  False, mask.float(), n)[0]
    torch.cuda.synchronize()
    _assert_close(got.reshape(b * n, 1, h), want, dtype)


def test_cached_greedy_decode_equals_full_recompute_on_the_card(dev):
    """A float32 seq2seq model on the flash kernels (the FMA ones): cached
    greedy and beam tokens equal full recompute, and a cached greedy call
    launches K3a once per encoder layer and twice per decoder layer and
    step."""
    from chambers_tpu_torch import initializers
    from chambers_tpu_torch.models import (
        Seq2SeqTransformer,
        beam_search_decode,
        greedy_decode,
    )

    model = initializers.init_module(Seq2SeqTransformer(
        input_vocab_size=64, output_vocab_size=64, embed_dim=128,
        num_heads=2, dim_feedforward=256, num_encoder_layers=2,
        num_decoder_layers=2, dropout_rate=0.0, attention_impl="flash",
        device=dev), torch.Generator(device=dev).manual_seed(3)).eval()
    g = torch.Generator(device=dev).manual_seed(4)
    src = torch.randint(1, 64, (4, 40), device=dev, generator=g)
    src[0, 30:] = 0
    max_len = 12
    before = fa.flash_attention.launches["fwd"]
    cached = greedy_decode(model, src, max_len=max_len, bos_id=1)
    assert fa.flash_attention.launches["fwd"] - before == 2 + 4 * max_len
    assert torch.equal(cached, greedy_decode(model, src, max_len=max_len,
                                             bos_id=1, use_cache=False))
    kw = dict(max_len=max_len, bos_id=1, beam_size=3, eos_id=2,
              length_penalty=0.6)
    assert torch.equal(beam_search_decode(model, src, **kw),
                       beam_search_decode(model, src, use_cache=False, **kw))


def test_auction_on_the_card_equals_its_cpu_run(dev):
    """The ε-auction's float32 body and first-maximum ties give the same
    assignment on the card as on the CPU, on costs with 1e6-padded rows
    (the slow cascade) and with the fallback after a few iterations."""
    from chambers_tpu_torch.losses import detection as det

    g = torch.Generator().manual_seed(5)
    cost = torch.randn(48, 20, 100, generator=g)
    cost[:, 12:] = 1e6
    cost[::5, 6:] = 1e6
    for eps, max_iters in ((1e-2, 200), (1e-3, 200), (1e-2, 4)):
        want = det.auction_assignment(cost, eps=eps, max_iters=max_iters)
        got = det.auction_assignment(cost.to(dev), eps=eps,
                                     max_iters=max_iters)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)


def test_small_detr_loss_is_finite_on_the_card(dev):
    """The small DETR in bf16 with the auction-matched loss over its
    decoder layers, one AdamW step: finite loss and gradients."""
    from chambers_tpu_torch.losses.detection import DETRLoss
    from chambers_tpu_torch.models.detection import build_detr
    from chambers_tpu_torch.optimizers import AdamW

    model = build_detr(num_classes=7, input_shape=(64, 64, 3),
                       num_queries=10, embed_dim=32, num_heads=4, ff_dim=64,
                       num_encoder_layers=1, num_decoder_layers=2,
                       dtype=torch.bfloat16, device=dev).train()
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.rand((3, 64, 64, 3), device=dev, generator=g)
    targets = {"labels": torch.randint(0, 7, (3, 4), device=dev,
                                       generator=g),
               "boxes": torch.rand((3, 4, 4), device=dev, generator=g),
               "mask": torch.rand((3, 4), device=dev, generator=g) < 0.6}
    opt = AdamW(model.named_parameters(), weight_decay=1e-4,
                learning_rate=1e-4, decay_exclude=["bias", "norm"])
    loss = DETRLoss(num_classes=7, matcher="auction")(
        model(x, deterministic=True), targets)
    loss.backward()
    opt.step()
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


@pytest.mark.parametrize("magnitude", [9, 10])
def test_whole_batch_randaugment_on_the_card_equals_the_cpu(dev, magnitude):
    """Whole-batch RandAugment on the card against its CPU run on the same
    host draws, bit for bit, with each of the 16 ops forced once."""
    from chambers_tpu_torch.augmentations.image_augmentations import (
        to_device,
    )

    aug = RandAugment(2, magnitude)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randint(0, 256, (8, 56, 48, 3), dtype=torch.uint8, device=dev,
                      generator=g)
    template = aug.sample(8, (56, 48), torch.Generator().manual_seed(0),
                          "cpu")[0]
    for op in range(16):
        d = dict(template, idx=op)
        got = aug.apply(x, [to_device(d, dev)])
        assert torch.equal(got.cpu(), aug.apply(x.cpu(), [d])), op
    draws = aug.sample(8, (56, 48), torch.Generator().manual_seed(1), dev)
    assert all(isinstance(d["idx"], int) and d["sign"].is_cuda
               for d in draws)
