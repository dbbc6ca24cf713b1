"""Batched uint8 image primitives in plain PyTorch.

Port of ``chambers_tpu/ops/image_ops.py`` for what the RandAugment slice
needs. Every op takes a whole uint8 NHWC batch ``[b, h, w, c]`` and
per-image parameter vectors where the JAX package takes them, and repeats
its arithmetic order exactly so uint8 outputs are bit-equal:

- blends compute in float32 as ``img1 + (factor * (img2 - img1))`` — a
  rounded multiply, then a rounded add (eager PyTorch runs them as two
  kernels, so nothing contracts them into an FMA), clip, truncate;
- grayscale is the left-associated ITU-R 601 sum of rounded products on
  ``x * float32(1/255)``, then ``x255.5`` and truncation;
- histograms and LUT application use ``scatter_add_`` and ``gather`` in
  place of the JAX package's one-hot matrix-unit formulations (a TPU
  workaround);
- the separable warp composes its three shear passes into one gather
  instead of replaying the barrel-shift rolls (also a TPU workaround); on a
  uint8 batch it goes through the hand-written CUDA kernel
  (``warp_kernels.transform_affine_separable``).

Geometry matrices follow the tfa ``ImageProjectiveTransform`` contract: an
8-parameter matrix maps *output* coordinates to input coordinates.
"""

import numpy as np
import torch

_GRAY_WEIGHTS = np.array([0.299, 0.587, 0.114], np.float32)  # ITU-R 601


def _per_image(value, images):
    """A ``[b]`` vector broadcast against ``[b, h, w, c]``, or a Python
    scalar. Scalars stay on the host: a scalar tensor made on the card
    would cost a synchronising host-to-device copy."""
    if isinstance(value, np.ndarray) and value.ndim == 1:
        value = torch.from_numpy(value)
    if isinstance(value, torch.Tensor) and value.ndim == 1:
        return value.to(images.device)[:, None, None, None]
    return np.asarray(value).item()


# ---------------------------------------------------------------------------
# blending / tonal ops
# ---------------------------------------------------------------------------

def blend(image1, image2, factor):
    """``image1 + factor * (image2 - image1)`` in float32, clipped to
    [0, 255] and truncated to uint8. ``factor`` is a scalar or ``[b]``."""
    factor = _per_image(factor, image1)
    if isinstance(factor, torch.Tensor):
        factor = factor.to(torch.float32)
    else:  # rounded to float32 first, as jnp.asarray(factor, float32)
        factor = float(np.float32(factor))
    img1 = image1.to(torch.float32)
    img2 = image2.to(torch.float32)
    temp = img1 + factor * (img2 - img1)
    return temp.clamp(0.0, 255.0).to(torch.uint8)


def to_grayscale(images):
    """RGB -> ``[b, h, w, 1]`` uint8 with tf.image.rgb_to_grayscale's
    arithmetic (unit scale, weighted sum, ``x255.5`` saturating truncation).
    """
    inv = np.float32(1.0) / np.float32(255.0)
    unit = images.to(torch.float32) * float(inv)
    w = [float(v) for v in _GRAY_WEIGHTS]
    # channel i of a c < 3 image is its last one, as the JAX package's
    # static index clamps: a one-channel image weighs channel 0 three times
    r, g, b = (unit[..., min(i, images.shape[-1] - 1)] for i in range(3))
    gray = (w[0] * r + w[1] * g) + w[2] * b
    return (gray * 255.5).clamp(0.0, 255.0).to(torch.uint8)[..., None]


def invert(images):
    return 255 - images


def solarize(images, threshold=128):
    """Invert pixels >= threshold."""
    threshold = _per_image(threshold, images)
    return torch.where(images < threshold, images, 255 - images)


def solarize_add(images, addition=0, threshold=128):
    """Add ``addition`` to pixels below ``threshold``."""
    addition = _per_image(addition, images)
    threshold = _per_image(threshold, images)
    x = (images.to(torch.int32) + addition).clamp(0, 255).to(torch.uint8)
    return torch.where(images < threshold, x, images)


def posterize(images, bits):
    """Keep the top ``bits`` bits of each pixel; ``bits`` scalar or ``[b]``."""
    bits = _per_image(bits, images)
    shift = 8 - (bits.to(torch.uint8) if isinstance(bits, torch.Tensor)
                 else int(bits))
    return (images >> shift) << shift


def _autocontrast_params(images):
    """Per-(image, channel) rescale parameters, each flattened to ``[b*c]``
    in ``b * c + ch`` order (float32, the reference's arithmetic)."""
    lo = images.amin(dim=(1, 2)).to(torch.float32).reshape(-1)
    hi = images.amax(dim=(1, 2)).to(torch.float32).reshape(-1)
    denom = hi - lo
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    # a tensor over a tensor rounds once, as JAX's division does; a Python
    # scalar over a tensor is computed as reciprocal(safe) * 255, which
    # rounds twice and misrounds 46 of the 255 ranges
    scale = torch.where(denom > 0, torch.full_like(safe, 255.0) / safe,
                        torch.zeros_like(denom))
    offset = -lo * scale
    mask = (hi > lo).to(torch.float32)
    return scale * mask + (1 - mask), offset * mask


def _rescale(x, scale, offset):
    """``x * scale + offset`` rounded once to float32, as the fused
    multiply-add that XLA makes of it under ``jit``, where the JAX package's
    pipelines run it. For pixel values ``x`` (8 bits) and float32 ``scale``,
    ``offset`` the product is exact in float64 and the sum is too (it spans
    under 40 bits), so one rounding to float32 gives the fused result on
    any device."""
    return (x.to(torch.float64) * scale.to(torch.float64)
            + offset.to(torch.float64)).to(torch.float32)


def autocontrast(images):
    """Per-image, per-channel rescale to the full [0, 255] range."""
    scale, offset = _autocontrast_params(images)
    b, c = images.shape[0], images.shape[3]
    scale = scale.reshape(b, c)[:, None, None, :]
    offset = offset.reshape(b, c)[:, None, None, :]
    x = _rescale(images, scale, offset)
    return x.clamp(0.0, 255.0).to(torch.uint8)


def brightness(images, factor):
    """Blend with black."""
    return blend(torch.zeros_like(images), images, factor)


def color(images, factor):
    """Blend with the grayscale degenerate."""
    degenerate = to_grayscale(images).expand(images.shape)
    return blend(degenerate, images, factor)


def contrast(images, factor):
    """Blend with the reference's mean-gray degenerate, ``h*w/256`` — a
    constant independent of pixel content (a quirk of the reference, kept so
    outputs stay bit-equal)."""
    h, w = images.shape[1], images.shape[2]
    mean = np.clip(np.float32(h * w / 256.0), 0.0, 255.0).astype(np.uint8)
    degenerate = torch.full_like(images, int(mean))
    return blend(degenerate, images, factor)


def contrast_true_mean(images, factor):
    """Contrast about each image's own mean gray level (the original
    AutoAugment formulation): the gray levels sum exactly (in float64;
    under 2^24, so float32 sums them exactly too), one float32 division by
    the pixel count, rounded half to even and clipped to uint8."""
    gray = to_grayscale(images).to(torch.float64)
    total = gray.sum(dim=(1, 2, 3)).to(torch.float32)
    count = torch.full_like(total, gray[0].numel())
    mean = torch.round(total / count).clamp(0, 255).to(torch.uint8)
    degenerate = mean[:, None, None, None].expand(images.shape)
    return blend(degenerate, images, factor)


def channel_histograms(images):
    """Per-(image, channel) 256-bin histograms, ``[b*c, 256]`` int32.

    A ``scatter_add_`` of ones into ``b*c*256`` bins (integer adds, so the
    result does not depend on their order). ``torch.bincount`` computes the
    same counts but reads its input's maximum back to the host on CUDA."""
    b, h, w, c = images.shape
    bc = b * c
    dev = images.device
    flat = images.permute(0, 3, 1, 2).reshape(bc, h * w).to(torch.int64)
    bins = (flat + torch.arange(bc, device=dev)[:, None] * 256).reshape(-1)
    counts = torch.zeros(bc * 256, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, bins, torch.ones_like(bins))
    return counts.reshape(bc, 256).to(torch.int32)


def equalize_luts(images, hist=None):
    """Equalization tables per (image, channel), ``[b*c, 256]`` uint8
    (identity where the AutoAugment algorithm's ``step == 0``)."""
    if hist is None:
        hist = channel_histograms(images)
    nonzero = (hist > 0).to(torch.int32)
    last_idx = 255 - torch.argmax(torch.flip(nonzero, dims=[1]), dim=1)
    last_count = torch.gather(hist, 1, last_idx[:, None])[:, 0]
    step = torch.div(hist.sum(dim=1) - last_count, 255, rounding_mode="floor")

    cums = torch.cumsum(hist, dim=1)
    shifted = torch.cat([torch.zeros_like(cums[:, :1]), cums[:, :-1]], dim=1)
    safe_step = torch.where(step == 0, torch.ones_like(step), step)
    half = torch.div(step, 2, rounding_mode="floor")
    lut = torch.div(shifted + half[:, None], safe_step[:, None],
                    rounding_mode="floor")
    lut = lut.clamp(0, 255).to(torch.uint8)
    identity = torch.arange(256, dtype=torch.uint8, device=images.device)
    return torch.where((step == 0)[:, None], identity[None], lut)


def autocontrast_luts(images):
    """Autocontrast tables per (image, channel), ``[b*c, 256]`` uint8."""
    scale, offset = _autocontrast_params(images)
    v = torch.arange(256, dtype=torch.float32, device=images.device)[None]
    lut = _rescale(v, scale[:, None], offset[:, None])
    return lut.clamp(0.0, 255.0).to(torch.uint8)


def apply_channel_luts(images, luts):
    """``out[b, y, x, ch] = luts[b * c + ch][pixel]`` as one gather."""
    b, h, w, c = images.shape
    flat = images.permute(0, 3, 1, 2).reshape(b * c, h * w).to(torch.int64)
    out = torch.gather(luts, 1, flat)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()


def equalize(images):
    """Per-channel histogram equalization (tfa.image.equalize semantics)."""
    return apply_channel_luts(images, equalize_luts(images))


def sharpness(images, factor):
    """Blend with a 3x3-smoothed degenerate; only the interior is smoothed.

    The ``[[1,1,1],[1,5,1],[1,1,1]] / 13`` smoothing is a 9-term int32 sum
    with exact round-half-to-even division (13 is odd, so no quotient is a
    half-way case)."""
    x = images.to(torch.int32)
    s = (x[:, :-2, :-2] + x[:, :-2, 1:-1] + x[:, :-2, 2:]
         + x[:, 1:-1, :-2] + 5 * x[:, 1:-1, 1:-1] + x[:, 1:-1, 2:]
         + x[:, 2:, :-2] + x[:, 2:, 1:-1] + x[:, 2:, 2:])
    n = torch.div(s, 13, rounding_mode="floor")
    r = s - 13 * n
    degenerate = (n + (2 * r > 13).to(torch.int32)).to(torch.uint8)
    result = images.clone()
    result[:, 1:-1, 1:-1] = degenerate
    return blend(result, images, factor)


def cutout(images, cy, cx, mask_size, constant_values=0):
    """Fill a ``mask_size`` square per image centred at ``(cy[i], cx[i])``
    (``[b]`` ints), clipped at the borders (tfa.image.random_cutout
    semantics with the centres drawn by the caller)."""
    b, h, w, _ = images.shape
    half = mask_size // 2
    dev = images.device
    cy = torch.as_tensor(cy, device=dev)[:, None, None]
    cx = torch.as_tensor(cx, device=dev)[:, None, None]
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    in_y = (rows >= cy - half) & (rows < cy + half)
    in_x = (cols >= cx - half) & (cols < cx + half)
    return images.masked_fill((in_y & in_x)[..., None], constant_values)


# ---------------------------------------------------------------------------
# geometry: projective matrices and the separable warp
# ---------------------------------------------------------------------------

def transform(images, transforms, fill_value=0, interpolation="nearest"):
    """Projective warp (tfa.image.transform contract): ``transforms``
    ``[8]`` or ``[b, 8]`` map output ``(x, y)`` to input
    ``((a0 x + a1 y + a2) / k, (b0 x + b1 y + b2) / k)``,
    ``k = c0 x + c1 y + 1``; out-of-bounds samples take ``fill_value``.

    ``interpolation="nearest"`` picks ``floor(x + 0.5)``; ``"bilinear"``
    weighs four taps in float32, each out-of-bounds tap at ``fill_value``,
    in the JAX package's order (``t00 (1-fx)(1-fy) + t10 fx (1-fy) + t01
    (1-fx) fy + t11 fx fy``, left to right, every product rounded), and
    integer images come back as ``round(clip(., 0, 255))``. (The JAX
    package takes ``interpolation`` third; here ``fill_value`` keeps the
    third place it had before bilinear was ported.)"""
    b, h, w, c = images.shape
    dev = images.device
    t = torch.as_tensor(transforms, dtype=torch.float32, device=dev)
    if t.ndim == 1:
        t = t[None].expand(b, 8)
    ox = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    oy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    a0, a1, a2, b0, b1, b2, c0, c1 = (t[:, i, None, None] for i in range(8))
    k = c0 * ox + c1 * oy + 1.0
    sx = (a0 * ox + a1 * oy + a2) / k
    sy = (b0 * ox + b1 * oy + b2) / k
    bidx = torch.arange(b, device=dev)[:, None, None]
    if interpolation == "nearest":
        ix = torch.floor(sx + 0.5).to(torch.int64)
        iy = torch.floor(sy + 0.5).to(torch.int64)
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        gathered = images[bidx, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return gathered.masked_fill(~valid[..., None], fill_value)
    if interpolation != "bilinear":
        raise ValueError(f"Unknown interpolation '{interpolation}'")
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    fx = (sx - x0f)[..., None]
    fy = (sy - y0f)[..., None]
    fill = float(np.float32(fill_value))

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        g = images[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return g.to(torch.float32).masked_fill(~valid[..., None], fill)

    out = (tap(x0, y0) * (1 - fx) * (1 - fy)
           + tap(x0 + 1, y0) * fx * (1 - fy)
           + tap(x0, y0 + 1) * (1 - fx) * fy
           + tap(x0 + 1, y0 + 1) * fx * fy)
    if not images.is_floating_point():
        out = torch.round(out.clamp(0, 255))
    return out.to(images.dtype)


def _resize_weights(m, n):
    """``[m, n]`` float32 weights of a linear resize from ``m`` to ``n``
    samples, as ``jax.image.resize`` computes them under ``jit`` (with
    ``antialias``): half-pixel centres, a triangle kernel stretched by the
    downscale factor, each output's weights divided by their sum, zero
    outside the input. Computed on the host in numpy float32 in the
    jitted order: ``1 - |d| * (1 / kernel_scale)`` rounded once (XLA
    turns the division into a product and contracts it into a fused
    multiply-add, emulated in float64), the sum over the inputs taken in
    order."""
    f32 = np.float32
    inv_scale = 1.0 / (n / m)
    recip = f32(1) / f32(max(inv_scale, 1.0))
    sample = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None])
    weights = np.maximum(f32(0), (1.0 - dist.astype(np.float64)
                                  * np.float64(recip)).astype(f32))
    total = np.zeros(n, f32)
    for row in weights:
        total = total + row
    safe = np.where(total != 0, total, f32(1))
    weights = np.where(np.abs(total) > f32(1000 * np.finfo(f32).eps),
                       weights / safe, f32(0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def _nearest_indices(m, n):
    """Source index of each of ``n`` outputs resized from ``m`` samples:
    ``floor((i + 0.5) * m / n)`` in float32, as ``jax.image.resize``."""
    f32 = np.float32
    return np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n)
                    ).astype(np.int64)


def resize(images, size, method="bilinear"):
    """Resize ``[b, h, w, c]`` images to ``size = (height, width)`` with
    ``jax.image.resize``'s semantics, as the JAX package's ``Resizing``
    and ``ResizingMinMax`` call it: ``"nearest"`` gathers, ``"bilinear"``
    applies :func:`_resize_weights` as one float32 product over the height
    axis and one over the width axis (an axis whose size does not change
    is left as it is). Returns float32; the callers round integer images.
    """
    b, h, w, c = images.shape
    nh, nw = size
    x = images.to(torch.float32)
    dev = images.device
    if method == "nearest":
        rows = torch.from_numpy(_nearest_indices(h, nh)).to(dev)
        cols = torch.from_numpy(_nearest_indices(w, nw)).to(dev)
        return x[:, rows][:, :, cols]
    if method != "bilinear":
        raise ValueError(f"Unknown resize method '{method}'")
    if nh != h:
        weights = torch.from_numpy(_resize_weights(h, nh)).to(dev)
        x = torch.einsum("bhwc,hk->bkwc", x, weights)
    if nw != w:
        weights = torch.from_numpy(_resize_weights(w, nw)).to(dev)
        x = torch.einsum("bhwc,wk->bhkc", x, weights)
    return x


def _warp(images, transforms, interpolation, fill_value):
    return transform(images, transforms.to(images.device), fill_value,
                     interpolation)


def rotate(images, radians, interpolation="nearest", fill_value=0):
    """Rotate about the centre; ``radians`` scalar or per-image ``[b]``."""
    h, w = images.shape[1], images.shape[2]
    return _warp(images, rotation_matrices(radians, h, w), interpolation,
                 fill_value)


def shear_x(images, level, interpolation="nearest", fill_value=0):
    """Horizontal shear by ``level`` (scalar or ``[b]``)."""
    return _warp(images, shear_x_matrices(level), interpolation, fill_value)


def shear_y(images, level, interpolation="nearest", fill_value=0):
    """Vertical shear by ``level`` (scalar or ``[b]``)."""
    return _warp(images, shear_y_matrices(level), interpolation, fill_value)


def translate(images, translations, interpolation="nearest", fill_value=0):
    """Translate by ``[dx, dy]`` (``[2]`` or ``[b, 2]``): the content moves
    by +dx/+dy, so the matrix holds the negated values (tfa convention)."""
    tr = torch.as_tensor(translations, dtype=torch.float32)
    if tr.ndim == 1:
        tr = tr[None].expand(images.shape[0], 2)
    z, o = torch.zeros_like(tr[:, 0]), torch.ones_like(tr[:, 0])
    mats = torch.stack([o, z, -tr[:, 0], z, o, -tr[:, 1], z, z], dim=1)
    return _warp(images, mats, interpolation, fill_value)


def translate_x(images, pixels, interpolation="nearest", fill_value=0):
    """Reference TranslateX: the content moves by ``-pixels`` horizontally."""
    return _warp(images, translate_x_matrices(pixels), interpolation,
                 fill_value)


def translate_y(images, pixels, interpolation="nearest", fill_value=0):
    """Reference TranslateY: the content moves by ``-pixels`` vertically."""
    return _warp(images, translate_y_matrices(pixels), interpolation,
                 fill_value)


def identity_matrices(batch, device=None):
    """``[b, 8]`` identity projective transforms."""
    mats = torch.zeros((batch, 8), dtype=torch.float32, device=device)
    mats[:, 0] = 1.0
    mats[:, 4] = 1.0
    return mats


def _vec(values):
    return torch.atleast_1d(torch.as_tensor(values, dtype=torch.float32))


def rotation_matrices(radians, h, w):
    """tfa ``angles_to_projective_transforms``: rotation about the centre."""
    radians = _vec(radians)
    cos, sin = torch.cos(radians), torch.sin(radians)
    x_offset = ((w - 1) - (cos * (w - 1) - sin * (h - 1))) / 2.0
    y_offset = ((h - 1) - (sin * (w - 1) + cos * (h - 1))) / 2.0
    zeros = torch.zeros_like(cos)
    return torch.stack(
        [cos, -sin, x_offset, sin, cos, y_offset, zeros, zeros], dim=1)


def shear_x_matrices(level):
    level = _vec(level)
    z, o = torch.zeros_like(level), torch.ones_like(level)
    return torch.stack([o, level, z, z, o, z, z, z], dim=1)


def shear_y_matrices(level):
    level = _vec(level)
    z, o = torch.zeros_like(level), torch.ones_like(level)
    return torch.stack([o, z, z, level, o, z, z, z], dim=1)


def translate_x_matrices(pixels):
    """Reference TranslateX semantics: content moves left by ``pixels``."""
    pixels = _vec(pixels)
    z, o = torch.zeros_like(pixels), torch.ones_like(pixels)
    return torch.stack([o, z, pixels, z, o, z, z, z], dim=1)


def translate_y_matrices(pixels):
    pixels = _vec(pixels)
    z, o = torch.zeros_like(pixels), torch.ones_like(pixels)
    return torch.stack([o, z, z, z, o, pixels, z, z], dim=1)


def decompose_affine_shears(transforms):
    """Factor ``[b, 8]`` det-1 affine transforms into three shear passes.

    Returns ``(A1, B1, A2, B2, A3, B3)``, each ``[b]``: x-shift pass
    ``x -> x + A1*y + B1``, then y-shift ``y -> y + A2*x + B2``, then x-shift
    ``x -> x + A3*y + B3`` reproduce ``source = M @ (x, y, 1)``.
    Preconditions: zero projective row, ``det == 1``, and ``a0 == 1``
    whenever ``b0 == 0`` (every matrix the policies build).
    """
    t = torch.as_tensor(transforms, dtype=torch.float32)
    a0, a1, a2 = t[:, 0], t[:, 1], t[:, 2]
    b0, b1, b2 = t[:, 3], t[:, 4], t[:, 5]
    nz = b0.abs() > 1e-8
    safe = torch.where(nz, b0, torch.ones_like(b0))
    zero = torch.zeros_like(b0)
    A2 = b0
    A1 = torch.where(nz, (a0 - 1.0) / safe, zero)
    A3 = torch.where(nz, (b1 - 1.0) / safe, a1)
    B3 = torch.where(nz, zero, a2)
    B2 = b2 - A2 * B3
    B1 = a2 - a0 * B3 - A1 * B2
    return A1, B1, A2, B2, A3, B3


def default_pad(h, w):
    """Fill columns per side covering rotations up to 30 degrees."""
    return int(np.ceil(0.2680 * (max(h, w) - 1) / 2.0)) + 2


def transform_affine_separable(images, transforms, fill_value=0, pad=None):
    """Nearest-neighbour warp for det-1 affine ``[b, 8]`` transforms as three
    composed shear passes, with ``pad`` fill columns per side for the
    intermediate passes' excursions. Matches :func:`transform` exactly for
    single-shear maps; rotations round once per pass (<= 1 source pixel).

    uint8 batches only: the warp is the hand-written kernel K2
    (``warp_kernels.transform_affine_separable``), or its plain version for
    a CPU tensor."""
    from chambers_tpu_torch.ops import warp_kernels

    b, h, w, _ = images.shape
    t = torch.as_tensor(transforms, dtype=torch.float32, device=images.device)
    if t.ndim == 1:
        t = t[None].expand(b, 8)
    if pad is None:
        pad = default_pad(h, w)
    return warp_kernels.transform_affine_separable(images, t, fill_value, pad)
