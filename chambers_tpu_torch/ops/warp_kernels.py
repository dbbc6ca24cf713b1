"""Wrappers for the separable-warp and fused-round CUDA kernels, with their
plain PyTorch versions.

Port of ``chambers_tpu/ops/warp_pallas.py``:

- :func:`transform_affine_separable` (K2) replaces
  ``transform_affine_separable_pallas``: the three-shear nearest warp of a
  uint8 batch by det-1 affine matrices, constant fill.
- :func:`fused_round` (K1) replaces ``fused_round_pallas``: one
  RandAugment/AutoAugment round in which every image runs only its sampled
  op — warp, Color, Sharpness, CutOut or passthrough.

Both kernels live in ``csrc/warp.cu`` (see the note there for their design
and bound). A wrapper checks its inputs, allocates the output with
``torch.empty``, launches on the current stream and adds one to its
``launches`` counter. On a CPU tensor it runs the plain version instead;
on a CUDA tensor it launches the kernel or raises — there is no fallback.
"""

import ctypes
import functools

import numpy as np
import torch

from chambers_tpu_torch.ops import _build
from chambers_tpu_torch.ops import image_ops

# op-class ids for fused_round (the kernel's contract, warp_pallas.py:52)
PASSTHROUGH, WARP, COLOR, SHARPNESS, CUTOUT = range(5)

LIBRARY = ("warp", ["warp.cu"])


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load(*LIBRARY)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.warp_launch.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.warp_launch.restype = i32
    lib.fused_round_launch.argtypes = [ptr] * 10 + [i32] * 8 + [ptr]
    lib.fused_round_launch.restype = i32
    return lib


def _resolve_fill(fill_value, dtype=np.uint8):
    """Static fill through the same dtype conversion as the JAX package's
    XLA path: Python scalars are range-checked (OverflowError), numpy
    scalars C-cast."""
    if isinstance(fill_value, (bool, int, float)):
        return int(np.asarray(fill_value, dtype))
    return int(np.asarray(fill_value).astype(dtype))


def _check_images(images, name, channels=None):
    if not isinstance(images, torch.Tensor) or images.dtype != torch.uint8:
        raise TypeError(f"{name} takes a uint8 tensor, got "
                        f"{getattr(images, 'dtype', type(images))}")
    if images.ndim != 4 or (channels and images.shape[3] != channels):
        want = f"[b, h, w, {channels}]" if channels else "[b, h, w, c]"
        raise ValueError(f"{name} takes {want} images, got "
                         f"{tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA, not {images.device}")


def _per_image(value, b, dtype, device):
    """``[b]`` values on the device from a ``[b]`` tensor or a scalar (a
    scalar is filled on the device: no synchronising host copy)."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    if isinstance(value, torch.Tensor) and value.ndim == 1:
        v = value.to(device=device, dtype=dtype)
    else:
        value = np.asarray(value).item()
        v = torch.full((b,), value, dtype=dtype, device=device)
    if v.shape != (b,):
        raise ValueError(f"expected a scalar or [{b}] values, got "
                         f"{tuple(v.shape)}")
    return v.contiguous()


def _shift_vectors(transforms, b, h, w, pad):
    """Integer shifts of the three shear passes, ``int32``: ``n1`` and
    ``n3`` per row ``[b, h]``, ``n2`` per padded column ``[b, w + 2 pad]``
    (the arithmetic of ``warp_pallas._shift_vectors``; the gather needs only
    the raw shifts, not their ``% L`` forms)."""
    wp = w + 2 * pad
    t = torch.as_tensor(transforms, dtype=torch.float32)
    if t.ndim == 1:
        t = t[None].expand(b, 8)
    if t.shape != (b, 8):
        raise ValueError(f"expected [{b}, 8] transforms, got {tuple(t.shape)}")
    A1, B1, A2, B2, A3, B3 = image_ops.decompose_affine_shears(t)
    dev = t.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :]
    xs = torch.arange(wp, dtype=torch.float32, device=dev)[None, :] - pad

    def shifts(A, B, coords):
        return torch.floor(A[:, None] * coords + B[:, None] + 0.5).to(
            torch.int32)

    return shifts(A1, B1, ys), shifts(A2, B2, xs), shifts(A3, B3, ys)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def warp_plain(images, n1, n2, n3, fill, pad):
    """The composed three-shear gather (see ``csrc/warp.cu``) in PyTorch."""
    b, h, w, _ = images.shape
    wp = w + 2 * pad
    dev = images.device
    bi = torch.arange(b, device=dev)[:, None, None]
    y = torch.arange(h, device=dev)[None, :, None]
    x = torch.arange(w, device=dev)[None, None, :]
    n1, n2, n3 = (n.to(torch.int64) for n in (n1, n2, n3))
    x3 = x + pad + n3[:, :, None]
    ok = (x3 >= 0) & (x3 < wp)
    y2 = y + n2[bi, x3.clamp(0, wp - 1)]
    ok &= (y2 >= 0) & (y2 < h)
    y2 = y2.clamp(0, h - 1)
    x1 = x3 + n1[bi, y2]
    ok &= (x1 >= pad) & (x1 < pad + w)
    src = images[bi, y2, (x1 - pad).clamp(0, w - 1)]
    return src.masked_fill(~ok[..., None], fill)


def fused_round_plain(images, n1, n2, n3, op_class, cut_cy, cut_cx,
                      color_factor, sharp_factor, fill, pad, cut_half,
                      cut_fill):
    """K1 in PyTorch: each op-class subset of the batch through the
    corresponding ``image_ops`` op (or the plain warp)."""
    out = images.clone()
    for cls in (WARP, COLOR, SHARPNESS, CUTOUT):
        sel = torch.nonzero(op_class == cls)[:, 0]
        if sel.numel() == 0:
            continue
        x = images[sel]
        if cls == WARP:
            y = warp_plain(x, n1[sel], n2[sel], n3[sel], fill, pad)
        elif cls == COLOR:
            y = image_ops.color(x, color_factor[sel])
        elif cls == SHARPNESS:
            y = image_ops.sharpness(x, sharp_factor[sel])
        else:
            y = image_ops.cutout(x, cut_cy[sel], cut_cx[sel], 2 * cut_half,
                                 cut_fill)
        out[sel] = y
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_ptr, _stream, _check_launch = _build.ptr, _build.stream, _build.check_launch


def launch_warp(images, out, n1, n2, n3, fill, pad):
    """Launch K2 alone on prepared device arguments (the wrapper's last
    step); raises if CUDA refuses the launch."""
    lib = _library()
    b, h, w, c = images.shape
    with torch.cuda.device(images.device):
        code = lib.warp_launch(
            _ptr(images), _ptr(out), _ptr(n1), _ptr(n2), _ptr(n3),
            b, h, w, c, pad, fill, _stream(images.device))
    _check_launch(lib, code, "warp_kernel")
    return out


def launch_fused_round(images, out, n1, n2, n3, op_class, cy, cx, fc, fs,
                       fill, pad, cut_half, cut_fill):
    """Launch K1 alone on prepared device arguments (int32 ``op_class``,
    ``cy``, ``cx``; float32 ``fc``, ``fs``; all ``[b]``)."""
    lib = _library()
    b, h, w, c = images.shape
    with torch.cuda.device(images.device):
        code = lib.fused_round_launch(
            _ptr(images), _ptr(out), _ptr(n1), _ptr(n2), _ptr(n3),
            _ptr(op_class), _ptr(cy), _ptr(cx), _ptr(fc), _ptr(fs),
            b, h, w, c, pad, fill, cut_half, cut_fill,
            _stream(images.device))
    _check_launch(lib, code, "fused_round_kernel")
    return out


def transform_affine_separable(images, transforms, fill_value, pad):
    """K2: warp a uint8 ``[b, h, w, c]`` batch by ``[b, 8]`` det-1 affine
    matrices (output -> input), nearest sampling, constant ``fill_value``,
    ``pad`` fill columns per side for intermediate shear excursions."""
    _check_images(images, "transform_affine_separable")
    b, h, w, _ = images.shape
    fill = _resolve_fill(fill_value)
    t = torch.as_tensor(transforms, dtype=torch.float32, device=images.device)
    n1, n2, n3 = _shift_vectors(t, b, h, w, pad)
    if images.device.type == "cpu":
        return warp_plain(images, n1, n2, n3, fill, pad)
    out = launch_warp(images, torch.empty_like(images), n1, n2, n3, fill, pad)
    transform_affine_separable.launches += 1
    return out


transform_affine_separable.launches = 0


def fused_round_args(images, transforms, op_class, cut_cy, cut_cx, *,
                     fill_value, pad, color_factor, sharp_factor, cut_half,
                     cut_fill):
    """Checked, device-resident arguments of K1 (see :func:`fused_round`),
    in :func:`launch_fused_round`'s order after ``images, out``."""
    _check_images(images, "fused_round", channels=3)
    b, h, w, _ = images.shape
    dev = images.device
    t = torch.as_tensor(transforms, dtype=torch.float32, device=dev)
    n1, n2, n3 = _shift_vectors(t, b, h, w, pad)
    return (n1, n2, n3,
            _per_image(op_class, b, torch.int32, dev),
            _per_image(cut_cy, b, torch.int32, dev),
            _per_image(cut_cx, b, torch.int32, dev),
            _per_image(color_factor, b, torch.float32, dev),
            _per_image(sharp_factor, b, torch.float32, dev),
            _resolve_fill(fill_value), pad, int(cut_half),
            _resolve_fill(cut_fill))


def fused_round(images, transforms, op_class, cut_cy, cut_cx, **kwargs):
    """K1: one augmentation round over the non-LUT ops, dispatched per
    image on ``op_class`` ``[b]`` (PASSTHROUGH, WARP, COLOR, SHARPNESS,
    CUTOUT).

    :param images: uint8 ``[b, h, w, 3]``.
    :param transforms: ``[b, 8]`` det-1 affines (identity where unused).
    :param cut_cy, cut_cx: ``[b]`` cutout centres (read for CUTOUT only).
    :param kwargs: ``fill_value``, ``pad``; ``color_factor`` and
        ``sharp_factor``, blend factors as a scalar or ``[b]`` (the kernel
        always takes them per image); ``cut_half``, half the side of the
        cutout square; ``cut_fill``.
    """
    args = fused_round_args(images, transforms, op_class, cut_cy, cut_cx,
                            **kwargs)
    if images.device.type == "cpu":
        return fused_round_plain(images, *args)
    out = launch_fused_round(images, torch.empty_like(images), *args)
    fused_round.launches += 1
    return out


fused_round.launches = 0
