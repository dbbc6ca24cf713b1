"""The R-MAC descriptor (port of ``chambers_tpu/layers/descriptors.py``).

``rmac_regions`` is the multi-scale region grid of Tolias et al.: squares
of side ``2 min(W, H) / (l + 1)`` at scales ``l = 1..L`` with ~40% overlap,
extra regions along the long side. The grid is made once in numpy and
becomes boolean masks; ``RMAC`` is one masked max over them. As in the
reference, ``RMAC`` passes the first spatial axis as ``W`` and the second
as ``H``.
"""

import numpy as np
import torch


def _axis_offsets(extent, side, slots):
    """Offsets of ``slots`` squares of ``side`` spread over ``[0, extent)``:
    ``floor(k (extent - side) / (slots - 1))``."""
    if slots <= 1:
        return np.zeros(1, dtype=np.int64)
    stride = (extent - side) / (slots - 1)
    return np.floor(np.arange(slots) * stride).astype(np.int64)


def rmac_regions(W, H, L):
    """The R-MAC regions of a ``W x H`` map at ``L`` scales, ``[n, 4]``
    int64 ``(x, y, side, side)``, y-major."""
    short, long_side = min(W, H), max(W, H)
    # slot counts 2..7 along the long side at scale 1: the stride closest
    # to 0.6 of a side, an overlap closest to 0.4
    candidates = np.arange(2, 8)
    stride_over_side = (long_side - short) / (candidates - 1) / short
    extra = int(np.argmin(np.abs(stride_over_side - 0.6))) + 1
    extra_x = extra if W > H else 0
    extra_y = extra if H > W else 0
    boxes = []
    for scale in range(1, L + 1):
        side = 2 * short // (scale + 1)
        if side == 0:
            continue
        xs = _axis_offsets(W, side, scale + extra_x)
        ys = _axis_offsets(H, side, scale + extra_y)
        grid_x, grid_y = np.meshgrid(xs, ys)
        for x0, y0 in zip(grid_x.ravel(), grid_y.ravel()):
            boxes.append((x0, y0, side, side))
    return np.asarray(boxes, dtype=np.int64)


def _region_masks(regions, H, W):
    """``[n_regions, H, W]`` membership masks of a region grid."""
    rows = np.arange(H)[None, :, None]
    cols = np.arange(W)[None, None, :]
    ox = regions[:, 0, None, None]
    oy = regions[:, 1, None, None]
    tw = regions[:, 2, None, None]
    th = regions[:, 3, None, None]
    return (rows >= oy) & (rows < oy + th) & (cols >= ox) & (cols < ox + tw)


class RMAC:
    """Regional maximum activations: ``[b, H, W, C]`` -> ``[b, n_regions,
    C]`` channel maxima of each region."""

    def __init__(self, scales=3):
        self.scales = scales
        self._masks = None
        self._spatial = None

    def __call__(self, x):
        H, W = x.shape[1], x.shape[2]
        if self._masks is None or self._spatial != (H, W):
            # the reference's W is the first spatial axis
            regions = rmac_regions(H, W, self.scales)
            self._masks = _region_masks(regions, H, W)
            self._spatial = (H, W)
        masks = torch.from_numpy(self._masks).to(x.device)
        masked = torch.where(masks[None, :, :, :, None], x[:, None],
                             -torch.inf)
        return torch.amax(masked, dim=(2, 3))
