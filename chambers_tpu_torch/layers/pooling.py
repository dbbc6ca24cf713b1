"""Generalized-mean and RoI pooling (port of
``chambers_tpu/layers/pooling.py``).

- ``GlobalGeneralizedMean``: ``mean(clip(x, 1e-7, max(x))^p)^(1/p)`` over
  the spatial axes of ``[b, h, w, c]`` inputs, computed in float32, with a
  shared (``(1,)``) or per-channel (``(c,)``) parameter ``p``;
  ``trainable=False`` detaches it.
- ``roi_max_pool`` / ``RoiPooling``: each RoI's channel maxima as a masked
  max over the whole map.
- ``spatial_pyramid_roi_pool`` / ``RoiPooling_OG``: each RoI cut into
  ``i x i`` cells for every ``i`` of ``pool_list``, the cell edges rounded
  half to even (``torch.round``, as ``jnp.round``), an empty cell 0.

The clip keeps JAX's gradient: ``minimum(maximum(x, eps), max(x))`` splits
a tie between its operands, as XLA's ``min`` and ``max`` do.
"""

import torch
from torch import nn

from chambers_tpu_torch._device import resolve_device

_EPSILON = 1e-7  # tf.keras.backend.epsilon()


class GlobalGeneralizedMean(nn.Module):
    """GeM pooling of ``[b, h, w, c]`` inputs -> ``[b, c]`` float32.
    ``channels`` sizes a per-channel ``p`` (``shared=False``); the JAX
    module reads it from its first input."""

    def __init__(self, p=3.0, shared=True, trainable=True, channels=None,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if not shared and channels is None:
            raise ValueError("a per-channel p (shared=False) needs channels")
        self.init_p = p
        self.shared, self.trainable, self.channels = shared, trainable, channels
        shape = (1,) if shared else (channels,)
        self.p = nn.Parameter(torch.full(shape, float(p), dtype=param_dtype,
                                         device=resolve_device(device)))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.p.fill_(float(self.init_p))

    def get_config(self):
        """The constructor's arguments (``p`` is the initial value; the
        parameter of that name is a tensor)."""
        return {"p": self.init_p, "shared": self.shared,
                "trainable": self.trainable, "channels": self.channels}

    def forward(self, x):
        p = self.p if self.trainable else self.p.detach()
        x = x.to(torch.float32)
        x = torch.minimum(torch.maximum(x, torch.tensor(_EPSILON,
                                                        device=x.device)),
                          torch.amax(x))
        x = torch.pow(x, p)
        x = torch.mean(x, dim=(1, 2))
        return torch.pow(x, 1.0 / p)


def roi_max_pool(x, roi_boxes):
    """Channel maxima of ``[b, num_rois, 4]`` integer boxes ``(x, y, w,
    h)`` (column and row offset, width, height) over ``[b, H, W, C]`` maps
    -> ``[b, num_rois, C]``."""
    h, w = x.shape[1], x.shape[2]
    rows = torch.arange(h, device=x.device)[:, None]
    cols = torch.arange(w, device=x.device)[None, :]
    boxes = roi_boxes.to(torch.int32)
    ox, oy = boxes[..., 0, None, None], boxes[..., 1, None, None]
    tw, th = boxes[..., 2, None, None], boxes[..., 3, None, None]
    mask = ((rows >= oy) & (rows < oy + th) & (cols >= ox)
            & (cols < ox + tw))                           # [b, R, H, W]
    masked = torch.where(mask[..., None], x[:, None], -torch.inf)
    return torch.amax(masked, dim=(2, 3))


class RoiPooling:
    """RoI max pooling over ``[x_img, x_roi]``."""

    def __call__(self, inputs):
        x, roi_boxes = inputs
        return roi_max_pool(x, roi_boxes)


def spatial_pyramid_roi_pool(x, rois, pool_list):
    """Spatial-pyramid RoI pooling: every ``(x, y, w, h)`` RoI of ``[b, R,
    4]`` cut into ``i x i`` cells for each ``i`` of ``pool_list``, each
    cell max-pooled -> ``[b, R, C * sum(i * i)]``."""
    b, height, width, _ = x.shape
    rois = rois.to(torch.float32)
    bx, by = rois[..., 0], rois[..., 1]
    bw, bh = rois[..., 2], rois[..., 3]
    rows = torch.arange(height, device=x.device)[:, None]
    cols = torch.arange(width, device=x.device)[None, :]
    outputs = []
    for n in pool_list:
        steps = torch.arange(n + 1, dtype=torch.float32, device=x.device)
        x_edges = torch.round(bx[..., None] + steps * (bw[..., None] / n))
        y_edges = torch.round(by[..., None] + steps * (bh[..., None] / n))
        x0, x1 = x_edges[..., :-1], x_edges[..., 1:]          # [b, R, n]
        y0, y1 = y_edges[..., :-1], y_edges[..., 1:]
        col_in = ((cols >= x0[..., None, None])
                  & (cols < x1[..., None, None]))            # [b, R, n, 1, W]
        row_in = ((rows >= y0[..., None, None])
                  & (rows < y1[..., None, None]))            # [b, R, n, H, 1]
        mask = row_in[:, :, :, None] & col_in[:, :, None, :]
        masked = torch.where(mask[..., None], x[:, None, None, None],
                             -torch.inf)            # [b, R, ny, nx, H, W, C]
        pooled = torch.amax(masked, dim=(4, 5))
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
        outputs.append(pooled.reshape(b, rois.shape[1], -1))
    return torch.cat(outputs, dim=-1)


class RoiPooling_OG:
    """Spatial-pyramid RoI pooling over ``[x_img, x_roi]`` (the reference's
    name)."""

    def __init__(self, pool_list, num_rois=None):
        self.pool_list = list(pool_list)
        self.num_rois = num_rois  # the reference's signature; not used

    def __call__(self, inputs):
        x, rois = inputs
        return spatial_pyramid_roi_pool(x, rois, self.pool_list)
