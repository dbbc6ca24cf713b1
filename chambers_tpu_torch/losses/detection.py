"""DETR's set-prediction loss and its matchers (port of
``chambers_tpu/losses/detection.py``).

- Box utilities over normalized ``(cx, cy, w, h)`` and ``xyxy`` boxes.
- :func:`matching_cost_matrix`: DETR's matching costs ``[b, t, q]``, rows
  the target slots; a padded slot costs ``1e6`` against every query.
- :func:`hungarian_matcher`: the optimal assignment. The costs are computed
  on the costs' device; scipy's Jonker-Volgenant solver assigns on the
  host, with one copy each way.
- :func:`auction_assignment` / :func:`auction_matcher`: Bertsekas's
  ε-auction on the device, every problem of the batch in lockstep.
- :class:`DETRLoss`: class cross-entropy with the no-object class
  down-weighted, L1 and generalized IoU on the matched pairs, summed over
  the decoder's layers for ``[b, L, q, *]`` outputs.

The auction's body is the JAX package's float32 arithmetic in its order
(``argmax`` returns the first maximum, as ``jnp.argmax`` does), so both
packages assign the same columns on the same costs, ties included: at a
padded slot's cost of 1e6 float32 steps are 0.0625 wide and the price
rises of ``eps`` are invisible, so such rows tie on the first column until
its price passes ~0.03 and then cascade along the columns. JAX runs the
loop as a vmapped ``lax.while_loop``, until every problem is assigned or
``max_iters``; a finished problem has no bidder and the body leaves it as
it is. The port runs the body ``AUCTION_CHECK_EVERY`` times between host
reads of "is any row unassigned", never more than ``max_iters`` times in
all, with the same result.

Assignments come back int64 (JAX: int32). Costs are computed under
``torch.no_grad()`` on detached tensors, as JAX's ``stop_gradient``.
"""

import numpy as np
import torch
from torch.nn import functional as F

# iterations of the auction's body between host checks for unassigned rows
AUCTION_CHECK_EVERY = 8

# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------


def box_cxcywh_to_xyxy(boxes):
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def box_area(boxes_xyxy):
    return (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) * (
        boxes_xyxy[..., 3] - boxes_xyxy[..., 1])


def box_iou(boxes1, boxes2):
    """Pairwise IoU and union of ``[..., n, 4]`` and ``[..., m, 4]`` xyxy
    boxes -> ``[..., n, m]`` each (leading axes broadcast)."""
    area1 = box_area(boxes1)[..., :, None]
    area2 = box_area(boxes2)[..., None, :]
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / torch.clamp(union, min=1e-8), union


def generalized_box_iou(boxes1, boxes2):
    """Pairwise GIoU (Rezatofighi et al.) of xyxy boxes -> ``[..., n, m]``."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    enclosing = torch.clamp(wh[..., 0] * wh[..., 1], min=1e-8)
    return iou - (enclosing - union) / enclosing


def paired_generalized_box_iou(boxes1, boxes2):
    """GIoU of matched xyxy box pairs ``[..., 4]`` -> ``[...]``."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / torch.clamp(union, min=1e-8)
    lt_c = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_c = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_c = torch.clamp(rb_c - lt_c, min=0.0)
    enclosing = torch.clamp(wh_c[..., 0] * wh_c[..., 1], min=1e-8)
    return iou - (enclosing - union) / enclosing


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

@torch.no_grad()
def matching_cost_matrix(pred_logits, pred_boxes, target_labels,
                         target_boxes, target_mask, cost_class=1.0,
                         cost_bbox=5.0, cost_giou=2.0):
    """DETR's matching costs ``[b, t, q]`` (rows the target slots) of
    ``[b, q, c]`` logits and ``[b, q, 4]`` boxes against ``[b, t]`` labels,
    ``[b, t, 4]`` boxes and a ``[b, t]`` mask; a padded slot costs 1e6."""
    logits, boxes = pred_logits.detach(), pred_boxes.detach()
    b, q = logits.shape[:2]
    t = target_labels.shape[1]
    prob = torch.softmax(logits, dim=-1)
    c_class = -torch.gather(prob, 2, target_labels.long()[:, None, :]
                            .expand(b, q, t))
    c_bbox = torch.sum(torch.abs(boxes[:, :, None] - target_boxes[:, None]),
                       dim=-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(boxes),
                                  box_cxcywh_to_xyxy(target_boxes))
    cost = cost_class * c_class + cost_bbox * c_bbox + cost_giou * c_giou
    cost = torch.where(target_mask.bool()[:, None, :], cost, 1e6)
    return cost.transpose(1, 2)


def _lsa_host(cost):
    """Optimal assignment of a host ``[..., n, m]`` cost array: the column
    of each row, ``[..., n]`` int64. Needs ``n <= m``."""
    from scipy.optimize import linear_sum_assignment as lsa

    n, m = cost.shape[-2], cost.shape[-1]
    if n > m:
        raise ValueError(
            f"linear_sum_assignment needs rows <= cols; got {n} targets for "
            f"{m} queries — raise num_queries above max targets per image.")
    out = np.zeros(cost.shape[:-2] + (n,), np.int64)
    flat_out = out.reshape(-1, n)
    for i, c in enumerate(cost.reshape((-1,) + cost.shape[-2:])):
        rows, cols = lsa(np.asarray(c, np.float64))
        flat_out[i, rows] = cols
    return out


def linear_sum_assignment(cost_matrix):
    """Optimal assignment of ``[..., n, m]`` costs (``n <= m``) by scipy on
    the host: ``[..., n]`` int64 on the costs' device."""
    cols = _lsa_host(cost_matrix.detach().cpu().numpy())
    return torch.from_numpy(cols).to(cost_matrix.device)


def hungarian_matcher(pred_logits, pred_boxes, target_labels, target_boxes,
                      target_mask, cost_class=1.0, cost_bbox=5.0,
                      cost_giou=2.0):
    """The optimal query for each target slot, ``[b, t]`` int64: costs on
    the device, the assignment from scipy on the host. Read it together
    with ``target_mask``."""
    cost = matching_cost_matrix(
        pred_logits, pred_boxes, target_labels, target_boxes, target_mask,
        cost_class=cost_class, cost_bbox=cost_bbox, cost_giou=cost_giou)
    return linear_sum_assignment(cost)


def hungarian_matcher_host(pred_logits, pred_boxes, target_labels,
                           target_boxes, target_mask, cost_class=1.0,
                           cost_bbox=5.0, cost_giou=2.0):
    """:func:`hungarian_matcher` (in JAX the eager twin of the jitted
    matcher's host callback; in PyTorch the two are one computation)."""
    return hungarian_matcher(pred_logits, pred_boxes, target_labels,
                             target_boxes, target_mask, cost_class=cost_class,
                             cost_bbox=cost_bbox, cost_giou=cost_giou)


def _auction_rows(benefit, eps, max_iters, check_every):
    """The auction's loop over ``[B, n, m]`` float32 benefits: ``(row2col
    [B, n] int64 with -1 where unassigned, iterations run)``. The body runs
    ``check_every`` times between host checks, ``max_iters`` at most."""
    nb, n, m = benefit.shape
    dev = benefit.device
    cols = torch.arange(m, device=dev)
    rows = torch.arange(n, device=dev)
    price = torch.zeros((nb, m), dtype=torch.float32, device=dev)
    row2col = torch.full((nb, n), -1, dtype=torch.int64, device=dev)
    neg_inf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    it = 0
    while it < max_iters and bool((row2col < 0).any()):
        for _ in range(min(check_every, max_iters - it)):
            bidding = row2col < 0
            value = benefit - price[:, None, :]
            j1 = torch.argmax(value, dim=2)
            v1 = torch.amax(value, dim=2)
            is_j1 = cols == j1[..., None]
            v2 = torch.amax(torch.where(is_j1, neg_inf, value), dim=2)
            # one column: no second best, a fixed increment
            bid = (torch.gather(price, 1, j1)
                   + torch.where(torch.isfinite(v2), v1 - v2, 0.0) + eps)
            bids = torch.where(is_j1 & bidding[..., None], bid[..., None],
                               neg_inf)
            col_best = torch.amax(bids, dim=1)
            col_winner = torch.argmax(bids, dim=1)
            has_bid = col_best > neg_inf
            cur = torch.clamp(row2col, min=0)
            dethroned = ((row2col >= 0) & torch.gather(has_bid, 1, cur)
                         & (torch.gather(col_winner, 1, cur) != rows))
            won = (bidding & torch.gather(has_bid, 1, j1)
                   & (torch.gather(col_winner, 1, j1) == rows))
            row2col = torch.where(won, j1,
                                  torch.where(dethroned, -1, row2col))
            price = torch.where(has_bid, col_best, price)
            it += 1
    return row2col, it


def auction_assignment(cost, eps=1e-3, max_iters=200):
    """Bertsekas's ε-auction on the costs' device: an assignment of
    ``[..., n, m]`` costs (``n <= m``) within ``n·eps`` of the optimum,
    ``[..., n]`` int64, a distinct column per row. Rows still unassigned
    after ``max_iters`` get the free columns in order of rank."""
    n, m = cost.shape[-2], cost.shape[-1]
    if n > m:
        raise ValueError(
            f"auction_assignment needs rows <= cols; got {n} rows for "
            f"{m} columns.")
    flat = cost.detach().reshape(-1, n, m)
    row2col, _ = _auction_rows(-flat.to(torch.float32), eps, max_iters,
                               AUCTION_CHECK_EVERY)
    # leftovers take distinct free columns by rank (a colliding fallback
    # would scatter duplicate indices downstream)
    unassigned = row2col < 0
    cols = torch.arange(m, device=cost.device)
    owned = torch.zeros((flat.shape[0], m + 1), dtype=torch.bool,
                        device=cost.device)
    owned.scatter_(1, torch.where(unassigned, m, row2col), True)
    owned = owned[:, :m]
    free_in_order = torch.argsort(torch.where(owned, m + cols, cols), dim=1,
                                  stable=True)
    rank = torch.cumsum(unassigned, dim=1) - 1
    fallback = torch.gather(free_in_order, 1, torch.clamp(rank, min=0))
    out = torch.where(unassigned, fallback, row2col)
    return out.reshape(cost.shape[:-2] + (n,))


def auction_matcher(pred_logits, pred_boxes, target_labels, target_boxes,
                    target_mask, cost_class=1.0, cost_bbox=5.0,
                    cost_giou=2.0, eps=1e-3, max_iters=200):
    """:func:`hungarian_matcher`'s contract, assigned by the ε-auction on
    the device."""
    cost = matching_cost_matrix(
        pred_logits, pred_boxes, target_labels, target_boxes, target_mask,
        cost_class=cost_class, cost_bbox=cost_bbox, cost_giou=cost_giou)
    return auction_assignment(cost, eps=eps, max_iters=max_iters)


# ---------------------------------------------------------------------------
# DETR loss
# ---------------------------------------------------------------------------

class DETRLoss:
    """Set-prediction loss: matching, then CE / L1 / GIoU terms.

    :param num_classes: object classes; class id ``num_classes`` is the
        no-object class.
    :param eos_coef: weight of the no-object CE terms (DETR: 0.1).
    :param matcher: ``"hungarian"`` (exact, scipy on the host) or
        ``"auction"`` (the ε-auction on the device).
    :param matcher_eps: the auction's bid increment; the assignment is
        within ``n_targets · eps`` of the optimum.
    """

    def __init__(self, num_classes, cost_class=1.0, cost_bbox=5.0,
                 cost_giou=2.0, weight_ce=1.0, weight_bbox=5.0,
                 weight_giou=2.0, eos_coef=0.1, matcher="hungarian",
                 matcher_eps=1e-2, matcher_iters=200):
        if matcher not in ("hungarian", "auction"):
            raise ValueError(f"Unknown matcher '{matcher}'")
        self.matcher = matcher
        self.matcher_eps = matcher_eps
        self.matcher_iters = matcher_iters
        self.num_classes = num_classes
        self.cost_class = cost_class
        self.cost_bbox = cost_bbox
        self.cost_giou = cost_giou
        self.weight_ce = weight_ce
        self.weight_bbox = weight_bbox
        self.weight_giou = weight_giou
        self.eos_coef = eos_coef

    def _costs(self):
        return dict(cost_class=self.cost_class, cost_bbox=self.cost_bbox,
                    cost_giou=self.cost_giou)

    def __call__(self, outputs, targets, assignment=None):
        """The total loss of ``outputs`` (``{"logits": [b, q, c + 1],
        "boxes": [b, q, 4]}``, or ``[b, L, q, *]`` with the decoder's
        layers, whose losses are summed) against ``targets`` (``{"labels":
        [b, t], "boxes": [b, t, 4], "mask": [b, t]}``). ``assignment``
        (``[b, t]``, or ``[L, b, t]``; :meth:`match`) skips the matcher."""
        logits, boxes = outputs["logits"], outputs["boxes"]
        if logits.ndim == 4:
            if assignment is None and self.matcher == "auction":
                # every layer in one lockstep auction over the L·b problems
                assignment = self._auction_all_layers(logits, boxes, targets)
            total = 0.0
            for layer in range(logits.shape[1]):
                total = total + self._single(
                    logits[:, layer], boxes[:, layer], targets,
                    None if assignment is None else assignment[layer])
            return total
        return self._single(logits, boxes, targets, assignment)

    def _auction_all_layers(self, logits, boxes, targets):
        """``[L, b, t]`` assignments of ``[b, L, q, *]`` outputs by one
        auction over the folded ``L·b`` problems."""
        b, n_layers = logits.shape[:2]
        t = targets["labels"].shape[1]
        flat_logits = logits.transpose(0, 1).reshape(
            (n_layers * b,) + logits.shape[2:])
        flat_boxes = boxes.transpose(0, 1).reshape(
            (n_layers * b,) + boxes.shape[2:])

        def tile(x):
            return torch.cat([x] * n_layers, dim=0)

        flat = auction_matcher(
            flat_logits, flat_boxes, tile(targets["labels"]),
            tile(targets["boxes"]), tile(targets["mask"].bool()),
            eps=self.matcher_eps, max_iters=self.matcher_iters,
            **self._costs())
        return flat.reshape(n_layers, b, t)

    def match(self, outputs, targets):
        """The Hungarian assignment of ``outputs``, ``[b, t]`` or ``[L, b,
        t]``, to pass to ``__call__``."""
        logits, boxes = outputs["logits"], outputs["boxes"]
        t = (targets["labels"], targets["boxes"], targets["mask"].bool())
        if logits.ndim == 4:
            return torch.stack([
                hungarian_matcher_host(logits[:, i], boxes[:, i], *t,
                                       **self._costs())
                for i in range(logits.shape[1])])
        return hungarian_matcher_host(logits, boxes, *t, **self._costs())

    def _single(self, logits, boxes, targets, assignment=None):
        t_labels = targets["labels"].long()
        t_boxes = targets["boxes"]
        t_mask = targets["mask"].bool()
        if assignment is None:
            if self.matcher == "auction":
                assignment = auction_matcher(
                    logits, boxes, t_labels, t_boxes, t_mask,
                    eps=self.matcher_eps, max_iters=self.matcher_iters,
                    **self._costs())
            else:
                assignment = hungarian_matcher(
                    logits, boxes, t_labels, t_boxes, t_mask,
                    **self._costs())
        assignment = assignment.long()
        b, q = logits.shape[:2]
        num_boxes = torch.clamp(t_mask.sum().to(torch.float32), min=1.0)

        # matched queries take the target's label, every other query the
        # no-object class; padded slots scatter the no-object class
        scatter_labels = torch.where(t_mask, t_labels, self.num_classes)
        target_classes = torch.full((b, q), self.num_classes,
                                    dtype=torch.int64, device=logits.device)
        target_classes = target_classes.scatter(1, assignment,
                                                scatter_labels)
        log_p = F.log_softmax(logits, dim=-1)
        ce = -torch.gather(log_p, 2, target_classes[..., None])[..., 0]
        class_weights = torch.where(target_classes == self.num_classes,
                                    self.eos_coef, 1.0)
        loss_ce = torch.sum(ce * class_weights) / torch.sum(class_weights)

        matched_boxes = torch.gather(
            boxes, 1, assignment[..., None].expand(*assignment.shape, 4))
        l1 = torch.sum(torch.abs(matched_boxes - t_boxes), dim=-1)
        loss_bbox = torch.sum(torch.where(t_mask, l1, 0.0)) / num_boxes
        giou = paired_generalized_box_iou(box_cxcywh_to_xyxy(matched_boxes),
                                          box_cxcywh_to_xyxy(t_boxes))
        loss_giou = torch.sum(torch.where(t_mask, 1.0 - giou, 0.0)) / num_boxes
        return (self.weight_ce * loss_ce + self.weight_bbox * loss_bbox
                + self.weight_giou * loss_giou)
