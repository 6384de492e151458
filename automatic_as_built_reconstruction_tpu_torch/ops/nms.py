"""Batched NMS on score-sorted rows: rotated IoU NMS, nearest
(axis-aligned) NMS and centre suppression.

The port of ``ops/nms_jax.py``: ``rotate_nms_presorted`` (:237) and
``nearest_nms_presorted`` (:277) with their exact two-level
``compact_cap`` sizing, ``nearest_nms`` (:347), ``rbbox_to_near_bbox``
(:369), the greedy fixpoint ``_greedy_suppress`` (:18) and
``center_suppress_presorted`` (:183).  As
the reference decides with ``lax.while_loop`` (:46) and ``lax.cond``
(:268), the port decides on the device with the ``while_loop`` and
``cond`` higher-order ops, called as ops (not through their
``torch.compile`` front ends), so that ``torch.export`` holds the
serving program's NMS whole.  The
dense ``[R, K', K']`` IoU comes from the rotated-IoU kernel
(:func:`..ops.rotated_iou.rotate_iou_matrix`).  The JAX package's
circle-bound candidate pruning (``_neighbor_candidates``) is TPU tuning
against the cost of the dense clip and gives the same keep set, so it is
not ported.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch._higher_order_ops.cond import cond_op
from torch._higher_order_ops.while_loop import while_loop_op

from .box_ops import limit_period
from .rotated_iou import rotate_iou_matrix


def _unsettled(keep, changed, sweep, sup, valid):
    """The fixpoint's loop condition: the last sweep changed the mask and
    fewer than K sweeps ran."""
    return changed & (sweep < sup.shape[-1])


def _sweep(keep, changed, sweep, sup, valid):
    """One sweep of the greedy fixpoint."""
    new = valid & ~(keep[:, :, None] & sup).any(dim=1)
    return new, (new != keep).any(), sweep + 1


def greedy_suppress(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact greedy keep mask of score-sorted rows.

    ``sup`` [R, K, K] bool: ``sup[r, j, i]`` — box j overlaps box i enough
    to suppress it (only ``j < i`` is used).  ``valid`` [R, K] bool.

    The greedy answer is the unique fixpoint of ``keep_i = valid_i and not
    any_{j<i} (keep_j and sup_ji)``; iterating from ``keep = valid``
    settles at least one more leading box per sweep, so the loop ends at
    the exact greedy answer after at most K sweeps (usually a few).  The
    loop is a ``while_loop`` higher-order op carrying (keep, changed,
    sweep): an export holds it as one node that decides on the device;
    run eagerly, the op reads its condition after each sweep.  Its
    functions capture no tensor (``sup`` and ``valid`` are passed in).
    """
    K = sup.shape[-1]
    idx = torch.arange(K, device=sup.device)
    sup = sup & (idx[:, None] < idx[None, :])
    start = (valid,
             torch.ones((), dtype=torch.bool, device=sup.device),
             torch.zeros((), dtype=torch.int64, device=sup.device))
    keep, _, _ = while_loop_op(_unsettled, _sweep, start, (sup, valid))
    return keep


def compact_keep(keep: torch.Tensor, post_max_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kept column indices per row -> [R, post_max_size] (-1 padding) and
    their validity mask (a scatter of the first ``post_max_size`` kept
    columns to their ranks; the others go to a dump column)."""
    R, K = keep.shape
    kpos = torch.cumsum(keep.int(), dim=1) - 1
    tgt = torch.where(keep & (kpos < post_max_size), kpos,
                      post_max_size).long()
    cols = torch.arange(K, dtype=torch.int32, device=keep.device)
    out = torch.full((R, post_max_size + 1), -1, dtype=torch.int32,
                     device=keep.device)
    out = torch.scatter(out, 1, tgt, cols.expand(R, K))[:, :post_max_size]
    return out, out >= 0


def _nms_keep(boxes, valid, iou_threshold: float, post_max_size: int):
    iou = rotate_iou_matrix(boxes, boxes)
    keep = greedy_suppress(iou > iou_threshold, valid)
    idx, ok = compact_keep(keep, post_max_size)
    return idx.contiguous(), ok.contiguous()


def _presorted(keep_fn, boxes: torch.Tensor, scores: torch.Tensor,
               compact_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``keep_fn(boxes, valid)`` on the first ``compact_cap`` columns when
    no row has more valid (descending, so a prefix) entries, else on the
    full width: a ``cond`` higher-order op on the device."""
    K = scores.shape[1]
    valid = scores > -float("inf")
    boxes = boxes.float().contiguous()
    k2 = min(compact_cap, K)
    if k2 == K:
        return keep_fn(boxes, valid)

    def compact(boxes, valid):
        return keep_fn(boxes[:, :k2].contiguous(),
                       valid[:, :k2].contiguous())

    fits = valid.sum(dim=1).max() <= k2
    idx, ok = cond_op(fits, compact, keep_fn, (boxes, valid))
    return idx, ok


def rotate_nms_presorted(boxes: torch.Tensor, scores: torch.Tensor,
                         iou_threshold: float, post_max_size: int,
                         compact_cap: int = 256
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotated NMS of rows already sorted by descending score.

    boxes [R, K, 5] (x, y, w, l, yaw); scores [R, K], -inf = invalid.
    Returns indices into each row's K axis [R, post_max_size] (-1 pad)
    and their validity mask.

    Two-level sizing: valid entries of a descending row form a prefix, so
    when no row has more than ``compact_cap`` of them, NMS on the first
    ``compact_cap`` columns is exact and the IoU matrix shrinks to
    [R, cap, cap]; otherwise the full width runs.  The choice is a
    ``cond`` higher-order op on the device (both branches end in
    :func:`compact_keep`: [R, post_max_size]).
    """
    def keep(boxes, valid):
        return _nms_keep(boxes, valid, iou_threshold, post_max_size)

    return _presorted(keep, boxes, scores, compact_cap)


def near_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of axis-aligned BEV boxes [..., K, 4] (x1, y1, x2, y2)
    -> [..., K, K]; 0 where the union is not positive."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0))
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :]))
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :]))
    inter = torch.clamp_min(iw, 0) * torch.clamp_min(ih, 0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-12),
                       torch.zeros((), dtype=inter.dtype,
                                   device=inter.device))


def nearest_nms_presorted(boxes_bev: torch.Tensor, scores: torch.Tensor,
                          iou_threshold: float, post_max_size: int,
                          compact_cap: int = 256
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Axis-aligned NMS of rows already sorted by descending score.

    boxes_bev [R, K, 4] (x1, y1, x2, y2); scores [R, K], -inf = invalid.
    Returns indices into each row's K axis [R, post_max_size] (-1 pad)
    and their validity mask, with :func:`rotate_nms_presorted`'s exact
    two-level sizing decided on the device."""
    def keep(boxes, valid):
        kept = greedy_suppress(near_iou_matrix(boxes) > iou_threshold,
                               valid)
        idx, ok = compact_keep(kept, post_max_size)
        return idx.contiguous(), ok.contiguous()

    return _presorted(keep, boxes_bev, scores, compact_cap)


def nearest_nms(boxes_bev: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float, pre_max_size: int,
                post_max_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Axis-aligned NMS on yaw-snapped BEV boxes [N, 4] (x1, y1, x2, y2)
    with scores [N] (-inf = invalid): the ``pre_max_size`` best (ties to
    the lower index, as ``jax.lax.top_k``), greedy NMS, -> indices into
    the input [post_max_size] (-1 pad) and their validity mask."""
    k = min(pre_max_size, boxes_bev.shape[0])
    top_sc, top_idx = torch.sort(scores, descending=True, stable=True)
    top_sc, top_idx = top_sc[:k], top_idx[:k]
    kept = greedy_suppress(
        near_iou_matrix(boxes_bev[top_idx].float())[None] > iou_threshold,
        (top_sc > -float("inf"))[None])
    idx, ok = compact_keep(kept, post_max_size)
    idx, ok = idx[0], ok[0]
    out = torch.where(ok, top_idx[idx.clamp_min(0).long()].to(torch.int32),
                      -1)
    return out, ok


def rbbox_to_near_bbox(rbboxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, w, l, yaw) -> the nearest axis-aligned [..., 4]
    (x1, y1, x2, y2): w and l swap where the yaw is nearer a quarter
    turn (the JAX package's ``rbbox_to_near_bbox``)."""
    rots = torch.abs(limit_period(rbboxes[..., -1], 0.5, math.pi))
    swap = (rots > math.pi / 4)[..., None]
    boxes = torch.where(swap, rbboxes[..., [0, 1, 3, 2]], rbboxes[..., :4])
    centers, dims = boxes[..., :2], boxes[..., 2:]
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1)


def center_suppress_presorted(centers: torch.Tensor, valid: torch.Tensor,
                              radius: float) -> torch.Tensor:
    """Greedy suppression by BEV centre distance on score-sorted rows.

    centers [R, K, 2], valid [R, K] -> keep [R, K]: a detection is dropped
    when a higher-scored KEPT detection of its row lies within ``radius``.
    """
    d2 = ((centers[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
    return greedy_suppress(d2 < radius * radius, valid)
