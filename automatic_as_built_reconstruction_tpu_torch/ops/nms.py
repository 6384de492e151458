"""Batched NMS on score-sorted rows: rotated IoU NMS + centre suppression.

The port of ``ops/nms_jax.py``: ``rotate_nms_presorted`` (:237) with its
exact two-level ``compact_cap`` sizing, the greedy fixpoint
``_greedy_suppress`` (:18) and ``center_suppress_presorted`` (:183).  As
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

from typing import Tuple

import torch
from torch._higher_order_ops.cond import cond_op
from torch._higher_order_ops.while_loop import while_loop_op

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
    R, K = scores.shape
    valid = scores > -float("inf")
    boxes = boxes.float().contiguous()
    k2 = min(compact_cap, K)

    def full(boxes, valid):
        return _nms_keep(boxes, valid, iou_threshold, post_max_size)

    if k2 == K:
        return full(boxes, valid)

    def compact(boxes, valid):
        return _nms_keep(boxes[:, :k2].contiguous(),
                         valid[:, :k2].contiguous(), iou_threshold,
                         post_max_size)

    fits = valid.sum(dim=1).max() <= k2
    idx, ok = cond_op(fits, compact, full, (boxes, valid))
    return idx, ok


def center_suppress_presorted(centers: torch.Tensor, valid: torch.Tensor,
                              radius: float) -> torch.Tensor:
    """Greedy suppression by BEV centre distance on score-sorted rows.

    centers [R, K, 2], valid [R, K] -> keep [R, K]: a detection is dropped
    when a higher-scored KEPT detection of its row lies within ``radius``.
    """
    d2 = ((centers[:, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)
    return greedy_suppress(d2 < radius * radius, valid)
