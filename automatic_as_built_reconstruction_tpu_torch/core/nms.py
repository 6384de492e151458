"""Host-side NMS: plain (axis-aligned) and rotated greedy NMS.

The port's copy of the JAX package's ``core/nms.py``, in numpy over the
port's ``core/box_ops.py`` and ``core/geometry.py``: the oracles that the
device NMS of ``ops/nms.py`` is held to.  The same boxes and scores give
the same kept indices.
"""
from __future__ import annotations

import numpy as np

from . import box_ops, geometry


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
        pre_max_size: int | None = None, post_max_size: int | None = None):
    """Greedy axis-aligned NMS on [N,4] (x1,y1,x2,y2) boxes -> kept indices."""
    order = scores.argsort()[::-1]
    if pre_max_size is not None:
        order = order[:pre_max_size]
    boxes = boxes[order]
    keep = []
    suppressed = np.zeros(len(boxes), dtype=bool)
    for i in range(len(boxes)):
        if suppressed[i]:
            continue
        keep.append(order[i])
        if post_max_size is not None and len(keep) >= post_max_size:
            break
        ious = box_ops.iou_2d(boxes[i : i + 1], boxes[i + 1 :])[0]
        suppressed[i + 1 :] |= ious > iou_threshold
    return np.asarray(keep, dtype=np.int64)


def rotate_nms(rboxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
               pre_max_size: int | None = None,
               post_max_size: int | None = None):
    """Greedy rotated NMS on [N,5] (x,y,w,l,yaw) BEV boxes -> kept indices."""
    order = scores.argsort()[::-1]
    if pre_max_size is not None:
        order = order[:pre_max_size]
    rboxes = rboxes[order]
    n = len(rboxes)
    keep = []
    suppressed = np.zeros(n, dtype=bool)
    areas = rboxes[:, 2] * rboxes[:, 3]
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(order[i])
        if post_max_size is not None and len(keep) >= post_max_size:
            break
        for j in range(i + 1, n):
            if suppressed[j]:
                continue
            inter = geometry.rotated_box_intersection_area(rboxes[i], rboxes[j])
            union = areas[i] + areas[j] - inter
            if union > 0 and inter / union > iou_threshold:
                suppressed[j] = True
    return np.asarray(keep, dtype=np.int64)
