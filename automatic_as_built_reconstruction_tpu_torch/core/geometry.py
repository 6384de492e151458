"""Computational geometry on the host: the exact rotated-box IoU (vertex
enumeration) that the evaluation uses.

The port's copy of the JAX package's ``core/geometry.py``:
``rotated_box_intersection_area``, ``rotate_iou_matrix`` and
``d3_box_overlap``, the separating-axis ``box_collision_test`` of the
per-object noise augmentation and the ground-truth sampler, and the
convex-polyhedron point test the KITTI prep crops scans to the camera's
frustum with.  All NumPy, the same formulas in the same
order, so the results equal the reference's numpy path exactly.  (The
reference's ``d3_box_overlap`` and ``box_collision_test`` take a float32
C++ kernel where its native library built; this copy keeps to the numpy
forms.)
"""
from __future__ import annotations

import numpy as np

from . import box_ops

# ---------------------------------------------------------------------------
# convex polyhedron point tests
# ---------------------------------------------------------------------------


def corner_to_surfaces_3d_jit(corners: np.ndarray) -> np.ndarray:
    """[N,8,3] box corners -> [N,6,4,3] quad surfaces (outward normals).

    Corner order follows :func:`box_ops.corners_nd` 3D ordering.
    """
    idx = np.array([
        [0, 1, 2, 3],  # bottom (z-)
        [7, 6, 5, 4],  # top (z+)
        [0, 3, 7, 4],
        [1, 5, 6, 2],
        [0, 4, 5, 1],
        [3, 2, 6, 7],
    ])
    return corners[:, idx, :]


def surface_equ_3d(surfaces: np.ndarray):
    """[N,S,4,3] planar surfaces -> normals [N,S,3] and d [N,S] (n.x + d = 0)."""
    sv0 = surfaces[:, :, 0, :] - surfaces[:, :, 1, :]
    sv1 = surfaces[:, :, 1, :] - surfaces[:, :, 2, :]
    normal = np.cross(sv0, sv1)
    d = -np.einsum("nsk,nsk->ns", normal, surfaces[:, :, 0, :])
    return normal, d


def points_in_convex_polygon_3d(points: np.ndarray, surfaces: np.ndarray):
    """[P,3] points vs [N,6,4,3] box surfaces -> [P,N] bool."""
    normal, d = surface_equ_3d(surfaces)
    sign = np.einsum("pk,nsk->pns", points, normal) + d[None]
    return (sign <= 1e-6).all(axis=-1)


# ---------------------------------------------------------------------------
# rotated-box IoU — NumPy oracle (vertex enumeration, nms_gpu-style)
# ---------------------------------------------------------------------------


def _box_to_corners(boxes: np.ndarray) -> np.ndarray:
    """[N,5] (x,y,w,l,yaw) -> [N,4,2] CCW corners."""
    return box_ops.center_to_corner_box2d(
        boxes[:, :2], boxes[:, 2:4], boxes[:, 4])


def _segment_intersection(p1, p2, q1, q2):
    """Intersection point of segments p1p2 and q1q2 (or None)."""
    r = p2 - p1
    s = q2 - q1
    denom = r[0] * s[1] - r[1] * s[0]
    if abs(denom) < 1e-12:
        return None
    qp = q1 - p1
    t = (qp[0] * s[1] - qp[1] * s[0]) / denom
    u = (qp[0] * r[1] - qp[1] * r[0]) / denom
    if -1e-9 <= t <= 1 + 1e-9 and -1e-9 <= u <= 1 + 1e-9:
        return p1 + t * r
    return None


def _point_in_quad(pt, quad):
    nxt = np.roll(quad, -1, axis=0)
    edges = nxt - quad
    to_pt = pt[None, :] - quad
    cross = edges[:, 0] * to_pt[:, 1] - edges[:, 1] * to_pt[:, 0]
    return (cross >= -1e-9).all() or (cross <= 1e-9).all()


def _convex_area(pts: np.ndarray) -> float:
    """Area of the convex hull of intersection points (sort by angle)."""
    if len(pts) < 3:
        return 0.0
    pts = np.asarray(pts)
    center = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - center[1], pts[:, 0] - center[0])
    pts = pts[np.argsort(ang)]
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def rotated_box_intersection_area(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Exact intersection area of two (x,y,w,l,yaw) BEV boxes.

    Algorithm (same as the lineage's numba-CUDA devRotateIoU): collect
    corners of A inside B, corners of B inside A, and all edge-edge
    intersection points; the intersection polygon is their convex hull.
    """
    ca = _box_to_corners(box_a[None])[0]
    cb = _box_to_corners(box_b[None])[0]
    pts = []
    for i in range(4):
        if _point_in_quad(ca[i], cb):
            pts.append(ca[i])
        if _point_in_quad(cb[i], ca):
            pts.append(cb[i])
    for i in range(4):
        for j in range(4):
            p = _segment_intersection(ca[i], ca[(i + 1) % 4],
                                      cb[j], cb[(j + 1) % 4])
            if p is not None:
                pts.append(p)
    return _convex_area(pts)


def _may_touch(bev_a: np.ndarray, bev_b: np.ndarray) -> np.ndarray:
    """[N,5] vs [K,5] -> [N,K] bool: False where the boxes' circumscribed
    circles are apart, so that the clip finds no point and the overlap is
    exactly 0 (those pairs skip the clip), and where either box has a
    non-finite value (an untrained box head's ``exp`` of a size residual
    gives infinite sizes: the clip then finds no point either, at several
    times a finite pair's cost; a NaN box, whose overlap the clip makes
    NaN or 0, gets 0, which matches nothing either way).  A finite box
    without area stays True against everything: its quad is degenerate
    and the clip's point tests then count every corner of the other box
    as inside, which the result has to keep."""
    ra = 0.5 * np.hypot(bev_a[:, 2], bev_a[:, 3])
    rb = 0.5 * np.hypot(bev_b[:, 2], bev_b[:, 3])
    dist = np.hypot(bev_a[:, None, 0] - bev_b[None, :, 0],
                    bev_a[:, None, 1] - bev_b[None, :, 1])
    flat_a = ~(bev_a[:, 2] * bev_a[:, 3] > 0)
    flat_b = ~(bev_b[:, 2] * bev_b[:, 3] > 0)
    finite = (np.isfinite(bev_a).all(1)[:, None]
              & np.isfinite(bev_b).all(1)[None, :])
    return finite & (~(dist > ra[:, None] + rb[None, :] + 1e-6)
                     | flat_a[:, None] | flat_b[None, :])


def rotate_iou_matrix(boxes: np.ndarray, query_boxes: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """Rotated IoU between [N,5] and [K,5] BEV boxes -> [N,K].

    criterion: -1 = IoU (union); 0 = intersection/area_a; 1 = inter/area_b.
    (The KITTI eval uses criterion=-1 for BEV/3D overlaps.)
    """
    n, k = len(boxes), len(query_boxes)
    out = np.zeros((n, k), dtype=np.float32)
    area_a = boxes[:, 2] * boxes[:, 3]
    area_b = query_boxes[:, 2] * query_boxes[:, 3]
    near = _may_touch(boxes, query_boxes)
    for i in range(n):
        for j in np.flatnonzero(near[i]):
            inter = rotated_box_intersection_area(boxes[i], query_boxes[j])
            if criterion == -1:
                denom = area_a[i] + area_b[j] - inter
            elif criterion == 0:
                denom = area_a[i]
            else:
                denom = area_b[j]
            out[i, j] = inter / max(denom, 1e-12)
    return out


def d3_box_overlap(boxes, qboxes, criterion: int = -1) -> np.ndarray:
    """3D IoU of [N,7] vs [K,7] lidar boxes: BEV rotated inter x z overlap."""
    n, k = len(boxes), len(qboxes)
    out = np.zeros((n, k), dtype=np.float32)
    bev_a = boxes[:, [0, 1, 3, 4, 6]]
    bev_b = qboxes[:, [0, 1, 3, 4, 6]]
    near = _may_touch(bev_a, bev_b)
    for i in range(n):
        for j in np.flatnonzero(near[i]):
            inter2d = rotated_box_intersection_area(bev_a[i], bev_b[j])
            if inter2d <= 0:
                continue
            za0, za1 = boxes[i, 2], boxes[i, 2] + boxes[i, 5]
            zb0, zb1 = qboxes[j, 2], qboxes[j, 2] + qboxes[j, 5]
            zi = min(za1, zb1) - max(za0, zb0)
            if zi <= 0:
                continue
            inter3d = inter2d * zi
            va = boxes[i, 3] * boxes[i, 4] * boxes[i, 5]
            vb = qboxes[j, 3] * qboxes[j, 4] * qboxes[j, 5]
            if criterion == -1:
                denom = va + vb - inter3d
            elif criterion == 0:
                denom = va
            else:
                denom = vb
            out[i, j] = inter3d / max(denom, 1e-12)
    return out


def box_collision_test(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """[N,5] vs [K,5] BEV boxes -> [N,K] bool overlap (any contact).

    Separating-axis test over both boxes' edge normals — exact for convex
    quads and fully vectorized (the lineage used corner-in-box + segment
    intersection loops), in float64 whatever the inputs' precision.
    """
    ca = _box_to_corners(np.asarray(boxes, np.float64))    # [N,4,2]
    cb = _box_to_corners(np.asarray(qboxes, np.float64))   # [K,4,2]

    def axes_of(c):
        e = np.roll(c, -1, axis=1) - c  # [M,4,2]
        normals = np.stack([-e[..., 1], e[..., 0]], axis=-1)
        return normals  # [M,4,2]

    ax_a = axes_of(ca)
    ax_b = axes_of(cb)
    # SAT: for each pair (i,j) and each of 8 candidate axes, the boxes are
    # disjoint iff some axis separates their projection intervals.
    n, k = len(ca), len(cb)
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=bool)
    # axes: [N,K,8,2] = A's 4 axes broadcast + B's 4 axes broadcast
    axes = np.concatenate([
        np.broadcast_to(ax_a[:, None], (n, k, 4, 2)),
        np.broadcast_to(ax_b[None, :], (n, k, 4, 2)),
    ], axis=2)
    pa = np.einsum("nvd,nkad->nkav", ca, axes)  # [N,K,8,4]
    pb = np.einsum("kvd,nkad->nkav", cb, axes)
    sep = (pa.max(-1) < pb.min(-1) - 1e-12) | (pb.max(-1) < pa.min(-1) - 1e-12)
    return ~sep.any(axis=2)
