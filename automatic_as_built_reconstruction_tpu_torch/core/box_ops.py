"""Host box math on NumPy arrays: what serving, evaluation and the
training reader need.

Conventions (SECOND lineage): 3D boxes are ``[x, y, z, w, l, h, yaw]`` in
the LiDAR frame with ``(x, y, z)`` the bottom centre; yaw rotates
counter-clockwise about +z.  BEV boxes are ``[x, y, w, l, yaw]``.  Corner
order from :func:`corners_nd` follows a ring: for 2D ``(-,-), (-,+),
(+,+), (+,-)`` scaled by dims.  Formula for formula the same as the JAX
package's ``core/box_ops.py`` (parity is tested exactly): the numpy
residual encodings the box coders use (``second_box_encode`` /
``_decode``, ``bev_box_encode`` / ``_decode``), the axis-aligned
``iou_2d`` of the nearest-IoU similarity and the gt filters of the
training branch, and the KITTI camera and image functions
(``camera_to_lidar`` ... ``image_bbox_to_camera_frustum``) the KITTI
dataset, its offline prep and the synthetic clone use.
``points_in_rbbox`` runs its numpy arithmetic as torch CPU ops (the same
bits, on every core).  The torch decode ``predict`` runs is in
``ops/box_ops.py``.
"""
from __future__ import annotations

import numpy as np
import torch


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Wrap angle into ``[-offset*period, (1-offset)*period)``."""
    return val - np.floor(val / period + offset) * period


def corners_nd(dims: np.ndarray, origin=0.5) -> np.ndarray:
    """Generate axis-aligned ND box corners from sizes.

    Args:
        dims: [N, ndim] box sizes.
        origin: scalar or [ndim] — fractional position of the box origin
            inside the box (0.5 = center; 0 = min corner).

    Returns:
        [N, 2**ndim, ndim] corners.  2D order: (-,-), (-,+), (+,+), (+,-)
        relative to center when origin=0.5.
    """
    dims = np.asarray(dims)
    ndim = dims.shape[-1]
    # unit-square/cube corners traversed as a ring — (0,0) -> (0,1) ->
    # (1,1) -> (1,0) — so consecutive corners share an edge (polygon-clip
    # and surface code depend on this ordering).  In 3D the ring runs in
    # the last two axes, once per half along the first axis.
    ring = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], dims.dtype)
    if ndim == 2:
        corners_norm = ring
    elif ndim == 3:
        corners_norm = np.concatenate([
            np.concatenate([np.full((4, 1), h, dims.dtype), ring], axis=1)
            for h in (0, 1)])
    else:
        raise ValueError(f"unsupported ndim {ndim}")
    corners_norm = corners_norm - np.asarray(origin, dtype=dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(1, 2**ndim, ndim)


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotate [N, P, 2] point sets counter-clockwise by per-box angles [N]."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    # row-vector convention: p' = p @ R_T with R_T = [[c, s], [-s, c]]
    rot_mat_T = np.stack([
        np.stack([rot_cos, rot_sin], axis=-1),
        np.stack([-rot_sin, rot_cos], axis=-1),
    ], axis=-2)  # [N, 2, 2]
    return np.matmul(points, rot_mat_T)


def rotation_3d_in_axis(points: np.ndarray, angles: np.ndarray, axis: int = 2):
    """Rotate [N, P, 3] point sets about a coordinate axis by angles [N]."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    ones = np.ones_like(rot_cos)
    zeros = np.zeros_like(rot_cos)
    if axis == 2:
        rot_mat_T = np.stack([
            np.stack([rot_cos, rot_sin, zeros], axis=-1),
            np.stack([-rot_sin, rot_cos, zeros], axis=-1),
            np.stack([zeros, zeros, ones], axis=-1),
        ], axis=-2)
    elif axis == 1:
        rot_mat_T = np.stack([
            np.stack([rot_cos, zeros, -rot_sin], axis=-1),
            np.stack([zeros, ones, zeros], axis=-1),
            np.stack([rot_sin, zeros, rot_cos], axis=-1),
        ], axis=-2)
    elif axis == 0:
        rot_mat_T = np.stack([
            np.stack([ones, zeros, zeros], axis=-1),
            np.stack([zeros, rot_cos, rot_sin], axis=-1),
            np.stack([zeros, -rot_sin, rot_cos], axis=-1),
        ], axis=-2)
    else:
        raise ValueError(f"axis must be 0/1/2, got {axis}")
    return np.matmul(points, rot_mat_T)


def rotation_points_single_angle(points: np.ndarray, angle: float, axis: int = 2):
    """Rotate [P, 3] points about an axis by one scalar angle."""
    return rotation_3d_in_axis(points[None], np.asarray([angle]), axis=axis)[0]


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """[N,2] centers + [N,2] dims (+ [N] yaw) -> [N,4,2] BEV corners."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + np.asarray(centers).reshape(-1, 1, 2)


def center_to_corner_box3d(centers, dims, angles=None, origin=(0.5, 0.5, 0.0),
                           axis: int = 2):
    """[N,3] bottom-centers + [N,3] dims (+ [N] yaw) -> [N,8,3] corners."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + np.asarray(centers).reshape(-1, 1, 3)


def corner_to_standup_nd(corners: np.ndarray) -> np.ndarray:
    """[N, K, ndim] corners -> [N, 2*ndim] axis-aligned (min..., max...)."""
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=-1)


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """[N,5] (x,y,w,l,yaw) -> nearest axis-aligned [N,4] (x1,y1,x2,y2).

    Snaps yaw to the nearest multiple of pi/2 by swapping w/l when the box is
    closer to a 90-degree orientation.  Used by NearestIouSimilarity.
    """
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = np.abs(limit_period(rots, 0.5, np.pi))
    cond = (rots_0_pi_div_2 > np.pi / 4)[..., None]
    bboxes_center = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    centers, dims = bboxes_center[:, :2], bboxes_center[:, 2:]
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def second_box_encode(boxes: np.ndarray, anchors: np.ndarray,
                      encode_angle_to_vector: bool = False,
                      smooth_dim: bool = False) -> np.ndarray:
    """Encode gt boxes [N,7] against anchors [N,7] -> residuals.

    Residuals: dx,dy normalized by the anchor BEV diagonal; dz by anchor
    height (after shifting z to box center); sizes log-ratio (or smooth
    ratio-1); yaw as difference or (cos,sin) vector difference.
    """
    xa, ya, za, wa, la, ha, ra = np.split(anchors, 7, axis=-1)
    xg, yg, zg, wg, lg, hg, rg = np.split(boxes, 7, axis=-1)
    diagonal = np.sqrt(la**2 + wa**2)
    zg = zg + hg / 2
    za = za + ha / 2
    xt = (xg - xa) / diagonal
    yt = (yg - ya) / diagonal
    zt = (zg - za) / ha
    if smooth_dim:
        lt = lg / la - 1
        wt = wg / wa - 1
        ht = hg / ha - 1
    else:
        lt = np.log(lg / la)
        wt = np.log(wg / wa)
        ht = np.log(hg / ha)
    if encode_angle_to_vector:
        rgx, rgy = np.cos(rg), np.sin(rg)
        rax, ray = np.cos(ra), np.sin(ra)
        rtx = rgx - rax
        rty = rgy - ray
        return np.concatenate([xt, yt, zt, wt, lt, ht, rtx, rty], axis=-1)
    rt = rg - ra
    return np.concatenate([xt, yt, zt, wt, lt, ht, rt], axis=-1)


def second_box_decode(encodings: np.ndarray, anchors: np.ndarray,
                      encode_angle_to_vector: bool = False,
                      smooth_dim: bool = False) -> np.ndarray:
    """Inverse of :func:`second_box_encode` -> boxes [N,7]."""
    xa, ya, za, wa, la, ha, ra = np.split(anchors, 7, axis=-1)
    if encode_angle_to_vector:
        xt, yt, zt, wt, lt, ht, rtx, rty = np.split(encodings, 8, axis=-1)
    else:
        xt, yt, zt, wt, lt, ht, rt = np.split(encodings, 7, axis=-1)
    diagonal = np.sqrt(la**2 + wa**2)
    za = za + ha / 2
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    if smooth_dim:
        lg = (lt + 1) * la
        wg = (wt + 1) * wa
        hg = (ht + 1) * ha
    else:
        lg = np.exp(lt) * la
        wg = np.exp(wt) * wa
        hg = np.exp(ht) * ha
    if encode_angle_to_vector:
        rax, ray = np.cos(ra), np.sin(ra)
        rg = np.arctan2(rty + ray, rtx + rax)
    else:
        rg = rt + ra
    zg = zg - hg / 2
    return np.concatenate([xg, yg, zg, wg, lg, hg, rg], axis=-1)


def bev_box_encode(boxes: np.ndarray, anchors: np.ndarray,
                   encode_angle_to_vector: bool = False,
                   smooth_dim: bool = False) -> np.ndarray:
    """Encode BEV boxes [N,5] (x,y,w,l,yaw) against BEV anchors [N,5]."""
    xa, ya, wa, la, ra = np.split(anchors, 5, axis=-1)
    xg, yg, wg, lg, rg = np.split(boxes, 5, axis=-1)
    diagonal = np.sqrt(la**2 + wa**2)
    xt = (xg - xa) / diagonal
    yt = (yg - ya) / diagonal
    if smooth_dim:
        lt = lg / la - 1
        wt = wg / wa - 1
    else:
        lt = np.log(lg / la)
        wt = np.log(wg / wa)
    if encode_angle_to_vector:
        rtx = np.cos(rg) - np.cos(ra)
        rty = np.sin(rg) - np.sin(ra)
        return np.concatenate([xt, yt, wt, lt, rtx, rty], axis=-1)
    return np.concatenate([xt, yt, wt, lt, rg - ra], axis=-1)


def bev_box_decode(encodings: np.ndarray, anchors: np.ndarray,
                   encode_angle_to_vector: bool = False,
                   smooth_dim: bool = False) -> np.ndarray:
    xa, ya, wa, la, ra = np.split(anchors, 5, axis=-1)
    if encode_angle_to_vector:
        xt, yt, wt, lt, rtx, rty = np.split(encodings, 6, axis=-1)
    else:
        xt, yt, wt, lt, rt = np.split(encodings, 5, axis=-1)
    diagonal = np.sqrt(la**2 + wa**2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    if smooth_dim:
        lg = (lt + 1) * la
        wg = (wt + 1) * wa
    else:
        lg = np.exp(lt) * la
        wg = np.exp(wt) * wa
    if encode_angle_to_vector:
        rg = np.arctan2(rty + np.sin(ra), rtx + np.cos(ra))
    else:
        rg = rt + ra
    return np.concatenate([xg, yg, wg, lg, rg], axis=-1)


def points_in_rbbox(points: np.ndarray, rbbox: np.ndarray,
                    origin=(0.5, 0.5, 0.0)) -> np.ndarray:
    """Boolean [P, N] membership of points in rotated 3D boxes [N,7].

    Implemented by inverse-transforming points into each box frame (exact and
    fully vectorized), in the precision of its inputs: numpy's promotion
    and the reference's arithmetic, op for op, run as torch CPU ops on
    every core (the same bits as numpy: one rounding an op, no fused
    multiply-add).  ``evaluate``'s point refinement tests a whole scan
    against ~94 yaw hypotheses a detection.
    """
    rbbox = np.atleast_2d(rbbox)
    # shift origin to box center
    origin = np.asarray(origin, dtype=rbbox.dtype)
    true_centers = rbbox[:, :3] + (0.5 - origin) * rbbox[:, 3:6]
    c, s = np.cos(-rbbox[:, 6]), np.sin(-rbbox[:, 6])
    half = rbbox[:, 3:6] / 2
    t = torch.from_numpy
    pts = t(np.ascontiguousarray(np.asarray(points)[:, :3]))
    # local = R(-yaw) @ (p - c)
    d = pts[None, :, :] - t(true_centers)[:, None, :]  # [N, P, 3]
    c, s = t(c)[:, None], t(s)[:, None]
    lx = d[..., 0] * c - d[..., 1] * s
    ly = d[..., 0] * s + d[..., 1] * c
    half = t(half)
    inside = ((lx.abs() <= half[:, 0:1]) & (ly.abs() <= half[:, 1:2])
              & (d[..., 2].abs() <= half[:, 2:3]))
    return inside.T.numpy()  # [P, N]


def _dense_anchor_grid(x_centers, y_centers, z_centers, sizes, rotations,
                       dtype):
    """Broadcast centers x sizes x rotations into [D,H,W,S*R,7].

    Per-location anchor axis is size-major, rotation-minor (lineage order).
    """
    D, H, W = len(z_centers), len(y_centers), len(x_centers)
    rotations = np.asarray(rotations, dtype)
    S, R = sizes.shape[0], len(rotations)
    out = np.empty((D, H, W, S, R, 7), dtype=dtype)
    out[..., 0] = x_centers.reshape(1, 1, W, 1, 1)
    out[..., 1] = y_centers.reshape(1, H, 1, 1, 1)
    out[..., 2] = z_centers.reshape(D, 1, 1, 1, 1)
    out[..., 3:6] = sizes.reshape(1, 1, 1, S, 1, 3)
    out[..., 6] = rotations.reshape(1, 1, 1, 1, R)
    return out.reshape(D, H, W, S * R, 7)


def create_anchors_3d_range(feature_size, anchor_range,
                            sizes=((1.6, 3.9, 1.56),),
                            rotations=(0.0, np.pi / 2), dtype=np.float32):
    """Dense anchor grid by range: centres evenly spaced over
    ``anchor_range`` [x0, y0, z0, x1, y1, z1] (endpoint excluded) for a
    (D, H, W) ``feature_size``.  Returns [D, H, W, S*R, 7]."""
    anchor_range = np.asarray(anchor_range, dtype)
    z_centers = np.linspace(anchor_range[2], anchor_range[5], feature_size[0],
                            endpoint=False, dtype=dtype)
    y_centers = np.linspace(anchor_range[1], anchor_range[4], feature_size[1],
                            endpoint=False, dtype=dtype)
    x_centers = np.linspace(anchor_range[0], anchor_range[3], feature_size[2],
                            endpoint=False, dtype=dtype)
    sizes = np.reshape(np.asarray(sizes, dtype), [-1, 3])
    return _dense_anchor_grid(x_centers, y_centers, z_centers, sizes,
                              rotations, dtype)


def create_anchors_3d_stride(feature_size, sizes=((1.6, 3.9, 1.56),),
                             anchor_strides=(0.4, 0.4, 0.0),
                             anchor_offsets=(0.2, -39.8, -1.78),
                             rotations=(0.0, np.pi / 2), dtype=np.float32):
    """Dense anchor grid by stride/offset. Returns [D,H,W,S*R,7]."""
    x_stride, y_stride, z_stride = anchor_strides
    x_offset, y_offset, z_offset = anchor_offsets
    z_centers = np.arange(feature_size[0], dtype=dtype) * z_stride + z_offset
    y_centers = np.arange(feature_size[1], dtype=dtype) * y_stride + y_offset
    x_centers = np.arange(feature_size[2], dtype=dtype) * x_stride + x_offset
    sizes = np.reshape(np.asarray(sizes, dtype), [-1, 3])
    return _dense_anchor_grid(x_centers, y_centers, z_centers, sizes,
                              rotations, dtype)


def sparse_sum_for_anchors_mask(coors: np.ndarray, shape) -> np.ndarray:
    """Accumulate voxel counts into a dense BEV grid [H, W].

    ``coors`` are voxel coords in (z, y, x) order (lineage convention).
    """
    ret = np.zeros(shape, dtype=np.float32)
    np.add.at(ret, (coors[:, 1], coors[:, 2]), 1.0)
    return ret


def fused_get_anchors_area(dense_map: np.ndarray, anchors_bv: np.ndarray,
                           stride, offset, grid_size) -> np.ndarray:
    """Per-anchor occupied-voxel count via 2D summed-area table.

    Args:
        dense_map: [H, W] BEV voxel-count map.
        anchors_bv: [A, 4] axis-aligned anchor BEV boxes (x1,y1,x2,y2).
        stride: (vx, vy, vz) voxel sizes; offset: (x0, y0, z0) range min.
        grid_size: (Wgrid, Hgrid) BEV grid extents.
    """
    sat = dense_map.cumsum(axis=0).cumsum(axis=1)
    sat = np.pad(sat, ((1, 0), (1, 0)))
    x1 = np.clip(((anchors_bv[:, 0] - offset[0]) / stride[0]).astype(np.int64),
                 0, grid_size[0] - 1)
    y1 = np.clip(((anchors_bv[:, 1] - offset[1]) / stride[1]).astype(np.int64),
                 0, grid_size[1] - 1)
    x2 = np.clip(((anchors_bv[:, 2] - offset[0]) / stride[0]).astype(np.int64),
                 0, grid_size[0] - 1)
    y2 = np.clip(((anchors_bv[:, 3] - offset[1]) / stride[1]).astype(np.int64),
                 0, grid_size[1] - 1)
    # inclusive box sum on the padded SAT
    return (sat[y2 + 1, x2 + 1] - sat[y1, x2 + 1]
            - sat[y2 + 1, x1] + sat[y1, x1])


def iou_2d(boxes: np.ndarray, query_boxes: np.ndarray,
           add1: bool = False) -> np.ndarray:
    """Axis-aligned IoU between [N,4] and [K,4] (x1,y1,x2,y2) -> [N,K]."""
    a = 1.0 if add1 else 0.0
    area_q = (query_boxes[:, 2] - query_boxes[:, 0] + a) * (
        query_boxes[:, 3] - query_boxes[:, 1] + a)
    area_b = (boxes[:, 2] - boxes[:, 0] + a) * (boxes[:, 3] - boxes[:, 1] + a)
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]) + a
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]) + a
    iw = np.clip(iw, 0, None)
    ih = np.clip(ih, 0, None)
    inter = iw * ih
    union = area_b[:, None] + area_q[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


# ---------------------------------------------------------------------------
# camera <-> lidar transforms + image projection (KITTI)
# ---------------------------------------------------------------------------


def camera_to_lidar(points, r_rect, velo2cam):
    """[N,3] cam-frame points -> lidar frame given rectification + extrinsic."""
    points = np.asarray(points)
    n = points.shape[0]
    pts = np.concatenate([points[:, :3], np.ones((n, 1), points.dtype)], axis=1)
    lidar = pts @ np.linalg.inv((r_rect @ velo2cam).T)
    return lidar[:, :3]


def lidar_to_camera(points, r_rect, velo2cam):
    points = np.asarray(points)
    n = points.shape[0]
    pts = np.concatenate([points[:, :3], np.ones((n, 1), points.dtype)], axis=1)
    cam = pts @ (r_rect @ velo2cam).T
    return cam[:, :3]


def box_camera_to_lidar(data, r_rect, velo2cam):
    """KITTI camera boxes [N,7] (x,y,z,l,h,w,ry) -> lidar [N,7] (x,y,z,w,l,h,yaw)."""
    xyz = data[:, 0:3]
    l, h, w = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    r = data[:, 6:7]
    xyz_lidar = camera_to_lidar(xyz, r_rect, velo2cam)
    return np.concatenate([xyz_lidar, w, l, h, -r - np.pi / 2], axis=1)


def box_lidar_to_camera(data, r_rect, velo2cam):
    """Lidar boxes [N,7] (x,y,z,w,l,h,yaw) -> camera [N,7] (x,y,z,l,h,w,ry)."""
    xyz_lidar = data[:, 0:3]
    w, l, h = data[:, 3:4], data[:, 4:5], data[:, 5:6]
    r = data[:, 6:7]
    xyz = lidar_to_camera(xyz_lidar, r_rect, velo2cam)
    return np.concatenate([xyz, l, h, w, -r - np.pi / 2], axis=1)


def project_to_image(points_3d, proj_mat):
    """[N,3] cam points -> [N,2] pixel coords via 3x4 or 4x4 projection."""
    points_3d = np.asarray(points_3d)
    n = points_3d.shape[0]
    pts = np.concatenate([points_3d, np.ones((n, 1), points_3d.dtype)], axis=-1)
    pts2d = pts @ proj_mat.T
    return pts2d[:, :2] / np.maximum(pts2d[:, 2:3], 1e-8)


def center_to_minmax_2d(centers, dims):
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def remove_outside_points(points, r_rect, velo2cam, P2, image_shape):
    """Frustum-crop a velodyne scan to the camera FOV. [ref: create_data]."""
    image_bbox = np.array([0, 0, image_shape[1], image_shape[0]],
                          dtype=P2.dtype)
    frustum = image_bbox_to_camera_frustum(P2, image_bbox)
    frustum = camera_to_lidar(frustum, r_rect, velo2cam)
    from . import geometry  # geometry imports this module
    frustum_surfaces = geometry.corner_to_surfaces_3d_jit(frustum[None, ...])
    indices = geometry.points_in_convex_polygon_3d(points[:, :3], frustum_surfaces)
    return points[indices.reshape(-1)]


def image_bbox_to_camera_frustum(proj, bbox, near=0.001, far=100.0):
    """Camera-frame corners of the viewing frustum through an image rect.

    A rectified pixel (u, v) at depth z satisfies
    ``proj @ [X, 1] = z * [u, v, 1]``, so the camera-frame unprojection
    is simply ``X = M^-1 (z [u, v, 1] - b)`` with ``M`` proj's left 3x3
    block and ``b`` its last column — no intrinsics/rotation split
    needed.  Returns [8, 3]: the four bbox corners (clockwise from the
    top-left) on the near plane, then on the far plane.
    """
    m_inv = np.linalg.inv(proj[:3, :3])
    shift = proj[:3, 3]
    u0, v0, u1, v1 = (np.asarray(bbox, proj.dtype)[i] for i in range(4))
    px = np.array([[u0, v0], [u0, v1], [u1, v1], [u1, v0]], proj.dtype)
    planes = []
    for z in (near, far):
        uvz = np.concatenate(
            [px * z, np.full((4, 1), z, proj.dtype)], axis=1)
        planes.append((uvz - shift) @ m_inv.T)
    return np.concatenate(planes, axis=0)


def filter_gt_box_outside_range(gt_boxes, limit_range):
    """Keep boxes whose BEV center lies inside [x0,y0,x1,y1]."""
    bev = gt_boxes[:, [0, 1]]
    return ((bev >= np.asarray(limit_range[:2])).all(axis=1)
            & (bev <= np.asarray(limit_range[2:])).all(axis=1))


def remove_points_outside_range(points, pc_range):
    mask = ((points[:, 0] >= pc_range[0]) & (points[:, 0] < pc_range[3])
            & (points[:, 1] >= pc_range[1]) & (points[:, 1] < pc_range[4])
            & (points[:, 2] >= pc_range[2]) & (points[:, 2] < pc_range[5]))
    return points[mask]


def remove_points_in_boxes(points, boxes):
    masks = points_in_rbbox(points, boxes)
    return points[np.logical_not(masks.any(-1))]
