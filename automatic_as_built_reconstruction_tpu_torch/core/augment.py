"""Point/box augmentation: per-object noise, global rotate/scale/flip/
translate, frustum dropout and point dropping inside gt boxes.

The port's copy of the JAX package's ``core/augment.py``: host NumPy, the
same rng calls in the same order on the same ``np.random.Generator``, so
one seed gives the reference's augmented scan and boxes bit for bit.  The
per-object noise loop is sequential over boxes because each accept /
reject depends on previously accepted noise (same as the reference's numba
kernel).  ``box_ops.points_in_rbbox`` and ``geometry.box_collision_test``
are the numpy forms (the reference takes its C++ kernels for float32
inputs where they built).
"""
from __future__ import annotations

import numpy as np

from . import box_ops, geometry


def _rotate_points_around(points, center, angle):
    """Rotate [P,>=3] points around (cx, cy) by angle (z axis)."""
    c, s = np.cos(angle), np.sin(angle)
    d = points[:, :2] - center[None, :2]
    out = points.copy()
    out[:, 0] = d[:, 0] * c - d[:, 1] * s + center[0]
    out[:, 1] = d[:, 0] * s + d[:, 1] * c + center[1]
    return out


def noise_per_object(gt_boxes: np.ndarray,
                     points: np.ndarray | None = None,
                     valid_mask: np.ndarray | None = None,
                     rotation_perturb=(-np.pi / 4, np.pi / 4),
                     center_noise_std=(1.0, 1.0, 1.0),
                     num_try: int = 100,
                     rng: np.random.Generator | None = None):
    """Independently jitter each gt box (translation + yaw) with collision
    re-check against all other boxes; moves the box's points along with it.

    Mutates and returns (gt_boxes, points).
    [ref: second/core/preprocess.py::noise_per_object_v3_]
    """
    rng = rng or np.random.default_rng()
    n = gt_boxes.shape[0]
    if n == 0:
        return gt_boxes, points
    if valid_mask is None:
        valid_mask = np.ones(n, dtype=bool)
    rotation_perturb = np.asarray(rotation_perturb, np.float64)
    center_noise_std = np.asarray(center_noise_std, np.float64)

    loc_noises = rng.normal(scale=center_noise_std, size=(n, num_try, 3))
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1],
                             size=(n, num_try))

    if points is not None:
        point_masks = box_ops.points_in_rbbox(points, gt_boxes)  # [P, N]

    current = gt_boxes.copy()
    for i in range(n):
        if not valid_mask[i]:
            continue
        others = np.delete(current, i, axis=0)
        # all candidates at once: [num_try, 5] vs [K, 5] collision matrix
        cands = np.broadcast_to(current[i], (num_try, 7)).copy()
        cands[:, :3] += loc_noises[i]
        cands[:, 6] += rot_noises[i]
        if len(others):
            coll = geometry.box_collision_test(
                cands[:, [0, 1, 3, 4, 6]].astype(current.dtype),
                others[:, [0, 1, 3, 4, 6]])
            ok = ~coll.any(axis=1)
            if not ok.any():
                continue
            t = int(np.argmax(ok))
        else:
            t = 0
        loc_n, rot_n, cand = loc_noises[i, t], rot_noises[i, t], cands[t]
        if points is not None:
            sel = point_masks[:, i]
            if sel.any():
                moved = _rotate_points_around(
                    points[sel], current[i, :2], rot_n)
                moved[:, :3] += loc_n
                points[sel] = moved
        current[i] = cand
    gt_boxes[:] = current
    return gt_boxes, points


def global_rotation(gt_boxes, points, rotation=(-np.pi / 4, np.pi / 4),
                    rng: np.random.Generator | None = None):
    """Rotate scene (points + boxes) by one uniform angle about z."""
    rng = rng or np.random.default_rng()
    if isinstance(rotation, (tuple, list, np.ndarray)):
        noise = rng.uniform(rotation[0], rotation[1])
    else:
        noise = rotation
    points[:, :3] = box_ops.rotation_points_single_angle(
        points[:, :3], noise, axis=2)
    gt_boxes[:, :3] = box_ops.rotation_points_single_angle(
        gt_boxes[:, :3], noise, axis=2)
    gt_boxes[:, 6] += noise
    return gt_boxes, points, noise


def global_scaling(gt_boxes, points, scale_range=(0.95, 1.05),
                   rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    scale = rng.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    return gt_boxes, points, scale


def random_flip(gt_boxes, points, probability: float = 0.5,
                flip_x: bool = False, flip_y: bool = True,
                rng: np.random.Generator | None = None):
    """Flip across the x axis (negate y; the KITTI-standard flip) and/or
    the y axis (negate x)."""
    rng = rng or np.random.default_rng()
    flipped = []
    if flip_y and rng.uniform() < probability:
        points[:, 1] = -points[:, 1]
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        flipped.append("y")
    if flip_x and rng.uniform() < probability:
        points[:, 0] = -points[:, 0]
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        flipped.append("x")
    return gt_boxes, points, flipped


def global_translate(gt_boxes, points, noise_std=(0.0, 0.0, 0.0),
                     rng: np.random.Generator | None = None):
    rng = rng or np.random.default_rng()
    noise_std = np.asarray(noise_std, np.float64)
    if not (noise_std > 0).any():
        return gt_boxes, points
    t = rng.normal(scale=noise_std, size=3)
    points[:, :3] += t
    gt_boxes[:, :3] += t
    return gt_boxes, points


def frustum_dropout(points, probability: float = 0.5,
                    azimuth_width: float = np.pi / 12,
                    max_range_fraction: float = 1.0,
                    rng: np.random.Generator | None = None):
    """Drop every point inside a random azimuth frustum (sensor-occlusion
    augmentation).

    With ``probability``, picks a random azimuth wedge of ``azimuth_width``
    radians (and optionally only beyond a random range fraction) and
    removes its points — simulating an occluder between the scanner and
    the scene.  [ref: SURVEY.md §2.1 augmentation row (frustum dropout)]
    """
    rng = rng or np.random.default_rng()
    if rng.uniform() >= probability or len(points) == 0:
        return points
    az = np.arctan2(points[:, 1], points[:, 0])
    a0 = rng.uniform(-np.pi, np.pi)
    # wrapped wedge membership
    d = np.mod(az - a0 + np.pi, 2 * np.pi) - np.pi
    in_wedge = np.abs(d) < azimuth_width / 2
    if max_range_fraction < 1.0:
        r = np.linalg.norm(points[:, :2], axis=1)
        rmax = r.max() if len(r) else 0.0
        r0 = rng.uniform(0, max_range_fraction) * rmax
        in_wedge &= r >= r0
    return points[~in_wedge]


def drop_points_in_gt(points, gt_boxes,
                      drop_percentage: float,
                      max_keep_points: int,
                      rng: np.random.Generator | None = None):
    """Sparsify points inside a random subset of gt boxes.

    ``drop_percentage`` of the gt boxes are chosen; each keeps at most
    ``max_keep_points`` of its points (uniformly subsampled).  Mirrors the
    reference's ``groundtruth_points_drop_percentage`` /
    ``groundtruth_drop_max_keep_points`` fields [ref:
    second/protos/preprocess.proto — lineage-expected, UNVERIFIED].
    """
    rng = rng or np.random.default_rng()
    if drop_percentage <= 0 or len(gt_boxes) == 0 or len(points) == 0:
        return points
    chosen = rng.uniform(size=len(gt_boxes)) < drop_percentage
    if not chosen.any():
        return points
    membership = box_ops.points_in_rbbox(points, gt_boxes[chosen])
    drop = np.zeros(len(points), bool)
    for j in range(membership.shape[1]):
        idx = np.flatnonzero(membership[:, j])
        if len(idx) > max_keep_points:
            kill = rng.choice(idx, size=len(idx) - max_keep_points,
                              replace=False)
            drop[kill] = True
    return points[~drop]
