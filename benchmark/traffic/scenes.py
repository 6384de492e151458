"""Frozen copies of the scene generators the cells serve, so that a later
change to the program's data code cannot change the traffic.

Copied from the port at commit d2dd0e1912dc5cb39f0a6e878b6e6a71a70c420a:
``data/building.py`` (``generate_building_scene`` with its helpers and
``pad_batch``), ``data/kitti_like.py`` (``make_scene``) and the two numpy
box helpers of ``core/box_ops.py`` they call.  The same seed gives the
same scene bit for bit.
"""
from __future__ import annotations

from typing import List

import numpy as np


def _limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Wrap angle into ``[-offset*period, (1-offset)*period)``."""
    return val - np.floor(val / period + offset) * period


def _rotate_z(points: np.ndarray, angle: float) -> np.ndarray:
    """Rotate [P, 3] points about the z axis by one angle."""
    angles = np.asarray([angle])
    rot_sin, rot_cos = np.sin(angles), np.cos(angles)
    ones, zeros = np.ones_like(rot_cos), np.zeros_like(rot_cos)
    rot_mat_T = np.stack([
        np.stack([rot_cos, rot_sin, zeros], axis=-1),
        np.stack([-rot_sin, rot_cos, zeros], axis=-1),
        np.stack([zeros, zeros, ones], axis=-1),
    ], axis=-2)
    return np.matmul(points[None], rot_mat_T)[0]


WALL_HEIGHT = (2.5, 3.2)
WALL_THICKNESS = (0.1, 0.3)
COLUMN_SIZE = (0.3, 0.7)
DOOR_WIDTH = (0.8, 1.1)
DOOR_HEIGHT = (1.9, 2.2)
DOOR_THICKNESS = (0.04, 0.08)
MAX_WALL_SEGMENT = 2.5


def _sample_box_surface(rng, box, density: float) -> np.ndarray:
    """Sample points on the 4 side faces + top of a box [7] (w,l,h)."""
    x, y, z, w, l, h, yaw = box
    faces = []
    # (u along length, v along height) for each of the two pairs of faces
    for sign in (-1, 1):
        n = max(int(l * h * density), 2)
        u = rng.uniform(-l / 2, l / 2, n)
        v = rng.uniform(0, h, n)
        faces.append(np.stack([np.full(n, sign * w / 2), u, v], axis=1))
        n = max(int(w * h * density), 2)
        u = rng.uniform(-w / 2, w / 2, n)
        v = rng.uniform(0, h, n)
        faces.append(np.stack([u, np.full(n, sign * l / 2), v], axis=1))
    n = max(int(w * l * density / 2), 1)
    faces.append(np.stack([rng.uniform(-w / 2, w / 2, n),
                           rng.uniform(-l / 2, l / 2, n),
                           np.full(n, h)], axis=1))
    local = np.concatenate(faces)
    # local frame: x along w, y along l, z up from bottom
    c, s = np.cos(yaw), np.sin(yaw)
    world = np.stack([
        local[:, 0] * c - local[:, 1] * s + x,
        local[:, 0] * s + local[:, 1] * c + y,
        local[:, 2] + z], axis=1)
    return world


def _wall_with_door(rng, p0, p1, thickness, height, door_prob=0.5):
    """Wall segment p0->p1; possibly split by a door opening.

    Returns (wall boxes, door boxes).  Boxes are [x,y,z,w,l,h,yaw] with the
    wall's *length* along the segment (l = segment length, w = thickness).
    """
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    seg = p1 - p0
    length = float(np.hypot(*seg))
    yaw = float(np.arctan2(seg[1], seg[0]) + np.pi / 2)  # l-axis along seg
    walls, doors = [], []

    def wall_box(a, b):
        """Wall run a->b split into <= MAX_WALL_SEGMENT boxes."""
        ln = float(np.hypot(*(b - a)))
        n_seg = max(int(np.ceil(ln / MAX_WALL_SEGMENT)), 1)
        out = []
        for si in range(n_seg):
            sa = a + (b - a) * (si / n_seg)
            sb = a + (b - a) * ((si + 1) / n_seg)
            mid = (sa + sb) / 2
            out.append([mid[0], mid[1], 0.0, thickness, ln / n_seg,
                        height, yaw])
        return out

    if length > 2.4 and rng.uniform() < door_prob:
        dw = rng.uniform(*DOOR_WIDTH)
        # door position along the segment, leaving >= 0.6 m of wall each side
        t = rng.uniform(0.6 / length, 1 - (0.6 + dw) / length)
        a = p0 + seg * t
        b = a + seg / length * dw
        walls.extend(wall_box(p0, a))
        walls.extend(wall_box(b, p1))
        dmid = (a + b) / 2
        dh = rng.uniform(*DOOR_HEIGHT)
        # door leaf sits in the opening (sometimes ajar)
        leaf_yaw = yaw + (rng.uniform(-np.pi / 3, np.pi / 3)
                          if rng.uniform() < 0.5 else 0.0)
        doors.append([dmid[0], dmid[1], 0.0,
                      rng.uniform(*DOOR_THICKNESS), dw, dh, leaf_yaw])
    else:
        walls.extend(wall_box(p0, p1))
    return walls, doors


def generate_building_scene(seed: int, *,
                            extent: float = 16.0,
                            density: float = 120.0,
                            clutter_ratio: float = 0.15,
                            dropout: float = 0.3,
                            layout_rotation: bool = True) -> dict:
    """One synthetic as-built scan.

    Returns dict(points [P,4] float32, gt_boxes [N,7], gt_names [N] str).
    Scene frame: x,y in [0, extent], floor at z=0.
    """
    rng = np.random.default_rng(seed)
    height = rng.uniform(*WALL_HEIGHT)
    rot = rng.uniform(0, np.pi / 2) if layout_rotation else 0.0

    # floor plan: outer rectangle + 1-3 partition walls
    margin = rng.uniform(1.0, 2.5)
    x0, y0 = margin, margin
    x1 = extent - margin
    y1 = extent - margin
    corners = [np.array([x0, y0]), np.array([x1, y0]),
               np.array([x1, y1]), np.array([x0, y1])]
    wall_boxes: List[list] = []
    door_boxes: List[list] = []
    for i in range(4):
        th = rng.uniform(*WALL_THICKNESS)
        w, d = _wall_with_door(rng, corners[i], corners[(i + 1) % 4], th,
                               height)
        wall_boxes += w
        door_boxes += d
    for _ in range(rng.integers(1, 4)):
        th = rng.uniform(*WALL_THICKNESS)
        if rng.uniform() < 0.5:
            xx = rng.uniform(x0 + 2, x1 - 2)
            w, d = _wall_with_door(rng, (xx, y0), (xx, y1), th, height,
                                   door_prob=0.8)
        else:
            yy = rng.uniform(y0 + 2, y1 - 2)
            w, d = _wall_with_door(rng, (x0, yy), (x1, yy), th, height,
                                   door_prob=0.8)
        wall_boxes += w
        door_boxes += d

    column_boxes = []
    for _ in range(rng.integers(0, 5)):
        cs = rng.uniform(*COLUMN_SIZE)
        column_boxes.append([rng.uniform(x0 + 1, x1 - 1),
                             rng.uniform(y0 + 1, y1 - 1),
                             0.0, cs, cs, height, rng.uniform(0, np.pi / 2)])

    boxes = np.array(wall_boxes + column_boxes + door_boxes, np.float32)
    names = np.array(["wall"] * len(wall_boxes)
                     + ["column"] * len(column_boxes)
                     + ["door"] * len(door_boxes))

    # rotate the whole layout about the scene center
    if rot != 0.0 and len(boxes):
        ctr = np.array([extent / 2, extent / 2, 0.0], np.float32)
        boxes[:, :3] = _rotate_z(
            boxes[:, :3] - ctr, rot) + ctr
        boxes[:, 6] += rot
    # building elements are pi-symmetric: canonicalize yaw to [-pi/2, pi/2)
    if len(boxes):
        boxes[:, 6] = _limit_period(boxes[:, 6], 0.5, np.pi)

    pts = [_sample_box_surface(rng, b, density) for b in boxes]
    # floor + ceiling
    nf = int(extent * extent * density / 18)
    pts.append(np.stack([rng.uniform(0, extent, nf),
                         rng.uniform(0, extent, nf),
                         np.abs(rng.normal(0, 0.01, nf))], axis=1))
    pts.append(np.stack([rng.uniform(0, extent, nf // 2),
                         rng.uniform(0, extent, nf // 2),
                         height + rng.normal(0, 0.01, nf // 2)], axis=1))
    points = np.concatenate(pts)
    # clutter blobs (furniture-ish)
    n_clutter = int(len(points) * clutter_ratio)
    if n_clutter:
        centers = rng.uniform([x0, y0, 0], [x1, y1, 1.2], (8, 3))
        which = rng.integers(0, 8, n_clutter)
        points = np.concatenate([
            points, centers[which] + rng.normal(0, 0.3, (n_clutter, 3))])
    # scanner noise + occlusion dropout
    points += rng.normal(0, 0.008, points.shape)
    keep = rng.uniform(size=len(points)) > dropout * rng.uniform()
    points = points[keep]
    intensity = rng.uniform(0, 1, (len(points), 1))
    points = np.concatenate([points, intensity], axis=1).astype(np.float32)

    return {"points": points, "gt_boxes": boxes.reshape(-1, 7),
            "gt_names": names,
            "metadata": {"scene_id": seed, "extent": extent}}


def pad_batch(scenes) -> tuple:
    """Point clouds -> one padded request: points [B, P, C] (zeros past
    each scan's end) and num_valid [B] int32."""
    clouds = [np.asarray(s["points"] if isinstance(s, dict) else s,
                         np.float32) for s in scenes]
    P = max(len(c) for c in clouds)
    C = clouds[0].shape[1]
    points = np.zeros((len(clouds), P, C), np.float32)
    for b, c in enumerate(clouds):
        points[b, :len(c)] = c
    return points, np.array([len(c) for c in clouds], np.int32)


NUM_POINTS = 18000


def make_scene(seed: int, n_points: int = NUM_POINTS) -> np.ndarray:
    """Structured scan [n_points, 4] float32 (x, y, z, reflectance):
    ground plane + ~40 car-like clusters + clutter, shuffled."""
    r = np.random.default_rng(seed)
    n_ground = int(n_points * 0.55)
    n_clutter = int(n_points * 0.10)
    n_obj = n_points - n_ground - n_clutter
    ground = np.stack([r.uniform(0, 69.1, n_ground),
                       r.uniform(-39.7, 39.7, n_ground),
                       r.normal(-1.73, 0.03, n_ground)], 1)
    n_clusters = 40
    centers = np.stack([r.uniform(5, 65, n_clusters),
                        r.uniform(-35, 35, n_clusters),
                        np.full(n_clusters, -1.0)], 1)
    per = -(-n_obj // n_clusters)
    objs = []
    for c in centers:
        yaw = r.uniform(0, np.pi)
        local = np.stack([r.uniform(-1.9, 1.9, per),
                          r.uniform(-0.8, 0.8, per),
                          r.uniform(-0.7, 0.9, per)], 1)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        objs.append(local @ rot.T + c)
    obj = np.concatenate(objs)[: n_obj]
    clutter = np.stack([r.uniform(0, 69.1, n_clutter),
                        r.uniform(-39.7, 39.7, n_clutter),
                        r.uniform(-1.7, 1.5, n_clutter)], 1)
    xyz = np.concatenate([ground, obj, clutter])[:n_points]
    refl = r.random((xyz.shape[0], 1))
    scan = np.concatenate([xyz, refl], 1).astype(np.float32)
    return scan[r.permutation(scan.shape[0])]
