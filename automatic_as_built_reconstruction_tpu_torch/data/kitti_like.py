"""Synthetic KITTI-like lidar scans for the SECOND serving path.

The port's copy of the structured scan the JAX package's benchmark serves
(``bench.py::make_scene``): a ground plane, about 40 car-sized clusters
and clutter inside the KITTI car range ``[0, -40, -3, 70.4, 40, 1]``,
from a numpy seed.  The same seed gives the same scan bit for bit.
"""
from __future__ import annotations

import numpy as np

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
