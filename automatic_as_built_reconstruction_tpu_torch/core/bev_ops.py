"""BEV rasterization: point clouds -> occupancy / height / intensity maps.

The port's copy of the JAX package's ``core/bev_ops.py``
(``points_to_bev``), in numpy; the same points give the same maps bit for
bit.
"""
from __future__ import annotations

import numpy as np


def points_to_bev(points: np.ndarray, voxel_size, coors_range,
                  with_intensity: bool = True) -> np.ndarray:
    """[P, >=3] points -> BEV maps [n_height + 1 (+1), H, W].

    Channels: per-z-slab max-height maps, then a density channel, then
    (optionally) a max-intensity channel.
    """
    voxel_size = np.asarray(voxel_size, np.float64)
    coors_range = np.asarray(coors_range, np.float64)
    grid = np.round((coors_range[3:] - coors_range[:3]) / voxel_size
                    ).astype(np.int64)
    gx, gy, gz = int(grid[0]), int(grid[1]), int(grid[2])

    c = np.floor((points[:, :3] - coors_range[:3]) / voxel_size).astype(
        np.int64)
    ok = ((c >= 0) & (c < grid[None, :])).all(axis=1)
    c = c[ok]
    pts = points[ok]

    n_ch = gz + 1 + (1 if with_intensity and points.shape[1] > 3 else 0)
    bev = np.zeros((n_ch, gy, gx), np.float32)
    # per-slab max height (normalized within slab)
    z_rel = (pts[:, 2] - coors_range[2]) / voxel_size[2] - c[:, 2]
    np.maximum.at(bev, (c[:, 2], c[:, 1], c[:, 0]), z_rel.astype(np.float32))
    # density: log-normalized counts
    counts = np.zeros((gy, gx), np.float32)
    np.add.at(counts, (c[:, 1], c[:, 0]), 1.0)
    bev[gz] = np.minimum(np.log1p(counts) / np.log(64.0), 1.0)
    if n_ch > gz + 1:
        np.maximum.at(bev, (np.full(len(c), gz + 1), c[:, 1], c[:, 0]),
                      pts[:, 3].astype(np.float32))
    return bev
