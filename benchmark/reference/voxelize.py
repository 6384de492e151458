"""Hard voxelization, written out scan by scan.

A point lies in cell ``floor((p - range_min) / voxel_size)`` (a float32
division), and counts when that cell is inside the grid and the point is
before the scan's ``num_valid``.  Voxels are the occupied cells in
ascending key order, key ``(y * gx + x) * gz + z``; the first
``max_voxels`` of them are kept.  A voxel holds its first ``max_points``
points in the order they came, zeros after.  Coordinates are (z, y, x),
-1 for unused rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Voxels(NamedTuple):
    voxels: torch.Tensor       # [B, V, T, C] float32
    num_points: torch.Tensor   # [B, V] int32
    coords: torch.Tensor       # [B, V, 3] int32 (z, y, x), -1 padding


def grid_size(pc_range, voxel_size) -> np.ndarray:
    """(gx, gy, gz) of a point-cloud range and voxel size."""
    pr = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    return np.round((pr[3:] - pr[:3]) / vs).astype(np.int64)


def voxelize(points: torch.Tensor, num_valid, *, pc_range, voxel_size,
             max_points: int, max_voxels: int,
             point_dtype=torch.float32) -> Voxels:
    """points [B, P, C] float32, num_valid [B] -> :class:`Voxels`.
    ``point_dtype``: the type the cell coordinates are computed in (the
    lower-precision control passes bfloat16)."""
    B, P, C = points.shape
    V, T = int(max_voxels), int(max_points)
    dev = points.device
    gx, gy, gz = (int(g) for g in grid_size(pc_range, voxel_size))
    r0 = torch.tensor(np.asarray(pc_range, np.float32)[:3], device=dev)
    vs = torch.tensor(np.asarray(voxel_size, np.float32), device=dev)
    voxels = torch.zeros((B, V, T, C), dtype=torch.float32, device=dev)
    num_points = torch.zeros((B, V), dtype=torch.int32, device=dev)
    coords = torch.full((B, V, 3), -1, dtype=torch.int32, device=dev)
    for b in range(B):
        p = points[b, :int(num_valid[b])]
        q = p.to(point_dtype)
        cell = torch.floor((q[:, :3] - r0.to(point_dtype))
                           / vs.to(point_dtype)).float()
        inside = torch.isfinite(cell).all(1)
        for axis, g in enumerate((gx, gy, gz)):
            inside &= (cell[:, axis] >= 0) & (cell[:, axis] < g)
        idx = torch.nonzero(inside)[:, 0]
        c = cell[idx].long()
        key = (c[:, 1] * gx + c[:, 0]) * gz + c[:, 2]
        key_sorted, order = torch.sort(key, stable=True)
        cells, first_at, counts = torch.unique_consecutive(
            key_sorted, return_inverse=True, return_counts=True)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(len(key_sorted), device=dev) - start[first_at]
        keep = (first_at < V) & (rank < T)
        vox, slot = first_at[keep], rank[keep]
        voxels[b, vox, slot] = p[idx[order[keep]]].float()
        n = min(len(cells), V)
        num_points[b, :n] = torch.clamp(counts[:n], max=T).int()
        kept = cells[:n]
        coords[b, :n, 0] = (kept % gz).int()
        coords[b, :n, 1] = (kept // (gx * gz)).int()
        coords[b, :n, 2] = ((kept // gz) % gx).int()
    return Voxels(voxels, num_points, coords)
