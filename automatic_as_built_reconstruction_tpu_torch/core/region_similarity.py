"""Anchor-to-GT similarity functions for target assignment.

The port's copy of the JAX package's ``core/region_similarity.py``
(numpy, the same formulas).  The rotated-IoU similarity uses the port's
host rotated IoU (``core/geometry.py::rotate_iou_matrix``, the numpy
vertex enumeration the reference's function is).
"""
from __future__ import annotations

import numpy as np

from . import box_ops, geometry


class RegionSimilarityCalculator:
    def compare(self, boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class RotateIouSimilarity(RegionSimilarityCalculator):
    """Exact rotated-BEV IoU between [N,5] and [K,5] (x,y,w,l,yaw)."""

    def compare(self, boxes1, boxes2):
        return geometry.rotate_iou_matrix(boxes1, boxes2)


class NearestIouSimilarity(RegionSimilarityCalculator):
    """IoU of nearest axis-aligned (yaw-snapped) boxes — the fast default."""

    def compare(self, boxes1, boxes2):
        boxes1_bv = box_ops.rbbox2d_to_near_bbox(boxes1)
        boxes2_bv = box_ops.rbbox2d_to_near_bbox(boxes2)
        return box_ops.iou_2d(boxes1_bv, boxes2_bv)


class DistanceSimilarity(RegionSimilarityCalculator):
    """Negative normalized center distance (optionally yaw-aware)."""

    def __init__(self, distance_norm: float, with_rotation: bool = False,
                 rotation_alpha: float = 0.5):
        self._distance_norm = distance_norm
        self._with_rotation = with_rotation
        self._rotation_alpha = rotation_alpha

    def compare(self, boxes1, boxes2):
        d = np.linalg.norm(
            boxes1[:, None, :2] - boxes2[None, :, :2], axis=-1)
        dist = 1.0 - d / self._distance_norm
        if self._with_rotation:
            rot_diff = np.cos(boxes1[:, None, -1] - boxes2[None, :, -1])
            a = self._rotation_alpha
            dist = a * dist + (1 - a) * (rot_diff * 0.5 + 0.5)
        return dist
