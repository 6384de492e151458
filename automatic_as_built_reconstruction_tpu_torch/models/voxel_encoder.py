"""Voxel feature encoders (VFE stage), the port of the JAX package's
``models/voxel_encoder.py``: ``SimpleVoxel`` (the mean of a voxel's
points, what SECOND runs), ``SimpleVoxelRadius`` (that mean with the BEV
position folded to a radius) and the VoxelNet paper's encoders
``VoxelFeatureExtractor`` (stacked VFE layers, a last Linear + BN + ReLU
and a max over the points) and ``VoxelFeatureExtractorV2`` (the last VFE
layer's Linear + BN + ReLU pools directly).

A VFE layer is the pillar net's ``PFNLayer`` with half the output
channels: Linear (no bias), BatchNorm over every ``[B, V, T]`` row
(padded points and empty voxels included: the mask multiplies only after
the ReLU), the mask, then each point's features concatenated with their
max over the voxel.  Module names follow the lineage torch net
(``vfe{i}.linear`` / ``.norm`` from 1, the trailing ``linear`` / ``norm``),
the names ``utils/weight_import.py`` emits.  These encoders compute in
float32 (float64 stays float64) whatever the model's ``compute_dtype``,
as the JAX modules, which take no ``dtype``.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .pointpillars import (BN_EPS, BN_MOMENTUM, FlaxBatchNorm1d, Linear,
                           PFNLayer, points_mask)

__all__ = ["points_mask", "SimpleVoxel", "SimpleVoxelRadius",
           "VoxelFeatureExtractor", "VoxelFeatureExtractorV2"]


def _voxel_mean(voxels: torch.Tensor, num_points: torch.Tensor,
                channels: int) -> torch.Tensor:
    """The mean of each voxel's points over its first ``channels``
    channels, [B, V, T, C] -> [B, V, channels]."""
    mask = points_mask(num_points, voxels.shape[2], voxels.dtype)
    pts = voxels[..., :channels] * mask
    denom = torch.clamp_min(num_points[..., None], 1).to(voxels.dtype)
    return pts.sum(dim=2) / denom


class SimpleVoxel(nn.Module):
    """Mean-of-points VFE: the mean of each voxel's points over its first
    ``num_input_features`` channels, [B, V, T, C] -> [B, V, C'].  No
    parameters."""

    def __init__(self, num_input_features: int = 4):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords=None) -> torch.Tensor:
        return _voxel_mean(voxels, num_points, self.num_input_features)


class SimpleVoxelRadius(SimpleVoxel):
    """:class:`SimpleVoxel` with the BEV position folded to a radius:
    [sqrt(mean_x^2 + mean_y^2), mean_z, mean_extra...], one channel fewer
    than its input's.  No parameters."""

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords=None) -> torch.Tensor:
        mean = _voxel_mean(voxels, num_points, self.num_input_features)
        radius = torch.linalg.vector_norm(mean[..., :2], dim=-1,
                                          keepdim=True)
        return torch.cat([radius, mean[..., 2:]], dim=-1)


class VoxelFeatureExtractor(nn.Module):
    """Stacked VFE layers + a last Linear + BN + ReLU + max over the points
    (the VoxelNet paper's encoder), [B, V, T, C] -> [B, V, F].

    The decorated input is every voxel channel plus the offsets of each
    point from its voxel's mean (``xyz - mean * mask``), and its norm
    ``|xyz|`` with ``with_distance``.  Empty voxels give 0.
    ``last_vfe=False`` (:class:`VoxelFeatureExtractorV2`) drops the last
    VFE layer: the last filter count is the trailing Linear's."""

    last_vfe = True

    def __init__(self, num_input_features: int = 4,
                 num_filters: Sequence[int] = (32, 128),
                 with_distance: bool = False):
        super().__init__()
        self.with_distance = with_distance
        in_ch = num_input_features + 3 + int(with_distance)
        stack = num_filters if self.last_vfe else num_filters[:-1]
        for i, nf in enumerate(stack):
            setattr(self, f"vfe{i + 1}", PFNLayer(in_ch, nf // 2,
                                                  last_layer=False))
            in_ch = nf // 2 * 2
        self.num_vfe = len(stack)
        self.linear = Linear(in_ch, num_filters[-1], bias=False)
        self.norm = FlaxBatchNorm1d(num_filters[-1], eps=BN_EPS,
                                    momentum=BN_MOMENTUM)

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords=None) -> torch.Tensor:
        B, V, T, C = voxels.shape
        mask = points_mask(num_points, T, voxels.dtype)
        denom = torch.clamp_min(num_points[..., None, None], 1).to(
            voxels.dtype)
        points_mean = (voxels[..., :3] * mask).sum(2, keepdim=True) / denom
        features = [voxels, voxels[..., :3] - points_mean * mask]
        if self.with_distance:
            features.append(torch.linalg.vector_norm(
                voxels[..., :3], dim=-1, keepdim=True))
        x = torch.cat(features, dim=-1) * mask
        for i in range(self.num_vfe):
            x = getattr(self, f"vfe{i + 1}")(x, mask) * mask
        x = self.linear(x)
        shape = x.shape
        x = torch.relu(self.norm(x.reshape(-1, shape[-1])).reshape(shape))
        x = torch.where(mask > 0, x, -torch.inf)
        x = torch.amax(x, dim=2)
        # fully empty voxels (padding) -> 0
        return torch.where(torch.isfinite(x), x,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class VoxelFeatureExtractorV2(VoxelFeatureExtractor):
    """VFE layers whose LAST layer pools directly: no VFE layer of the last
    filter count, only its Linear + BN + ReLU and the max."""

    last_vfe = False
