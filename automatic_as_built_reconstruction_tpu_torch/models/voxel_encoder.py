"""Voxel feature encoders (VFE stage): the helpers the pillar VFE shares
and ``SimpleVoxel``, the mean-of-points encoder SECOND runs.
``SimpleVoxelRadius`` and the ``VoxelFeatureExtractor`` variants of the JAX
package's ``models/voxel_encoder.py`` are not ported."""
from __future__ import annotations

import torch
from torch import nn


def points_mask(num_points: torch.Tensor, max_points: int,
                dtype=torch.float32) -> torch.Tensor:
    """[B, V] counts -> [B, V, T, 1] validity mask."""
    ids = torch.arange(max_points, device=num_points.device)
    return (ids[None, None, :] < num_points[..., None]).to(dtype)[..., None]


class SimpleVoxel(nn.Module):
    """Mean-of-points VFE: the mean of each voxel's points over its first
    ``num_input_features`` channels, [B, V, T, C] -> [B, V, C'].  No
    parameters."""

    def __init__(self, num_input_features: int = 4):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords=None) -> torch.Tensor:
        mask = points_mask(num_points, voxels.shape[2], voxels.dtype)
        pts = voxels[..., : self.num_input_features] * mask
        denom = torch.clamp_min(num_points[..., None], 1).to(voxels.dtype)
        return pts.sum(dim=2) / denom
