"""Point-sharded mean canvas for whole-building scans.

The port of the JAX package's ``parallel/sharded_voxelize.py``: the
point buffer is split shard-major over the ranks; each rank scatter-adds
its own shard into per-cell sums and counts (``index_add_``, as the
reference computes this step in XLA), one ``all_reduce`` merges the
shards, and every rank ends with the whole mean-feature canvas.  The
sums are float32 in another order than one device's: the means agree to
rounding, the counts exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh


def _local_accumulate(points: torch.Tensor, num_valid, *, voxel_size,
                      pc_range, grid_hw, num_features: int) -> torch.Tensor:
    """[Pl, C] shard -> [H*W, F + 1]: each cell's feature sums, then its
    point count."""
    H, W = grid_hw
    col = torch.floor((points[:, 0] - pc_range[0]) / voxel_size[0]
                      ).to(torch.int64)
    row = torch.floor((points[:, 1] - pc_range[1]) / voxel_size[1]
                      ).to(torch.int64)
    z = points[:, 2]
    ok = ((col >= 0) & (col < W) & (row >= 0) & (row < H)
          & (z >= pc_range[2]) & (z < pc_range[5])
          & (torch.arange(points.shape[0], device=points.device)
             < num_valid))
    lin = torch.where(ok, row * W + col, H * W)
    vals = torch.cat([torch.where(ok[:, None],
                                  points[:, :num_features].float(), 0.0),
                      ok[:, None].float()], dim=1)
    acc = torch.zeros(H * W + 1, num_features + 1, dtype=torch.float32,
                      device=points.device)
    acc.index_add_(0, lin, vals)
    return acc[:H * W]


def _mean_canvas(acc: torch.Tensor, grid_hw, num_features: int):
    H, W = grid_hw
    counts = acc[:, num_features]
    mean = acc[:, :num_features] / torch.clamp_min(counts[:, None], 1.0)
    return mean.reshape(H, W, num_features), counts.reshape(H, W)


def make_sharded_mean_canvas(mesh: Mesh, *, voxel_size, pc_range,
                             grid_hw: Tuple[int, int],
                             num_features: int = 4):
    """-> ``fn(points [Ptot, C], num_valid_per_shard [D])`` -> (mean canvas
    [H, W, F], counts [H, W]) on this rank's device, the same on every
    rank.

    ``points`` rows are laid out shard-major, as every rank sees the
    buffer: rank d owns rows ``[d*Pl, (d+1)*Pl)`` with ``Pl = Ptot / D``,
    and ``num_valid_per_shard[d]`` masks that shard's tail."""
    def fn(points, num_valid_per_shard):
        total = points.shape[0]
        if total % mesh.size:
            raise ValueError(f"{total} points not divisible by "
                             f"{mesh.size} shards")
        per = total // mesh.size
        mine = torch.as_tensor(points[mesh.rank * per:(mesh.rank + 1) * per],
                               device=mesh.device)
        acc = _local_accumulate(
            mine, int(num_valid_per_shard[mesh.rank]),
            voxel_size=voxel_size, pc_range=pc_range, grid_hw=grid_hw,
            num_features=num_features)
        dist.all_reduce(acc, group=mesh.group)     # the shards merged
        return _mean_canvas(acc, grid_hw, num_features)

    return fn


def single_device_mean_canvas(points: torch.Tensor, num_valid, *,
                              voxel_size, pc_range, grid_hw,
                              num_features: int = 4):
    """The unsharded oracle, on ``points``' device."""
    acc = _local_accumulate(points, num_valid, voxel_size=voxel_size,
                            pc_range=pc_range, grid_hw=grid_hw,
                            num_features=num_features)
    return _mean_canvas(acc, grid_hw, num_features)
