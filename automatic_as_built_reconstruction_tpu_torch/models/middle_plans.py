"""Exact per-variant layer plans for the lineage sparse middle extractors.

Each lineage ``SpMiddle*`` name maps to an explicit sequence of
:class:`~..ops.sparse_conv.BlockSpec` — submanifold-conv counts, channel
schedule, strided-conv kernel/stride/padding — reproducing the reference
stacks layer for layer, so a lineage config builds a
weight-for-weight-equivalent network instead of a heuristic-planned one.

The port's copy of the JAX package's ``models/middle_plans.py`` (pure
Python; the plans encode the publicly known second.pytorch
architectures).

Conventions shared with the reference:

- The sparse grid is the voxel grid with **one extra z cell**
  (``sparse_shape = grid_size[::-1] + [1, 0, 0]``) — hence ``Z_PAD = 1``
  for every plan here; voxel z coords 0..D-1 stay valid in depth D+1.
- Submanifold convs are always 3x3x3 (``SubMConv3d(..., 3)``); only the
  strided ``SpConv3d`` kernels vary (the final z-collapse uses (3,1,1)).
- For KITTI-FHD geometry (0.05 m voxels, z range -3..1 -> D=40, padded
  41) the FHD plan walks depths 41 -> 21 -> 11 -> 5 -> 2 and the BEV
  output is ``2 * 64 = 128`` channels at (H/8, W/8).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..ops.sparse_conv import BlockSpec, _out_grid

Z_PAD = 1   # lineage sparse_shape adds one z cell

_K3 = (3, 3, 3)
_KZ = (3, 1, 1)   # z-only collapse kernel
_S2 = (2, 2, 2)
_SZ = (2, 1, 1)

# SpMiddleFHD: 2xSubM(16) -> SpConv(32, s2) -> 2xSubM(32) -> SpConv(64, s2)
# -> 3xSubM(64) -> SpConv(64, s2, pad z0) -> 3xSubM(64) -> SpConv(64, z-only)
_FHD = (
    BlockSpec(2, 16, 32, _K3, _S2, (1, 1, 1)),
    BlockSpec(2, 32, 64, _K3, _S2, (1, 1, 1)),
    BlockSpec(3, 64, 64, _K3, _S2, (0, 1, 1)),
    BlockSpec(3, 64, 64, _KZ, _SZ, (0, 0, 0)),
)

# SpMiddleFHDLite: the four strided convs only, no submanifold layers
_FHD_LITE = (
    BlockSpec(0, 0, 32, _K3, _S2, (1, 1, 1)),
    BlockSpec(0, 0, 64, _K3, _S2, (1, 1, 1)),
    BlockSpec(0, 0, 64, _K3, _S2, (0, 1, 1)),
    BlockSpec(0, 0, 64, _KZ, _SZ, (0, 0, 0)),
)

# SpMiddleD4HD: xy downsampled 4x (two strided blocks), then two z-only
# collapses 11 -> 5 -> 2 with submanifold stacks between
_D4HD = (
    BlockSpec(2, 16, 32, _K3, _S2, (1, 1, 1)),
    BlockSpec(2, 32, 64, _K3, _S2, (1, 1, 1)),
    BlockSpec(3, 64, 64, _KZ, _SZ, (0, 0, 0)),
    BlockSpec(3, 64, 64, _KZ, _SZ, (0, 0, 0)),
)

_D4HD_LITE = (
    BlockSpec(0, 0, 32, _K3, _S2, (1, 1, 1)),
    BlockSpec(0, 0, 64, _K3, _S2, (1, 1, 1)),
    BlockSpec(0, 0, 64, _KZ, _SZ, (0, 0, 0)),
    BlockSpec(0, 0, 64, _KZ, _SZ, (0, 0, 0)),
)

# SpMiddle2K: one extra 8->16 block on the 2x-finer grid (depth 81),
# then the FHD stack
_2K = (BlockSpec(2, 8, 16, _K3, _S2, (1, 1, 1)),) + _FHD

MIDDLE_PLANS = {
    "SpMiddleFHD": _FHD,
    "SpMiddleFHDV2": _FHD,
    "SpMiddleD8HD": _FHD,        # D8 == FHD's xy/8 plan
    "SpMiddleFHDLite": _FHD_LITE,
    "SpMiddleD4HD": _D4HD,
    "SpMiddleD4HDLite": _D4HD_LITE,
    "SpMiddle2K": _2K,
    "SpMiddle2KMerged": _2K,
}


def plan_fits(specs: Tuple[BlockSpec, ...],
              grid_dhw: Tuple[int, int, int]) -> bool:
    """True if every block of the plan yields a non-empty output grid."""
    grid = tuple(int(g) for g in grid_dhw)
    for s in specs:
        grid = _out_grid(grid, s.pad, s.kernel, s.stride)
        if any(g < 1 for g in grid):
            return False
    return True


def lookup(name: str, grid_dhw: Tuple[int, int, int]
           ) -> Optional[Tuple[BlockSpec, ...]]:
    """The exact lineage plan for ``name`` if one exists AND the
    (z-padded) grid is deep enough for it; None -> caller falls back to
    the parameterized heuristic (tiny test grids)."""
    specs = MIDDLE_PLANS.get(name)
    if specs is None:
        return None
    padded = (grid_dhw[0] + Z_PAD, grid_dhw[1], grid_dhw[2])
    if not plan_fits(specs, padded):
        return None
    return specs


def xy_downsample(specs: Tuple[BlockSpec, ...]) -> int:
    f = 1
    for s in specs:
        f *= s.stride[1]
    return f


def bev_channels(specs: Tuple[BlockSpec, ...],
                 grid_dhw: Tuple[int, int, int]) -> int:
    """Final BEV channel count = last down_cout * remaining depth."""
    grid = (grid_dhw[0] + Z_PAD, grid_dhw[1], grid_dhw[2])
    for s in specs:
        grid = _out_grid(grid, s.pad, s.kernel, s.stride)
    return specs[-1].down_cout * grid[0]
