"""The hand-written kernels as registered operators, namespace ``abr``.

Every kernel launch that a served request makes is one
``torch.library.custom_op`` here, with three implementations:

- ``"cpu"``: the kernel's plain PyTorch version;
- ``"cuda"``: the kernel's launch (its wrapper module's ``_*_cuda``
  function: the checks that read addresses, the launch, the
  ``cudaError`` check and the wrapper's ``.launches`` count).  It never
  falls back to the plain version: a build or launch failure raises;
- a fake (``register_fake``) that gives the outputs' shapes and types
  from the inputs' alone, so that ``torch.export`` traces through the op
  without running it.

The wrappers (``ops/pillar_scatter.py``, ``rotated_iou.py``,
``sparse_gather_gemm.py``, ``voxel_mean.py``) call these ops on either
device: the op's per-device dispatch takes the place of an ``is_cuda``
branch, so that a program exported on the CPU holds the same ops as one
exported on the card, and a loaded ``torch.export`` artifact launches the
kernels and counts them on the same counters.  The backward kernels
(``csrc/sparse_join_grad.cu``, K1's gather) stay behind the wrappers'
``autograd.Function``s, which call these forward ops.

Importing this module registers the ops and imports nothing else of the
package: each implementation imports its wrapper module when it is first
called (a loaded serving artifact needs this module and ``ops/`` only).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import Tensor
from torch.library import custom_op

def _ops(name: str):
    """The wrapper module ``ops/<name>.py`` (imported at first use)."""
    import importlib

    return importlib.import_module(f"{__package__}.{name}")


def _float_out(dtype: torch.dtype) -> torch.dtype:
    """The joins' output type: float32, float64 for float64 inputs."""
    return torch.promote_types(dtype, torch.float32)


# ---- K1: pillar scatter (both routes of scatter_plan) ----------------------

@custom_op("abr::pillar_scatter", mutates_args=(), device_types="cpu")
def pillar_scatter(feats: Tensor, lin: Tensor, hw: int) -> Tensor:
    """[B, V, C] rows + cell ids [B, V] -> canvas [B, hw, C]."""
    return _ops("pillar_scatter").scatter_sorted_to_canvas_plain(
        feats, lin, hw).contiguous()


@pillar_scatter.register_kernel("cuda")
def _(feats, lin, hw):
    return _ops("pillar_scatter")._scatter_cuda(feats, lin, hw)


@pillar_scatter.register_fake
def _(feats, lin, hw):
    B, _, C = feats.shape
    return feats.new_empty((B, hw, C))


# ---- K2: rotated IoU -------------------------------------------------------

@custom_op("abr::rotated_iou", mutates_args=(), device_types="cpu")
def rotated_iou(boxes: Tensor, qboxes: Tensor, criterion: int) -> Tensor:
    """[R, N, 5] x [R, K, 5] -> [R, N, K] float32."""
    return _ops("rotated_iou").rotate_iou_matrix_plain(boxes, qboxes,
                                                       criterion)


@rotated_iou.register_kernel("cuda")
def _(boxes, qboxes, criterion):
    return _ops("rotated_iou")._rotated_iou_cuda(boxes, qboxes, criterion)


@rotated_iou.register_fake
def _(boxes, qboxes, criterion):
    return boxes.new_empty((boxes.shape[0], boxes.shape[1], qboxes.shape[1]),
                           dtype=torch.float32)


# ---- K3 / K3s: gather-GEMM (float32 and bfloat16) --------------------------

@custom_op("abr::gather_gemm", mutates_args=(), device_types="cpu")
def gather_gemm(features: Tensor, gather_idx: Tensor, found: Tensor,
                weights: Tensor) -> Tensor:
    """features [(B,) N, Cin] x rulebook [(B,) K, R] x [K, Cin, Cout] ->
    [(B,) R, Cout]."""
    return _ops("sparse_gather_gemm").gather_gemm_plain(
        features, gather_idx, found, weights)


@gather_gemm.register_kernel("cuda")
def _(features, gather_idx, found, weights):
    return _ops("sparse_gather_gemm")._gather_cuda(features, gather_idx,
                                                   found, weights)


@gather_gemm.register_fake
def _(features, gather_idx, found, weights):
    shape = (*features.shape[:-2], gather_idx.shape[-1], weights.shape[-1])
    return features.new_empty(shape, dtype=_float_out(features.dtype))


# ---- K4 (every form): key-match GEMM (float32 and bfloat16) ----------------

@custom_op("abr::keymatch_gemm", mutates_args=(), device_types="cpu")
def keymatch_gemm(features: Tensor, in_keys: Tensor, q_keys: Tensor,
                  weights: Tensor) -> Tensor:
    """features [(B,) N, Cin] x keys [(B,) N] x query keys [(B,) K, M] x
    [K, Cin, Cout] -> [(B,) M, Cout]."""
    return _ops("sparse_gather_gemm").keymatch_gemm_plain(
        features, in_keys, q_keys, weights)


@keymatch_gemm.register_kernel("cuda")
def _(features, in_keys, q_keys, weights):
    return _ops("sparse_gather_gemm")._keymatch_cuda(features, in_keys,
                                                     q_keys, weights)


@keymatch_gemm.register_fake
def _(features, in_keys, q_keys, weights):
    shape = (*features.shape[:-2], q_keys.shape[-1], weights.shape[-1])
    return features.new_empty(shape, dtype=_float_out(features.dtype))


# ---- K5: fused voxelize + mean --------------------------------------------

@custom_op("abr::point_keys", mutates_args=(), device_types="cpu")
def point_keys(points: Tensor, num_valid: Tensor, voxel_size: List[float],
               pc_range: List[float], grid_size: List[int]) -> Tensor:
    """points [B, P, C] + num_valid [B] -> packed int64 keys [B, P]."""
    return _ops("voxel_mean").point_keys_plain(
        points, num_valid, voxel_size=voxel_size, pc_range=pc_range,
        grid_size=grid_size)


@point_keys.register_kernel("cuda")
def _(points, num_valid, voxel_size, pc_range, grid_size):
    return _ops("voxel_mean")._point_keys_cuda(
        points, num_valid, voxel_size, pc_range, grid_size, None, None)


@point_keys.register_fake
def _(points, num_valid, voxel_size, pc_range, grid_size):
    return points.new_empty(points.shape[:2], dtype=torch.int64)


@custom_op("abr::point_keys_fill",
           mutates_args=("features", "coords", "num_points", "num_voxels",
                         "tile_state"), device_types="cpu")
def point_keys_fill(points: Tensor, num_valid: Tensor,
                    voxel_size: List[float], pc_range: List[float],
                    grid_size: List[int], features: Tensor, coords: Tensor,
                    num_points: Tensor, num_voxels: Tensor,
                    tile_state: Tensor) -> Tensor:
    """:func:`point_keys` whose launch also sets the segment kernel's
    buffers to their empty value (the fused route's form)."""
    vm = _ops("voxel_mean")
    fill = vm.FusedVoxelMeanResult(features, coords, num_points, num_voxels)
    vm._check_outputs(fill, tile_state, points, features.shape[1])
    vm._set_empty(fill, tile_state)
    return vm.point_keys_plain(points, num_valid, voxel_size=voxel_size,
                               pc_range=pc_range, grid_size=grid_size)


@point_keys_fill.register_kernel("cuda")
def _(points, num_valid, voxel_size, pc_range, grid_size, features, coords,
      num_points, num_voxels, tile_state):
    vm = _ops("voxel_mean")
    return vm._point_keys_cuda(
        points, num_valid, voxel_size, pc_range, grid_size,
        vm.FusedVoxelMeanResult(features, coords, num_points, num_voxels),
        tile_state)


@point_keys_fill.register_fake
def _(points, num_valid, voxel_size, pc_range, grid_size, features, coords,
      num_points, num_voxels, tile_state):
    return points.new_empty(points.shape[:2], dtype=torch.int64)


@custom_op("abr::segment_mean",
           mutates_args=("features", "coords", "num_points", "num_voxels",
                         "tile_state"), device_types="cpu")
def segment_mean(points: Tensor, packed: Tensor, grid_size: List[int],
                 max_points: int, features: Tensor, coords: Tensor,
                 num_points: Tensor, num_voxels: Tensor,
                 tile_state: Tensor) -> None:
    """Key-sorted packed values -> each voxel's capped mean, coords and
    count, and the voxel count, written into the given buffers (those
    :func:`point_keys` emptied; V = features.shape[1])."""
    vm = _ops("voxel_mean")
    out = vm.FusedVoxelMeanResult(features, coords, num_points, num_voxels)
    vm._check_outputs(out, tile_state, points, features.shape[1])
    got = vm.segment_mean_plain(points, packed, grid_size=grid_size,
                                max_points=max_points,
                                max_voxels=features.shape[1])
    for dst, src in zip(out, got):
        dst.copy_(src)


@segment_mean.register_kernel("cuda")
def _(points, packed, grid_size, max_points, features, coords, num_points,
      num_voxels, tile_state):
    vm = _ops("voxel_mean")
    vm._segment_mean_cuda(points, packed, grid_size, max_points,
                          vm.FusedVoxelMeanResult(features, coords,
                                                  num_points, num_voxels),
                          tile_state)


@segment_mean.register_fake
def _(points, packed, grid_size, max_points, features, coords, num_points,
      num_voxels, tile_state):
    return None


@custom_op("abr::mean_from_table", mutates_args=(), device_types="cpu")
def mean_from_table(points: Tensor, cell: Tensor, order: Tensor,
                    start: Tensor, count: Tensor, max_points: int,
                    max_voxels: int) -> Tuple[Tensor, Tensor, Tensor]:
    """points [B, P, C], their cells and the slot table -> (features
    [B, V, C], coords [B, V, 3], num_points [B, V]) of the first V
    slots."""
    return _ops("voxel_mean")._mean_from_table_plain(
        points, cell, order, start, count, max_points, max_voxels)


@mean_from_table.register_kernel("cuda")
def _(points, cell, order, start, count, max_points, max_voxels):
    return _ops("voxel_mean")._mean_from_table_cuda(
        points, cell, order, start, count, max_points, max_voxels)


@mean_from_table.register_fake
def _(points, cell, order, start, count, max_points, max_voxels):
    B, _, C = points.shape
    return (points.new_empty((B, max_voxels, C)),
            points.new_empty((B, max_voxels, 3), dtype=torch.int32),
            points.new_empty((B, max_voxels), dtype=torch.int32))


OPS = (pillar_scatter, rotated_iou, gather_gemm, keymatch_gemm, point_keys,
       point_keys_fill, segment_mean, mean_from_table)
