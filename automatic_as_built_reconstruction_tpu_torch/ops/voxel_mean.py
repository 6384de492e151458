"""Fused voxelize + mean (SECOND's input stage): CUDA kernels + plain
versions.

Replaces the TPU kernel
``automatic_as_built_reconstruction_tpu/ops/pallas/voxel_mean.py::
fused_voxelize_mean``: hard voxelization followed by the ``SimpleVoxel``
mean, without the ``[V, T, C]`` padded voxel tensor.  Contract: equal to
``SimpleVoxel`` applied to ``ops.voxelize.voxelize(...)`` with the same
FCFS cap, the same slot numbering and the same ``max_voxels`` truncation;
empty slots give exact zeros.

Two routes, chosen by ``first_appearance`` (``csrc/voxel_mean.cu`` holds
all three kernels):

- key order (``first_appearance=False``, what serving runs): the key
  kernel (:func:`point_keys`) packs each point's cell key and index into
  one int64, ``torch.sort`` orders them, and the segment-and-mean kernel
  (:func:`segment_mean`) numbers the cells, cuts at ``max_voxels`` and
  writes features, coords and counts in one pass;
- first appearance (the host voxelizer's numbering): the slot table of
  ``ops/voxelize.py`` and the table kernel (:func:`mean_from_table`).

Each kernel is an operator of ``ops/library.py`` (``abr::point_keys``
and its filling form ``abr::point_keys_fill``, ``abr::segment_mean``,
``abr::mean_from_table``): on CPU tensors its
plain version, on CUDA tensors the kernel, which raises on what it does
not take.  Bound: bytes, and so few that the kernels' chains of dependent
reads set their time; see the source note.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from . import _build, library
from .voxelize import (INT32_MAX, SlotTable, _cell_coords, padded_from_table,
                       slot_table)

# (5 in, 3 out pointers, six ints, stream) of the C launch function
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_KEYS_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_longlong,
                                             ctypes.c_int)
                  + (ctypes.c_float,) * 6 + (ctypes.c_int,) * 3
                  + (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_void_p)
                  + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))
_SEGMENT_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 2
                     + (ctypes.c_longlong,) + (ctypes.c_int,) * 5
                     + (ctypes.c_void_p,))
# sorted positions a segment_mean block covers (SEGMENT_TILE in the source)
SEGMENT_TILE = 512
_MASK32 = 0xFFFFFFFF


class FusedVoxelMeanResult(NamedTuple):
    features: torch.Tensor    # [B, V, C] capped per-voxel mean features
    coords: torch.Tensor      # [B, V, 3] int32 (z, y, x); -1 padding
    num_points: torch.Tensor  # [B, V] int32 (capped at T)
    num_voxels: torch.Tensor  # [B] int32


# --------------------------------------------------------------------------
# key-order route: key kernel, sort, segment-and-mean kernel
# --------------------------------------------------------------------------

def _grid_dims(grid_size):
    gx, gy, gz = (int(g) for g in grid_size)
    if gx * gy * gz >= INT32_MAX:
        raise ValueError("grid too large for int32 keys")
    return gx, gy, gz


def point_keys_plain(points: torch.Tensor, num_valid: torch.Tensor, *,
                     voxel_size: Sequence[float], pc_range: Sequence[float],
                     grid_size: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of :func:`point_keys`: the packed int64
    ``key << 32 | pos`` of every point, ``key`` the depth-minor cell key
    of ``ops/voxelize.py::slot_table`` or ``INT32_MAX`` for a point out of
    range or in the padding."""
    B, P, _ = points.shape
    gx, _, gz = _grid_dims(grid_size)
    c, in_range = _cell_coords(points, voxel_size, pc_range, grid_size)
    pos = torch.arange(P, dtype=torch.int64, device=points.device)
    valid = in_range & (pos[None, :] < num_valid.to(points.device)[:, None])
    c = c.long()
    key = (c[..., 1] * gx + c[..., 0]) * gz + c[..., 2]
    key = torch.where(valid, key, INT32_MAX)
    return (key << 32) | pos


def _check_points(points: torch.Tensor) -> None:
    if points.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 points, got {points.dtype}")
    if points.shape[1] >= 2**32:
        raise ValueError(f"P = {points.shape[1]}: the packed keys hold a "
                         f"point's index in 32 bits")


def scan_words(P: int) -> int:
    """Words of a scan's row of ``tile_state``: each tile's head count,
    then the ticket counter that gives the blocks their tiles."""
    return -(-P // SEGMENT_TILE) + 1


def _check_outputs(out: FusedVoxelMeanResult, tile_state: torch.Tensor,
                   points: torch.Tensor, V: int) -> None:
    """The segment kernel's output buffers and scan words: contiguous, on
    the points' device, of the shapes it writes."""
    B, P, C = points.shape
    shapes = ((B, V, C), (B, V, 3), (B, V), (B,), (B, scan_words(P)))
    dtypes = (torch.float32,) + (torch.int32,) * 4
    for t, shape, dtype in zip((*out, tile_state), shapes, dtypes):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != points.device):
            raise ValueError(f"output buffer {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}: want contiguous {dtype} {shape} "
                             f"on {points.device}")


def _set_empty(fill: FusedVoxelMeanResult,
               tile_state: torch.Tensor) -> None:
    """The segment kernel's buffers at their empty value (features 0,
    coords -1, counts and scan words 0), as the key kernel leaves them."""
    fill.features.zero_()
    fill.coords.fill_(-1)
    fill.num_points.zero_()
    fill.num_voxels.zero_()
    tile_state.zero_()


def _point_keys_cuda(points, num_valid, voxel_size, pc_range, grid_size,
                     fill: Optional[FusedVoxelMeanResult],
                     tile_state: Optional[torch.Tensor]) -> torch.Tensor:
    """The CUDA body of the ``abr::point_keys`` op (``ops/library.py``):
    checks, the launch, its count."""
    _check_points(points)
    if num_valid.device != points.device:
        raise ValueError("points and num_valid on different devices")
    B, P, C = points.shape
    gx, gy, gz = _grid_dims(grid_size)
    points = points.contiguous()
    nv = num_valid.to(torch.int32).contiguous()
    packed = torch.empty((B, P), dtype=torch.int64, device=points.device)
    out = [0, 0, 0, 0]
    V = words = 0
    if fill is not None:
        V, words = fill.features.shape[1], tile_state.shape[1]
        _check_outputs(fill, tile_state, points, V)
        out = [t.data_ptr() for t in fill]
    if B == 0:
        return packed
    vs = [float(v) for v in voxel_size]
    r0 = [float(v) for v in pc_range[:3]]
    fn = _build.function("voxel_mean", "point_keys_launch", _KEYS_ARGTYPES)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), nv.data_ptr(), packed.data_ptr(), B, P,
                 C, *vs, *r0, gx, gy, gz, *out, V,
                 0 if fill is None else tile_state.data_ptr(), words,
                 int(fill is not None), stream)
    _build.check(err, "point_keys_launch")
    point_keys.launches += 1
    return packed


def point_keys(points: torch.Tensor, num_valid: torch.Tensor, *,
               voxel_size: Sequence[float], pc_range: Sequence[float],
               grid_size: Sequence[int],
               fill: Optional[FusedVoxelMeanResult] = None,
               tile_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The key kernel's wrapper: points [B, P, C] + num_valid [B] ->
    packed int64 keys [B, P] (see :func:`point_keys_plain`).  ``fill``
    and ``tile_state``: the buffers :func:`segment_mean` will write, which
    the same launch sets to the empty value (features 0, coords -1,
    counts 0) and zeroes.  Runs the ``abr::point_keys`` op (with ``fill``,
    ``abr::point_keys_fill``): on CPU tensors the plain version, on CUDA
    tensors the kernel or it raises."""
    geo = ([float(v) for v in voxel_size], [float(v) for v in pc_range],
           [int(g) for g in grid_size])
    if fill is None:
        return library.point_keys(points, num_valid, *geo)
    return library.point_keys_fill(points, num_valid, *geo, *fill,
                                   tile_state)


point_keys.launches = 0


def decode_key(key: torch.Tensor, grid_size: Sequence[int]) -> torch.Tensor:
    """Cell keys [...] -> int32 (z, y, x) [..., 3]."""
    gx, _, gz = (int(g) for g in grid_size)
    xy = torch.div(key, gz, rounding_mode="floor")
    return torch.stack([key % gz, torch.div(xy, gx, rounding_mode="floor"),
                        xy % gx], -1).to(torch.int32)


def segment_mean_plain(points: torch.Tensor, packed: torch.Tensor, *,
                       grid_size: Sequence[int], max_points: int,
                       max_voxels: int) -> FusedVoxelMeanResult:
    """Plain PyTorch version of :func:`segment_mean`: key-sorted packed
    values [B, P] -> features, coords, counts and ``num_voxels``.  A head
    (first position of a valid key) numbers its cell by the heads before
    it; each of the first ``max_voxels`` cells sums its first
    ``max_points`` rows in sorted order (t order) and divides by the
    count."""
    B, P, C = points.shape
    V, T = int(max_voxels), int(max_points)
    dev = points.device
    key, pos = packed >> 32, packed & _MASK32
    valid = key != INT32_MAX
    head = valid.clone()
    head[:, 1:] &= key[:, 1:] != key[:, :-1]
    slot = torch.cumsum(head, dim=1) - 1
    idx = torch.arange(P, device=dev)
    run = idx - torch.cummax(torch.where(head, idx, -1), dim=1).values
    kept = valid & (slot < V) & (run < T)
    num_points = torch.zeros((B, V + 1), dtype=torch.int32, device=dev)
    num_points.scatter_add_(1, torch.where(kept, slot, V), kept.int())
    num_points = num_points[:, :V]
    start = torch.full((B, V + 1), P, dtype=torch.int64, device=dev)
    start.scatter_reduce_(1, torch.where(head & (slot < V), slot, V),
                          idx.expand(B, P), "amin")
    start = start[:, :V].clamp(max=P - 1) if P else start[:, :V]
    acc = torch.zeros((B, V, C), dtype=points.dtype, device=dev)
    for t in range(T if P else 0):
        src = torch.gather(pos, 1, (start + t).clamp(max=P - 1))
        rows = torch.gather(points, 1, src[..., None].expand(B, V, C))
        acc = acc + torch.where((t < num_points)[..., None], rows, 0.0)
    features = acc / num_points.clamp(min=1)[..., None].to(points.dtype)
    occupied = num_points > 0
    hkey = torch.gather(key, 1, start) if P else torch.zeros_like(start)
    coords = torch.where(occupied[..., None], decode_key(hkey, grid_size),
                         -1)
    num_voxels = (head & (slot < V)).sum(dim=1, dtype=torch.int32)
    return FusedVoxelMeanResult(features, coords.to(torch.int32), num_points,
                                num_voxels)


def _empty_outputs(B, V, C, device) -> FusedVoxelMeanResult:
    return FusedVoxelMeanResult(
        torch.empty((B, V, C), dtype=torch.float32, device=device),
        torch.empty((B, V, 3), dtype=torch.int32, device=device),
        torch.empty((B, V), dtype=torch.int32, device=device),
        torch.empty((B,), dtype=torch.int32, device=device))


def _segment_mean_cuda(points, packed, grid_size, max_points,
                       outputs: FusedVoxelMeanResult,
                       tile_state: torch.Tensor) -> None:
    """The CUDA body of the ``abr::segment_mean`` op (``ops/library.py``):
    checks, the launch into ``outputs``, its count."""
    _check_points(points)
    B, P, C = points.shape
    if (packed.device != points.device or packed.dtype != torch.int64
            or tuple(packed.shape) != (B, P)):
        raise ValueError(f"packed keys {packed.dtype} "
                         f"{tuple(packed.shape)}: want int64 {(B, P)} on "
                         f"the points' device")
    V, T = outputs.features.shape[1], int(max_points)
    gx, _, gz = _grid_dims(grid_size)
    if T < 1:
        raise ValueError(f"max_points = {T}")
    points, packed = points.contiguous(), packed.contiguous()
    n_tiles = -(-P // SEGMENT_TILE)
    _check_outputs(outputs, tile_state, points, V)
    if B == 0 or P == 0:
        return
    fn = _build.function("voxel_mean", "segment_mean_launch",
                         _SEGMENT_ARGTYPES)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), packed.data_ptr(),
                 *(t.data_ptr() for t in outputs), tile_state.data_ptr(),
                 n_tiles, B, P, C, V, T, gx, gz, stream)
    _build.check(err, "segment_mean_launch")
    segment_mean.launches += 1


def segment_mean(points: torch.Tensor, packed: torch.Tensor, *,
                 grid_size: Sequence[int], max_points: int, max_voxels: int,
                 outputs: Optional[FusedVoxelMeanResult] = None,
                 tile_state: Optional[torch.Tensor] = None
                 ) -> FusedVoxelMeanResult:
    """The segment-and-mean kernel's wrapper: points [B, P, C] + the
    key-sorted packed values [B, P] -> :class:`FusedVoxelMeanResult` (see
    :func:`segment_mean_plain`).  ``outputs`` and ``tile_state`` come
    from :func:`point_keys`'s ``fill``; without them they are allocated
    and emptied here.  Runs the ``abr::segment_mean`` op, which writes
    into them: on CPU tensors the plain version, on CUDA tensors the
    kernel or it raises."""
    if outputs is None:
        B, P, C = points.shape
        outputs = _empty_outputs(B, int(max_voxels), C, points.device)
        tile_state = torch.empty((B, scan_words(P)), dtype=torch.int32,
                                 device=points.device)
        _set_empty(outputs, tile_state)
    elif outputs.features.shape[1] != int(max_voxels):
        raise ValueError(f"outputs hold {outputs.features.shape[1]} voxels, "
                         f"max_voxels = {max_voxels}")
    library.segment_mean(points, packed, [int(g) for g in grid_size],
                         int(max_points), *outputs, tile_state)
    return outputs


segment_mean.launches = 0


# --------------------------------------------------------------------------
# first-appearance route: slot table + table kernel
# --------------------------------------------------------------------------

def mean_from_table_plain(points: torch.Tensor, cell: torch.Tensor,
                          tab: SlotTable, max_points: int
                          ) -> FusedVoxelMeanResult:
    """Plain PyTorch version of :func:`mean_from_table`: the padded voxels
    of the table, then the mean as ``models.voxel_encoder.SimpleVoxel``
    takes it (the sum of the first ``num_points`` rows over the clamped
    count)."""
    vox = padded_from_table(points, cell, tab, max_points)
    T = vox.voxels.shape[2]
    ids = torch.arange(T, device=points.device)
    mask = (ids[None, None, :] < vox.num_points[..., None]).to(
        vox.voxels.dtype)[..., None]
    denom = torch.clamp_min(vox.num_points[..., None], 1).to(
        vox.voxels.dtype)
    mean = (vox.voxels * mask).sum(dim=2) / denom
    return FusedVoxelMeanResult(mean, vox.coords, vox.num_points,
                                vox.num_voxels)


def _mean_from_table_plain(points, cell, order, start, count, max_points,
                           max_voxels):
    """The ``abr::mean_from_table`` op's CPU body: (features, coords,
    num_points) of :func:`mean_from_table_plain`, contiguous."""
    tab = SlotTable(order, start[:, :max_voxels], count[:, :max_voxels],
                    *[None] * 4)
    got = mean_from_table_plain(points, cell, tab, max_points)
    return tuple(t.contiguous() for t in got[:3])


def _mean_from_table_cuda(points, cell, order, start, count, max_points,
                          V: int):
    """The CUDA body of the ``abr::mean_from_table`` op
    (``ops/library.py``): checks, the launch, its count."""
    if points.dtype != torch.float32:
        raise TypeError(f"kernel takes float32 points, got {points.dtype}")
    if any(t.device != points.device for t in (cell, order, start, count)):
        raise ValueError("points, cells and slot table on different devices")
    B, P, C = points.shape
    T = int(max_points)
    points, cell = points.contiguous(), cell.contiguous()
    order = order.contiguous()
    # the table's rows carry a dump column past V: hand the kernel the
    # row stride instead of copying the V columns out
    stride = start.stride(0)
    if (start.stride(1) != 1 or count.stride() != start.stride()
            or stride < V):
        start = start[:, :V].contiguous()
        count = count[:, :V].contiguous()
        stride = V
    dev = points.device
    features, coords, num_points, _ = _empty_outputs(B, V, C, dev)
    fn = _build.function("voxel_mean", "voxel_mean_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(points.data_ptr(), order.data_ptr(), cell.data_ptr(),
                 start.data_ptr(), count.data_ptr(), features.data_ptr(),
                 coords.data_ptr(), num_points.data_ptr(), B, P, C, V, T,
                 stride, stream)
    _build.check(err, "voxel_mean_launch")
    mean_from_table.launches += 1
    return features, coords, num_points


def mean_from_table(points: torch.Tensor, cell: torch.Tensor, tab: SlotTable,
                    max_points: int) -> FusedVoxelMeanResult:
    """The table kernel's wrapper: points [B, P, C], their cells [B, P, 3]
    and the slot table -> capped means, coords and counts of every slot.
    Runs the ``abr::mean_from_table`` op: on CPU tensors the plain
    version, on CUDA tensors the kernel (fp32 points) or it raises."""
    features, coords, num_points = library.mean_from_table(
        points, cell, tab.order, tab.start, tab.count, int(max_points),
        int(tab.start.shape[1]))
    return FusedVoxelMeanResult(features, coords, num_points, tab.num_voxels)


mean_from_table.launches = 0


# --------------------------------------------------------------------------
# the function
# --------------------------------------------------------------------------

def _check(points, num_valid) -> None:
    if points.dim() != 3 or num_valid.shape != points.shape[:1]:
        raise ValueError(f"points {tuple(points.shape)} / num_valid "
                         f"{tuple(num_valid.shape)}: want [B,P,C] / [B]")
    if points.shape[-1] < 3:
        raise ValueError(f"points need x, y, z first, got C = "
                         f"{points.shape[-1]}")
    if num_valid.device != points.device:
        raise ValueError("points and num_valid on different devices")


def fused_voxelize_mean_plain(points: torch.Tensor, num_valid: torch.Tensor,
                              *, voxel_size: Sequence[float],
                              pc_range: Sequence[float],
                              grid_size: Sequence[int], max_points: int,
                              max_voxels: int, first_appearance: bool = True
                              ) -> FusedVoxelMeanResult:
    """Plain PyTorch version of :func:`fused_voxelize_mean`:
    ``SimpleVoxel`` applied to ``ops.voxelize.voxelize(...)``."""
    _check(points, num_valid)
    cell, tab = slot_table(points, num_valid, voxel_size=voxel_size,
                           pc_range=pc_range, grid_size=grid_size,
                           max_voxels=max_voxels,
                           first_appearance=first_appearance)
    return mean_from_table_plain(points, cell, tab, max_points)


def fused_voxelize_mean(points: torch.Tensor, num_valid: torch.Tensor, *,
                        voxel_size: Sequence[float],
                        pc_range: Sequence[float], grid_size: Sequence[int],
                        max_points: int, max_voxels: int,
                        first_appearance: bool = True, tile: int = 256,
                        window: int = 1024) -> FusedVoxelMeanResult:
    """points [B, P, C] + num_valid [B] -> capped per-voxel mean features
    [B, V, C], coords, counts and voxel count.

    ``tile`` and ``window`` are the TPU kernel's window tuning: accepted
    and without effect here.  Runs the key route
    (``first_appearance=False``: the key op, ``torch.sort``, the
    segment-and-mean op) or the table route (slot table, the table op):
    on CPU tensors the ops' plain versions, on CUDA tensors the kernels,
    which raise on what they do not take.
    """
    _check(points, num_valid)
    if first_appearance:
        cell, tab = slot_table(points, num_valid, voxel_size=voxel_size,
                               pc_range=pc_range, grid_size=grid_size,
                               max_voxels=max_voxels, first_appearance=True)
        return mean_from_table(points, cell, tab, max_points)
    B, P, C = points.shape
    out = _empty_outputs(B, int(max_voxels), C, points.device)
    state = torch.empty((B, scan_words(P)), dtype=torch.int32,
                        device=points.device)
    packed = point_keys(points, num_valid, voxel_size=voxel_size,
                        pc_range=pc_range, grid_size=grid_size, fill=out,
                        tile_state=state)
    packed = torch.sort(packed, dim=1).values
    return segment_mean(points, packed, grid_size=grid_size,
                        max_points=max_points, max_voxels=max_voxels,
                        outputs=out, tile_state=state)
