"""Device voxelization — sort-based, static shapes, batched.

The port of ``ops/voxelize_jax.py``: a stable sort by the cell key (invalid
points keyed INT32_MAX, so they sort last) keeps arrival order within each
cell; segment arithmetic gives each point its FCFS rank; voxel slots follow
either the key order (coords come out sorted by ``(y, x, z)``) or the order
in which the cells first appear in the scan (the host voxelizer's
numbering: the rank of each segment's earliest original index among all
segments).  Integer outputs equal the JAX functions' in both numberings.

Three forms share that bookkeeping: :func:`voxelize` (padded ``[V, T, C]``
voxels), :func:`voxelize_flat` (the point-major view of the same hard
voxelization) and :func:`dynamic_voxelize` (cap-free per-voxel means).  All
take a padded batch ``[B, P, C]``; the JAX functions are per scan and
``vmap``-ped by their callers.  ``ops/voxel_mean.py`` builds the fused
voxelize+mean's first-appearance route on :func:`slot_table`; its key
route computes the same cells and keys in a kernel of its own.  Nothing
here synchronises the host.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

INT32_MAX = 2**31 - 1
# largest fp32 below 2**31: cell coords are clamped here before the int32
# cast (XLA's float->int32 conversion saturates, and NaN becomes 0)
_F32_BELOW_2_31 = 2147483520.0


class VoxelizationResult(NamedTuple):
    voxels: torch.Tensor      # [B, V, T, C] zero-padded point features
    coords: torch.Tensor      # [B, V, 3] int32 (z, y, x); -1 padding
    num_points: torch.Tensor  # [B, V] int32 points per voxel (<= T)
    num_voxels: torch.Tensor  # [B] int32 valid voxel count


class FlatVoxelizationResult(NamedTuple):
    """The per-point view of the hard voxelization :func:`voxelize` makes,
    without the [V, T, C] padded grid."""
    points: torch.Tensor      # [B, P, C] points sorted by cell key
    slot: torch.Tensor        # [B, P] int32 voxel slot; V = invalid/overflow
    coords: torch.Tensor      # [B, V, 3] int32 (z, y, x); -1 padding
    num_points: torch.Tensor  # [B, V] int32 points per voxel (<= T)
    num_voxels: torch.Tensor  # [B] int32 valid voxel count


class DynamicVoxelizationResult(NamedTuple):
    features: torch.Tensor         # [B, V, C] per-voxel mean features
    coords: torch.Tensor           # [B, V, 3] int32 (z, y, x); -1 padding
    num_points: torch.Tensor       # [B, V] int32 (uncapped)
    num_voxels: torch.Tensor       # [B] int32
    point_voxel_idx: torch.Tensor  # [B, P] int32 slot per point (-1 dropped)


class SlotTable(NamedTuple):
    """Where each voxel slot's points lie in the key-sorted order."""
    order: torch.Tensor       # [B, P] int64 original index of sorted point
    start: torch.Tensor       # [B, V] int32 sorted position of the slot's
                              # first point (P for an empty slot)
    count: torch.Tensor       # [B, V] int32 points of the slot's cell
    num_voxels: torch.Tensor  # [B] int32
    slots: torch.Tensor       # [B, P] int32 slot of each sorted point
    svalid: torch.Tensor      # [B, P] bool sorted point is valid
    rank: torch.Tensor        # [B, P] int32 FCFS rank within the cell


def _cell_coords(points, voxel_size, pc_range, grid_size):
    """Integer cell coords [B,P,3] (x,y,z order) + in-range mask [B,P].

    ``floor((p - r0) / vs)`` as an fp32 division, as the JAX package
    computes it (not a multiply by ``1/vs``)."""
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    r0 = torch.tensor(pc_range[:3], dtype=points.dtype, device=points.device)
    f = torch.floor((points[..., :3] - r0) / vs)
    f = torch.nan_to_num(f, nan=0.0).clamp(-2.0**31, _F32_BELOW_2_31)
    c = f.to(torch.int32)
    gs = torch.tensor(grid_size, dtype=torch.int32, device=points.device)
    in_range = ((c >= 0) & (c < gs)).all(dim=-1)
    return c, in_range


def _sorted_segments(key: torch.Tensor, valid: torch.Tensor):
    """Stable sort by key along dim 1 with invalids last -> (order,
    svalid, first, seg_id, rank); ``seg_id`` is -1 before the first
    segment."""
    P = key.shape[1]
    key = torch.where(valid, key, torch.full_like(key, INT32_MAX))
    skey, order = torch.sort(key, dim=1, stable=True)
    svalid = skey != INT32_MAX
    first = torch.ones_like(svalid)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first &= svalid
    seg_id = torch.cumsum(first.int(), dim=1, dtype=torch.int32) - 1
    pos = torch.arange(P, dtype=torch.int32, device=key.device)
    seg_start = torch.cummax(torch.where(first, pos, -1), dim=1).values
    return order, svalid, first, seg_id, pos - seg_start


def _voxel_slots(order, first, seg_id, svalid, first_appearance: bool):
    """Slot of each sorted point's segment: the segment id (key order), or
    the rank of the segment's earliest original index among all segments
    (first appearance).  Slots of invalid points are arbitrary; callers
    mask them by ``svalid``."""
    if not first_appearance:
        return seg_id
    B, P = order.shape
    seg_min = torch.full((B, P + 1), INT32_MAX, dtype=torch.int32,
                         device=order.device)
    idx = torch.where(first & svalid, seg_id, P).long()
    seg_min.scatter_reduce_(1, idx, order.to(torch.int32), "amin")
    seg_min = seg_min[:, :P]
    by_arrival = torch.argsort(seg_min, dim=1, stable=True)
    slots_per_seg = torch.argsort(by_arrival, dim=1, stable=True)
    return torch.gather(slots_per_seg, 1,
                        seg_id.clamp(0, P - 1).long()).to(torch.int32)


def slot_table(points: torch.Tensor, num_valid: torch.Tensor, *, voxel_size,
               pc_range, grid_size, max_voxels: int, first_appearance: bool,
               renumber_by_key: bool = False):
    """The sort and the per-slot bookkeeping every voxelizer shares.
    -> (cell coords [B,P,3] int32 in x,y,z order, :class:`SlotTable`).

    ``renumber_by_key`` keeps the cells that ``first_appearance`` and
    ``max_voxels`` select and numbers them in key order."""
    B, P, _ = points.shape
    dev = points.device
    gx, gy, gz = (int(g) for g in grid_size)
    if gx * gy * gz >= INT32_MAX:
        raise ValueError("grid too large for int32 keys")
    V = int(max_voxels)
    c, in_range = _cell_coords(points, voxel_size, pc_range, grid_size)
    pos = torch.arange(P, dtype=torch.int32, device=dev)
    valid = in_range & (pos[None, :] < num_valid.to(dev)[:, None])
    # depth-minor key (y, x, z), as ops/sparse_conv.py linearizes
    key = (c[..., 1] * gx + c[..., 0]) * gz + c[..., 2]
    order, svalid, first, seg_id, rank = _sorted_segments(key, valid)
    slots = _voxel_slots(order, first, seg_id, svalid, first_appearance)
    if renumber_by_key and first_appearance:
        kept = svalid & (slots < V)
        slots = torch.where(
            kept, torch.cumsum((first & kept).int(), dim=1,
                               dtype=torch.int32) - 1, V)

    kept = svalid & (slots < V)
    head_ok = first & kept
    # one head per kept slot; every other point goes to the dump column
    start = torch.full((B, V + 1), P, dtype=torch.int32, device=dev)
    start.scatter_reduce_(1, torch.where(head_ok, slots, V).long(),
                          pos[None, :].expand(B, P), "amin")
    count = torch.zeros((B, V + 1), dtype=torch.int32, device=dev)
    count.scatter_add_(1, torch.where(kept, slots, V).long(), kept.int())
    num_voxels = head_ok.sum(dim=1, dtype=torch.int32)
    return c, SlotTable(order, start[:, :V], count[:, :V], num_voxels, slots,
                        svalid, rank)


def _slot_coords(c: torch.Tensor, tab: SlotTable) -> torch.Tensor:
    """[B, V, 3] int32 (z, y, x) of each slot's head point; -1 padding."""
    P = c.shape[1]
    head = torch.gather(tab.order, 1, tab.start.clamp(max=P - 1).long())
    zyx = torch.gather(c, 1, head[..., None].expand(-1, -1, 3)).flip(-1)
    return torch.where((tab.count > 0)[..., None], zyx,
                       torch.full_like(zyx, -1))


def padded_from_table(points: torch.Tensor, c: torch.Tensor, tab: SlotTable,
                      max_points: int) -> VoxelizationResult:
    """The padded voxels of a slot table.  A slot's first T FCFS points
    are sorted positions start..start+T-1 (stable sort): gather that
    [V, T] window."""
    B, P, C = points.shape
    V, T = tab.start.shape[1], int(max_points)
    num_points = tab.count.clamp(max=T)
    t = torch.arange(T, dtype=torch.int32, device=points.device)
    window = (tab.start[..., None] + t).clamp(max=P - 1).long()   # [B, V, T]
    src = torch.gather(tab.order, 1, window.reshape(B, V * T))
    voxels = torch.gather(points, 1, src[..., None].expand(B, V * T, C))
    tmask = t < num_points[..., None]
    voxels = torch.where(tmask[..., None], voxels.reshape(B, V, T, C),
                         torch.zeros((), dtype=points.dtype,
                                     device=points.device))
    return VoxelizationResult(voxels, _slot_coords(c, tab), num_points,
                              tab.num_voxels)


def voxelize(points: torch.Tensor, num_valid: torch.Tensor, *,
             voxel_size: Sequence[float], pc_range: Sequence[float],
             grid_size: Sequence[int], max_points: int, max_voxels: int,
             first_appearance: bool = True) -> VoxelizationResult:
    """Hard voxelization of a padded batch.

    Args:
        points: [B, P, C] padded point buffers (x, y, z first).
        num_valid: [B] int — points at or beyond this index are padding.
        grid_size: (gx, gy, gz).
        max_points: per-voxel cap T (first-come-first-served).
        max_voxels: voxel cap V (the first V occupied cells in the slot
            numbering).
        first_appearance: number voxels by first point arrival (the host
            voxelizer's order); False = key order (what serving uses).
    """
    c, tab = slot_table(points, num_valid, voxel_size=voxel_size,
                        pc_range=pc_range, grid_size=grid_size,
                        max_voxels=max_voxels,
                        first_appearance=first_appearance)
    return padded_from_table(points, c, tab, max_points)


def voxelize_flat(points: torch.Tensor, num_valid: torch.Tensor, *,
                  voxel_size: Sequence[float], pc_range: Sequence[float],
                  grid_size: Sequence[int], max_points: int, max_voxels: int,
                  first_appearance: bool = False) -> FlatVoxelizationResult:
    """Hard voxelization, flat (point-major) output.

    Same cell assignment, FCFS cap and voxel numbering as :func:`voxelize`:
    ``slot[b, p]`` is the voxel row that sorted point p occupies there;
    points beyond the T cap, beyond the V cap, outside the grid or in the
    padding get ``slot == max_voxels``.  ``slot`` is not nondecreasing even
    in key order: an over-cap point (slot V) precedes the next cell's.
    """
    B, P, C = points.shape
    V, T = int(max_voxels), int(max_points)
    c, tab = slot_table(points, num_valid, voxel_size=voxel_size,
                        pc_range=pc_range, grid_size=grid_size, max_voxels=V,
                        first_appearance=first_appearance)
    pt_ok = tab.svalid & (tab.slots < V) & (tab.rank < T)
    slot = torch.where(pt_ok, tab.slots, V).to(torch.int32)
    pts_sorted = torch.gather(points, 1,
                              tab.order[..., None].expand(B, P, C))
    return FlatVoxelizationResult(pts_sorted, slot, _slot_coords(c, tab),
                                  tab.count.clamp(max=T), tab.num_voxels)


def dynamic_voxelize(points: torch.Tensor, num_valid: torch.Tensor, *,
                     voxel_size: Sequence[float], pc_range: Sequence[float],
                     grid_size: Sequence[int], max_voxels: int,
                     key_order: bool = False) -> DynamicVoxelizationResult:
    """Dynamic voxelization: per-voxel mean features, no point cap, slots
    in first-appearance order.  ``key_order`` keeps the same cells (the
    first ``max_voxels`` to appear) and numbers them by ascending key, the
    order a sparse middle searches fastest.

    The sums are a segmented reduction over the key-sorted buffer (a
    float64 running sum, differenced at each cell's ends and rounded to
    the input type), not an atomic scatter-add: the same on every run and
    on either device, and within 1e-6 relative of the JAX function's
    in-order fp32 sums.  A cell that holds a non-finite value gets NaN in
    that channel.
    """
    B, P, C = points.shape
    V = int(max_voxels)
    c, tab = slot_table(points, num_valid, voxel_size=voxel_size,
                        pc_range=pc_range, grid_size=grid_size, max_voxels=V,
                        first_appearance=True, renumber_by_key=key_order)
    pts_sorted = torch.gather(points, 1,
                              tab.order[..., None].expand(B, P, C))
    # channel-major [B, C, P], so that the scans run along the innermost
    # axis
    by_channel = pts_sorted.transpose(1, 2)
    finite = torch.isfinite(by_channel)
    running = torch.zeros((B, C, P + 1), dtype=torch.float64,
                          device=points.device)
    running[..., 1:] = torch.cumsum(
        torch.where(finite, by_channel, 0).double(), dim=2)
    bad = torch.zeros((B, C, P + 1), dtype=torch.int32, device=points.device)
    bad[..., 1:] = torch.cumsum((~finite).int(), dim=2, dtype=torch.int32)
    lo = tab.start.clamp(max=P).long()[:, None, :].expand(B, C, V)
    hi = (tab.start + tab.count).clamp(max=P).long()[:, None, :].expand(
        B, C, V)

    def between_ends(cum):                                     # -> [B, V, C]
        return (torch.gather(cum, 2, hi)
                - torch.gather(cum, 2, lo)).transpose(1, 2)

    sums = between_ends(running).to(points.dtype)
    sums = torch.where(between_ends(bad) > 0,
                       torch.full_like(sums, float("nan")), sums)
    means = sums / tab.count.clamp(min=1)[..., None].to(points.dtype)

    pt_ok = tab.svalid & (tab.slots < V)
    pv = torch.full((B, P), -1, dtype=torch.int32, device=points.device)
    pv.scatter_(1, tab.order, torch.where(pt_ok, tab.slots, -1))
    return DynamicVoxelizationResult(means, _slot_coords(c, tab), tab.count,
                                     tab.num_voxels, pv)
