"""Sparse 3D convolution on static shapes: plans, site and rulebook
builders, and the plain convolutions.

The port of the JAX package's ``ops/sparse_conv.py``, for the functions
the SECOND serving path runs:

- **keys**: ``linearize`` maps (z, y, x) to the depth-minor key
  ``(y*W + x)*D + z``; anything outside the grid becomes ``INT32_MAX``.
  A neighbour query is always coords + offset -> bounds check -> key (a
  key +- constant would wrap across BEV rows).
- **plans**: ``BlockSpec`` / ``BlockPlan`` / ``plan_from_specs`` /
  ``make_plan`` / ``respec`` / ``measure_site_caps`` (pure Python and
  numpy, the same tuples as the JAX package gives).
- **sites**: ``build_strided_sites`` (output sites of a strided conv, key
  sorted, truncated at ``max_out`` in key order).
- **rulebooks**: the merge builders, as functions with the JAX results:
  ``_merge_lookup`` here is a stable sort of the input keys and one
  ``torch.searchsorted`` (a GPU does binary-search gathers in parallel;
  the JAX package's combined sort is a TPU device).
- **convs**: ``submanifold_conv`` / ``strided_sparse_conv`` (plain gather
  + one matmul), ``scatter_to_bev``, and the dense oracle ``densify`` /
  ``dense_conv3d``.

Every tensor function takes arbitrary leading batch dimensions: a site
axis is the last (keys, masks) or the last but one (coords, features).
The dense-LUT and binary-search builders, ``sparse_max_pool`` and
``inverse_sparse_conv`` are not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1


def _offsets(kernel_size: Tuple[int, int, int]) -> np.ndarray:
    """[K, 3] kernel offsets in (z, y, x), centered (sub-manifold style)."""
    kz, ky, kx = kernel_size
    return np.stack(np.meshgrid(
        np.arange(kz) - kz // 2,
        np.arange(ky) - ky // 2,
        np.arange(kx) - kx // 2, indexing="ij"), -1).reshape(-1, 3)


def conv_taps(kernel_size: Tuple[int, int, int]) -> np.ndarray:
    """[T, 3] un-centered tap offsets of a strided conv, in the weight
    layout order shared by every strided-conv consumer."""
    k = np.asarray(kernel_size)
    return np.stack(np.meshgrid(*[np.arange(kk) for kk in k],
                                indexing="ij"), -1).reshape(-1, 3)


def linearize(coords: torch.Tensor,
              grid_dhw: Tuple[int, int, int]) -> torch.Tensor:
    """(z,y,x) int coords [..., 3] -> int32 keys [...]; anything outside
    the grid (<0 or >=grid) -> INT32_MAX.  Depth-minor order:
    ``key = (y*W + x)*D + z``."""
    D, H, W = grid_dhw
    z, y, x = coords[..., 0], coords[..., 1], coords[..., 2]
    ok = ((z >= 0) & (z < D) & (y >= 0) & (y < H) & (x >= 0) & (x < W))
    key = (y * W + x) * D + z
    return torch.where(ok, key, INT32_MAX).to(torch.int32)


class BlockSpec(NamedTuple):
    """One middle-stack block: ``n_subm`` 3x3x3 submanifold convs
    (``subm_cout`` channels) followed by one strided SparseConv
    (``down_cout`` channels, arbitrary kernel/stride/pad)."""

    n_subm: int
    subm_cout: int                  # ignored when n_subm == 0
    down_cout: int
    kernel: Tuple[int, int, int]    # strided-conv kernel (z, y, x)
    stride: Tuple[int, int, int]
    pad: Tuple[int, int, int]


class BlockPlan(NamedTuple):
    """Static per-block geometry of a sparse middle stack."""

    grid: Tuple[int, int, int]       # input grid (D, H, W)
    out_grid: Tuple[int, int, int]   # grid after the strided conv
    kernel: Tuple[int, int, int]     # strided-conv kernel
    stride: Tuple[int, int, int]
    pad: Tuple[int, int, int]
    in_cap: int                      # active-site capacity entering the block
    out_cap: int                     # capacity after the strided conv
    n_subm: int                      # submanifold convs before the downsample
    cout: int                        # strided-conv output channels
    subm_cout: int = -1              # submanifold channels (-1 -> == cout)
    subm_kernel: Tuple[int, int, int] = (3, 3, 3)

    @property
    def subm_channels(self) -> int:
        return self.cout if self.subm_cout < 0 else self.subm_cout


def _out_grid(grid, pad, kernel, stride):
    return tuple((g + 2 * p - k) // s + 1 for g, p, k, s in zip(
        grid, pad, kernel, stride))


def plan_from_specs(grid_dhw: Tuple[int, int, int], v_cap: int,
                    specs: Tuple[BlockSpec, ...],
                    capacity_shrink: Optional[float] = None,
                    min_capacity: int = 2048,
                    out_caps: Optional[Sequence[int]] = None,
                    ) -> Tuple[BlockPlan, ...]:
    """Explicit per-block specs -> capacity-annotated BlockPlans.

    A strided SparseConv expands the active-site set; a block whose true
    output count exceeds its static ``out_cap`` truncates in sorted-key
    order (the highest-y BEV rows go first).  Three sizing modes:

    - ``out_caps``: explicit per-block capacities (size them from data
      with :func:`measure_site_caps`); rounded up to 128.
    - ``capacity_shrink``: uniform multiplier on the running capacity
      after each >=2-axis strided conv (z-only convs keep ~max(it, .85)).
    - neither: 3.0x for the first downsample whose kernel dilates any
      non-strided axis, 1.25x for later ones, 1.0x for pure-collapse
      convs, all capped at 4x the stack's input capacity.

    Every capacity is at least ``min(min_capacity, cap)``, at most the
    output grid's cell count, and a multiple of 128.  Raises ValueError
    if the grid is too small for the plan.
    """
    if out_caps is not None and len(out_caps) != len(specs):
        raise ValueError(
            f"out_site_caps has {len(out_caps)} entries but the middle "
            f"stack has {len(specs)} strided blocks — caps measured for a "
            f"different middle variant? (use measure_site_caps on this "
            f"plan, or clear out_site_caps for the heuristic)")
    blocks = []
    grid = tuple(int(g) for g in grid_dhw)
    cap = int(v_cap)
    seen_ds = False
    for i, s in enumerate(specs):
        og = _out_grid(grid, s.pad, s.kernel, s.stride)
        if any(g < 1 for g in og):
            raise ValueError(
                f"grid {grid} too small for block {s} (out grid {og})")
        n_ds_axes = sum(1 for st in s.stride if st > 1)
        dilates = any(k > 1 and st == 1
                      for k, st in zip(s.kernel, s.stride))
        if out_caps is not None:
            next_cap = int(out_caps[i])
        elif capacity_shrink is not None:
            shrink = (capacity_shrink if n_ds_axes >= 2
                      else min(1.0, max(capacity_shrink, 0.85)))
            next_cap = int(cap * shrink)
        else:
            if n_ds_axes >= 2 or dilates:
                mult = 1.25 if seen_ds else 3.0
                seen_ds = True
            else:
                mult = 1.0
            next_cap = min(int(cap * mult), 4 * int(v_cap))
        next_cap = max(next_cap, min(min_capacity, cap))
        next_cap = min(next_cap, int(np.prod(og)))
        next_cap = ((next_cap + 127) // 128) * 128
        blocks.append(BlockPlan(
            grid=grid, out_grid=og, kernel=tuple(s.kernel),
            stride=tuple(s.stride), pad=tuple(s.pad), in_cap=cap,
            out_cap=next_cap, n_subm=int(s.n_subm), cout=int(s.down_cout),
            subm_cout=int(s.subm_cout), subm_kernel=(3, 3, 3)))
        grid, cap = og, next_cap
    return tuple(blocks)


def strided_out_sites_np(coords: np.ndarray, grid: Tuple[int, int, int],
                         kernel, stride, pad,
                         out_grid: Tuple[int, int, int]) -> np.ndarray:
    """Exact output-site set of one strided conv, on host: ``coords``
    [N, 3] int (z, y, x), -1-padded rows allowed -> sorted unique [M, 3]
    output coordinates."""
    pts = coords[coords[:, 0] >= 0].astype(np.int64)
    if pts.size == 0:
        return np.zeros((0, 3), np.int64)
    keys = []
    for dz in range(kernel[0]):
        for dy in range(kernel[1]):
            for dx in range(kernel[2]):
                o = pts + np.array([pad[0] - dz, pad[1] - dy, pad[2] - dx])
                m = ((o % np.array(stride)) == 0).all(1)
                o = o[m] // np.array(stride)
                m = ((o >= 0) & (o < np.array(out_grid))).all(1)
                o = o[m]
                keys.append((o[:, 0] * out_grid[1] + o[:, 1])
                            * out_grid[2] + o[:, 2])
    uniq = np.unique(np.concatenate(keys))
    z = uniq // (out_grid[1] * out_grid[2])
    y = (uniq // out_grid[2]) % out_grid[1]
    x = uniq % out_grid[2]
    return np.stack([z, y, x], axis=1)


def measure_site_caps(coords_iter, grid_dhw: Tuple[int, int, int],
                      specs: Tuple[BlockSpec, ...], *,
                      safety: float = 1.15,
                      round_to: int = 128) -> Tuple[int, ...]:
    """Per-block output-site capacities measured over sample scans
    (iterable of [V, 3] (z, y, x) int voxel coords, -1-padded rows ok):
    the per-block max count, times ``safety``, rounded up to
    ``round_to``."""
    grid0 = tuple(int(g) for g in grid_dhw)
    maxes = [0] * len(specs)
    for coords in coords_iter:
        c = np.asarray(coords)
        grid = grid0
        for i, s in enumerate(specs):
            og = _out_grid(grid, s.pad, s.kernel, s.stride)
            c = strided_out_sites_np(c, grid, s.kernel, s.stride, s.pad, og)
            maxes[i] = max(maxes[i], len(c))
            grid = og
    return tuple(int(-(-int(m * safety) // round_to)) * round_to
                 for m in maxes)


def respec(plan: Tuple[BlockPlan, ...]) -> Tuple[Tuple[int, int, int],
                                                 Tuple[BlockSpec, ...]]:
    """Recover (input grid, BlockSpecs) from a capacity-annotated plan."""
    grid = plan[0].grid
    specs = tuple(
        BlockSpec(n_subm=b.n_subm, subm_cout=b.subm_cout, down_cout=b.cout,
                  kernel=b.kernel, stride=b.stride, pad=b.pad)
        for b in plan)
    return grid, specs


def legacy_specs(num_filters, layers_per_block, z_strides,
                 xy_strides) -> Tuple[BlockSpec, ...]:
    """The specs of the legacy-parameterized stack (uniform 3x3x3 kernels;
    subm channels == strided channels) that :func:`make_plan` plans."""
    return tuple(
        BlockSpec(n_subm=int(n), subm_cout=int(c), down_cout=int(c),
                  kernel=(3, 3, 3), stride=(int(zs), int(xys), int(xys)),
                  pad=(1, 1, 1))
        for c, n, zs, xys in zip(num_filters, layers_per_block,
                                 z_strides, xy_strides))


def make_plan(grid_dhw: Tuple[int, int, int], v_cap: int,
              num_filters, layers_per_block, z_strides, xy_strides,
              capacity_shrink: Optional[float] = None,
              min_capacity: int = 2048,
              out_caps: Optional[Sequence[int]] = None,
              ) -> Tuple[BlockPlan, ...]:
    """The legacy-parameterized conv plan for a SparseMiddle stack."""
    specs = legacy_specs(num_filters, layers_per_block, z_strides,
                         xy_strides)
    return plan_from_specs(grid_dhw, v_cap, specs, capacity_shrink,
                           min_capacity, out_caps)


# --------------------------------------------------------------------------
# rulebooks and sites
# --------------------------------------------------------------------------


class SubmanifoldRulebook(NamedTuple):
    gather_idx: torch.Tensor   # [..., K, N] input index per (offset, site)
    found: torch.Tensor        # [..., K, N] bool


class StridedSparseLayout(NamedTuple):
    out_coords: torch.Tensor   # [..., M, 3] (z,y,x), -1 padding
    out_valid: torch.Tensor    # [..., M]
    gather_idx: torch.Tensor   # [..., K, M] input index per (offset, output)
    found: torch.Tensor        # [..., K, M]
    num_out: torch.Tensor      # [...] int32


class StridedSites(NamedTuple):
    """Output-site set of a strided sparse conv, without tap rulebooks —
    all a key-match kernel needs (the join happens inside the kernel)."""
    out_coords: torch.Tensor   # [..., M, 3] (z, y, x); -1 pad
    out_valid: torch.Tensor    # [..., M] bool
    num_out: torch.Tensor      # [...] int32


def _merge_lookup(in_keys: torch.Tensor, q_keys: torch.Tensor):
    """For each query key, the row index of the matching in-key (keys
    unique among valid; INT32_MAX = invalid), for keys in any order.

    ``in_keys`` [..., N], ``q_keys`` [..., Q] -> (idx [..., Q] int32, hit
    [..., Q] bool); ``idx`` means something only where ``hit``."""
    N = in_keys.shape[-1]
    skeys, order = torch.sort(in_keys, dim=-1, stable=True)
    pos = torch.searchsorted(skeys.contiguous(), q_keys.contiguous())
    pos = pos.clamp_(max=N - 1)
    hit = (torch.gather(skeys, -1, pos) == q_keys) & (q_keys != INT32_MAX)
    return torch.gather(order, -1, pos).to(torch.int32), hit


def _tensor(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), dtype=torch.int32,
                           device=like.device)


def subm_tap_keys(coords: torch.Tensor, valid: torch.Tensor,
                  grid_dhw: Tuple[int, int, int],
                  kernel_size: Tuple[int, int, int] = (3, 3, 3)
                  ) -> torch.Tensor:
    """[..., K, N] per-tap neighbour query keys of a submanifold conv
    (INT32_MAX where there is no query): coords [..., N, 3], valid
    [..., N]."""
    offsets = _tensor(_offsets(kernel_size), coords)           # [K, 3]
    q = coords[..., None, :, :] + offsets[:, None, :]          # [..,K,N,3]
    return torch.where(valid[..., None, :], linearize(q, grid_dhw),
                       INT32_MAX).to(torch.int32)


def build_submanifold_rulebook_merge(
        coords: torch.Tensor, valid: torch.Tensor,
        grid_dhw: Tuple[int, int, int],
        kernel_size: Tuple[int, int, int] = (3, 3, 3)
) -> SubmanifoldRulebook:
    """coords [..., N, 3] (z,y,x), valid [..., N] -> neighbour table over
    the K offsets.  One key array serves every SubM layer of a block."""
    N = coords.shape[-2]
    in_keys = torch.where(valid, linearize(coords, grid_dhw), INT32_MAX)
    q = subm_tap_keys(coords, valid, grid_dhw, kernel_size)
    K = q.shape[-2]
    idx, hit = _merge_lookup(in_keys, q.flatten(-2))
    return SubmanifoldRulebook(idx.unflatten(-1, (K, N)),
                               hit.unflatten(-1, (K, N)))


def build_strided_sites(coords: torch.Tensor, valid: torch.Tensor,
                        grid_dhw: Tuple[int, int, int],
                        kernel_size: Tuple[int, int, int],
                        stride: Tuple[int, int, int],
                        padding: Tuple[int, int, int],
                        max_out: int) -> StridedSites:
    """Exact output-site construction of a strided conv (any site whose
    receptive field touches an active input), key sorted: each input's
    candidate output cells, one sort of the C*N candidate keys, dedup by
    compare-adjacent, truncation in key order at ``max_out``.

    Output site o (per dim) receives input i iff ``o*s + k - p == i`` for
    a tap k in [0, K): ``o*s`` in ``[i + p - k + 1, i + p]``, at most
    ceil(k/s) values from ``floor((i + p) / s)`` downwards."""
    out_grid = _out_grid(grid_dhw, padding, kernel_size, stride)
    sj = _tensor(stride, coords)
    pj = _tensor(padding, coords)
    kj = _tensor(kernel_size, coords)
    n_cand = [int(-(-kk // ss)) for kk, ss in zip(kernel_size, stride)]
    deltas = _tensor(np.stack(np.meshgrid(
        *[np.arange(c) for c in n_cand], indexing="ij"), -1).reshape(-1, 3),
        coords)                                                # [C, 3]

    c = coords[..., None, :, :]                                # [..,1,N,3]
    o = torch.div(c + pj, sj, rounding_mode="floor") - deltas[:, None, :]
    lo = c + pj - kj + 1
    ok = valid[..., None, :] & ((o * sj >= lo) & (o * sj <= c + pj)).all(-1)
    cand = torch.where(ok, linearize(o, out_grid), INT32_MAX)  # [..,C,N]
    skeys = torch.sort(cand.flatten(-2), dim=-1).values        # [.., C*N]
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[..., 1:] = skeys[..., 1:] != skeys[..., :-1]
    first &= skeys != INT32_MAX
    pos_out = torch.cumsum(first, dim=-1) - 1
    # the first max_out unique keys land at their rank; every other
    # candidate goes to the dump slot max_out, which is cut off
    slot = torch.where(first & (pos_out < max_out), pos_out, max_out)
    out_keys = torch.full(skeys.shape[:-1] + (max_out + 1,), INT32_MAX,
                          dtype=torch.int32, device=coords.device)
    out_keys.scatter_(-1, slot, skeys.to(torch.int32))
    out_keys = out_keys[..., :max_out]
    num_out = first.sum(-1).clamp(max=max_out).to(torch.int32)
    out_valid = (torch.arange(max_out, device=coords.device)
                 < num_out[..., None])
    oD, oW = out_grid[0], out_grid[2]
    oy = torch.div(out_keys, oW * oD, rounding_mode="floor")
    ox = torch.div(out_keys, oD, rounding_mode="floor") % oW
    oz = out_keys % oD
    out_coords = torch.where(out_valid[..., None],
                             torch.stack([oz, oy, ox], dim=-1),
                             -1).to(torch.int32)
    return StridedSites(out_coords, out_valid, num_out)


def strided_tap_keys(sites: StridedSites,
                     grid_in: Tuple[int, int, int],
                     kernel_size: Tuple[int, int, int],
                     stride: Tuple[int, int, int],
                     padding: Tuple[int, int, int]) -> torch.Tensor:
    """[..., T, M] per-tap input query keys of a strided conv's output
    sites (INT32_MAX where there is no query)."""
    oc = sites.out_coords
    sj = _tensor(stride, oc)
    pj = _tensor(padding, oc)
    taps = _tensor(conv_taps(kernel_size), oc)                 # [T, 3]
    icoords = oc[..., None, :, :] * sj + taps[:, None, :] - pj
    return torch.where(sites.out_valid[..., None, :],
                       linearize(icoords, grid_in),
                       INT32_MAX).to(torch.int32)


def build_strided_layout_merge(coords: torch.Tensor, valid: torch.Tensor,
                               grid_dhw: Tuple[int, int, int],
                               kernel_size: Tuple[int, int, int],
                               stride: Tuple[int, int, int],
                               padding: Tuple[int, int, int],
                               max_out: int) -> StridedSparseLayout:
    """Output sites (:func:`build_strided_sites`) + the tap rulebook from
    one :func:`_merge_lookup` over all T*max_out queries."""
    sites = build_strided_sites(coords, valid, grid_dhw, kernel_size,
                                stride, padding, max_out)
    q = strided_tap_keys(sites, grid_dhw, kernel_size, stride, padding)
    T = q.shape[-2]
    in_keys = torch.where(valid, linearize(coords, grid_dhw), INT32_MAX)
    idx, hit = _merge_lookup(in_keys, q.flatten(-2))
    return StridedSparseLayout(sites.out_coords, sites.out_valid,
                               idx.unflatten(-1, (T, max_out)),
                               hit.unflatten(-1, (T, max_out)),
                               sites.num_out)


# --------------------------------------------------------------------------
# plain convolutions
# --------------------------------------------------------------------------


def gathered_matmul(features: torch.Tensor, gather_idx: torch.Tensor,
                    found: torch.Tensor, weights: torch.Tensor
                    ) -> torch.Tensor:
    """``out[r] = sum_k found[k, r] * features[idx[k, r]] @ W[k]`` as one
    masked gather into [R, K*Cin] and one matmul: features [..., N, Cin],
    idx/found [..., K, R], weights [K, Cin, Cout] -> [..., R, Cout]
    float32 (float64 for float64 features)."""
    K, Cin, Cout = weights.shape
    R = gather_idx.shape[-1]
    lead = features.shape[:-2]
    idx = gather_idx.long().flatten(-2)                        # [.., K*R]
    g = torch.gather(features, -2, idx[..., None].expand(*lead, K * R, Cin))
    g = torch.where(found[..., None], g.unflatten(-2, (K, R)), 0.0)
    g = g.transpose(-3, -2).reshape(*lead, R, K * Cin)
    out = g @ weights.reshape(K * Cin, Cout).to(g.dtype)
    return out.to(torch.promote_types(out.dtype, torch.float32))


def submanifold_conv(features: torch.Tensor, rulebook: SubmanifoldRulebook,
                     weights: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """features [..., N, Cin], weights [K, Cin, Cout] -> [..., N, Cout]."""
    out = gathered_matmul(features, rulebook.gather_idx, rulebook.found,
                          weights)
    if bias is not None:
        out = out + bias
    if valid is not None:
        out = torch.where(valid[..., None], out, 0.0)
    return out.to(features.dtype)


def strided_sparse_conv(features: torch.Tensor, layout: StridedSparseLayout,
                        weights: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """features [..., N, Cin], weights [T, Cin, Cout] -> [..., M, Cout]."""
    out = gathered_matmul(features, layout.gather_idx, layout.found, weights)
    if bias is not None:
        out = out + bias
    out = torch.where(layout.out_valid[..., None], out, 0.0)
    return out.to(features.dtype)


def densify(features: torch.Tensor, coords: torch.Tensor,
            valid: torch.Tensor, grid_dhw: Tuple[int, int, int]
            ) -> torch.Tensor:
    """[..., N, C] sparse -> [..., D, H, W, C] dense; invalid rows are
    dropped and empty cells are 0."""
    D, H, W = grid_dhw
    C = features.shape[-1]
    lead = features.shape[:-2]
    cells = D * H * W
    c = coords.long()
    lin = (c[..., 0] * H + c[..., 1]) * W + c[..., 2]
    lin = torch.where(valid, lin, cells)
    dense = torch.zeros(lead + (cells + 1, C), dtype=features.dtype,
                        device=features.device)
    dense.scatter_(-2, lin[..., None].expand(*lead, lin.shape[-1], C),
                   torch.where(valid[..., None], features, 0.0))
    return dense[..., :cells, :].reshape(*lead, D, H, W, C)


def scatter_to_bev(features: torch.Tensor, coords: torch.Tensor,
                   valid: torch.Tensor, grid_dhw: Tuple[int, int, int]
                   ) -> torch.Tensor:
    """[..., N, C] sparse -> dense BEV [..., H, W, D*C]: depth folded into
    channels, depth-major then channel (channel ``d*C + c``)."""
    dense = densify(features, coords, valid, grid_dhw)     # [.., D,H,W,C]
    D, H, W, C = dense.shape[-4:]
    return dense.movedim(-4, -2).reshape(*dense.shape[:-4], H, W, D * C)


def conv3d_weight(weights: torch.Tensor,
                  kernel_size: Tuple[int, int, int]) -> torch.Tensor:
    """Sparse weight layout [T, Cin, Cout] -> ``conv3d``'s
    [Cout, Cin, kz, ky, kx]."""
    kz, ky, kx = kernel_size
    return weights.reshape(kz, ky, kx, weights.shape[1],
                           weights.shape[2]).permute(4, 3, 0, 1, 2)


def dense_conv3d(dense: torch.Tensor, weights: torch.Tensor, kernel_size,
                 stride=(1, 1, 1), padding=None) -> torch.Tensor:
    """Dense 3D conv on [D, H, W, Cin] with the sparse weight layout
    [T, Cin, Cout] -> [D', H', W', Cout] (the parity oracle)."""
    kz, ky, kx = kernel_size
    if padding is None:
        padding = (kz // 2, ky // 2, kx // 2)
    out = torch.nn.functional.conv3d(
        dense.permute(3, 0, 1, 2)[None], conv3d_weight(weights, kernel_size),
        stride=tuple(stride), padding=tuple(padding))
    return out[0].permute(1, 2, 3, 0)
