"""The sparse 3D middle extractor: voxel features -> dense BEV map.

The port of the JAX package's ``models/middle.py``: ``scatter_to_dense``,
``MaskedBatchNorm`` and ``SparseMiddle`` (the SpMiddleFHD-equivalent
stack) in its three modes —

- key-match (``use_keymatch`` and ``use_pallas_gemm``): no rulebooks; the
  :func:`~..ops.sparse_gather_gemm.keymatch_gemm` kernel joins each tap's
  query keys with the sorted input keys;
- gather-GEMM (``use_pallas_gemm``): rulebooks through the
  :func:`~..ops.sparse_gather_gemm.gather_gemm` kernel;
- plain: rulebooks through ``ops.sparse_conv``'s plain convs;

the rulebooks of the last two merge-built on the device, or built on the
host by the input pipeline (``rulebooks=``, ``ops/rulebook_host.py``),
and the dense tail (``dense_tail_blocks``: the last N blocks as masked
dense ``conv3d``).  ``dtype=torch.bfloat16`` computes as the JAX
module's ``dtype=jnp.bfloat16``: features in bfloat16, each join of
bfloat16 features and weights into float32 and back, BatchNorm in
float32.  Parameter names follow the lineage torch net: the
n-th conv of the stack is ``middle_conv.{3n}.weight`` in the spconv 1.x
layout ``(kz, ky, kx, Cin, Cout)``, its BatchNorm ``middle_conv.{3n+1}``
— the names ``utils/weight_import.py`` emits.

``DenseMiddle`` (the VoxelNet paper's dense 3-D convolution middle)
scatters the voxel features into a dense ``[B, D, H, W, C]`` canvas
through the pillar-scatter kernel (K1 at ``hw = D * H * W``; its gradient
is K1's gather kernel) and runs cuDNN ``conv3d`` on it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops import sparse_conv as sc
from ..ops.pillar_scatter import scatter_sorted_to_canvas
from ..ops.sparse_gather_gemm import gather_gemm, group_perm, keymatch_gemm
from .pointpillars import (BN_EPS, BN_MOMENTUM, FlaxBatchNorm3d,
                           all_reduce_sum)


def scatter_to_dense(voxel_features: torch.Tensor, coords: torch.Tensor,
                     grid_dhw: Tuple[int, int, int]) -> torch.Tensor:
    """[B,V,F] + [B,V,3] (z,y,x; -1 pad) -> dense [B, D, H, W, F]."""
    return sc.densify(voxel_features, coords, coords[..., 0] >= 0, grid_dhw)


def dense_canvas(voxel_features: torch.Tensor, coords: torch.Tensor,
                 grid_dhw: Tuple[int, int, int]) -> torch.Tensor:
    """:func:`scatter_to_dense` through the pillar-scatter kernel: [B,V,F]
    + [B,V,3] (z,y,x; -1 pad) -> NCDHW [B, F, D, H, W] with
    ``channels_last_3d`` strides (a view of the kernel's [B, D*H*W, F]
    canvas, no copy).  Padded voxels get the id D*H*W, which the kernel
    drops; the other ids are unique, as hard voxelization makes them."""
    B, V, nf = voxel_features.shape
    D, H, W = grid_dhw
    lin = ((coords[..., 0] * H + coords[..., 1]) * W + coords[..., 2])
    lin = torch.where(coords[..., 0] >= 0, lin, D * H * W).to(torch.int32)
    canvas = scatter_sorted_to_canvas(voxel_features.contiguous(), lin,
                                      D * H * W)
    return canvas.view(B, D, H, W, nf).permute(0, 4, 1, 2, 3)


def _dense_out(n: int, stride: int) -> int:
    """Output length of a 3-wide, 1-padded convolution of ``stride``."""
    return (n - 1) // stride + 1


class DenseMiddle(nn.Module):
    """Dense 3-D convolution middle (the JAX package's ``DenseMiddle``):
    per block ``layers_per_block`` stride-1 3x3x3 convolutions, then one
    strided one (z by ``z_strides``, y and x by ``xy_strides``), each with
    BatchNorm over every dense site (empty ones included) and ReLU.  The
    output puts depth outside the channels, [B, D' * C, H', W'] (channel
    ``d * C + c``, as the JAX module's ``[B, H, W, D, C]`` reshape), with
    channels-last strides.  The n-th convolution is ``middle_conv.{3n}``,
    its BatchNorm ``middle_conv.{3n + 1}``."""

    def __init__(self, grid_dhw: Tuple[int, int, int],
                 num_input_features: int = 4,
                 num_filters: Sequence[int] = (16, 32, 64),
                 layers_per_block: Sequence[int] = (2, 2, 2),
                 z_strides: Sequence[int] = (2, 2, 2),
                 xy_strides: Sequence[int] = (1, 1, 2)):
        super().__init__()
        self.grid_dhw = tuple(int(g) for g in grid_dhw)
        mods = []
        cin, depth = num_input_features, self.grid_dhw[0]
        for f, n, zs, xys in zip(num_filters, layers_per_block, z_strides,
                                 xy_strides):
            for stride in [(1, 1, 1)] * n + [(zs, xys, xys)]:
                mods += [nn.Conv3d(cin, f, 3, stride=stride, padding=1,
                                   bias=False),
                         FlaxBatchNorm3d(f, eps=BN_EPS,
                                         momentum=BN_MOMENTUM),
                         nn.ReLU()]
                cin = f
            depth = _dense_out(depth, zs)
        self.middle_conv = nn.Sequential(*mods)
        self.out_channels = cin * depth

    def forward(self, voxel_features: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        x = self.middle_conv(dense_canvas(voxel_features, coords,
                                          self.grid_dhw))
        B, C, D, H, W = x.shape
        x = x.permute(0, 3, 4, 2, 1).reshape(B, H, W, D * C)
        return x.permute(0, 3, 1, 2)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over sparse rows [B, N, C] with a validity mask.

    In training the statistics are taken over valid rows only and the
    running ones move by ``momentum`` (torch's convention: 0.01 is flax's
    0.99); the running variance is the biased masked one, as in the JAX
    package.  In eval the running statistics normalise.  Rows outside the
    mask come out exactly 0.  A bfloat16 input is normalised in float32
    and cast back; the statistics stay float32.  With ``stats_group`` set
    (data-parallel training) the masked sums and the valid-row count,
    then the masked sums of the centred squares, are summed over the
    group's ranks by a differentiable all-reduce: the statistics of the
    global batch."""

    stats_group = None

    def __init__(self, num_features: int, momentum: float = BN_MOMENTUM,
                 eps: float = BN_EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        # statistics and normalisation in fp32 (fp64 stays fp64)
        x = x.to(torch.promote_types(in_dtype, torch.float32))
        if self.training:
            m = mask[..., None].to(x.dtype)
            if self.stats_group is None:
                cnt = m.sum().clamp_min(1.0)
                mean = (x * m).sum(dim=(0, 1)) / cnt
                var = (torch.square(x - mean) * m).sum(dim=(0, 1)) / cnt
            else:
                s = all_reduce_sum(torch.cat([(x * m).sum(dim=(0, 1)),
                                              m.sum().reshape(1)]),
                                   self.stats_group)
                cnt = s[-1].clamp_min(1.0)
                mean = s[:-1] / cnt
                var = all_reduce_sum(
                    (torch.square(x - mean) * m).sum(dim=(0, 1)),
                    self.stats_group) / cnt
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = ((x - mean) * torch.rsqrt(var + self.eps) * self.weight
             + self.bias)
        return torch.where(mask[..., None], y, 0.0).to(in_dtype)


def trunc_normal(shape, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """A unit normal truncated to [-2, 2] of ``shape``, float32, by its
    inverse CDF: a uniform draw between the bounds' CDF values, one an
    element, through ``erfinv``.  (torch's ``nn.init.trunc_normal_``
    redraws the elements outside the bounds, pass after pass over the
    whole tensor: about 10x slower on a sparse conv's kernel.)"""
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    u = torch.empty(shape).uniform_(lo, hi, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


class SparseConvWeight(nn.Module):
    """The weight of one sparse conv, held as spconv 1.x holds it:
    ``(kz, ky, kx, Cin, Cout)``; :meth:`taps` gives ``[K, Cin, Cout]``.
    Kaiming-style init over fan_in = K * Cin, truncated at two sigma."""

    def __init__(self, kernel: Tuple[int, int, int], cin: int, cout: int):
        super().__init__()
        self.kernel = tuple(int(k) for k in kernel)
        std = (2.0 / (int(np.prod(self.kernel)) * cin)) ** 0.5
        self.weight = nn.Parameter(
            trunc_normal((*self.kernel, cin, cout)) * std)

    def taps(self) -> torch.Tensor:
        return self.weight.reshape(-1, *self.weight.shape[3:])


def _per_join(val, bi: int, mult: int) -> Tuple[int, int]:
    """A window setting (int, per-block tuple, or per-block (subm,
    strided) pairs) -> this block's (subm, strided) values."""
    v = val[bi] if isinstance(val, (tuple, list)) else val
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v) * mult


class SparseMiddle(nn.Module):
    """Sparse 3D middle extractor — SpMiddleFHD-equivalent stack.

    Per block: ``n_subm`` submanifold convs (one shared set of keys or
    rulebook) then one strided SparseConv, each followed by masked BN and
    ReLU; after the last block the remaining active sites are scattered to
    a dense BEV map with depth folded into channels.

    ``pallas_tile``, ``pallas_window``, ``keymatch_subwindow`` and
    ``keymatch_group`` are the TPU kernels' tuning, read from the config
    and handed to the GEMM functions as the JAX package hands them; they
    change no result (``keymatch_group`` permutes taps and weights alike).
    After a forward pass ``capacity_saturated`` holds, per block, how many
    scans filled the block's static site capacity (sites beyond it are
    truncated in key order); dense-tail blocks have no capacity and count
    0.  ``dtype``: the compute type of the features (float32, or bfloat16
    as ``car.fhd.mixed`` runs it); float64 inputs stay float64.
    """

    def __init__(self, grid_dhw: Tuple[int, int, int],
                 num_input_features: int = 4,
                 num_filters: Sequence[int] = (16, 32, 64),
                 layers_per_block: Sequence[int] = (2, 2, 2),
                 z_strides: Sequence[int] = (2, 2, 2),
                 xy_strides: Sequence[int] = (1, 1, 2),
                 blocks: Optional[Tuple[Tuple, ...]] = None,
                 capacity_shrink: Optional[float] = None,
                 out_caps: Optional[Tuple[int, ...]] = None,
                 min_capacity: int = 2048,
                 use_pallas_gemm: bool = False, pallas_tile: int = 256,
                 pallas_window=768, keymatch_subwindow=0,
                 keymatch_group: bool = False, use_keymatch: bool = False,
                 dense_tail_blocks: int = 0, dtype=torch.float32):
        super().__init__()
        self.grid_dhw = tuple(int(g) for g in grid_dhw)
        self.specs = (tuple(sc.BlockSpec(*b) for b in blocks)
                      if blocks is not None else
                      sc.legacy_specs(num_filters, layers_per_block,
                                      z_strides, xy_strides))
        self.capacity_shrink = capacity_shrink
        self.out_caps = out_caps
        self.min_capacity = min_capacity
        self.use_pallas_gemm = use_pallas_gemm
        self.pallas_tile = pallas_tile
        self.pallas_window = pallas_window
        self.keymatch_subwindow = keymatch_subwindow
        self.keymatch_group = keymatch_group
        self.use_keymatch = use_keymatch
        self.dense_tail_blocks = int(dense_tail_blocks)
        self.dtype = dtype
        self.capacity_saturated: Dict[str, torch.Tensor] = {}

        # lineage Sequential: conv at 3n, BN at 3n + 1, ReLU at 3n + 2
        mods, cin = [], int(num_input_features)
        for blk in self.plan(1):
            for _ in range(blk.n_subm):
                mods += [SparseConvWeight(blk.subm_kernel, cin,
                                          blk.subm_channels),
                         MaskedBatchNorm(blk.subm_channels), nn.ReLU()]
                cin = blk.subm_channels
            mods += [SparseConvWeight(blk.kernel, cin, blk.cout),
                     MaskedBatchNorm(blk.cout), nn.ReLU()]
            cin = blk.cout
        self.middle_conv = nn.ModuleList(mods)

    def plan(self, v_cap: int) -> Tuple[sc.BlockPlan, ...]:
        return sc.plan_from_specs(self.grid_dhw, v_cap, self.specs,
                                  self.capacity_shrink, self.min_capacity,
                                  self.out_caps)

    @property
    def out_channels(self) -> int:
        """Channels of the BEV map: last block's cout * remaining depth."""
        last = self.plan(1)[-1]
        return last.cout * last.out_grid[0]

    def _conv(self, feats, w, valid, km, rulebook, window, subwindow,
              group):
        """One sparse conv in this module's mode, masked to ``valid``.
        ``km``: (input keys, query keys, the tap permutation applied to
        the query keys or None) in key-match mode, else None."""
        if km is not None:
            in_keys, q_keys, perm = km
            if perm is not None:
                w = w[perm]
            # the weights in the features' type, as the JAX package's
            # _keymatch_impl casts them (bfloat16 under mixed precision)
            out = keymatch_gemm(feats, in_keys, q_keys, w.to(feats.dtype),
                                None, self.pallas_tile, window, True,
                                subwindow, group)
        elif self.use_pallas_gemm:
            out = gather_gemm(feats, rulebook.gather_idx, rulebook.found,
                              w.to(feats.dtype), None, self.pallas_tile,
                              window)
        else:
            out = sc.gathered_matmul(feats, rulebook.gather_idx,
                                     rulebook.found, w.to(feats.dtype))
        # the joins give float32 (float64): back to the features' type
        return torch.where(valid[..., None], out, 0.0).to(feats.dtype)

    def forward(self, voxel_features: torch.Tensor, coords: torch.Tensor,
                rulebooks=None) -> torch.Tensor:
        """[B, V, F] + [B, V, 3] (z,y,x; -1 pad; key order for the
        key-match mode) -> NCHW BEV map [B, D'*C, H', W'], channel
        ``d*C + c``: a permuted view of the JAX layout [B, H', W', D'*C].
        ``rulebooks``: per-block (SubmanifoldRulebook, StridedSparseLayout)
        pairs built on the host (``ops/rulebook_host.py::unflatten``), one
        per sparse block, which every mode then joins with; without them
        the key-match mode joins keys and the others merge rulebooks on
        the device.
        """
        if self.dtype == torch.bfloat16:
            feats = voxel_features.to(torch.bfloat16)
        else:
            feats = voxel_features.to(torch.promote_types(
                voxel_features.dtype, torch.float32))
        cur_coords = coords
        valid = coords[..., 0] >= 0
        use_km = (self.use_keymatch and self.use_pallas_gemm
                  and rulebooks is None)
        plan = self.plan(coords.shape[1])
        dense_from = (len(plan) - self.dense_tail_blocks
                      if self.dense_tail_blocks > 0 else len(plan))
        convs = iter(self.middle_conv)
        x = mask = None   # dense-tail carriers
        self.capacity_saturated = {}

        def bn_relu(feats, valid):
            bn, relu = next(convs), next(convs)
            return relu(bn(feats, valid))     # masked rows stay exactly 0

        for bi, blk in enumerate(plan):
            if bi >= dense_from:
                if x is None:   # transition: scatter sparse -> dense once
                    x = scatter_to_dense(feats, cur_coords, blk.grid)
                    mask = scatter_to_dense(
                        valid[..., None].to(feats.dtype), cur_coords,
                        blk.grid)
                x, mask = self._dense_block(x, mask, blk, convs)
                self.capacity_saturated[f"b{bi}"] = torch.zeros(
                    (), dtype=torch.int32, device=feats.device)
                continue
            xy_area = int(blk.stride[1] * blk.stride[2])
            win_b, win_str = _per_join(self.pallas_window, bi, xy_area)
            sub_b, sub_str = _per_join(self.keymatch_subwindow, bi, xy_area)
            # grouped-tap mode: group size = the kernel's z extent; the
            # tap permutation goes on query keys and weights alike
            g_subm = (int(blk.subm_kernel[0])
                      if self.keymatch_group and sub_b else 1)
            g_str = (int(blk.kernel[0])
                     if self.keymatch_group and sub_str else 1)
            perm_subm = (torch.as_tensor(group_perm(blk.subm_kernel),
                                         device=feats.device)
                         if g_subm > 1 else None)
            perm_str = (torch.as_tensor(group_perm(blk.kernel),
                                        device=feats.device)
                        if g_str > 1 else None)
            rb = layout = km_subm = km_str = None
            if rulebooks is not None:
                rb, layout = rulebooks[bi]
                sites = layout
                if tuple(layout.out_valid.shape) != (*coords.shape[:-2],
                                                     blk.out_cap):
                    raise ValueError(
                        f"block {bi}: host rulebooks of "
                        f"{tuple(layout.out_valid.shape)} output sites, the "
                        f"plan's capacity is {blk.out_cap}")
            elif use_km:
                # linearize maps padding (-1 coords) to INT32_MAX: a row
                # with no key, a query that matches nothing
                in_keys = sc.linearize(cur_coords, blk.grid)
                if blk.n_subm > 0:
                    qk = sc.subm_tap_keys(cur_coords, valid, blk.grid,
                                          blk.subm_kernel)
                    if perm_subm is not None:
                        qk = qk[:, perm_subm]
                    km_subm = (in_keys, qk, perm_subm)
                sites = sc.build_strided_sites(
                    cur_coords, valid, blk.grid, blk.kernel, blk.stride,
                    blk.pad, blk.out_cap)
                qk = sc.strided_tap_keys(sites, blk.grid, blk.kernel,
                                         blk.stride, blk.pad)
                if perm_str is not None:
                    qk = qk[:, perm_str]
                km_str = (in_keys, qk, perm_str)
            else:
                if blk.n_subm > 0:
                    rb = sc.build_submanifold_rulebook_merge(
                        cur_coords, valid, blk.grid, blk.subm_kernel)
                sites = layout = sc.build_strided_layout_merge(
                    cur_coords, valid, blk.grid, blk.kernel, blk.stride,
                    blk.pad, blk.out_cap)
            for _ in range(blk.n_subm):
                feats = self._conv(feats, next(convs).taps(), valid,
                                   km_subm, rb, win_b, sub_b, g_subm)
                feats = bn_relu(feats, valid)
            feats = self._conv(feats, next(convs).taps(), sites.out_valid,
                               km_str, layout,
                               win_str if use_km else win_b, sub_str, g_str)
            # overflow telemetry: a block whose active-site count hit its
            # static capacity has (almost surely) truncated real sites
            self.capacity_saturated[f"b{bi}"] = (
                sites.num_out >= blk.out_cap).sum().to(torch.int32)
            cur_coords, valid = sites.out_coords, sites.out_valid
            feats = bn_relu(feats, valid)
            final_grid = blk.out_grid

        if x is not None:   # dense tail: the grid is the BEV source
            B, D, H, W, C = x.shape
            bev = x.permute(0, 2, 3, 1, 4).reshape(B, H, W, D * C)
        else:
            bev = sc.scatter_to_bev(feats, cur_coords, valid, final_grid)
        return bev.permute(0, 3, 1, 2)

    def _dense_block(self, x, mask, blk, convs):
        """One middle block on the dense [B, D, H, W, C] carrier.

        Exact sparse semantics: inactive cells are zero, every conv
        output is re-masked to the active set, and the strided conv's
        output mask is the dilation of the input mask by the kernel
        footprint (= the sparse builders' output sites, minus their
        static capacity truncation; ``max_pool3d`` pads with -inf, which
        on a 0/1 mask equals a window maximum that starts from 0).  The
        convolutions are plain ``conv3d``, as they are plain XLA
        convolutions in the JAX package."""

        def conv(x, w, kernel, stride, pad):
            # bfloat16 (the JAX module's preferred_element_type): float32
            # products of the bfloat16 values, cast back
            ct = torch.promote_types(x.dtype, torch.float32)
            y = F.conv3d(x.permute(0, 4, 1, 2, 3).to(ct),
                         sc.conv3d_weight(w, kernel).to(x.dtype).to(ct),
                         stride=tuple(stride), padding=tuple(pad))
            return y.permute(0, 2, 3, 4, 1).to(x.dtype)

        def bn_relu(x, mask):
            bn, relu = next(convs), next(convs)
            B, C = x.shape[0], x.shape[-1]
            flat = bn(x.reshape(B, -1, C), mask.reshape(B, -1) > 0)
            return relu(flat.reshape(x.shape))

        for _ in range(blk.n_subm):
            x = conv(x, next(convs).taps(), blk.subm_kernel, (1, 1, 1),
                     [k // 2 for k in blk.subm_kernel])
            x = bn_relu(x, mask)
        x = conv(x, next(convs).taps(), blk.kernel, blk.stride, blk.pad)
        # output sites = any active input in the receptive field
        mask = (F.max_pool3d(
            mask.permute(0, 4, 1, 2, 3).to(torch.promote_types(
                mask.dtype, torch.float32)), tuple(blk.kernel),
            tuple(blk.stride), tuple(blk.pad))
                > 0).to(x.dtype).permute(0, 2, 3, 4, 1)
        return bn_relu(x, mask), mask
