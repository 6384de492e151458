"""The sparse 3D middle extractor: voxel features -> dense BEV map.

The port of the JAX package's ``models/middle.py``: ``scatter_to_dense``,
``MaskedBatchNorm`` and ``SparseMiddle`` (the SpMiddleFHD-equivalent
stack) in its three modes —

- key-match (``use_keymatch`` and ``use_pallas_gemm``): no rulebooks; the
  :func:`~..ops.sparse_gather_gemm.keymatch_gemm` kernel joins each tap's
  query keys with the sorted input keys;
- gather-GEMM (``use_pallas_gemm``): merge-built rulebooks through the
  :func:`~..ops.sparse_gather_gemm.gather_gemm` kernel;
- plain: merge-built rulebooks through ``ops.sparse_conv``'s plain convs;

and the dense tail (``dense_tail_blocks``: the last N blocks as masked
dense ``conv3d``).  Parameter names follow the lineage torch net: the
n-th conv of the stack is ``middle_conv.{3n}.weight`` in the spconv 1.x
layout ``(kz, ky, kx, Cin, Cout)``, its BatchNorm ``middle_conv.{3n+1}``
— the names ``utils/weight_import.py`` emits.  Host rulebooks
(``rulebooks=``) and ``DenseMiddle`` are not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops import sparse_conv as sc
from ..ops.sparse_gather_gemm import gather_gemm, group_perm, keymatch_gemm
from .pointpillars import BN_EPS, BN_MOMENTUM


def scatter_to_dense(voxel_features: torch.Tensor, coords: torch.Tensor,
                     grid_dhw: Tuple[int, int, int]) -> torch.Tensor:
    """[B,V,F] + [B,V,3] (z,y,x; -1 pad) -> dense [B, D, H, W, F]."""
    return sc.densify(voxel_features, coords, coords[..., 0] >= 0, grid_dhw)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over sparse rows [B, N, C] with a validity mask.

    In training the statistics are taken over valid rows only and the
    running ones move by ``momentum`` (torch's convention: 0.01 is flax's
    0.99); the running variance is the biased masked one, as in the JAX
    package.  In eval the running statistics normalise.  Rows outside the
    mask come out exactly 0."""

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
            cnt = m.sum().clamp_min(1.0)
            mean = (x * m).sum(dim=(0, 1)) / cnt
            var = (torch.square(x - mean) * m).sum(dim=(0, 1)) / cnt
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = ((x - mean) * torch.rsqrt(var + self.eps) * self.weight
             + self.bias)
        return torch.where(mask[..., None], y, 0.0).to(in_dtype)


class SparseConvWeight(nn.Module):
    """The weight of one sparse conv, held as spconv 1.x holds it:
    ``(kz, ky, kx, Cin, Cout)``; :meth:`taps` gives ``[K, Cin, Cout]``.
    Kaiming-style init over fan_in = K * Cin, truncated at two sigma."""

    def __init__(self, kernel: Tuple[int, int, int], cin: int, cout: int):
        super().__init__()
        self.kernel = tuple(int(k) for k in kernel)
        w = torch.empty(*self.kernel, cin, cout)
        std = (2.0 / (int(np.prod(self.kernel)) * cin)) ** 0.5
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)
        self.weight = nn.Parameter(w)

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
    0.
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
                 dense_tail_blocks: int = 0):
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
            out = keymatch_gemm(feats, in_keys, q_keys, w, None,
                                self.pallas_tile, window, True, subwindow,
                                group)
        elif self.use_pallas_gemm:
            out = gather_gemm(feats, rulebook.gather_idx, rulebook.found, w,
                              None, self.pallas_tile, window)
        else:
            out = sc.gathered_matmul(feats, rulebook.gather_idx,
                                     rulebook.found, w)
        return torch.where(valid[..., None], out, 0.0)

    def forward(self, voxel_features: torch.Tensor, coords: torch.Tensor,
                rulebooks=None) -> torch.Tensor:
        """[B, V, F] + [B, V, 3] (z,y,x; -1 pad; key order for the
        key-match mode) -> NCHW BEV map [B, D'*C, H', W'], channel
        ``d*C + c``: a permuted view of the JAX layout [B, H', W', D'*C].
        """
        if rulebooks is not None:
            raise NotImplementedError("host-built rulebooks are not ported")
        feats = voxel_features.to(torch.promote_types(voxel_features.dtype,
                                                      torch.float32))
        cur_coords = coords
        valid = coords[..., 0] >= 0
        use_km = self.use_keymatch and self.use_pallas_gemm
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
            if use_km:
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
            y = F.conv3d(x.permute(0, 4, 1, 2, 3),
                         sc.conv3d_weight(w, kernel).to(x.dtype),
                         stride=tuple(stride), padding=tuple(pad))
            return y.permute(0, 2, 3, 4, 1)

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
        mask = (F.max_pool3d(mask.permute(0, 4, 1, 2, 3), tuple(blk.kernel),
                             tuple(blk.stride), tuple(blk.pad))
                > 0).to(x.dtype).permute(0, 2, 3, 4, 1)
        return bn_relu(x, mask), mask
