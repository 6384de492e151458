"""PointPillars: pillar feature net + scatter-to-canvas middle stage.

The port of the JAX package's ``models/pointpillars.py``: the padded path
and the flat (point-major) path in its segment-ops form.
Module and parameter names follow the lineage torch net
(``pfn_layers.{i}.linear`` / ``.norm``), so weights converted by
``utils/weight_import.py`` load with ``strict=True``.  The BatchNorms
update their statistics in training as flax's do
(:class:`FlaxBatchNorm1d`), and the pillar max splits its gradient among
tied points as ``jnp.max`` does (``torch.amax``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.pillar_scatter import scatter_sorted_to_canvas
from .voxel_encoder import points_mask

# flax BatchNorm(momentum=0.99, epsilon=1e-3) in torch terms
BN_EPS = 1e-3
BN_MOMENTUM = 0.01


class _FlaxBatchNorm:
    """Training-mode BatchNorm with flax's ``nn.BatchNorm(momentum=0.99,
    epsilon=1e-3)`` update: normalise with the batch mean and biased
    variance, and move the running statistics by 0.01 of the batch mean
    and of that BIASED variance (torch's own update takes the unbiased
    one).  Eval mode is torch's.

    The batch statistics are written out in the two-pass form (centre,
    then the mean square of the centred values), not ``F.batch_norm``
    and not flax's ``E[x^2] - E[x]^2``: PyTorch's fused CPU kernel sums a
    channels-last input's squares imprecisely (0.5 % off in the variance
    of the PFN's 1.2 M rows, 95 % of them padding), and autograd through
    the one-pass formula cancels large terms in the backward; the centred
    form is what a fused kernel's backward computes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = x.mean(dims, keepdim=True)
        xc = x - mean
        var = (xc * xc).mean(dims, keepdim=True)
        with torch.no_grad():
            self.running_mean.mul_(1 - BN_MOMENTUM).add_(
                mean.reshape(-1), alpha=BN_MOMENTUM)
            self.running_var.mul_(1 - BN_MOMENTUM).add_(
                var.reshape(-1), alpha=BN_MOMENTUM)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        return xc * mul + self.bias.view(shape)


class FlaxBatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class PFNLayer(nn.Module):
    """Pillar feature net layer: Linear + BN + ReLU (+ max-pool if last)."""

    def __init__(self, in_channels: int, units: int, last_layer: bool):
        super().__init__()
        self.last_layer = last_layer
        self.linear = nn.Linear(in_channels, units, bias=False)
        self.norm = FlaxBatchNorm1d(units, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, inputs: torch.Tensor, mask: torch.Tensor):
        x = self.linear(inputs)
        shape = x.shape
        # BN over every [B, V, T] slot, padded ones included, as the
        # reference's unmasked BatchNorm does
        x = self.norm(x.reshape(-1, shape[-1])).reshape(shape)
        x = torch.relu(x) * mask
        x_max = torch.amax(x, dim=2, keepdim=True)
        if self.last_layer:
            return x_max[:, :, 0, :]  # [B, V, units]
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarFeatureNet(nn.Module):
    """Decorate points (cluster offset + pillar-centre offset), run PFN
    layers, max-pool to one feature per pillar.

    Decorations: [x, y, z, r, xc, yc, zc, xp, yp].
    """

    def __init__(self, num_input_features: int = 4,
                 num_filters: Sequence[int] = (64,),
                 voxel_size: Tuple[float, float] = (0.2, 0.2),
                 pc_range: Tuple[float, float] = (0.0, -40.0)):
        super().__init__()
        self.num_input_features = num_input_features
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(pc_range)
        in_ch = num_input_features + 5
        layers = []
        for i, units in enumerate(num_filters):
            last = i == len(num_filters) - 1
            layers.append(PFNLayer(in_ch, units, last))
            in_ch = units * 2
        self.pfn_layers = nn.ModuleList(layers)

    def forward(self, voxels, num_points: torch.Tensor,
                coords: torch.Tensor, *, flat_points=None,
                flat_slot=None) -> torch.Tensor:
        """voxels [B,V,T,C], num_points [B,V], coords [B,V,3] (z,y,x)
        -> [B, V, F].

        Flat mode (``flat_points`` [B,P,C] + ``flat_slot`` [B,P] from
        ``ops.voxelize.voxelize_flat``; ``voxels`` may be None): the same
        math on the point-major layout, each point decorated against its
        own pillar's mean and centre, one PFN layer, then a max per
        pillar.  Equal to the padded path in eval mode: ReLU makes padded
        zero rows neutral under the max.  Single-layer configs only.
        """
        if flat_points is not None:
            if len(self.pfn_layers) != 1:
                raise NotImplementedError(
                    "flat PFN mode supports a single PFN layer")
            return self._flat(flat_points, flat_slot, num_points, coords)
        B, V, T, C = voxels.shape
        mask = points_mask(num_points, T, voxels.dtype)
        denom = torch.clamp_min(num_points[..., None, None], 1).to(
            voxels.dtype)
        points_mean = (voxels[..., :3] * mask).sum(2, keepdim=True) / denom
        f_cluster = voxels[..., :3] - points_mean

        vx, vy = self.voxel_size
        x0, y0 = self.pc_range
        px = coords[..., 2].to(voxels.dtype) * vx + (vx / 2 + x0)
        py = coords[..., 1].to(voxels.dtype) * vy + (vy / 2 + y0)
        f_center = torch.stack(
            [voxels[..., 0] - px[..., None], voxels[..., 1] - py[..., None]],
            dim=-1)

        raw = voxels[..., : self.num_input_features]
        x = torch.cat([raw, f_cluster, f_center], dim=-1) * mask
        for layer in self.pfn_layers:
            x = layer(x, mask)
        return x


    def _flat(self, points, slot, num_points, coords) -> torch.Tensor:
        """points [B,P,C], slot [B,P] (V = invalid; in any order)
        -> [B, V, F].  Rows with ``slot == V`` fall into a dump row."""
        B, P, C = points.shape
        V = coords.shape[1]
        dt = points.dtype
        pvalid = slot < V
        dump = slot.long().clamp(max=V)                   # [B, P] in [0, V]
        slot_c = slot.long().clamp(max=V - 1)
        # each pillar's points added one after another in their order in
        # the buffer (grouped by a stable sort on the slot), not by atomics:
        # the same bits on every run
        by_slot, perm = torch.sort(dump, dim=1, stable=True)
        ends = torch.searchsorted(by_slot, torch.arange(
            V + 2, device=points.device).expand(B, V + 2).contiguous())
        xyz = torch.gather(points[..., :3], 1, perm[..., None].expand(B, P, 3))
        sums = torch.segment_reduce(xyz, "sum", lengths=ends.diff(dim=1),
                                    axis=1)
        means = sums[:, :V] / torch.clamp_min(num_points[..., None], 1).to(dt)
        f_cluster = points[..., :3] - torch.gather(
            means, 1, slot_c[..., None].expand(B, P, 3))

        vx, vy = self.voxel_size
        x0, y0 = self.pc_range
        pcoords = torch.gather(coords, 1, slot_c[..., None].expand(B, P, 3))
        px = pcoords[..., 2].to(dt) * vx + (vx / 2 + x0)
        py = pcoords[..., 1].to(dt) * vy + (vy / 2 + y0)
        f_center = torch.stack([points[..., 0] - px, points[..., 1] - py],
                               dim=-1)

        raw = points[..., : self.num_input_features]
        x = torch.cat([raw, f_cluster, f_center], dim=-1)
        x = x * pvalid[..., None].to(dt)
        # the same PFNLayer: a [B, P, 1, F] layout makes its max over
        # axis 2 a no-op, so it returns each point's activation [B, P, F]
        x = self.pfn_layers[0](x[:, :, None, :],
                               pvalid[..., None, None].to(dt))
        F = x.shape[-1]
        # activations are >= 0 after the ReLU, so 0 is the floor of the
        # max and the value of an empty pillar, as on the padded path
        pooled = torch.zeros((B, V + 1, F), dtype=dt, device=points.device)
        pooled.scatter_reduce_(1, dump[..., None].expand(B, P, F), x, "amax")
        return torch.where((num_points > 0)[..., None], pooled[:, :V],
                           torch.zeros((), dtype=dt, device=points.device))


class PointPillarsScatter(nn.Module):
    """Scatter pillar features into a dense BEV canvas through the
    pillar-scatter kernel; returns NCHW [B, F, H, W] with channels-last
    strides (a view of the kernel's [B, H*W, F] canvas, no transpose)."""

    def __init__(self, output_shape: Tuple[int, int]):
        super().__init__()
        self.output_shape = tuple(output_shape)   # (H, W) = (ny, nx)

    def forward(self, voxel_features: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """voxel_features [B, V, F], coords [B, V, 3] (z, y, x) of voxels
        in any order: each scan's cell ids are unique, which is all the
        kernel needs (-1 padding rows are dropped)."""
        B, V, F = voxel_features.shape
        H, W = self.output_shape
        valid = coords[..., 1] >= 0
        lin = coords[..., 1] * W + coords[..., 2]
        lin = torch.where(valid, lin, H * W).to(torch.int32)
        feats = torch.where(valid[..., None], voxel_features,
                            torch.zeros((), dtype=voxel_features.dtype,
                                        device=voxel_features.device))
        canvas = scatter_sorted_to_canvas(feats.contiguous(), lin, H * W)
        return canvas.view(B, H, W, F).permute(0, 3, 1, 2)
