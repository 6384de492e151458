"""Dense BEV backbone (RPN) + detection heads, NCHW.

The port of the JAX package's ``models/rpn.py``: N downsampling blocks
(stride-s 3x3 conv + k stride-1 3x3 convs, BN + ReLU each), each block
upsampled back by a transposed conv (kernel = stride; a fractional
stride 1/k is a plain k x k conv of stride k) to a common stride and
concatenated, then 1x1 heads for class / box / direction and, with
``use_yaw_quality``, the per-anchor yaw-quality logit.  Module names
follow the lineage torch RPN (``blocks.{i}.{j}`` with a leading
``ZeroPad2d``, ``deblocks.{i}.{0,1}``, ``conv_cls`` / ``conv_box`` /
``conv_dir_cls``), the names ``utils/weight_import.py`` emits;
``conv_quality`` has no lineage slot.

``dtype=torch.bfloat16`` mirrors the JAX modules' flax ``dtype=bfloat16``
(``models/rpn.py:28-36``, ``:51-59``, ``:97-120`` there): the parameters
stay float32, each convolution casts its input, kernel and bias to
bfloat16 and runs in bfloat16 (the bias added after the convolution, in
bfloat16), and BatchNorm takes its statistics and normalises in float32
and gives bfloat16.  The casts are explicit in the modules, not
``torch.autocast``, which keeps BatchNorm's output in float32 and picks
its own list of operations.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .pointpillars import BN_EPS, BN_MOMENTUM, FlaxBatchNorm2d


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` where it is set
    (its input, kernel and bias cast, the bias added after the
    convolution, in that type, as flax's ``Conv(dtype=...)`` does); with
    None it is ``nn.Conv2d``."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is not None:
            y = y + self.bias.to(dt).view(1, -1, 1, 1)
        return y


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no bias) that computes in
    ``compute_dtype`` where it is set, as :class:`Conv2d`."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def _bn(ch: int) -> nn.BatchNorm2d:
    return FlaxBatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_block(in_ch: int, filters: int, layers: int,
               stride: int) -> nn.Sequential:
    """flax Conv(padding=((1,1),(1,1)), stride s) == ZeroPad2d(1) + Conv2d
    with no padding."""
    mods = [nn.ZeroPad2d(1),
            Conv2d(in_ch, filters, 3, stride=stride, bias=False),
            _bn(filters), nn.ReLU()]
    for _ in range(layers):
        mods += [Conv2d(filters, filters, 3, padding=1, bias=False),
                 _bn(filters), nn.ReLU()]
    return nn.Sequential(*mods)


class SameConv2d(Conv2d):
    """A k x k :class:`Conv2d` of stride k with flax's default ``"SAME"``
    padding: ceil(n / k) outputs, the missing rows and columns padded with
    zeros, the smaller half before."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k in zip(reversed(x.shape[-2:]), reversed(self.stride)):
            total = max((-(-n // k) - 1) * k + self.kernel_size[0] - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads) if any(pads) else x)


def upsample(in_ch: int, filters: int, stride: float) -> nn.Sequential:
    """stride >= 1: a transposed conv of kernel = stride; a fractional
    stride 1/k (the lineage's downsampling "upsample"): a k x k conv of
    stride k."""
    if stride >= 1:
        s = int(round(stride))
        up = ConvTranspose2d(in_ch, filters, s, stride=s, bias=False)
    else:
        k = int(round(1 / stride))
        up = SameConv2d(in_ch, filters, k, stride=k, bias=False)
    return nn.Sequential(up, _bn(filters), nn.ReLU())


class RPN(nn.Module):
    """Multi-scale BEV backbone with per-location anchor heads."""

    def __init__(self, num_input_features: int,
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 num_filters: Sequence[int] = (128, 128, 256),
                 upsample_strides: Sequence[float] = (1, 2, 4),
                 num_upsample_filters: Sequence[int] = (256, 256, 256),
                 num_anchor_per_loc: int = 2, num_class: int = 1,
                 box_code_size: int = 7, num_direction_bins: int = 2,
                 use_direction_classifier: bool = True,
                 encode_background_as_zeros: bool = True,
                 use_yaw_quality: bool = False,
                 dtype=torch.float32):
        super().__init__()
        blocks, deblocks = [], []
        in_ch = num_input_features
        for i, (n, s, f) in enumerate(zip(layer_nums, layer_strides,
                                          num_filters)):
            blocks.append(conv_block(in_ch, f, n, s))
            deblocks.append(upsample(f, num_upsample_filters[i],
                                     upsample_strides[i]))
            in_ch = f
        self.blocks = nn.ModuleList(blocks)
        self.deblocks = nn.ModuleList(deblocks)
        head_in = sum(num_upsample_filters[:len(blocks)])
        # softmax scores keep a background column
        num_cls = num_class if encode_background_as_zeros else num_class + 1
        self.conv_cls = Conv2d(head_in, num_anchor_per_loc * num_cls, 1)
        self.conv_box = Conv2d(head_in, num_anchor_per_loc * box_code_size,
                               1)
        if use_direction_classifier:
            self.conv_dir_cls = Conv2d(
                head_in, num_anchor_per_loc * num_direction_bins, 1)
        if use_yaw_quality:
            # per-anchor yaw-quality logit (voxelnet.compute_loss)
            self.conv_quality = Conv2d(head_in, num_anchor_per_loc, 1)
        if dtype != torch.float32:
            for m in self.modules():
                if isinstance(m, (Conv2d, ConvTranspose2d)):
                    m.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B, C, H, W] -> prediction maps [B, A*c, H', W'] (NCHW), in
        the compute dtype."""
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = block(x)
            ups.append(deblock(x))
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        ret = {"box_preds": self.conv_box(x), "cls_preds": self.conv_cls(x)}
        if hasattr(self, "conv_dir_cls"):
            ret["dir_cls_preds"] = self.conv_dir_cls(x)
        if hasattr(self, "conv_quality"):
            ret["quality_preds"] = self.conv_quality(x)
        return ret
