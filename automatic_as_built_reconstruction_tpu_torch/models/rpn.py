"""Dense BEV backbone (RPN) + detection heads, NCHW.

The port of the JAX package's ``models/rpn.py``: N downsampling blocks
(stride-s 3x3 conv + k stride-1 3x3 convs, BN + ReLU each), each block
upsampled back by a transposed conv (kernel = stride) to a common stride
and concatenated, then 1x1 heads for class / box / direction.  Module
names follow the lineage torch RPN (``blocks.{i}.{j}`` with a leading
``ZeroPad2d``, ``deblocks.{i}.{0,1}``, ``conv_cls`` / ``conv_box`` /
``conv_dir_cls``), the names ``utils/weight_import.py`` emits.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .pointpillars import BN_EPS, BN_MOMENTUM, FlaxBatchNorm2d


def _bn(ch: int) -> nn.BatchNorm2d:
    return FlaxBatchNorm2d(ch, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_block(in_ch: int, filters: int, layers: int,
               stride: int) -> nn.Sequential:
    """flax Conv(padding=((1,1),(1,1)), stride s) == ZeroPad2d(1) + Conv2d
    with no padding."""
    mods = [nn.ZeroPad2d(1),
            nn.Conv2d(in_ch, filters, 3, stride=stride, bias=False),
            _bn(filters), nn.ReLU()]
    for _ in range(layers):
        mods += [nn.Conv2d(filters, filters, 3, padding=1, bias=False),
                 _bn(filters), nn.ReLU()]
    return nn.Sequential(*mods)


def upsample(in_ch: int, filters: int, stride: int) -> nn.Sequential:
    up = nn.ConvTranspose2d(in_ch, filters, stride, stride=stride,
                            bias=False)
    return nn.Sequential(up, _bn(filters), nn.ReLU())


class RPN(nn.Module):
    """Multi-scale BEV backbone with per-location anchor heads."""

    def __init__(self, num_input_features: int,
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2),
                 num_filters: Sequence[int] = (128, 128, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 num_upsample_filters: Sequence[int] = (256, 256, 256),
                 num_anchor_per_loc: int = 2, num_class: int = 1,
                 box_code_size: int = 7, num_direction_bins: int = 2):
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
        self.conv_cls = nn.Conv2d(head_in, num_anchor_per_loc * num_class, 1)
        self.conv_box = nn.Conv2d(head_in, num_anchor_per_loc * box_code_size,
                                  1)
        self.conv_dir_cls = nn.Conv2d(
            head_in, num_anchor_per_loc * num_direction_bins, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B, C, H, W] -> prediction maps [B, A*c, H', W'] (NCHW)."""
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = block(x)
            ups.append(deblock(x))
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        return {"box_preds": self.conv_box(x), "cls_preds": self.conv_cls(x),
                "dir_cls_preds": self.conv_dir_cls(x)}
