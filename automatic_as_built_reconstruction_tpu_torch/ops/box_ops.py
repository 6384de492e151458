"""Box math on torch tensors: the decode ``predict`` runs and the two
helpers of the loss.

Formula for formula the same as the JAX package's ``ops/box_jax.py``
(``limit_period`` :14, ``second_box_decode`` :44, ``add_sin_difference``
:132, ``get_direction_target`` :144).
"""
from __future__ import annotations

import math

import torch


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = math.pi) -> torch.Tensor:
    return val - torch.floor(val / period + offset) * period


def second_box_decode(encodings: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """7-dof residuals [.., 7] against anchors [.., 7] -> boxes [.., 7]
    (log sizes, yaw difference: the only form ``predict`` decodes)."""
    xa, ya, za, wa, la, ha, ra = torch.split(anchors, 1, dim=-1)
    xt, yt, zt, wt, lt, ht, rt = torch.split(encodings, 1, dim=-1)
    diagonal = torch.sqrt(la**2 + wa**2)
    za = za + ha / 2
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    lg = torch.exp(lt) * la
    wg = torch.exp(wt) * wa
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    return torch.cat([xg, yg, zg, wg, lg, hg, rg], dim=-1)


def add_sin_difference(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Replace the yaw channel by the sin(a - b) split the loss uses:
    sin(a)cos(b) in ``boxes1``, cos(a)sin(b) in ``boxes2``."""
    rad_pred = boxes1[..., -1:]
    rad_tg = boxes2[..., -1:]
    b1 = torch.cat([boxes1[..., :-1], torch.sin(rad_pred) * torch.cos(rad_tg)],
                   dim=-1)
    b2 = torch.cat([boxes2[..., :-1], torch.cos(rad_pred) * torch.sin(rad_tg)],
                   dim=-1)
    return b1, b2


def get_direction_target(anchors: torch.Tensor, reg_targets: torch.Tensor,
                         dir_offset: float = 0.0,
                         num_bins: int = 2) -> torch.Tensor:
    """Direction-classifier targets from yaw residuals: bin =
    floor((reg_yaw + anchor_yaw - offset) mod 2pi / (2pi / num_bins)),
    clipped to [0, num_bins); int64."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = limit_period(rot_gt - dir_offset, 0.0, 2 * math.pi)
    return torch.clamp(torch.floor(offset_rot / (2 * math.pi / num_bins))
                       .long(), 0, num_bins - 1)
