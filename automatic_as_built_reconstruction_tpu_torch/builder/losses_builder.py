"""``loss`` config message -> loss hyperparameters (feeds the
``VoxelNetConfig`` loss fields), as the JAX package's
``builder/losses_builder.py`` reads them.  As there, the loss types are
recorded and ``compute_loss`` takes the sigmoid focal and smooth-L1
losses whatever they say."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .config_io import as_list, f32


@dataclasses.dataclass
class LossParams:
    cls_weight: float = 1.0
    loc_weight: float = 2.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    smooth_l1_sigma: float = 3.0
    code_weights: Optional[Tuple[float, ...]] = None
    cls_loss_type: str = "weighted_sigmoid_focal"
    loc_loss_type: str = "weighted_smooth_l1"


def _which(msg: dict) -> Optional[str]:
    """The field set in a oneof message (its only key), or None."""
    return next(iter(msg), None)


def build(cfg: dict) -> LossParams:
    p = LossParams()
    if f32(cfg.get("classification_weight", 0.0)):
        p.cls_weight = f32(cfg["classification_weight"])
    if f32(cfg.get("localization_weight", 0.0)):
        p.loc_weight = f32(cfg["localization_weight"])
    cls_loss = cfg.get("classification_loss", {})
    cls_which = _which(cls_loss)
    if cls_which:
        p.cls_loss_type = cls_which
        if cls_which == "weighted_sigmoid_focal":
            c = cls_loss[cls_which]
            p.focal_gamma = f32(c.get("gamma", 0.0)) or 2.0
            p.focal_alpha = f32(c.get("alpha", 0.0)) or 0.25
    loc_loss = cfg.get("localization_loss", {})
    loc_which = _which(loc_loss)
    if loc_which:
        p.loc_loss_type = loc_which
        if loc_which == "weighted_smooth_l1":
            c = loc_loss[loc_which]
            p.smooth_l1_sigma = f32(c.get("sigma", 0.0)) or 3.0
            weights = as_list(c.get("code_weight"))
            if weights:
                p.code_weights = tuple(f32(w) for w in weights)
    return p
