"""``region_similarity_calculator`` config message -> similarity
(``core/region_similarity.py``), as the JAX package's
``builder/similarity_calculator_builder.py`` builds it."""
from __future__ import annotations

from ..core import region_similarity
from .config_io import f32


def build(cfg: dict):
    """Nearest IoU when the message sets none (proto3's default, as in the
    reference)."""
    if "rotate_iou_similarity" in cfg:
        return region_similarity.RotateIouSimilarity()
    if "distance_similarity" in cfg:
        c = cfg["distance_similarity"]
        return region_similarity.DistanceSimilarity(
            distance_norm=f32(c.get("distance_norm", 0.0)),
            with_rotation=bool(c.get("with_rotation", False)),
            rotation_alpha=f32(c.get("rotation_alpha", 0.0)))
    unknown = set(cfg) - {"nearest_iou_similarity"}
    if unknown:
        raise ValueError(f"unknown similarity {sorted(unknown)}")
    return region_similarity.NearestIouSimilarity()
