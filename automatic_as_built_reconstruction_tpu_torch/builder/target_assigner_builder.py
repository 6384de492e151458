"""``target_assigner`` + ``box_coder`` config messages -> TargetAssigner,
as the JAX package's ``builder/target_assigner_builder.py`` builds it:
per-class anchor generators, the box coder, and the similarity of the
LAST class setting for every class (the reference's builder keeps the
last one it builds)."""
from __future__ import annotations

from ..core.target_assign import TargetAssigner
from . import (anchor_generator_builder, box_coder_builder,
               similarity_calculator_builder)
from .config_io import as_list, f32


def build(cfg: dict, box_coder: dict) -> TargetAssigner:
    """``box_coder``: the ``box_coder`` message of ``model.second``."""
    generators, classes = [], []
    similarity = None
    for cs in as_list(cfg.get("class_settings")):
        generators.append(anchor_generator_builder.build(cs))
        classes.append(cs.get("class_name") or generators[-1].class_name)
        similarity = similarity_calculator_builder.build(
            cs.get("region_similarity_calculator", {}))
    return TargetAssigner(
        box_coder=box_coder_builder.build(box_coder),
        anchor_generators=generators,
        classes=classes,
        region_similarity_calculator=similarity,
        positive_fraction=(f32(cfg.get("sample_positive_fraction", 0.0))
                           or None),
        sample_size=int(cfg.get("sample_size", 0)) or 512,
    )
