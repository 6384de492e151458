"""Database sampler message (the port's dict config) ->
``core.sample_ops.DataBaseSampler``, as the JAX package's
``builder/dbsampler_builder.py`` builds it from the proto."""
from __future__ import annotations

import functools
import pathlib

from ..core import sample_ops
from .config_io import as_list, f32


def _map(entries) -> dict:
    """A proto map field (repeated ``{key, value}``) -> dict, in order."""
    return {e["key"]: int(e["value"]) for e in as_list(entries)}


def build(cfg: dict, rng=None):
    """-> ``DataBaseSampler`` or None where no ``database_info_path`` is
    set.  ``rng``: the generator every draw takes (the input reader seeds
    it)."""
    info_path = cfg.get("database_info_path")
    if not info_path:
        return None
    prep_steps = []
    for step in as_list(cfg.get("database_prep_steps")):
        if "filter_by_min_num_points" in step:
            pairs = _map(step["filter_by_min_num_points"].get(
                "min_num_point_pairs"))
            prep_steps.append(functools.partial(
                sample_ops.filter_by_min_num_points, min_points=pairs))
        elif "filter_by_difficulty" in step:
            removed = [int(v) for v in as_list(
                step["filter_by_difficulty"].get("removed_difficulties"))]
            prep_steps.append(functools.partial(
                sample_ops.filter_by_difficulty, removed=removed))
    groups = [_map(g.get("name_to_max_num"))
              for g in as_list(cfg.get("sample_groups"))]
    grot = [f32(v) for v in as_list(
        cfg.get("global_random_rotation_range_per_object"))] or None
    # gt-database object files are recorded relative to the dataset root
    # = the dbinfos pickle's own directory (create_data writes both there)
    root = pathlib.Path(info_path).resolve().parent
    return sample_ops.DataBaseSampler.from_info_path(
        info_path, groups, root_path=root,
        rate=f32(cfg.get("rate", 0.0)) or 1.0, prep_steps=prep_steps,
        global_rot_range=grot, rng=rng)
