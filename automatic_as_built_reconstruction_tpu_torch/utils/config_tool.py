"""Programmatic config editing helpers.

The port's copy of the JAX package's ``utils/config_tool.py`` over the
port's own config reader (``builder/config_io.py``: no protobuf), so a
config is the nested dict that ``config_io.load_config`` gives.
``read_config`` / ``save_config`` read and write the text format,
``change_detection_range`` moves the BEV detection range of a model
config (``config["model"]["second"]``) in place and
``get_downsample_factor`` reads its middle's downsampling.  Values that
the schema holds as ``float`` are computed from their single-precision
value, as the reference's protobuf fields hold them.
"""
from __future__ import annotations

from pathlib import Path

from ..builder import config_io
from ..builder.config_io import as_list, f32


def read_config(path) -> dict:
    return config_io.load_config(path)


def save_config(cfg: dict, path) -> None:
    Path(path).write_text(config_io.to_text(cfg) + "\n")


def change_detection_range(model_config: dict, new_range) -> dict:
    """Set a new (x0, y0, x1, y1) BEV detection range: updates the
    voxelizer's point_cloud_range and every anchor generator's ranges."""
    assert len(new_range) == 4
    vg = model_config["voxel_generator"]
    old = as_list(vg["point_cloud_range"])
    vg["point_cloud_range"] = [new_range[0], new_range[1], old[2],
                               new_range[2], new_range[3], old[5]]
    for cs in as_list(model_config["target_assigner"]["class_settings"]):
        if "anchor_generator_range" in cs:
            gen = cs["anchor_generator_range"]
            ar = as_list(gen["anchor_ranges"])
            gen["anchor_ranges"] = [new_range[0], new_range[1], ar[2],
                                    new_range[2], new_range[3], ar[5]]
        elif "anchor_generator_stride" in cs:
            gen = cs["anchor_generator_stride"]
            strides = as_list(gen["strides"])
            off = as_list(gen["offsets"])
            gen["offsets"] = [new_range[0] + 0.5 * f32(strides[0]),
                              new_range[1] + 0.5 * f32(strides[1]),
                              off[2]]
    return model_config


def get_downsample_factor(model_config: dict) -> int:
    return int(model_config["middle_feature_extractor"].get(
        "downsample_factor", 0)) or 1
