"""``box_coder`` config message -> box coder (``core/box_coders.py``), as
the JAX package's ``builder/box_coder_builder.py`` builds it."""
from __future__ import annotations

from ..core import box_coders
from .config_io import f32


def build(cfg: dict) -> box_coders.BoxCoder:
    """The ground 3D coder when the message sets no coder (proto3's
    default, as in the reference)."""
    if "bev_box_coder" in cfg:
        c = cfg["bev_box_coder"]
        return box_coders.BevBoxCoder(
            linear_dim=bool(c.get("linear_dim", False)),
            vec_encode=bool(c.get("encode_angle_vector", False)),
            z_fixed=f32(c.get("z_fixed", 0.0)),
            h_fixed=f32(c.get("h_fixed", 0.0)))
    unknown = set(cfg) - {"ground_box3d_coder"}
    if unknown:
        raise ValueError(f"unknown box coder {sorted(unknown)}")
    c = cfg.get("ground_box3d_coder", {})
    return box_coders.GroundBox3dCoder(
        linear_dim=bool(c.get("linear_dim", False)),
        vec_encode=bool(c.get("encode_angle_vector", False)))
