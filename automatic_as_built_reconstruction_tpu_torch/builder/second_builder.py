"""``model.second`` config message -> (VoxelNet, VoxelNetConfig, feature
map size), as the JAX package's ``builder/second_builder.py::build`` does
for the fields serving and the loss read."""
from __future__ import annotations

import math
from typing import Tuple

from ..models import middle_plans
from ..models.voxelnet import VoxelNet, VoxelNetConfig
from . import losses_builder
from .config_io import as_list, f32


def feature_map_size_from(model_cfg: dict, grid_size) -> Tuple[int, int, int]:
    """(D=1, H, W) anchor/feature grid given the middle downsample factor."""
    mid = model_cfg.get("middle_feature_extractor", {})
    df = int(mid.get("downsample_factor", 0)) or 1
    gx, gy = int(grid_size[0]), int(grid_size[1])
    return (1, gy // df, gx // df)


def _ints(d: dict, key: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in as_list(d.get(key)))


def _sparse_window_kwargs(mid: dict) -> dict:
    """Per-block (subm, strided) window / subwindow pairs + the
    grouped-tap flag from the ``middle_feature_extractor`` message.  They
    tune the TPU kernels; the port reads and checks them as the JAX
    builder does, and its CUDA kernels ignore them.  Empty fields keep
    the VoxelNetConfig defaults."""
    out = {}
    for field, key in (("sparse_pallas_window", "pallas_window"),
                       ("sparse_keymatch_subwindow", "keymatch_subwindow")):
        subm, strided = _ints(mid, f"{key}_subm"), _ints(mid,
                                                         f"{key}_strided")
        if subm and strided:
            if len(subm) != len(strided):
                raise ValueError(
                    f"{key}_subm has {len(subm)} entries but {key}_strided "
                    f"has {len(strided)} — one pair per middle block")
            out[field] = tuple(zip(subm, strided))
    if mid.get("keymatch_group_taps", False):
        out["sparse_keymatch_group"] = True
    return out


def build_config(model_cfg: dict, voxel_grid, target_assigner
                 ) -> VoxelNetConfig:
    """Config dicts -> :class:`VoxelNetConfig` (any middle; building the
    model is what refuses the ones that are not ported)."""
    vfe = model_cfg.get("voxel_feature_extractor", {})
    mid = model_cfg.get("middle_feature_extractor", {})
    rpn = model_cfg.get("rpn", {})
    loss = losses_builder.build(model_cfg.get("loss", {}))

    grid_size = tuple(int(g) for g in voxel_grid.grid_size)
    middle_name = mid.get("module_class_name") or ""
    middle_filters = (_ints(mid, "num_filters_down1")
                      + _ints(mid, "num_filters_down2")) or (16, 32, 64)
    nb = len(middle_filters)
    is_sparse = middle_name.startswith(("SpMiddle", "SparseMiddle"))
    # exact lineage layer plan when the name has one and the grid is deep
    # enough for it; tiny test grids fall back to the parameterized stack
    middle_blocks = (middle_plans.lookup(
        middle_name, (grid_size[2], grid_size[1], grid_size[0]))
        if is_sparse else None)
    if is_sparse:
        # z halves every block; xy downsample spread so the total equals
        # the configured downsample_factor
        df = int(mid.get("downsample_factor", 0)) or 8
        n_xy = max(int(math.log2(df)), 0)
        middle_xy = tuple(2 if i < n_xy else 1 for i in range(nb))
        if middle_blocks is not None:
            df_plan = middle_plans.xy_downsample(middle_blocks)
            if df != df_plan:
                print(f"WARNING: config downsample_factor {df} != lineage "
                      f"plan {middle_name} xy downsample {df_plan}; anchors "
                      f"use the config value")
    else:
        middle_xy = (1,) * (nb - 1) + (2,)

    return VoxelNetConfig(
        num_class=len(target_assigner.classes),
        vfe_name=vfe.get("module_class_name") or "SimpleVoxel",
        vfe_num_filters=_ints(vfe, "num_filters") or (64,),
        num_input_features=int(model_cfg.get("num_point_features", 0)) or 4,
        with_distance=bool(vfe.get("with_distance", False)),
        voxel_size=tuple(voxel_grid.voxel_size),
        pc_range=tuple(voxel_grid.point_cloud_range),
        grid_size=grid_size,
        middle_name=middle_name or "PointPillarsScatter",
        sparse_use_pallas_gemm=bool(
            model_cfg.get("use_pallas_sparse_gemm", False)),
        sparse_keymatch=bool(model_cfg.get("use_keymatch_sparse_gemm",
                                           False)),
        sparse_out_caps=_ints(mid, "out_site_caps") or None,
        sparse_dense_tail_blocks=int(mid.get("dense_tail_blocks", 0)),
        **_sparse_window_kwargs(mid),
        middle_num_filters=middle_filters,
        middle_layers_per_block=(2,) * nb,
        middle_z_strides=(2,) * nb,
        middle_xy_strides=middle_xy,
        middle_blocks=middle_blocks,
        middle_zpad=middle_plans.Z_PAD if middle_blocks is not None else 0,
        rpn_layer_nums=_ints(rpn, "layer_nums") or (3, 5, 5),
        rpn_layer_strides=_ints(rpn, "layer_strides") or (2, 2, 2),
        rpn_num_filters=_ints(rpn, "num_filters") or (128, 128, 256),
        rpn_upsample_strides=(tuple(f32(v) for v in as_list(
            rpn.get("upsample_strides"))) or (1, 2, 4)),
        rpn_num_upsample_filters=(_ints(rpn, "num_upsample_filters")
                                  or (256, 256, 256)),
        num_anchor_per_loc=target_assigner.num_anchors_per_location,
        box_code_size=target_assigner.box_code_size,
        encode_background_as_zeros=bool(
            model_cfg.get("encode_background_as_zeros", False)),
        use_direction_classifier=bool(
            model_cfg.get("use_direction_classifier", False)),
        num_direction_bins=int(model_cfg.get("num_direction_bins", 0)) or 2,
        direction_offset=f32(model_cfg.get("direction_offset", 0.0)),
        encode_rad_error_by_sin=bool(
            model_cfg.get("encode_rad_error_by_sin", False)),
        sin_error_factor=f32(model_cfg.get("sin_error_factor", 0.0)) or 1.0,
        cls_weight=loss.cls_weight,
        loc_weight=loss.loc_weight,
        dir_weight=f32(model_cfg.get("direction_loss_weight", 0.0)) or 0.2,
        pos_cls_weight=f32(model_cfg.get("pos_class_weight", 0.0)) or 1.0,
        neg_cls_weight=f32(model_cfg.get("neg_class_weight", 0.0)) or 1.0,
        focal_gamma=loss.focal_gamma,
        focal_alpha=loss.focal_alpha,
        smooth_l1_sigma=loss.smooth_l1_sigma,
        code_weights=loss.code_weights,
        loss_norm_type=model_cfg.get("loss_norm_type") or "NormByNumPositives",
        use_yaw_quality_head=bool(
            model_cfg.get("use_yaw_quality_head", False)),
        nms_center_suppress_radius=f32(
            model_cfg.get("nms_center_suppress_radius", 0.0)),
        yaw_point_refine_classes=tuple(
            target_assigner.classes.index(c)
            for c in as_list(model_cfg.get("yaw_point_refine_classes"))
            if c in target_assigner.classes),
        yaw_point_refine_recenter=bool(
            model_cfg.get("yaw_point_refine_recenter", False)),
        yaw_point_refine_trim=bool(
            model_cfg.get("yaw_point_refine_trim", False)),
        post_center_limit_range=(tuple(f32(v) for v in as_list(
            model_cfg.get("post_center_limit_range"))) or None),
        use_rotate_nms=bool(model_cfg.get("use_rotate_nms", False)),
        nms_pre_max_size=int(model_cfg.get("nms_pre_max_size", 0)) or 1000,
        nms_post_max_size=int(model_cfg.get("nms_post_max_size", 0)) or 100,
        nms_score_threshold=(f32(model_cfg.get("nms_score_threshold", 0.0))
                             or 0.05),
        nms_iou_threshold=(f32(model_cfg.get("nms_iou_threshold", 0.0))
                           or 0.5),
    )


def build(model_cfg: dict, voxel_grid, target_assigner):
    """-> (VoxelNet, VoxelNetConfig, feature_map_size (1, H, W))."""
    cfg = build_config(model_cfg, voxel_grid, target_assigner)
    model = VoxelNet(cfg)
    return model, cfg, feature_map_size_from(model_cfg,
                                             voxel_grid.grid_size)
