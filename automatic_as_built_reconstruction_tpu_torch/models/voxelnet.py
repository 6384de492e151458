"""VoxelNet (VFE -> middle -> RPN) + ``predict`` (decode, top-k, rotated
NMS, centre suppression).

The port of the JAX package's ``models/voxelnet.py``: its own copy of
``VoxelNetConfig`` (the fields the serving paths read), the ``VoxelNet``
pillar branch (PillarFeatureNet -> PointPillarsScatter -> RPN) and sparse
branch (SimpleVoxel -> SparseMiddle -> RPN), ``num_middle_blocks``,
``middle_plan``, ``compute_loss`` (:364) and ``predict`` (:452).  The
other VFEs, ``DenseMiddle``, host rulebooks, bfloat16 compute, the
yaw-quality head, ``PillarFeatureNetRadius``, ``with_distance``,
fractional upsample strides, softmax class scores
(``encode_background_as_zeros`` false) and a model without the direction
classifier wait for later slices and raise ``NotImplementedError``; of
the flat PFN modes the segment-ops one is ported, ``segment_scan`` is not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..ops import box_ops, nms
from ..ops import sparse_conv as sc
from . import losses as losses_mod
from .middle import SparseMiddle
from .pointpillars import PillarFeatureNet, PointPillarsScatter
from .rpn import RPN
from .voxel_encoder import SimpleVoxel

# every lineage SpMiddle* spelling builds the sparse stack; the exact
# per-variant layer plan comes from models/middle_plans.py (wired in by
# second_builder as cfg.middle_blocks)
SPARSE_MIDDLE_NAMES = (
    "SparseMiddle", "SpMiddleFHD", "SpMiddleFHDV2", "SpMiddleFHDLite",
    "SpMiddleD4HD", "SpMiddleD4HDLite", "SpMiddleD8HD", "SpMiddle2K",
    "SpMiddle2KMerged")


def num_middle_blocks(cfg: "VoxelNetConfig") -> int:
    """Block count of the sparse middle stack (explicit plan wins)."""
    if cfg.middle_blocks is not None:
        return len(cfg.middle_blocks)
    return len(cfg.middle_num_filters)


def _sparse_grid(cfg: "VoxelNetConfig") -> Tuple[int, int, int]:
    return (cfg.grid_size[2] + cfg.middle_zpad, cfg.grid_size[1],
            cfg.grid_size[0])


def middle_plan(cfg: "VoxelNetConfig", v_cap: int):
    """Sparse middle-stack block plan for a config, or None if the middle
    extractor is not the sparse stack."""
    if cfg.middle_name not in SPARSE_MIDDLE_NAMES:
        return None
    if cfg.middle_blocks is not None:
        specs = tuple(sc.BlockSpec(*b) for b in cfg.middle_blocks)
        return sc.plan_from_specs(_sparse_grid(cfg), v_cap, specs,
                                  cfg.sparse_capacity_shrink,
                                  out_caps=cfg.sparse_out_caps)
    return sc.make_plan(_sparse_grid(cfg), v_cap, cfg.middle_num_filters,
                        cfg.middle_layers_per_block, cfg.middle_z_strides,
                        cfg.middle_xy_strides, cfg.sparse_capacity_shrink,
                        out_caps=cfg.sparse_out_caps)


@dataclasses.dataclass(frozen=True)
class VoxelNetConfig:
    """Static model config: the fields of the JAX package's
    ``VoxelNetConfig`` that serving and ``compute_loss`` read (same names,
    same defaults)."""

    num_class: int = 1
    # VFE
    vfe_name: str = "PillarFeatureNet"
    vfe_num_filters: Tuple[int, ...] = (64,)
    num_input_features: int = 4
    with_distance: bool = False
    # geometry
    voxel_size: Tuple[float, float, float] = (0.2, 0.2, 4.0)
    pc_range: Tuple[float, ...] = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    grid_size: Tuple[int, int, int] = (352, 400, 1)  # (gx, gy, gz)
    # middle
    middle_name: str = "PointPillarsScatter"
    middle_num_filters: Tuple[int, ...] = (16, 32, 64)
    middle_layers_per_block: Tuple[int, ...] = (2, 2, 2)
    middle_z_strides: Tuple[int, ...] = (2, 2, 2)
    middle_xy_strides: Tuple[int, ...] = (1, 1, 2)
    # exact lineage layer plan (tuple of BlockSpec tuples; overrides the
    # four parameterized fields above)
    middle_blocks: Optional[Tuple[Tuple, ...]] = None
    # extra z cells added to the sparse grid (the lineage
    # sparse_shape = grid + [1, 0, 0] convention)
    middle_zpad: int = 0
    # RPN
    rpn_layer_nums: Tuple[int, ...] = (3, 5, 5)
    rpn_layer_strides: Tuple[int, ...] = (2, 2, 2)
    rpn_num_filters: Tuple[int, ...] = (64, 128, 256)
    rpn_upsample_strides: Tuple[float, ...] = (1, 2, 4)
    rpn_num_upsample_filters: Tuple[int, ...] = (128, 128, 128)
    num_anchor_per_loc: int = 2
    box_code_size: int = 7
    encode_background_as_zeros: bool = True
    use_direction_classifier: bool = True
    num_direction_bins: int = 2
    direction_offset: float = 0.0
    encode_rad_error_by_sin: bool = True
    sin_error_factor: float = 1.0
    # losses
    cls_weight: float = 1.0
    loc_weight: float = 2.0
    dir_weight: float = 0.2
    use_yaw_quality_head: bool = False
    pos_cls_weight: float = 1.0
    neg_cls_weight: float = 1.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    smooth_l1_sigma: float = 3.0
    code_weights: Optional[Tuple[float, ...]] = None
    loss_norm_type: str = "NormByNumPositives"
    nms_center_suppress_radius: float = 0.0
    # host-side post-NMS point-evidence pose refinement (class indices,
    # 0-based; core/point_refine.py): ``evaluate`` applies it, the serving
    # entry point does not, as in the JAX package
    yaw_point_refine_classes: Tuple[int, ...] = ()
    yaw_point_refine_recenter: bool = False
    yaw_point_refine_trim: bool = False
    # sparse middle: which GEMM path it takes, the TPU kernels' tuning
    # (read, handed on, and without effect on the CUDA kernels), the
    # static site capacities and the dense tail
    compute_dtype: str = "float32"
    sparse_use_pallas_gemm: bool = False  # joins through the gather-GEMM
                                          # kernel, not the plain gather
    sparse_pallas_tile: int = 256
    sparse_pallas_window: Union[int, Tuple] = 768
    sparse_keymatch: bool = False         # join keys inside the kernel
                                          # (no rulebook build)
    sparse_keymatch_subwindow: Union[int, Tuple] = 0
    sparse_keymatch_group: bool = False
    sparse_capacity_shrink: Optional[float] = None
    sparse_out_caps: Optional[Tuple[int, ...]] = None
    sparse_dense_tail_blocks: int = 0
    # post-processing
    post_center_limit_range: Optional[Tuple[float, ...]] = None
    use_rotate_nms: bool = True
    nms_pre_max_size: int = 1000
    nms_post_max_size: int = 100
    nms_score_threshold: float = 0.05
    nms_iou_threshold: float = 0.5

    @property
    def bev_shape(self) -> Tuple[int, int]:
        return (self.grid_size[1], self.grid_size[0])  # (H=ny, W=nx)


class VoxelNet(nn.Module):
    """VFE -> middle -> RPN; raw NCHW maps.  Two families: PillarFeatureNet
    -> PointPillarsScatter, and SimpleVoxel -> SparseMiddle."""

    def __init__(self, cfg: VoxelNetConfig):
        super().__init__()
        if cfg.vfe_name not in ("PillarFeatureNet", "SimpleVoxel"):
            raise NotImplementedError(
                f"VFE {cfg.vfe_name}: only PillarFeatureNet and SimpleVoxel "
                f"are ported")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype}: only float32 is ported")
        if cfg.with_distance:
            raise NotImplementedError("PillarFeatureNet with_distance is not "
                                      "ported")
        if any(s < 1 or s != int(s) for s in cfg.rpn_upsample_strides):
            raise NotImplementedError(
                f"upsample strides {cfg.rpn_upsample_strides}: only integer "
                f"strides >= 1 are ported")
        sparse = cfg.middle_name in SPARSE_MIDDLE_NAMES
        if not sparse and cfg.middle_name != "PointPillarsScatter":
            raise NotImplementedError(
                f"middle {cfg.middle_name}: only PointPillarsScatter and "
                f"the sparse middle stack are ported")
        if cfg.use_yaw_quality_head:
            raise NotImplementedError("the yaw-quality head is not ported")
        _refuse_unported_heads(cfg)
        self.cfg = cfg
        if cfg.vfe_name == "PillarFeatureNet":
            self.voxel_feature_extractor = PillarFeatureNet(
                num_input_features=cfg.num_input_features,
                num_filters=cfg.vfe_num_filters,
                voxel_size=cfg.voxel_size[:2], pc_range=cfg.pc_range[:2])
            vfe_channels = cfg.vfe_num_filters[-1]
        else:
            self.voxel_feature_extractor = SimpleVoxel(
                num_input_features=cfg.num_input_features)
            vfe_channels = cfg.num_input_features
        if sparse:
            self.middle_feature_extractor = SparseMiddle(
                grid_dhw=_sparse_grid(cfg), num_input_features=vfe_channels,
                num_filters=cfg.middle_num_filters,
                layers_per_block=cfg.middle_layers_per_block,
                z_strides=cfg.middle_z_strides,
                xy_strides=cfg.middle_xy_strides,
                blocks=cfg.middle_blocks,
                capacity_shrink=cfg.sparse_capacity_shrink,
                out_caps=cfg.sparse_out_caps,
                use_pallas_gemm=cfg.sparse_use_pallas_gemm,
                pallas_tile=cfg.sparse_pallas_tile,
                pallas_window=cfg.sparse_pallas_window,
                use_keymatch=cfg.sparse_keymatch,
                keymatch_subwindow=cfg.sparse_keymatch_subwindow,
                keymatch_group=cfg.sparse_keymatch_group,
                dense_tail_blocks=cfg.sparse_dense_tail_blocks)
            rpn_in = self.middle_feature_extractor.out_channels
        else:
            self.middle_feature_extractor = PointPillarsScatter(
                cfg.bev_shape)
            rpn_in = vfe_channels
        self.rpn = RPN(
            num_input_features=rpn_in,
            layer_nums=cfg.rpn_layer_nums,
            layer_strides=cfg.rpn_layer_strides,
            num_filters=cfg.rpn_num_filters,
            upsample_strides=[int(s) for s in cfg.rpn_upsample_strides],
            num_upsample_filters=cfg.rpn_num_upsample_filters,
            num_anchor_per_loc=cfg.num_anchor_per_loc,
            num_class=cfg.num_class, box_code_size=cfg.box_code_size,
            num_direction_bins=cfg.num_direction_bins)

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor, *, middle_rulebooks=None,
                return_stages: bool = False, flat_points=None,
                flat_slot=None):
        """voxels [B,V,T,C], num_points [B,V], coords [B,V,3] (z, y, x)
        -> dict of NCHW prediction maps (and, with ``return_stages``, the
        voxel features [B,V,F] and the NCHW canvas).  The sparse middle
        wants the voxels in key order; the pillar scatter takes any order.
        ``flat_points`` / ``flat_slot`` (from ``ops.voxelize.
        voxelize_flat``): the point-major pillar VFE path; ``voxels`` may
        be None then.  ``middle_rulebooks`` (host-built sparse rulebooks)
        is not ported.
        """
        if middle_rulebooks is not None:
            raise NotImplementedError("host-built rulebooks are not ported")
        if flat_points is not None:
            if self.cfg.vfe_name != "PillarFeatureNet":
                raise NotImplementedError(
                    "flat point input is a pillar-encoder path")
            voxel_features = self.voxel_feature_extractor(
                None, num_points, coords, flat_points=flat_points,
                flat_slot=flat_slot)
        else:
            voxel_features = self.voxel_feature_extractor(
                voxels, num_points, coords)
        spatial = self.middle_feature_extractor(voxel_features, coords)
        preds = self.rpn(spatial)
        if return_stages:
            return preds, {"voxel_features": voxel_features,
                           "spatial_features": spatial}
        return preds


def _refuse_unported_heads(cfg: VoxelNetConfig) -> None:
    if not cfg.encode_background_as_zeros:
        raise NotImplementedError("softmax class scores (background as a "
                                  "class) are not ported")
    if not cfg.use_direction_classifier:
        raise NotImplementedError("a model without the direction "
                                  "classifier is not ported")


def flatten_preds(preds: Dict[str, torch.Tensor], cfg: VoxelNetConfig):
    """NCHW maps [B, A*c, H, W] -> [B, H*W*A, c] aligned with the anchor
    axis.  The maps go to NHWC first: the anchor axis is (y, x, anchor)
    with the anchor fastest, as the JAX package's NHWC reshape gives it."""
    def flat(t, c):
        return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, c)

    return {"box_preds": flat(preds["box_preds"], cfg.box_code_size),
            "cls_preds": flat(preds["cls_preds"], cfg.num_class),
            "dir_cls_preds": flat(preds["dir_cls_preds"],
                                  cfg.num_direction_bins)}


def compute_loss(preds: Dict[str, torch.Tensor],
                 example: Dict[str, torch.Tensor], cfg: VoxelNetConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss + per-term metrics (``loss_cls``, ``loss_loc``,
    ``loss_dir``, ``loss``), as the JAX package's ``compute_loss``.

    example: labels [B,A] int, reg_targets [B,A,code], anchors [B,A,7].
    """
    if cfg.use_yaw_quality_head:
        raise NotImplementedError("the yaw-quality loss is not ported")
    _refuse_unported_heads(cfg)
    p = flatten_preds(preds, cfg)
    labels = example["labels"]
    reg_targets = example["reg_targets"]
    B = labels.shape[0]

    cls_weights, reg_weights, cared = losses_mod.prepare_loss_weights(
        labels, cfg.pos_cls_weight, cfg.neg_cls_weight, cfg.loss_norm_type)

    # classification: one-hot with the background column dropped
    cls_targets = torch.where(cared, labels, torch.zeros_like(labels))
    one_hot = torch.nn.functional.one_hot(
        cls_targets.long(), cfg.num_class + 1).to(p["cls_preds"].dtype)
    one_hot = one_hot[..., 1:]
    focal = losses_mod.SigmoidFocalClassificationLoss(
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    cls_loss = focal(p["cls_preds"], one_hot, cls_weights).sum() / B

    # localization: sin-difference on yaw
    box_preds = p["box_preds"]
    if cfg.encode_rad_error_by_sin:
        box_preds_s, reg_targets_s = box_ops.add_sin_difference(
            box_preds, reg_targets)
    else:
        box_preds_s, reg_targets_s = box_preds, reg_targets
    smooth_l1 = losses_mod.WeightedSmoothL1LocalizationLoss(
        sigma=cfg.smooth_l1_sigma, code_weights=cfg.code_weights)
    loc_loss = smooth_l1(box_preds_s, reg_targets_s, reg_weights).sum() / B

    dir_targets = box_ops.get_direction_target(
        example["anchors"], reg_targets, cfg.direction_offset,
        cfg.num_direction_bins)
    dir_one_hot = torch.nn.functional.one_hot(
        dir_targets, cfg.num_direction_bins).to(p["dir_cls_preds"].dtype)
    dir_w = (labels > 0).to(box_preds.dtype)
    dir_w = dir_w / torch.clamp_min(dir_w.sum(-1, keepdim=True), 1.0)
    dir_loss = losses_mod.WeightedSoftmaxClassificationLoss()(
        p["dir_cls_preds"], dir_one_hot, dir_w).sum() / B

    total = (cfg.cls_weight * cls_loss + cfg.loc_weight * loc_loss
             + cfg.dir_weight * dir_loss)
    return total, {"loss_cls": cls_loss, "loss_loc": loc_loss,
                   "loss_dir": dir_loss, "loss": total}


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, A, c], idx [B, k] -> [B, k, c]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def predict(preds: Dict[str, torch.Tensor], anchors: torch.Tensor,
            cfg: VoxelNetConfig,
            anchors_mask: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
    """Decode + score threshold + per-class rotated NMS (+ centre
    suppression), static shapes.

    Args:
        preds: NCHW prediction maps from :class:`VoxelNet`.
        anchors: [B, A, 7].
        anchors_mask: optional [B, A] bool; anchors outside it score 0.

    Returns (D = nms_post_max_size per class, K = num_class * D):
        box3d_lidar [B, K, 7], scores [B, K], label_preds [B, K] (int32,
        0-based class), valid [B, K] bool.
    """
    if not cfg.use_rotate_nms:
        raise NotImplementedError("only rotated NMS is ported")
    if cfg.box_code_size != 7:
        raise NotImplementedError("predict decodes 7-dof residuals only")
    _refuse_unported_heads(cfg)
    p = flatten_preds(preds, cfg)
    box_preds = p["box_preds"].float()
    scores_all = torch.sigmoid(p["cls_preds"].float())    # [B, A, C]
    if anchors_mask is not None:
        scores_all = torch.where(anchors_mask[..., None], scores_all,
                                 torch.zeros((), device=scores_all.device))

    B, A = box_preds.shape[:2]
    C = cfg.num_class
    D = cfg.nms_post_max_size
    pre = min(cfg.nms_pre_max_size, A)
    neg_inf = torch.tensor(-math.inf, device=box_preds.device)

    # top-k FIRST (scores only), then decode / dir-fix / NMS the k winners
    # per (sample, class) row.  A stable descending sort breaks ties by
    # the lower anchor index, as jax.lax.top_k does (torch.topk does not
    # promise an order among ties).
    sc = scores_all.permute(0, 2, 1)                       # [B, C, A]
    sc = torch.where(sc >= cfg.nms_score_threshold, sc, neg_inf)
    top_sc, top_idx = torch.sort(sc.reshape(B * C, A), dim=1,
                                 descending=True, stable=True)
    top_sc, top_idx = top_sc[:, :pre], top_idx[:, :pre]

    idx_b = top_idx.reshape(B, C * pre)
    boxes_top = box_ops.second_box_decode(_take_rows(box_preds, idx_b),
                                          _take_rows(anchors.float(), idx_b))
    gathered_dir = _take_rows(p["dir_cls_preds"].float(), idx_b)
    dir_labels = torch.argmax(gathered_dir, dim=-1)
    period = 2 * math.pi / cfg.num_direction_bins
    dir_rot = box_ops.limit_period(
        boxes_top[..., 6] - cfg.direction_offset, 0.0, period)
    yaw = (dir_rot + cfg.direction_offset
           + period * dir_labels.to(torch.float32))
    boxes_top = torch.cat([boxes_top[..., :6], yaw[..., None]], dim=-1)

    if cfg.post_center_limit_range:
        lim = cfg.post_center_limit_range
        centers_ok = ((boxes_top[..., 0] >= lim[0])
                      & (boxes_top[..., 1] >= lim[1])
                      & (boxes_top[..., 2] >= lim[2])
                      & (boxes_top[..., 0] <= lim[3])
                      & (boxes_top[..., 1] <= lim[4])
                      & (boxes_top[..., 2] <= lim[5]))
        top_sc = torch.where(centers_ok.reshape(B * C, pre), top_sc, neg_inf)

    boxes_r = boxes_top.reshape(B * C, pre, boxes_top.shape[-1])
    bev = boxes_r[:, :, [0, 1, 3, 4, 6]]
    idx, valid = nms.rotate_nms_presorted(bev, top_sc, cfg.nms_iou_threshold,
                                          post_max_size=D)
    safe = torch.where(valid, idx, 0).long()               # [B*C, D]
    boxes = _take_rows(boxes_r, safe)
    scores = torch.where(valid, torch.gather(top_sc, 1, safe),
                         torch.zeros((), device=top_sc.device))
    if cfg.nms_center_suppress_radius > 0:
        valid = nms.center_suppress_presorted(
            boxes[..., :2], valid, cfg.nms_center_suppress_radius)
        scores = torch.where(valid, scores,
                             torch.zeros((), device=scores.device))
    labels = torch.arange(C, dtype=torch.int32, device=boxes.device)
    labels = labels[None, :, None].expand(B, C, D)
    return {"box3d_lidar": boxes.reshape(B, C * D, -1),
            "scores": scores.reshape(B, C * D),
            "label_preds": labels.reshape(B, C * D),
            "valid": valid.reshape(B, C * D)}
