"""The per-sample prep path: sensor data -> static-shape example.

The port's copy of the JAX package's ``data/preprocess.py``.  One function
(:func:`prep_pointcloud`) does, in order: (training) gt class filter ->
``min_points_in_gt`` -> ground-truth database paste-in (``db_sampler``)
-> point dropping in gt boxes -> frustum dropout ->
per-object noise -> global flip / rotation / scaling / translation ->
range filter -> yaw wrap; then point shuffle -> host voxelization -> (key
sort) -> padding to the static capacities (max_voxels /
max_points_per_voxel, so that batches stack into fixed-shape buffers;
validity is carried in counts and -1 coords) -> anchors (cached) ->
anchor mask (BEV density integral image) -> (training) target
assignment.  Every rng call is the reference's, in its order, so one
seed (and one sampler state) gives the reference's example.  Host-built
sparse rulebooks are not ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from ..core import augment, box_ops
from ..core.target_assign import TargetAssigner
from ..core.voxelize import VoxelGenerator


@dataclasses.dataclass
class PrepConfig:
    """The fields of the input reader's ``preprocess`` message that prep
    reads (same names and defaults as the JAX package's ``PrepConfig``)."""

    class_names: Sequence[str] = ("Car",)
    max_voxels: int = 12000
    shuffle_points: bool = True
    gt_loc_noise_std: Sequence[float] = (0.25, 0.25, 0.25)
    gt_rotation_noise: Sequence[float] = (-np.pi / 20, np.pi / 20)
    global_rotation_noise: Sequence[float] = (-np.pi / 4, np.pi / 4)
    global_scaling_noise: Sequence[float] = (0.95, 1.05)
    global_translate_noise_std: Sequence[float] = (0.0, 0.0, 0.0)
    random_flip_x: bool = False
    random_flip_y: bool = True
    anchor_area_threshold: float = -1.0
    remove_unknown: bool = False
    min_points_in_gt: int = -1
    remove_points_after_sample: bool = False
    symmetric_yaw: bool = False
    gt_points_drop_percentage: float = 0.0
    gt_drop_max_keep_points: int = 10
    frustum_dropout_prob: float = 0.0
    frustum_dropout_azimuth_width: float = np.pi / 12
    # re-sort voxel rows by ascending linear key after voxelization
    # (SECOND's mean VFE is order-insensitive; the sparse middle wants
    # its sites in key order)
    sort_voxels_by_key: bool = False
    out_size_factor: int = 2


def prep_pointcloud(input_dict: dict,
                    voxel_generator: VoxelGenerator,
                    target_assigner: TargetAssigner,
                    prep_cfg: PrepConfig,
                    training: bool,
                    anchor_cache: Optional[dict] = None,
                    db_sampler=None,
                    rng: Optional[np.random.Generator] = None,
                    feature_map_size: Optional[Sequence[int]] = None,
                    middle_plan=None,
                    middle_plan_buckets=None) -> Dict[str, np.ndarray]:
    """Sensor-data dict -> example dict of fixed-capacity numpy arrays:
    ``voxels`` [V, T, C], ``num_points`` [V], ``coordinates`` [V, 3]
    (z, y, x; -1 padding), ``num_voxels``, ``anchors`` [A, 7], and, where
    present or configured, ``metadata``, ``calib`` and ``anchors_mask``.
    With ``training`` also ``labels`` [A], ``reg_targets`` [A, code],
    ``importance`` [A], ``gt_boxes`` [G, 7] and ``gt_names`` [G].
    """
    if middle_plan is not None or middle_plan_buckets is not None:
        raise NotImplementedError("host-built rulebooks are not ported")
    rng = rng or np.random.default_rng()
    points = np.array(input_dict["lidar"]["points"], np.float32, copy=True)
    class_names = list(prep_cfg.class_names)

    gt_boxes = gt_names = gt_classes = None
    if training:
        annos = input_dict["annotations"]
        gt_boxes = np.asarray(annos["boxes"], np.float32).reshape(-1, 7).copy()
        gt_names = np.asarray(annos["names"]).reshape(-1)

        # keep known classes (+ sampler-relevant names)
        selected = np.array(
            [i for i, n in enumerate(gt_names) if n in class_names
             or not prep_cfg.remove_unknown], dtype=np.int64)
        gt_boxes, gt_names = gt_boxes[selected], gt_names[selected]

        if prep_cfg.min_points_in_gt > 0 and len(gt_boxes):
            counts = box_ops.points_in_rbbox(points, gt_boxes).sum(0)
            keep = counts >= prep_cfg.min_points_in_gt
            gt_boxes, gt_names = gt_boxes[keep], gt_names[keep]

        if db_sampler is not None:
            sampled = db_sampler.sample_all(gt_boxes, gt_names,
                                            points.shape[1])
            if sampled is not None:
                gt_boxes = np.concatenate([gt_boxes, sampled["gt_boxes"]])
                gt_names = np.concatenate([gt_names, sampled["gt_names"]])
                if prep_cfg.remove_points_after_sample:
                    points = box_ops.remove_points_in_boxes(
                        points, sampled["gt_boxes"])
                points = np.concatenate([sampled["points"], points])

        if prep_cfg.gt_points_drop_percentage > 0:
            points = augment.drop_points_in_gt(
                points, gt_boxes, prep_cfg.gt_points_drop_percentage,
                prep_cfg.gt_drop_max_keep_points, rng=rng)
        if prep_cfg.frustum_dropout_prob > 0:
            points = augment.frustum_dropout(
                points, prep_cfg.frustum_dropout_prob,
                prep_cfg.frustum_dropout_azimuth_width, rng=rng)
        if (np.any(np.asarray(prep_cfg.gt_loc_noise_std) > 0)
                or np.any(np.asarray(prep_cfg.gt_rotation_noise) != 0)):
            augment.noise_per_object(
                gt_boxes, points,
                rotation_perturb=prep_cfg.gt_rotation_noise,
                center_noise_std=prep_cfg.gt_loc_noise_std, rng=rng)
        gt_boxes, points, _ = augment.random_flip(
            gt_boxes, points, flip_x=prep_cfg.random_flip_x,
            flip_y=prep_cfg.random_flip_y, rng=rng)
        gt_boxes, points, _ = augment.global_rotation(
            gt_boxes, points, prep_cfg.global_rotation_noise, rng=rng)
        gt_boxes, points, _ = augment.global_scaling(
            gt_boxes, points, prep_cfg.global_scaling_noise, rng=rng)
        augment.global_translate(
            gt_boxes, points, prep_cfg.global_translate_noise_std, rng=rng)

        pc_range = np.asarray(voxel_generator.point_cloud_range)
        mask = box_ops.filter_gt_box_outside_range(
            gt_boxes, [pc_range[0], pc_range[1], pc_range[3], pc_range[4]])
        gt_boxes, gt_names = gt_boxes[mask], gt_names[mask]
        gt_boxes[:, 6] = box_ops.limit_period(
            gt_boxes[:, 6], offset=0.5,
            period=(np.pi if prep_cfg.symmetric_yaw else 2 * np.pi))
        gt_classes = np.array(
            [class_names.index(n) + 1 if n in class_names else -1
             for n in gt_names], dtype=np.int32)
        keep = gt_classes > 0
        gt_boxes, gt_names, gt_classes = (
            gt_boxes[keep], gt_names[keep], gt_classes[keep])

    if prep_cfg.shuffle_points:
        points = points[rng.permutation(len(points))]

    voxels_r, coords_r, num_points_r = voxel_generator.generate(
        points, prep_cfg.max_voxels)
    if prep_cfg.sort_voxels_by_key and len(coords_r):
        # depth-minor key (y, x, z) — matches ops.sparse_conv.linearize
        gsz = voxel_generator.grid_size          # (gx, gy, gz)
        keys = ((coords_r[:, 1].astype(np.int64) * int(gsz[0])
                 + coords_r[:, 2]) * int(gsz[2]) + coords_r[:, 0])
        order = np.argsort(keys, kind="stable")
        voxels_r, coords_r, num_points_r = (
            voxels_r[order], coords_r[order], num_points_r[order])
    nv = len(voxels_r)
    V, T = prep_cfg.max_voxels, voxel_generator.max_num_points
    C = points.shape[1]
    voxels = np.zeros((V, T, C), np.float32)
    voxels[:nv] = voxels_r
    coords = np.full((V, 3), -1, np.int32)
    coords[:nv] = coords_r
    num_points = np.zeros((V,), np.int32)
    num_points[:nv] = num_points_r

    example: Dict[str, np.ndarray] = {
        "voxels": voxels.astype(np.float32),
        "num_points": num_points.astype(np.int32),
        "coordinates": coords.astype(np.int32),
        "num_voxels": np.asarray(nv, np.int32),
    }
    if "metadata" in input_dict:
        example["metadata"] = input_dict["metadata"]
    if "calib" in input_dict:
        example["calib"] = input_dict["calib"]

    # anchors (computed once, cached by the input reader)
    if anchor_cache is not None:
        anchors = anchor_cache["anchors"]
        anchors_bv = anchor_cache["anchors_bv"]
        matched_thresholds = anchor_cache["matched_thresholds"]
        unmatched_thresholds = anchor_cache["unmatched_thresholds"]
    else:
        if feature_map_size is None:
            raise ValueError("prep_pointcloud needs an anchor_cache or a "
                             "feature_map_size")
        ret = target_assigner.generate_anchors(feature_map_size)
        anchors = ret["anchors"].reshape(-1, 7).astype(np.float32)
        matched_thresholds = ret["matched_thresholds"]
        unmatched_thresholds = ret["unmatched_thresholds"]
        anchors_bv = box_ops.rbbox2d_to_near_bbox(
            anchors[:, [0, 1, 3, 4, 6]])
    example["anchors"] = anchors

    anchors_mask = None
    if prep_cfg.anchor_area_threshold >= 0:
        grid_size = voxel_generator.grid_size
        dense_map = box_ops.sparse_sum_for_anchors_mask(
            coords[:nv], (int(grid_size[1]), int(grid_size[0])))
        area = box_ops.fused_get_anchors_area(
            dense_map, anchors_bv, voxel_generator.voxel_size,
            voxel_generator.point_cloud_range, grid_size)
        anchors_mask = (area > prep_cfg.anchor_area_threshold)
        example["anchors_mask"] = anchors_mask

    if training:
        targets = target_assigner.assign(
            anchors, gt_boxes, anchors_mask=anchors_mask,
            gt_classes=gt_classes,
            matched_thresholds=matched_thresholds,
            unmatched_thresholds=unmatched_thresholds)
        example["labels"] = targets["labels"]
        example["reg_targets"] = targets["bbox_targets"]
        example["importance"] = targets["bbox_outside_weights"]
        example["gt_boxes"] = gt_boxes
        example["gt_names"] = gt_names
    return example
