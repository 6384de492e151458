"""Input reader config message -> (PrepDataset, BatchLoader), as the JAX
package's ``builder/input_reader_builder.py::build`` does: the dataset
(``BuildingDataset``: 256 synthetic training scenes from seed 0 or 32 val
scenes from seed 7; ``KittiDataset``: the info pickle of the config),
the training reader shuffled, repeated and its last partial batch
dropped, the eval reader in order, once; the ground-truth database
sampler of a training reader, its generator seeded
``np.random.default_rng(seed)`` as the reference seeds it; the loader's
worker pools.  Bucketed shapes and host rulebooks are not ported and
raise ``NotImplementedError``."""
from __future__ import annotations

import functools

import numpy as np

from ..core import box_ops
from ..data import building  # noqa: F401 - registers BuildingDataset
from ..data import kitti_dataset  # noqa: F401 - registers KittiDataset
from ..data.dataset import get_dataset_class
from ..data.preprocess import PrepConfig, prep_pointcloud
from ..train.input_pipeline import BatchLoader, PrepDataset
from . import dbsampler_builder
from .config_io import as_list, f32


def _build_dataset(ds_cfg: dict, class_names, training: bool):
    cls = get_dataset_class(ds_cfg.get("dataset_class_name")
                            or "KittiDataset")
    if cls.__name__ == "BuildingDataset":
        return cls(root_path=ds_cfg.get("kitti_root_path") or None,
                   info_path=ds_cfg.get("kitti_info_path") or None,
                   class_names=class_names or building.CLASSES,
                   num_synthetic=256 if training else 32,
                   synthetic_seed=0 if training else 7)
    return cls(root_path=ds_cfg.get("kitti_root_path"),
               info_path=ds_cfg.get("kitti_info_path"),
               class_names=class_names)


def _prep_config(pp: dict, class_names, out_size_factor) -> PrepConfig:
    def floats(key, default):
        v = tuple(f32(x) for x in as_list(pp.get(key)))
        return v if v else default

    return PrepConfig(
        class_names=tuple(class_names),
        max_voxels=int(pp.get("max_number_of_voxels", 0)) or 12000,
        shuffle_points=bool(pp.get("shuffle_points", False)),
        gt_loc_noise_std=floats("groundtruth_localization_noise_std",
                                (0.0, 0.0, 0.0)),
        gt_rotation_noise=floats("groundtruth_rotation_uniform_noise",
                                 (0.0, 0.0)),
        global_rotation_noise=floats("global_rotation_uniform_noise",
                                     (0.0, 0.0)),
        global_scaling_noise=floats("global_scaling_uniform_noise",
                                    (1.0, 1.0)),
        global_translate_noise_std=floats("global_translate_noise_std",
                                          (0.0, 0.0, 0.0)),
        random_flip_x=bool(pp.get("random_flip_x", False)),
        random_flip_y=bool(pp.get("random_flip_y", False)),
        # an unset (0) threshold disables the mask, as in the reference
        anchor_area_threshold=(f32(pp.get("anchor_area_threshold", 0.0))
                               or -1.0),
        min_points_in_gt=int(pp.get("min_num_of_points_in_gt", 0)) or -1,
        remove_points_after_sample=bool(
            pp.get("remove_points_after_sample", False)),
        symmetric_yaw=bool(pp.get("symmetric_yaw", False)),
        gt_points_drop_percentage=f32(
            pp.get("groundtruth_points_drop_percentage", 0.0)),
        gt_drop_max_keep_points=int(
            pp.get("groundtruth_drop_max_keep_points", 0)) or 10,
        frustum_dropout_prob=f32(pp.get("frustum_dropout_prob", 0.0)),
        frustum_dropout_azimuth_width=(
            f32(pp.get("frustum_dropout_azimuth_width", 0.0))
            or float(np.pi / 12)),
        sort_voxels_by_key=bool(pp.get("sort_voxels_by_key", False)),
        out_size_factor=out_size_factor,
    )


def build(input_cfg: dict, training: bool, voxel_generator, target_assigner,
          feature_map_size, seed: int = 0, middle_plan=None,
          capacity_shrink=None, out_caps=None):
    """Returns (PrepDataset, BatchLoader).  ``middle_plan`` (host rulebook
    precompute) must be None: key-match and device-built rulebooks need
    none, and host rulebooks are not ported."""
    if middle_plan is not None:
        raise NotImplementedError("host-built rulebooks are not ported")
    class_names = list(as_list(input_cfg.get("class_names")))
    dataset = _build_dataset(input_cfg.get("dataset", {}), class_names,
                             training)
    pp = input_cfg.get("preprocess", {})
    if training and as_list(pp.get("static_shape_buckets")):
        raise NotImplementedError("bucketed static shapes are not ported")
    prep_cfg = _prep_config(pp, class_names or ["Car"], out_size_factor=1)

    db_sampler = None
    if training and pp.get("database_sampler", {}).get(
            "database_info_path"):
        db_sampler = dbsampler_builder.build(
            pp["database_sampler"], rng=np.random.default_rng(seed))

    # anchor cache: computed once for the fixed feature map
    ret = target_assigner.generate_anchors(feature_map_size)
    anchors = ret["anchors"].reshape(-1, 7).astype(np.float32)
    anchor_cache = {
        "anchors": anchors,
        "anchors_bv": box_ops.rbbox2d_to_near_bbox(
            anchors[:, [0, 1, 3, 4, 6]]),
        "matched_thresholds": ret["matched_thresholds"],
        "unmatched_thresholds": ret["unmatched_thresholds"],
    }
    prep_fn = functools.partial(
        prep_pointcloud, voxel_generator=voxel_generator,
        target_assigner=target_assigner, prep_cfg=prep_cfg,
        training=training, anchor_cache=anchor_cache,
        db_sampler=db_sampler)
    prep_ds = PrepDataset(dataset, lambda sd, rng: prep_fn(sd, rng=rng))
    loader = BatchLoader(
        prep_ds, batch_size=int(input_cfg.get("batch_size", 0)) or 2,
        shuffle=training,
        num_workers=int(input_cfg.get("num_workers", 0)) or 1, seed=seed,
        repeat=training, drop_last=training,
        process_workers=bool(input_cfg.get("process_workers", False)))
    return prep_ds, loader
