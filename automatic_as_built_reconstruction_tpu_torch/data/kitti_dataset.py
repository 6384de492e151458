"""KITTI dataset adapter: infos pkl -> sensor data; detections -> KITTI
annos -> official eval.

The port's copy of the JAX package's ``data/kitti_dataset.py``:
``get_sensor_data`` (the scan, calib and the DontCare-free annotations
as lidar boxes), ``convert_detection_to_kitti_annos`` (lidar detections
-> camera boxes, 2D image boxes, alpha) and ``evaluation`` (the KITTI
protocol of ``utils/eval.py``, result files under ``output_dir``).
Importing this module registers ``KittiDataset``.
"""
from __future__ import annotations

import pathlib
import pickle
from typing import List

import numpy as np

from ..core import box_ops
from ..utils import eval as eval_mod
from . import kitti_common as kitti
from .dataset import Dataset, register_dataset


@register_dataset
class KittiDataset(Dataset):
    NumPointFeatures = 4

    def __init__(self, root_path: str, info_path: str,
                 class_names=("Car",), num_point_features: int = 4):
        self._root = pathlib.Path(root_path)
        with open(info_path, "rb") as f:
            self._infos: List[dict] = pickle.load(f)
        self._class_names = list(class_names)
        self._num_point_features = num_point_features

    def __len__(self):
        return len(self._infos)

    def get_sensor_data(self, idx: int) -> dict:
        info = self._infos[idx]
        v_path = pathlib.Path(info["velodyne_path"])
        if not v_path.is_absolute():
            v_path = self._root / v_path
        points = np.fromfile(str(v_path), dtype=np.float32).reshape(
            -1, self._num_point_features)
        calib = {
            "P2": info["calib/P2"],
            "R0_rect": info["calib/R0_rect"],
            "Tr_velo_to_cam": info["calib/Tr_velo_to_cam"],
        }
        res = {
            "lidar": {"points": points},
            "metadata": {"image_idx": info["image_idx"],
                         "image_shape": info["img_shape"]},
            "calib": calib,
        }
        if "annos" in info:
            annos = kitti.remove_dontcare(info["annos"])
            boxes_cam = kitti.anno_to_rbboxes(annos)
            boxes_lidar = box_ops.box_camera_to_lidar(
                boxes_cam, calib["R0_rect"], calib["Tr_velo_to_cam"])
            res["annotations"] = {
                "boxes": boxes_lidar.astype(np.float32),
                "names": annos["name"],
                "difficulty": annos.get(
                    "difficulty", np.zeros(len(annos["name"]), np.int32)),
            }
        return res

    # ------------------------------------------------------------------
    # detection conversion + eval
    # ------------------------------------------------------------------

    def convert_detection_to_kitti_annos(self, detections: List[dict]
                                         ) -> List[dict]:
        """Per-sample predict() outputs -> KITTI camera-frame annos."""
        annos = []
        for i, det in enumerate(detections):
            info = self._infos[i]
            calib_rect = info["calib/R0_rect"]
            calib_v2c = info["calib/Tr_velo_to_cam"]
            P2 = info["calib/P2"]
            img_shape = info["img_shape"]
            boxes = np.asarray(det["box3d_lidar"], np.float64)
            scores = np.asarray(det["scores"], np.float64)
            labels = np.asarray(det["label_preds"], np.int64)
            if len(boxes) == 0:
                annos.append(kitti.empty_result_anno())
                continue
            boxes_cam = box_ops.box_lidar_to_camera(
                boxes, calib_rect, calib_v2c)
            # project to image for 2D bbox
            locs, dims = boxes_cam[:, :3], boxes_cam[:, 3:6]
            rys = boxes_cam[:, 6]
            corners = box_ops.center_to_corner_box3d(
                locs, dims[:, [0, 2, 1]], rys,
                origin=(0.5, 1.0, 0.5), axis=1)
            corners2d = np.stack(
                [box_ops.project_to_image(c, P2) for c in corners])
            minmax = np.concatenate(
                [corners2d.min(axis=1), corners2d.max(axis=1)], axis=1)
            minmax[:, [0, 2]] = np.clip(minmax[:, [0, 2]], 0, img_shape[1])
            minmax[:, [1, 3]] = np.clip(minmax[:, [1, 3]], 0, img_shape[0])
            anno = {
                "name": np.array([self._class_names[j] for j in labels]),
                "truncated": np.zeros(len(boxes)),
                "occluded": np.zeros(len(boxes), np.int64),
                "alpha": (-np.arctan2(-boxes[:, 1], boxes[:, 0])
                          + boxes_cam[:, 6]),
                "bbox": minmax,
                "dimensions": boxes_cam[:, 3:6],
                "location": boxes_cam[:, :3],
                "rotation_y": boxes_cam[:, 6],
                "score": scores,
            }
            annos.append(anno)
        return annos

    def ground_truth_annotations(self) -> List[dict]:
        return [info["annos"] for info in self._infos]

    def evaluation(self, detections, output_dir=None) -> dict:
        dt_annos = self.convert_detection_to_kitti_annos(detections)
        gt_annos = self.ground_truth_annotations()
        result = eval_mod.get_official_eval_result(
            gt_annos, dt_annos, self._class_names)
        if output_dir:
            (pathlib.Path(output_dir) / "result.txt").write_text(
                result["result_str"])
            kitti.write_kitti_results(
                dt_annos, [i["image_idx"] for i in self._infos],
                pathlib.Path(output_dir) / "data")
        return result
