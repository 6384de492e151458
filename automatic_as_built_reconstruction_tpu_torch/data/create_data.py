"""Offline data creation for KITTI: split infos, frustum-reduced clouds
and the ground-truth database.

The port's copy of the JAX package's ``data/create_data.py``:
``kitti_data_prep`` (infos of ``ImageSets/train.txt`` and ``val.txt``,
reduced clouds, the gt database of the training split),
``create_reduced_point_cloud``, ``_create_kitti_gt_database`` and
``create_groundtruth_database_from_infos`` (per-object crops stored
box-relative, and their db infos).  The same inputs give the same files.
The building-scan prep of the reference is not ported.
"""
from __future__ import annotations

import pathlib
import pickle

import numpy as np

from ..core import box_ops
from . import kitti_common as kitti


def create_groundtruth_database_from_infos(root, infos, db_info_name,
                                           points_loader) -> None:
    """Crop per-object points (box-relative) + db info pkl."""
    root = pathlib.Path(root)
    (root / "gt_database").mkdir(parents=True, exist_ok=True)
    db_infos: dict = {}
    obj_idx = 0
    for info in infos:
        points = points_loader(info)
        boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 7)
        names = np.asarray(info["gt_names"])
        if len(boxes) == 0:
            continue
        masks = box_ops.points_in_rbbox(points, boxes)
        for i in range(len(boxes)):
            pts = points[masks[:, i]].astype(np.float32).copy()
            pts[:, :3] -= boxes[i, :3]  # store box-relative
            rel = f"gt_database/obj_{obj_idx:07d}.bin"
            pts.tofile(root / rel)
            name = str(names[i])
            db_infos.setdefault(name, []).append({
                "name": name, "path": rel,
                "box3d_lidar": boxes[i],
                "num_points_in_gt": int(masks[:, i].sum()),
                "difficulty": 0,
            })
            obj_idx += 1
    with open(root / db_info_name, "wb") as f:
        pickle.dump(db_infos, f)
    counts = {k: len(v) for k, v in db_infos.items()}
    print(f"gt database: {counts} -> {root / db_info_name}")


def kitti_data_prep(root_path) -> None:
    root = pathlib.Path(root_path)
    train_ids = _read_split(root, "train.txt")
    val_ids = _read_split(root, "val.txt")

    infos_train = kitti.get_kitti_image_info(
        root, training=True, image_ids=train_ids)
    with open(root / "kitti_infos_train.pkl", "wb") as f:
        pickle.dump(infos_train, f)
    infos_val = kitti.get_kitti_image_info(
        root, training=True, image_ids=val_ids)
    with open(root / "kitti_infos_val.pkl", "wb") as f:
        pickle.dump(infos_val, f)

    create_reduced_point_cloud(root, infos_train + infos_val)
    _create_kitti_gt_database(root, infos_train)
    print(f"kitti data prep done under {root}")


def _read_split(root: pathlib.Path, name: str):
    p = root / "ImageSets" / name
    if p.exists():
        return [int(line) for line in p.read_text().split()]
    return None


def create_reduced_point_cloud(root, infos, save_suffix="_reduced") -> None:
    """Frustum-crop velodyne scans to the camera FOV."""
    root = pathlib.Path(root)
    for info in infos:
        v_path = root / info["velodyne_path"]
        points = np.fromfile(str(v_path), dtype=np.float32).reshape(-1, 4)
        reduced = box_ops.remove_outside_points(
            points, info["calib/R0_rect"], info["calib/Tr_velo_to_cam"],
            info["calib/P2"], info["img_shape"])
        out_dir = v_path.parent.parent / (v_path.parent.name + save_suffix)
        out_dir.mkdir(exist_ok=True)
        reduced.tofile(out_dir / v_path.name)


def _create_kitti_gt_database(root, infos) -> None:
    def loader(info):
        v_path = pathlib.Path(info["velodyne_path"])
        reduced = (root / v_path.parent.parent
                   / (v_path.parent.name + "_reduced") / v_path.name)
        path = reduced if reduced.exists() else root / v_path
        return np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)

    conv = []
    for info in infos:
        annos = kitti.remove_dontcare(info["annos"])
        boxes_cam = kitti.anno_to_rbboxes(annos)
        boxes_lidar = box_ops.box_camera_to_lidar(
            boxes_cam, info["calib/R0_rect"], info["calib/Tr_velo_to_cam"])
        conv.append({
            "path": info["velodyne_path"],
            "velodyne_path": info["velodyne_path"],
            "gt_boxes": boxes_lidar, "gt_names": annos["name"],
            "calib/R0_rect": info["calib/R0_rect"],
            "calib/Tr_velo_to_cam": info["calib/Tr_velo_to_cam"],
        })
    create_groundtruth_database_from_infos(
        root, conv, "kitti_dbinfos_train.pkl", points_loader=loader)
