"""KITTI format utilities: labels, calib, info dicts, difficulty, result
writers.

The port's copy of the JAX package's ``data/kitti_common.py`` (numpy and
text files only; the same parsing, the same dicts).
"""
from __future__ import annotations

import pathlib
from typing import Dict, List

import numpy as np


def get_image_index_str(img_idx: int) -> str:
    return f"{img_idx:06d}"


def _paths(root, idx, folder, suffix, training=True, relative=False):
    base = pathlib.Path("training" if training else "testing") / folder
    rel = base / (get_image_index_str(idx) + suffix)
    return str(rel) if relative else str(pathlib.Path(root) / rel)


def get_velodyne_path(idx, root, training=True, relative_path=False):
    return _paths(root, idx, "velodyne", ".bin", training, relative_path)


def get_image_path(idx, root, training=True, relative_path=False):
    return _paths(root, idx, "image_2", ".png", training, relative_path)


def get_label_path(idx, root, training=True, relative_path=False):
    return _paths(root, idx, "label_2", ".txt", training, relative_path)


def get_calib_path(idx, root, training=True, relative_path=False):
    return _paths(root, idx, "calib", ".txt", training, relative_path)


def get_label_anno(label_path_or_lines) -> dict:
    """Parse a KITTI label file (or list of lines) into an anno dict."""
    if isinstance(label_path_or_lines, (str, pathlib.Path)):
        with open(label_path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = label_path_or_lines
    content = [line.strip().split(" ") for line in lines if line.strip()]
    annotations = {
        "name": np.array([x[0] for x in content]),
        "truncated": np.array([float(x[1]) for x in content]),
        "occluded": np.array([int(float(x[2])) for x in content]),
        "alpha": np.array([float(x[3]) for x in content]),
        "bbox": np.array([[float(v) for v in x[4:8]] for x in content]
                         ).reshape(-1, 4),
        # KITTI stores h, w, l; keep lineage order l, h, w in 'dimensions'?
        # devkit order in file: h w l; we store (l, h, w) per lineage
        "dimensions": np.array([[float(x[10]), float(x[8]), float(x[9])]
                                for x in content]).reshape(-1, 3),
        "location": np.array([[float(v) for v in x[11:14]] for x in content]
                             ).reshape(-1, 3),
        "rotation_y": np.array([float(x[14]) for x in content]),
    }
    annotations["score"] = (
        np.array([float(x[15]) for x in content])
        if content and len(content[0]) == 16
        else np.zeros(len(content)))
    num_obj = int(np.sum(annotations["name"] != "DontCare"))
    annotations["index"] = np.concatenate(
        [np.arange(num_obj, dtype=np.int32),
         -np.ones(len(content) - num_obj, dtype=np.int32)])
    annotations["group_ids"] = np.arange(len(content), dtype=np.int32)
    return annotations


def get_calib(calib_path) -> Dict[str, np.ndarray]:
    """Parse a KITTI calib file into 4x4 matrices (extended)."""
    with open(calib_path) as f:
        lines = f.readlines()

    def mat(line, shape):
        vals = np.array([float(v) for v in line.split(":")[1].split()])
        return vals.reshape(shape)

    out = {}
    for line in lines:
        if not line.strip():
            continue
        key = line.split(":")[0]
        if key.startswith("P"):
            out[key] = _extend_matrix(mat(line, (3, 4)))
        elif key == "R0_rect":
            r = np.eye(4)
            r[:3, :3] = mat(line, (3, 3))
            out["R0_rect"] = r
        elif key in ("Tr_velo_to_cam", "Tr_imu_to_velo"):
            out[key] = _extend_matrix(mat(line, (3, 4)))
    return out


def _extend_matrix(m34: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [m34, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def get_kitti_image_info(root_path, training=True, label_info=True,
                         velodyne=True, calib=True, image_ids=None,
                         relative_path=True,
                         image_shapes: dict | None = None) -> List[dict]:
    """Build the offline per-frame info dicts (paths + calib + annos)."""
    if image_ids is None:
        split = "training" if training else "testing"
        vdir = pathlib.Path(root_path) / split / "velodyne"
        image_ids = sorted(int(p.stem) for p in vdir.glob("*.bin"))
    infos = []
    for idx in image_ids:
        info = {"image_idx": idx,
                "pointcloud_num_features": 4}
        if velodyne:
            info["velodyne_path"] = get_velodyne_path(
                idx, root_path, training, relative_path)
        info["img_path"] = get_image_path(idx, root_path, training,
                                          relative_path)
        if image_shapes and idx in image_shapes:
            info["img_shape"] = np.asarray(image_shapes[idx], np.int32)
        else:
            info["img_shape"] = np.array([375, 1242], np.int32)
        if calib:
            c = get_calib(get_calib_path(idx, root_path, training, False))
            info["calib/P2"] = c.get("P2")
            info["calib/R0_rect"] = c.get("R0_rect")
            info["calib/Tr_velo_to_cam"] = c.get("Tr_velo_to_cam")
        if label_info:
            anno = get_label_anno(get_label_path(idx, root_path, training,
                                                 False))
            info["annos"] = anno
            add_difficulty_to_annos(info)
        infos.append(info)
    return infos


def add_difficulty_to_annos(info: dict) -> None:
    from ..utils.eval import kitti_difficulty
    anno = info["annos"]
    anno["difficulty"] = kitti_difficulty({
        "bbox": anno["bbox"], "occluded": anno["occluded"],
        "truncated": anno["truncated"]})


def remove_dontcare(anno: dict) -> dict:
    keep = anno["name"] != "DontCare"
    return {k: (v[keep] if isinstance(v, np.ndarray) and len(v) == len(keep)
                else v) for k, v in anno.items()}


def filter_kitti_anno(anno: dict, used_classes) -> dict:
    keep = np.array([n in used_classes for n in anno["name"]], bool)
    return {k: (v[keep] if isinstance(v, np.ndarray) and len(v) == len(keep)
                else v) for k, v in anno.items()}


def anno_to_rbboxes(anno: dict) -> np.ndarray:
    """Camera-frame anno -> [N, 7] camera boxes (x,y,z,l,h,w,ry)."""
    return np.concatenate(
        [anno["location"], anno["dimensions"], anno["rotation_y"][..., None]],
        axis=1)


def empty_result_anno() -> dict:
    return {
        "name": np.array([]), "truncated": np.array([]),
        "occluded": np.array([]), "alpha": np.array([]),
        "bbox": np.zeros([0, 4]), "dimensions": np.zeros([0, 3]),
        "location": np.zeros([0, 3]), "rotation_y": np.array([]),
        "score": np.array([]),
    }


def anno_to_kitti_label_lines(anno: dict) -> list:
    """Result anno -> KITTI label/result txt lines (submission format)."""
    lines = []
    for i in range(len(anno["name"])):
        lines.append(
            f"{anno['name'][i]} "
            f"{float(anno['truncated'][i]):.2f} "
            f"{int(anno['occluded'][i])} "
            f"{float(anno['alpha'][i]):.2f} "
            + " ".join(f"{v:.2f}" for v in anno["bbox"][i]) + " "
            + " ".join(f"{v:.2f}" for v in
                       anno["dimensions"][i][[1, 2, 0]]) + " "  # h w l
            + " ".join(f"{v:.2f}" for v in anno["location"][i]) + " "
            f"{float(anno['rotation_y'][i]):.2f} "
            f"{float(anno['score'][i]):.4f}")
    return lines


def write_kitti_results(annos, image_ids, out_dir) -> None:
    """Write per-frame result txts (KITTI submission layout)."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for anno, idx in zip(annos, image_ids):
        (out / f"{get_image_index_str(idx)}.txt").write_text(
            "\n".join(anno_to_kitti_label_lines(anno)) + "\n")
