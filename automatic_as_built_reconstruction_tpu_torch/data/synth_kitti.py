"""A synthetic KITTI clone: frames in the KITTI directory layout
(velodyne ``.bin``, ``label_2`` and ``calib`` text files, ``ImageSets``
splits) with lidar-like car shells, ground and clutter, then the offline
prep of ``data/create_data.py`` (infos, reduced clouds, gt database).

The port's own copy of the repository's ``tools/make_synth_kitti.py``
(``make_frame``, ``label_lines``, the calibration and the splits): the
same seed writes the same files, byte for byte.  No download: training
and evaluating ``car.fhd.config`` on the card run on this clone.

    python -m automatic_as_built_reconstruction_tpu_torch.data.synth_kitti \
        --root /path/to/clone --num_train 400 --num_val 100 [--seed 0]
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

from ..core import box_ops
from . import create_data

# velodyne -> camera: cam x=right(-velo y), y=down(-velo z), z=fwd(velo x)
TR_VELO_TO_CAM = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, -0.08],
    [0.0, 0.0, 0.0, 1.0]])
P2 = np.array([
    [707.0, 0.0, 604.0, 45.75],
    [0.0, 707.0, 180.5, -0.34],
    [0.0, 0.0, 1.0, 0.005]])
IMG_HW = (375, 1242)


# per-class box-dimension samplers: (w_range, l_range, h_range, z_center)
CLASS_DIMS = {
    "Car": ((1.5, 1.8), (3.4, 4.6), (1.4, 1.75), -1.65),
    "Pedestrian": ((0.5, 0.75), (0.5, 0.85), (1.55, 1.9), -1.35),
    "Cyclist": ((0.5, 0.7), (1.5, 1.95), (1.55, 1.8), -1.4),
}


def sample_box_surface(rng, box, n_base: int = 600, asym: bool = False):
    """Lidar-ish shell sampling of an object box: visible faces only,
    density falling with distance, mild dropout.

    ``asym=True`` (cars) carves a hood/windshield profile into the
    front (+x local) half of the shell, so the point cloud is
    heading-asymmetric and the direction classifier has signal — a
    plain cuboid is 180-degree symmetric and pins loss_dir at ln 2
    (observed in the round-4 rehearsal: aos ~= bbox/2)."""
    x, y, z, w, l, h, yaw = box
    dist = float(np.hypot(x, y))
    n = max(int(n_base * min((12.0 / max(dist, 6.0)) ** 1.7, 1.0)), 25)
    # faces: front/back (l), left/right (w), roof — weighted by area
    areas = np.array([w * h, w * h, l * h, l * h, l * w])
    face = rng.choice(5, n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    local = np.zeros((n, 3))
    local[face == 0] = np.c_[np.full((face == 0).sum(), 0.5),
                             u[face == 0], v[face == 0] + 0.5][:, [0, 1, 2]]
    local[face == 1] = np.c_[np.full((face == 1).sum(), -0.5),
                             u[face == 1], v[face == 1] + 0.5]
    local[face == 2] = np.c_[u[face == 2],
                             np.full((face == 2).sum(), 0.5),
                             v[face == 2] + 0.5]
    local[face == 3] = np.c_[u[face == 3],
                             np.full((face == 3).sum(), -0.5),
                             v[face == 3] + 0.5]
    local[face == 4] = np.c_[u[face == 4], v[face == 4],
                             np.ones((face == 4).sum())]
    local *= np.array([l, w, h])
    if asym:
        # roof height tapers from full h behind the cabin (x <= 0.05*l)
        # down to 0.55*h at the front bumper — shell points above the
        # profile drop onto it (hood + windshield)
        t = np.clip((local[:, 0] / l - 0.05) / 0.45, 0.0, 1.0)
        zcap = h * (1.0 - 0.45 * t)
        local[:, 2] = np.minimum(local[:, 2], zcap)
    local += rng.normal(0, 0.02, local.shape)       # sensor noise
    c, s = np.cos(yaw), np.sin(yaw)
    pts = np.c_[local[:, 0] * c - local[:, 1] * s + x,
                local[:, 0] * s + local[:, 1] * c + y,
                local[:, 2] + z,
                rng.uniform(0.1, 0.9, n)]
    # crude self-occlusion: drop the far half of the shell
    keep = rng.random(n) > 0.35
    return pts[keep]


def make_frame(rng, multiclass: bool = False):
    """One scene: ground + objects + clutter, all inside the camera FOV."""
    quota = [("Car", int(rng.integers(2, 9)))]
    if multiclass:
        quota += [("Pedestrian", int(rng.integers(1, 5))),
                  ("Cyclist", int(rng.integers(0, 4)))]
    boxes, names = [], []
    for name, n_want in quota:
        (wr, lr, hr, zc) = CLASS_DIMS[name]
        placed = 0
        for _ in range(40):
            if placed >= n_want:
                break
            # pedestrians/cyclists are small: keep them nearer the sensor
            x_hi = 62 if name == "Car" else 42
            x = float(rng.uniform(6, x_hi))
            y = float(rng.uniform(-0.45 * x - 2, 0.45 * x + 2))
            if abs(y) > 26:
                continue
            w = float(rng.uniform(*wr))
            l = float(rng.uniform(*lr))
            h = float(rng.uniform(*hr))
            yaw = float(rng.uniform(-np.pi, np.pi))
            cand = np.array([x, y, zc, w, l, h, yaw])
            # BEV center-distance rejection (cheap collision test)
            if all(np.hypot(x - b[0], y - b[1]) > 0.6 * (l + b[4]) + 0.5
                   for b in boxes):
                boxes.append(cand)
                names.append(name)
                placed += 1
    boxes = np.asarray(boxes).reshape(-1, 7)

    pts = []
    n_ground = 9000
    gx = rng.uniform(2, 68, n_ground)
    gy = rng.uniform(-0.5 * gx - 2, 0.5 * gx + 2)
    keep = np.abs(gy) < 30
    pts.append(np.c_[gx[keep], gy[keep],
                     rng.normal(-1.72, 0.02, keep.sum()),
                     rng.random(keep.sum())])
    for b, name in zip(boxes, names):
        # small objects get a denser base shell so they survive distance
        # thinning with a detectable point count
        pts.append(sample_box_surface(
            rng, b, n_base=600 if name == "Car" else 350,
            asym=(name == "Car")))
    # vertical clutter (poles/walls)
    for _ in range(int(rng.integers(2, 7))):
        cx = float(rng.uniform(8, 60))
        cy = float(rng.uniform(-0.4 * cx, 0.4 * cx))
        m = int(rng.integers(40, 150))
        pts.append(np.c_[rng.normal(cx, 0.15, m), rng.normal(cy, 0.15, m),
                         rng.uniform(-1.7, 0.8, m), rng.random(m)])
    points = np.concatenate(pts).astype(np.float32)
    return points[rng.permutation(len(points))], boxes, names


def label_lines(boxes_lidar, names):
    lines = []
    for b, name in zip(boxes_lidar, names):
        box_cam = box_ops.box_lidar_to_camera(
            np.asarray(b, np.float64)[None], np.eye(4), TR_VELO_TO_CAM)[0]
        x, y, z, l, h, w, ry = box_cam
        corners = box_ops.center_to_corner_box3d(
            box_cam[None, :3], box_cam[None, [3, 5, 4]][:, [0, 1, 2]],
            box_cam[None, 6], origin=(0.5, 1.0, 0.5), axis=1)[0]
        pix = box_ops.project_to_image(corners, P2)
        x1, y1 = np.clip(pix.min(0), 0, [IMG_HW[1], IMG_HW[0]])
        x2, y2 = np.clip(pix.max(0), 0, [IMG_HW[1], IMG_HW[0]])
        if x2 - x1 < 4 or y2 - y1 < 4:
            continue            # effectively outside the image
        alpha = float(-np.arctan2(-b[1], b[0]) + b[6])
        lines.append(
            f"{name} 0.00 0 {alpha:.2f} {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
            f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
    return lines


def calib_text() -> str:
    """The calibration file every frame shares."""
    return "\n".join([
        "P0: " + " ".join(map(str, P2.reshape(-1))),
        "P1: " + " ".join(map(str, P2.reshape(-1))),
        "P2: " + " ".join(map(str, P2.reshape(-1))),
        "P3: " + " ".join(map(str, P2.reshape(-1))),
        "R0_rect: " + " ".join(map(str, np.eye(3).reshape(-1))),
        "Tr_velo_to_cam: " + " ".join(
            map(str, TR_VELO_TO_CAM[:3].reshape(-1))),
        "Tr_imu_to_velo: " + " ".join(map(str, np.eye(4)[:3].reshape(-1))),
    ]) + "\n"


def write_clone(root, num_train: int = 400, num_val: int = 100,
                seed: int = 0, multiclass: bool = False,
                prep: bool = True) -> int:
    """Write ``num_train + num_val`` frames from ``seed`` under ``root``
    (frames ``0 .. num_train - 1`` the training split, the rest the
    validation split) and, with ``prep``, run ``kitti_data_prep`` on them.
    -> the number of labels written."""
    root = pathlib.Path(root)
    for sub in ("velodyne", "label_2", "calib"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(exist_ok=True)
    calib_txt = calib_text()
    n_total = num_train + num_val
    rng = np.random.default_rng(seed)
    n_boxes = 0
    for idx in range(n_total):
        points, boxes, names = make_frame(rng, multiclass=multiclass)
        lines = label_lines(boxes, names)
        n_boxes += len(lines)
        frame = f"{idx:06d}"
        points.tofile(root / "training" / "velodyne" / f"{frame}.bin")
        (root / "training" / "label_2" / f"{frame}.txt").write_text(
            "\n".join(lines) + "\n")
        (root / "training" / "calib" / f"{frame}.txt").write_text(calib_txt)
    (root / "ImageSets" / "train.txt").write_text(
        "\n".join(f"{i}" for i in range(num_train)) + "\n")
    (root / "ImageSets" / "val.txt").write_text(
        "\n".join(f"{i}" for i in range(num_train, n_total)) + "\n")
    print(f"wrote {n_total} frames ({n_boxes} labels) under {root}")
    if prep:
        create_data.kitti_data_prep(root)
    return n_boxes


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--num_train", type=int, default=400)
    ap.add_argument("--num_val", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multiclass", action="store_true",
                    help="also place Pedestrian + Cyclist objects")
    args = ap.parse_args()
    write_clone(args.root, args.num_train, args.num_val, args.seed,
                args.multiclass)


if __name__ == "__main__":
    main()
