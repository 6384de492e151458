"""GT-database paste-in sampler.

Samples class-balanced object instances (box + cropped points saved offline
by ``data.create_data.create_groundtruth_database_from_infos``),
collision-tests them against the scene's existing boxes, and pastes
survivors into the sample.

The port's copy of the JAX package's ``core/sample_ops.py``: the same
draws in the same order from the same generator, so one seed gives the
reference's samples (its collision test is the numpy
``geometry.box_collision_test``; the reference takes a float32 C++ twin
where its library built).  One generator serves every class and every
example, seeded once by the input reader, as in the reference: examples
prepared by a pool draw from it in the order the workers reach it
(``train/input_pipeline.py``).
"""
from __future__ import annotations

import pathlib
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import geometry


class BatchSampler:
    """Epoch-shuffled without-replacement sampler over one class's infos."""

    def __init__(self, sampled_list: List[dict], name: str | None = None,
                 shuffle: bool = True,
                 rng: np.random.Generator | None = None):
        self._sampled_list = sampled_list
        self._name = name
        self._shuffle = shuffle
        self._rng = rng or np.random.default_rng()
        self._idx = 0
        self._indices = np.arange(len(sampled_list))
        if shuffle:
            self._rng.shuffle(self._indices)

    def sample(self, num: int) -> List[dict]:
        if num <= 0 or len(self._sampled_list) == 0:
            return []
        out = []
        while num > 0:
            remaining = len(self._indices) - self._idx
            take = min(num, remaining)
            out.extend(self._sampled_list[i] for i in
                       self._indices[self._idx : self._idx + take])
            self._idx += take
            num -= take
            if self._idx >= len(self._indices):
                self._idx = 0
                if self._shuffle:
                    self._rng.shuffle(self._indices)
        return out


def filter_by_difficulty(db_infos: Dict[str, List[dict]],
                         removed: Sequence[int]) -> Dict[str, List[dict]]:
    return {k: [i for i in v if i.get("difficulty", 0) not in removed]
            for k, v in db_infos.items()}


def filter_by_min_num_points(db_infos: Dict[str, List[dict]],
                             min_points: Dict[str, int]):
    for name, num in min_points.items():
        if name in db_infos and num > 0:
            db_infos[name] = [i for i in db_infos[name]
                              if i.get("num_points_in_gt", 1 << 30) >= num]
    return db_infos


class DataBaseSampler:
    """sample_all(): per-class quota sampling + BEV collision rejection."""

    def __init__(self, db_infos: Dict[str, List[dict]],
                 groups: List[Dict[str, int]],
                 root_path: str | pathlib.Path = ".",
                 rate: float = 1.0,
                 global_rot_range: Optional[Sequence[float]] = None,
                 rng: np.random.Generator | None = None):
        self._db_infos = db_infos
        self._rate = rate
        self._groups = groups
        self._root_path = pathlib.Path(root_path)
        gr = (tuple(float(v) for v in global_rot_range)
              if global_rot_range is not None else None)
        if gr is not None and gr[0] == gr[1] == 0.0:
            gr = None
        self._global_rot_range = gr
        self._rng = rng or np.random.default_rng()
        # group-aware sampling: infos carrying a group_id are sampled as
        # whole groups (an instance drags its group mates along, and the
        # group collision-tests jointly) [ref: second/core/sample_ops.py
        # group handling — lineage-expected, UNVERIFIED]
        self._group_members: Dict[object, List[dict]] = {}
        for infos in db_infos.values():
            for info in infos:
                gid = info.get("group_id")
                if gid is not None:
                    self._group_members.setdefault(gid, []).append(info)
        self._samplers = {
            name: BatchSampler(infos, name, rng=self._rng)
            for name, infos in db_infos.items()}

    @classmethod
    def from_info_path(cls, info_path, groups, root_path=".", rate=1.0,
                       prep_steps=(), global_rot_range=None, rng=None):
        with open(info_path, "rb") as f:
            db_infos = pickle.load(f)
        for step in prep_steps:
            db_infos = step(db_infos)
        return cls(db_infos, groups, root_path, rate,
                   global_rot_range=global_rot_range, rng=rng)

    def sample_all(self, gt_boxes: np.ndarray, gt_names: np.ndarray,
                   num_point_features: int = 4,
                   root_path: str | None = None):
        """Returns None or dict(gt_names, gt_boxes, points, difficulty)."""
        root = pathlib.Path(root_path) if root_path else self._root_path
        sampled_num_dict = {}
        for group in self._groups:
            for name, max_num in group.items():
                existing = int(np.sum(gt_names == name))
                quota = int(self._rate * (max_num - existing))
                sampled_num_dict[name] = max(quota, 0)

        sampled: List[dict] = []
        sampled_boxes: List[np.ndarray] = []
        sampled_rots: List[float] = []
        avoid = gt_boxes.copy()
        seen_gids: set = set()
        for name, num in sampled_num_dict.items():
            if num <= 0 or name not in self._samplers:
                continue
            cand = self._samplers[name].sample(num)
            for unit in self._expand_groups(cand, seen_gids):
                boxes = np.stack(
                    [np.asarray(u["box3d_lidar"], np.float32)
                     for u in unit])
                rot = 0.0
                if self._global_rot_range is not None:
                    boxes, rot = self._rotate_unit_about_origin(boxes)
                bev = boxes[:, [0, 1, 3, 4, 6]]
                if len(avoid) and geometry.box_collision_test(
                        bev, avoid[:, [0, 1, 3, 4, 6]]).any():
                    continue
                for u, b in zip(unit, boxes):
                    sampled.append(u)
                    sampled_boxes.append(b)
                    sampled_rots.append(rot)
                avoid = np.concatenate([avoid, boxes], axis=0)

        if not sampled:
            return None
        boxes = np.stack(sampled_boxes)
        points_list = []
        for info, box, rot in zip(sampled, boxes, sampled_rots):
            pts = self._load_points(root / info["path"], num_point_features)
            # db crops are stored box-relative (create_groundtruth_database
            # subtracts the box bottom-center); rotate with the sample-time
            # placement noise, then restore world position
            pts = pts.copy()
            if rot != 0.0:
                c, s = np.float32(np.cos(rot)), np.float32(np.sin(rot))
                # same convention as box_ops.rotation_3d_in_axis (axis=2)
                pts[:, :2] = pts[:, :2] @ np.array(
                    [[c, s], [-s, c]], np.float32)
            pts[:, :3] += box[:3]
            points_list.append(pts)
        return {
            "gt_names": np.array([s["name"] for s in sampled]),
            "gt_boxes": boxes,
            "points": (np.concatenate(points_list, axis=0) if points_list
                       else np.zeros((0, num_point_features), np.float32)),
            "difficulty": np.array([s.get("difficulty", 0) for s in sampled]),
        }

    def _expand_groups(self, cand: List[dict],
                       seen_gids: set) -> List[List[dict]]:
        """Candidates -> placement units (whole groups or singletons);
        a group appears once even if several members were drawn."""
        units: List[List[dict]] = []
        for c in cand:
            gid = c.get("group_id")
            if gid is not None and gid in self._group_members:
                if gid in seen_gids:
                    continue
                seen_gids.add(gid)
                units.append(list(self._group_members[gid]))
            else:
                units.append([c])
        return units

    def _rotate_unit_about_origin(self, boxes: np.ndarray):
        """Sample-time placement rotation: the unit is rigidly rotated
        about the scene origin so its azimuth lands inside
        ``global_rot_range`` (box yaw follows).  [ref:
        second/core/sample_ops.py global_rot_range — lineage-expected]"""
        lo, hi = self._global_rot_range
        alpha = float(np.arctan2(boxes[0, 1], boxes[0, 0]))
        rot = float(self._rng.uniform(lo, hi)) - alpha
        c, s = np.float32(np.cos(rot)), np.float32(np.sin(rot))
        boxes = boxes.copy()
        boxes[:, :2] = boxes[:, :2] @ np.array([[c, s], [-s, c]], np.float32)
        boxes[:, 6] += rot
        return boxes, rot

    def _reject_colliding(self, boxes: np.ndarray,
                          avoid: np.ndarray) -> np.ndarray:
        """True per candidate if it neither hits the scene nor earlier
        accepted candidates."""
        n = len(boxes)
        keep = np.zeros(n, dtype=bool)
        current = avoid
        for i in range(n):
            bev = boxes[i : i + 1][:, [0, 1, 3, 4, 6]]
            if len(current) == 0 or not geometry.box_collision_test(
                    bev, current[:, [0, 1, 3, 4, 6]]).any():
                keep[i] = True
                current = np.concatenate([current, boxes[i : i + 1]], axis=0)
        return keep

    @staticmethod
    def _load_points(path: pathlib.Path, num_features: int) -> np.ndarray:
        if path.suffix == ".npy":
            pts = np.load(path)
        else:
            pts = np.fromfile(path, dtype=np.float32).reshape(
                -1, num_features)
        return pts[:, :num_features].astype(np.float32)
