"""The port's as-built export (``utils/asbuilt_export.py``: detections ->
wall runs / columns / door openings -> JSON + SVG) against the JAX
package's on the same detections: every case of
``tests/test_asbuilt_export.py``, where the JSON model and the SVG text
equal the reference's character for character, the same on perturbed
ground truth of generated scenes, and detections given as torch tensors."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.data import (
    building as jax_building)
from automatic_as_built_reconstruction_tpu.utils import (
    asbuilt_export as jax_ax)
from automatic_as_built_reconstruction_tpu_torch.data import building
from automatic_as_built_reconstruction_tpu_torch.utils import (
    asbuilt_export as ax)

CLASSES = ("wall", "column", "door")


def _wall_chain(p0, p1, n_seg, thickness=0.12, height=2.8, jitter=0.0,
                seed=0):
    """n_seg collinear wall boxes along p0->p1 (generator convention:
    l along the segment, yaw = atan2(seg) + pi/2)."""
    rng = np.random.default_rng(seed)
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    seg = p1 - p0
    yaw = float(np.arctan2(seg[1], seg[0]) + np.pi / 2)
    ln = float(np.hypot(*seg)) / n_seg
    boxes = []
    for i in range(n_seg):
        mid = p0 + (i + 0.5) / n_seg * seg
        mid = mid + rng.normal(0, jitter, 2)
        boxes.append([mid[0], mid[1], height / 2, thickness, ln, height,
                      yaw + rng.normal(0, jitter)])
    return np.asarray(boxes)


def same_runs(boxes, **kw):
    """``merge_wall_runs`` of both packages, equal as JSON text.  -> the
    port's runs."""
    got = ax.merge_wall_runs(boxes, **kw)
    assert json.dumps(got) == json.dumps(jax_ax.merge_wall_runs(boxes, **kw))
    return got


def same_model(dets, class_names=CLASSES, **kw):
    """``build_asbuilt_model`` and ``render_svg`` of both packages, equal
    character for character.  -> the port's model."""
    got = ax.build_asbuilt_model(dets, class_names, **kw)
    want = jax_ax.build_asbuilt_model(dets, class_names, **kw)
    assert json.dumps(got, indent=1) == json.dumps(want, indent=1)
    assert ax.render_svg(got) == jax_ax.render_svg(want)
    return got


class TestMergeWallRuns:
    def test_collinear_chain_merges_to_one_run(self):
        runs = same_runs(_wall_chain((0, 0), (8, 0), 4))
        assert len(runs) == 1
        r = runs[0]
        assert r["n_segments"] == 4
        assert r["length"] == pytest.approx(8.0, abs=1e-6)
        got = sorted([r["start"], r["end"]])
        np.testing.assert_allclose(got, [[0, 0], [8, 0]], atol=1e-6)
        assert r["z0"] == pytest.approx(0.0, abs=1e-6)

    def test_noisy_chain_merges(self):
        runs = same_runs(_wall_chain((2, 1), (2, 9), 5, jitter=0.02, seed=3))
        assert len(runs) == 1
        assert runs[0]["length"] == pytest.approx(8.0, abs=0.2)

    def test_perpendicular_walls_stay_separate(self):
        boxes = np.concatenate([_wall_chain((0, 0), (6, 0), 3),
                                _wall_chain((0, 0.3), (0, 6), 3)])
        assert len(same_runs(boxes)) == 2

    def test_parallel_offset_walls_stay_separate(self):
        boxes = np.concatenate([_wall_chain((0, 0), (6, 0), 2),
                                _wall_chain((0, 1.0), (6, 1.0), 2)])
        assert len(same_runs(boxes)) == 2

    def test_big_gap_splits_runs(self):
        boxes = np.concatenate([_wall_chain((0, 0), (3, 0), 2),
                                _wall_chain((6, 0), (9, 0), 2)])
        assert len(same_runs(boxes)) == 2

    def test_opening_gap_bridged(self):
        boxes = np.concatenate([_wall_chain((0, 0), (3, 0), 2),
                                _wall_chain((3.4, 0), (6, 0), 2)])
        assert len(same_runs(boxes)) == 1

    def test_pi_symmetric_yaws_merge(self):
        a = _wall_chain((0, 0), (4, 0), 2)
        b = _wall_chain((8, 0), (4, 0), 2)   # opposite direction
        runs = same_runs(np.concatenate([a, b]))
        assert len(runs) == 1
        assert runs[0]["length"] == pytest.approx(8.0, abs=1e-6)

    def test_axis_boundary_and_tolerances(self):
        """Yaws on the canonical axis' boundary (ax_y == 0) and the
        gates moved: the same runs."""
        boxes = np.concatenate([_wall_chain((0, 0), (0, 4), 2),
                                _wall_chain((0, 8), (0, 4.3), 2)])
        for kw in ({}, dict(gap_tol=0.1), dict(angle_tol=0.0),
                   dict(lateral_tol=0.0)):
            same_runs(boxes, **kw)
        np.testing.assert_array_equal(
            ax._canon_axis(np.array([np.pi / 2, -np.pi / 2, 0.0, np.pi])),
            jax_ax._canon_axis(np.array([np.pi / 2, -np.pi / 2, 0.0,
                                         np.pi])))

    def test_empty(self):
        assert same_runs(np.zeros((0, 7))) == []


class TestModel:
    def _dets(self):
        walls = _wall_chain((0, 0), (6, 0), 3)
        col = np.array([[8.0, 2.0, 1.4, 0.4, 0.4, 2.8, 0.1]])
        door = np.array([[3.0, 0.05, 1.0, 0.08, 0.9, 2.0,
                          np.pi / 2 + 0.3]])
        boxes = np.concatenate([walls, col, door])
        labels = np.array([0, 0, 0, 1, 2])
        scores = np.array([0.9, 0.8, 0.85, 0.95, 0.7])
        return {"box3d_lidar": boxes, "scores": scores,
                "label_preds": labels}

    def test_build_model(self):
        m = same_model(self._dets())
        assert m["stats"]["num_wall_runs"] == 1
        assert m["stats"]["num_columns"] == 1
        assert m["stats"]["num_doors"] == 1
        d = m["doors"][0]
        assert d["wall_index"] == 0
        assert d["along_wall_m"] == pytest.approx(3.0, abs=0.1)
        assert m["columns"][0]["center"] == [8.0, 2.0]

    def test_score_threshold_drops(self):
        dets = self._dets()
        dets["scores"] = np.array([0.9, 0.8, 0.85, 0.1, 0.7])
        m = same_model(dets, score_threshold=0.3)
        assert m["stats"]["num_columns"] == 0

    def test_far_door_unattached(self):
        dets = self._dets()
        dets["box3d_lidar"][-1, :2] = [20.0, 20.0]
        m = same_model(dets)
        assert m["doors"][0]["wall_index"] is None

    def test_classes_missing_from_the_names(self):
        m = same_model(self._dets(), class_names=("wall", "column"))
        assert m["stats"]["num_doors"] == 0
        empty = {"box3d_lidar": np.zeros((0, 7)), "scores": np.zeros(0),
                 "label_preds": np.zeros(0, np.int64)}
        assert same_model(empty)["stats"]["num_detections"] == 0

    def test_json_svg_roundtrip(self, tmp_path):
        jp, sp = tmp_path / "m.json", tmp_path / "m.svg"
        rj, rs = tmp_path / "ref.json", tmp_path / "ref.svg"
        m = ax.export_asbuilt(self._dets(), CLASSES, json_path=str(jp),
                              svg_path=str(sp))
        jax_ax.export_asbuilt(self._dets(), CLASSES, json_path=str(rj),
                              svg_path=str(rs))
        assert jp.read_text() == rj.read_text()
        assert sp.read_text() == rs.read_text()
        loaded = json.loads(jp.read_text())
        assert loaded["stats"] == m["stats"]
        svg = sp.read_text()
        assert svg.count("<line") == 1       # one wall run
        assert svg.count("<rect") == 2       # background + column
        assert svg.count("<circle") == 1     # door

    def test_tensors_leave_their_device_at_the_entry(self):
        """Detections as torch tensors (what a caller holding the
        network's output has) give the model of their numpy values."""
        dets = self._dets()
        as_tensors = {"box3d_lidar": torch.tensor(dets["box3d_lidar"],
                                                  dtype=torch.float32),
                      "scores": torch.tensor(dets["scores"],
                                             dtype=torch.float32),
                      "label_preds": torch.tensor(dets["label_preds"])}
        as_numpy = {k: v.numpy() for k, v in as_tensors.items()}
        assert json.dumps(ax.build_asbuilt_model(as_tensors, CLASSES)) == \
            json.dumps(jax_ax.build_asbuilt_model(as_numpy, CLASSES))


def _perturbed_gt(seed):
    """Ground truth of generated scene ``seed`` as detections: centres
    moved by 3 cm, yaws by 1 degree, scores random, a few boxes dropped."""
    scene = building.generate_building_scene(seed)
    ref = jax_building.generate_building_scene(seed)
    np.testing.assert_array_equal(scene["gt_boxes"], ref["gt_boxes"])
    rng = np.random.default_rng(seed)
    boxes = np.array(scene["gt_boxes"], np.float64)
    boxes[:, :2] += rng.normal(0, 0.03, (len(boxes), 2))
    boxes[:, 6] += rng.normal(0, np.deg2rad(1.0), len(boxes))
    keep = rng.random(len(boxes)) > 0.1
    labels = np.array([CLASSES.index(n) for n in scene["gt_names"]])
    return {"box3d_lidar": boxes[keep].astype(np.float32),
            "scores": rng.uniform(0.2, 1.0, keep.sum()).astype(np.float32),
            "label_preds": labels[keep]}


@pytest.mark.parametrize("seed", [7, 11, 12])
def test_perturbed_ground_truth_gives_the_reference_model(seed):
    m = same_model(_perturbed_gt(seed))
    assert 0 < m["stats"]["num_wall_runs"] < m["stats"]["num_wall_segments"]


class TestOnGeneratedScene:
    def test_gt_boxes_reconstruct(self):
        scene = building.generate_building_scene(7)
        names = np.asarray(scene["gt_names"])
        boxes = np.asarray(scene["gt_boxes"])
        labels = np.array([CLASSES.index(n) for n in names])
        m = same_model({"box3d_lidar": boxes, "scores": np.ones(len(boxes)),
                        "label_preds": labels})
        n_wall_segs = int((names == "wall").sum())
        assert 0 < m["stats"]["num_wall_runs"] < n_wall_segs
        assert m["stats"]["num_doors"] == int((names == "door").sum())
        svg = ax.render_svg(m)
        assert svg.count("<line") == m["stats"]["num_wall_runs"]
