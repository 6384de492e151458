"""Port vs JAX package: the ``evaluate`` entry point and every host module
under it — ``core/geometry.py``, the ``core/box_ops.py`` additions, the
host ``VoxelGenerator``, the inference branch of ``prep_pointcloud``,
``core/point_refine.py``, ``utils/eval.py::evaluate_lidar_ap`` — then
``evaluate`` as a whole at full width with the trained as-built checkpoint.

The host modules are numpy copies of the reference's, so results are equal
exactly where the reference runs its numpy path.  Where the reference
prefers its C++ library (3D overlaps in float32, points-in-box on float32
input, the voxelizer) the comparison is made twice: with that library
switched off (exact) and as the reference runs here (tolerance stated at
the test).
"""
import contextlib
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu import native as jax_native
from automatic_as_built_reconstruction_tpu.builder import (
    input_reader_builder as jax_reader_builder)
from automatic_as_built_reconstruction_tpu.core import (
    box_ops as jax_box_ops, geometry as jax_geometry,
    point_refine as jax_point_refine, voxelize as jax_voxelize)
from automatic_as_built_reconstruction_tpu.data import (
    building as jax_building, preprocess as jax_preprocess)
from automatic_as_built_reconstruction_tpu.models import voxelnet as jvn
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.utils import eval as jax_eval
from automatic_as_built_reconstruction_tpu_torch.builder import (
    input_reader_builder)
from automatic_as_built_reconstruction_tpu_torch.core import (
    box_ops, geometry, point_refine, voxelize)
from automatic_as_built_reconstruction_tpu_torch.data import (
    building, preprocess)
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet as tvn
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    build_from_config, detections_mismatch)
from automatic_as_built_reconstruction_tpu_torch.train import (
    input_pipeline, train)
from automatic_as_built_reconstruction_tpu_torch.utils import (
    eval as eval_mod, weight_import)

from test_torch_models import (CKPT, JAX_CFG, PORT_CFG, jax_model_cfg,
                               random_variables)

BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4
AP_ATOL = 1e-3


@contextlib.contextmanager
def numpy_reference():
    """The reference with its C++ library switched off: its numpy path."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "AVAILABLE", False)
    try:
        yield
    finally:
        mp.undo()


# --------------------------------------------------------------------------
# core/geometry.py
# --------------------------------------------------------------------------

def _bev_boxes(rng, n, dtype=np.float64):
    """Random overlapping boxes plus degenerate ones: coincident, zero
    area, thin boxes crossed at 90 degrees, one far away."""
    b = np.concatenate([rng.uniform(0, 6, (n, 2)), rng.uniform(0.3, 3, (n, 2)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    b[1] = b[0]
    b[2, 2:4] = 0.0
    b[3] = [3.0, 3.0, 0.07, 2.5, 0.0]
    b[4] = [3.0, 3.0, 0.07, 2.5, np.pi / 2]
    b[5, :2] = 500.0
    return b.astype(dtype)


def _boxes_3d(rng, n):
    bev = _bev_boxes(rng, n)
    return np.concatenate([bev[:, :2], rng.uniform(-1, 1, (n, 1)), bev[:, 2:4],
                           rng.uniform(0.5, 3, (n, 1)), bev[:, 4:]], 1)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_rotate_iou_matrix_equals_reference(criterion):
    rng = np.random.default_rng(criterion + 5)
    a, q = _bev_boxes(rng, 24), _bev_boxes(rng, 17)
    got = geometry.rotate_iou_matrix(a, q, criterion)
    ref = jax_geometry.rotate_iou_matrix(a, q, criterion)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype and (got > 0.1).sum() > 20
    # the far box meets only its far twin and the box without area (whose
    # degenerate quad "contains" every corner, in the reference as here)
    assert got[0, 1] == got[0, 0] and np.delete(got[5], [2, 5]).max() == 0.0
    inter = geometry.rotated_box_intersection_area(a[3], q[4])
    assert inter == jax_geometry.rotated_box_intersection_area(a[3], q[4])
    np.testing.assert_allclose(inter, 0.07 * 0.07, rtol=1e-9)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_d3_box_overlap_equals_reference(criterion):
    rng = np.random.default_rng(criterion + 9)
    a, q = _boxes_3d(rng, 20), _boxes_3d(rng, 15)
    got = geometry.d3_box_overlap(a, q, criterion)
    with numpy_reference():
        np.testing.assert_array_equal(
            got, jax_geometry.d3_box_overlap(a, q, criterion))
    # as the reference runs here (float32 C++ BEV IoU for criterion -1),
    # on the boxes that have an area
    ok = np.ones_like(got, bool)
    ok[2], ok[:, 2] = False, False
    np.testing.assert_allclose(
        got[ok], jax_geometry.d3_box_overlap(a, q, criterion)[ok], atol=2e-5)
    assert (got > 0.05).sum() > 10


def test_iou_of_boxes_with_infinite_sizes_equals_reference():
    """Boxes of infinite size (an untrained box head's exp overflows):
    the port skips their clip, and every overlap stays 0 as the
    reference's clip gives it; a NaN box overlaps nothing."""
    rng = np.random.default_rng(4)
    a, q = _boxes_3d(rng, 12), _boxes_3d(rng, 9)
    a[::3, 3] = np.inf
    a[1, 4] = np.inf
    got = geometry.rotate_iou_matrix(a[:, [0, 1, 3, 4, 6]],
                                     q[:, [0, 1, 3, 4, 6]])
    with np.errstate(invalid="ignore"):
        ref = jax_geometry.rotate_iou_matrix(a[:, [0, 1, 3, 4, 6]],
                                             q[:, [0, 1, 3, 4, 6]])
        with numpy_reference():
            ref3 = jax_geometry.d3_box_overlap(a, q)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(geometry.d3_box_overlap(a, q), ref3)
    assert not got[[0, 1, 3, 6, 9]].any() and got.any()
    a[2, 0] = np.nan
    assert not geometry.rotate_iou_matrix(a[:, [0, 1, 3, 4, 6]],
                                          q[:, [0, 1, 3, 4, 6]])[2].any()


# --------------------------------------------------------------------------
# core/box_ops.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_box_ops_corners_and_rotations_equal_reference(dtype):
    rng = np.random.default_rng(11)
    boxes = _boxes_3d(rng, 16).astype(dtype)
    for name, args in [
            ("corners_nd", (boxes[:, 3:6],)),
            ("corners_nd", (boxes[:, 3:5], 0.0)),
            ("center_to_corner_box2d", (boxes[:, :2], boxes[:, 3:5],
                                        boxes[:, 6])),
            ("center_to_corner_box3d", (boxes[:, :3], boxes[:, 3:6],
                                        boxes[:, 6])),
            ("center_to_corner_box3d", (boxes[:, :3], boxes[:, 3:6],
                                        boxes[:, 6], (0.5, 1.0, 0.5), 1)),
            ("rotation_2d", (rng.normal(size=(16, 4, 2)).astype(dtype),
                             boxes[:, 6])),
            ("rotation_3d_in_axis", (rng.normal(size=(16, 8, 3)).astype(
                dtype), boxes[:, 6], 0)),
            ("rotation_points_single_angle", (boxes[:, :3], 0.7)),
            ("rbbox2d_to_near_bbox", (boxes[:, [0, 1, 3, 4, 6]],)),
            ("limit_period", (boxes[:, 6] * 3, 0.5, np.pi))]:
        got = getattr(box_ops, name)(*args)
        ref = getattr(jax_box_ops, name)(*args)
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    corners = box_ops.center_to_corner_box3d(boxes[:, :3], boxes[:, 3:6])
    np.testing.assert_array_equal(box_ops.corner_to_standup_nd(corners),
                                  jax_box_ops.corner_to_standup_nd(corners))
    with pytest.raises(ValueError):
        box_ops.corners_nd(np.ones((2, 4), dtype))


def test_points_in_rbbox_equals_reference():
    rng = np.random.default_rng(12)
    boxes = _boxes_3d(rng, 10)
    pts = rng.uniform(-1, 7, (3000, 4))
    pts[:, 2] = rng.uniform(-1.5, 4, 3000)
    got = box_ops.points_in_rbbox(pts, boxes)
    np.testing.assert_array_equal(got, jax_box_ops.points_in_rbbox(pts, boxes))
    assert got.shape == (3000, 10) and got.sum() > 100
    np.testing.assert_array_equal(
        box_ops.points_in_rbbox(pts, boxes[0], origin=(0.5, 0.5, 0.5)),
        jax_box_ops.points_in_rbbox(pts, boxes[0], origin=(0.5, 0.5, 0.5)))
    # float32 input: the reference's C++ kernel rounds otherwise; the
    # answers may differ only for points within 1e-5 m of a face
    p32, b32 = pts.astype(np.float32), boxes.astype(np.float32)
    got32 = box_ops.points_in_rbbox(p32, b32)
    with numpy_reference():
        np.testing.assert_array_equal(
            got32, jax_box_ops.points_in_rbbox(p32, b32))
    assert (got32 != jax_box_ops.points_in_rbbox(p32, b32)).sum() <= 2
    kept = box_ops.remove_points_outside_range(pts, (0, 0, -1, 6, 6, 3))
    np.testing.assert_array_equal(
        kept, jax_box_ops.remove_points_outside_range(pts, (0, 0, -1, 6, 6,
                                                            3)))
    assert 0 < len(kept) < len(pts)


def test_anchor_area_functions_equal_reference():
    rng = np.random.default_rng(13)
    coors = np.stack([np.zeros(500, np.int32), rng.integers(0, 40, 500),
                      rng.integers(0, 48, 500)], 1).astype(np.int32)
    dense = box_ops.sparse_sum_for_anchors_mask(coors, (40, 48))
    np.testing.assert_array_equal(
        dense, jax_box_ops.sparse_sum_for_anchors_mask(coors, (40, 48)))
    assert dense.sum() == 500 and dense.max() > 1
    anchors_bv = box_ops.rbbox2d_to_near_bbox(
        _bev_boxes(rng, 64, np.float32) * [2, 2, 1, 1, 1])
    args = (dense, anchors_bv, (0.25, 0.25, 4.0), (0.0, 0.0, -1.0),
            np.array([48, 40, 1]))
    area = box_ops.fused_get_anchors_area(*args)
    np.testing.assert_array_equal(area,
                                  jax_box_ops.fused_get_anchors_area(*args))
    assert (area > 0).any() and (area == 0).any()


# --------------------------------------------------------------------------
# core/voxelize.py (host), data/preprocess.py
# --------------------------------------------------------------------------

def _tiny_generators():
    _, jvg, jta, fmap = jax_model_cfg("asbuilt_pillars_tiny")
    bundle = train.Bundle(PORT_CFG / "asbuilt_pillars_tiny.config")
    return jvg, jta, fmap, bundle


def test_host_voxel_generator_puts_face_points_where_the_reference_does():
    """Val scene 2 holds a point at y = 13.7 exactly, on a cell face:
    the reference's C++ kernel (float64 division) and its numpy twin
    (float32) disagree on it.  The port follows the kernel, which is what
    the reference's ``generate`` runs here."""
    assert jax_native.AVAILABLE
    bundle = train.Bundle(PORT_CFG / "asbuilt_pillars.config")
    tvg = bundle.voxel_generator
    jvg = jax_voxelize.VoxelGenerator(tvg.voxel_size, tvg.point_cloud_range,
                                      tvg.max_num_points, tvg.max_voxels)
    pts = building.generate_building_scene(7 * 100003 + 2)["points"]
    assert (pts[:, 1] == np.float32(13.7)).any()
    got, ref = tvg.generate(pts, 25600), jvg.generate(pts, 25600)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    twin = jax_voxelize.points_to_voxel_fast(
        pts, jvg.voxel_size, jvg.point_cloud_range, 24, 25600)
    assert not np.array_equal(twin[2], ref[2])


@pytest.mark.parametrize("max_voxels", [None, 300])
def test_host_voxel_generator_equals_reference(max_voxels):
    """Against ``VoxelGenerator.generate`` as the reference runs it here
    (its C++ kernel where that built) and against its numpy version (this
    scan has no point on a cell face)."""
    jvg, _, _, bundle = _tiny_generators()
    tvg = bundle.voxel_generator
    assert isinstance(tvg, voxelize.VoxelGenerator)
    assert tvg == voxelize.VoxelGenerator(
        tuple(jvg.voxel_size), tuple(jvg.point_cloud_range),
        jvg.max_num_points, jvg.max_voxels)
    np.testing.assert_array_equal(tvg.grid_size, jvg.grid_size)
    pts = building.generate_building_scene(4)["points"][::6]
    pts = np.concatenate([pts, pts[:50] + 100.0])       # out of range
    got = tvg.generate(pts, max_voxels)
    for ref in (jvg.generate(pts, max_voxels),
                jax_voxelize.points_to_voxel_fast(
                    pts, jvg.voxel_size, jvg.point_cloud_range,
                    jvg.max_num_points, max_voxels or jvg.max_voxels)):
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
    voxels, coors, num = got
    assert len(voxels) == (max_voxels or len(voxels)) and len(voxels) >= 300
    assert num.max() == tvg.max_num_points      # a pillar over the cap
    # first-appearance numbering: voxel 0 holds the first point
    np.testing.assert_array_equal(voxels[0, 0], pts[0])
    empty = tvg.generate(pts[:0])
    assert [len(a) for a in empty] == [0, 0, 0]


@pytest.mark.parametrize("variant", [
    dict(),
    dict(anchor_area_threshold=1.0),
    dict(sort_voxels_by_key=True, shuffle_points=True),
], ids=["plain", "anchors_mask", "key_sorted_shuffled"])
def test_prep_pointcloud_inference_branch_equals_reference(variant):
    """Every key of the example, on the tiny config's reader."""
    jvg, jta, fmap, bundle = _tiny_generators()
    sensor = building.BuildingDataset(
        num_synthetic=3, synthetic_seed=7).get_sensor_data(1)
    kw = dict(class_names=("wall", "column", "door"), max_voxels=6000,
              shuffle_points=False)
    kw.update(variant)
    ref = jax_preprocess.prep_pointcloud(
        sensor, jvg, jta, jax_preprocess.PrepConfig(**kw), training=False,
        rng=np.random.default_rng(5), feature_map_size=fmap)
    got = preprocess.prep_pointcloud(
        sensor, bundle.voxel_generator, bundle.target_assigner,
        preprocess.PrepConfig(**kw), training=False,
        rng=np.random.default_rng(5),
        feature_map_size=bundle.feature_map_size)
    assert sorted(got) == sorted(ref)
    assert ("anchors_mask" in got) == ("anchor_area_threshold" in variant)
    for k in ref:
        if k == "metadata":
            assert got[k] == ref[k]
            continue
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert 500 < int(got["num_voxels"]) < 6000
    if "anchors_mask" in got:
        assert got["anchors_mask"].any() and not got["anchors_mask"].all()
    assert dataclasses.asdict(preprocess.PrepConfig()) == dataclasses.asdict(
        jax_preprocess.PrepConfig())
    with pytest.raises(NotImplementedError):    # host-built rulebooks
        preprocess.prep_pointcloud(sensor, bundle.voxel_generator,
                                   bundle.target_assigner,
                                   preprocess.PrepConfig(**kw), training=True,
                                   middle_plan=object())


def test_input_reader_matches_reference_batches():
    """The eval reader of the tiny config: the same dataset, PrepConfig,
    anchor cache and batches (two scans each, the last partial batch
    kept)."""
    jbundle = jax_train.Bundle(JAX_CFG / "asbuilt_pillars_tiny.config")
    tbundle = train.Bundle(PORT_CFG / "asbuilt_pillars_tiny.config")
    with shortened_val_split(3):
        jds, jloader = jbundle.input_reader(training=False)
        tds, tloader = tbundle.input_reader(training=False)
    assert len(tds) == len(jds) == 3
    jbatches, tbatches = list(jloader), list(tloader)
    assert len(tbatches) == len(jbatches) == 2
    for tb, jb in zip(tbatches, jbatches):
        assert sorted(tb) == sorted(jb)
        for k in jb:
            if k == "metadata":
                assert tb[k] == jb[k]
            else:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert tbatches[1]["voxels"].shape[0] == 1
    assert tbatches[0]["metadata"][0]["scene_id"] == 7 * 100003
    with pytest.raises(NotImplementedError):    # host-built rulebooks
        input_reader_builder.build(
            {"dataset": {"dataset_class_name": "BuildingDataset"}}, True,
            tbundle.voxel_generator, tbundle.target_assigner,
            tbundle.feature_map_size, middle_plan=object())


@pytest.mark.parametrize("pool", [dict(num_workers=3),
                                  dict(process_workers=True)],
                         ids=["threads", "processes"])
def test_batch_loader_warns_when_asked_for_a_pool(pool):
    """A worker pool (threads or forked processes) gives the sequential
    loader's batches, and neither form warns.  (The name dates from
    before the pools were ported, when asking for one warned; it now
    checks that no warning is left.)"""
    import warnings

    class Rows:
        def __len__(self):
            return 3

        def get_sensor_data(self, i):
            return {"voxels": np.full((2,), i, np.float32)}

    ds = input_pipeline.PrepDataset(Rows(), lambda sd, rng: sd)
    common = dict(batch_size=2, shuffle=False, repeat=False, drop_last=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plain = list(input_pipeline.BatchLoader(ds, **common))
        pooled = list(input_pipeline.BatchLoader(ds, **common, **pool))
    assert len(pooled) == len(plain) == 2
    for a, b in zip(pooled, plain):
        np.testing.assert_array_equal(a["voxels"], b["voxels"])


# --------------------------------------------------------------------------
# core/point_refine.py, utils/eval.py
# --------------------------------------------------------------------------

def _noisy_detections(rng, scene, n_false=6):
    """Ground truth boxes with pose noise (and thin boxes turned by 90
    degrees) plus false positives, as one detection dict."""
    gt = np.asarray(scene["gt_boxes"], np.float64)
    names = list(scene["gt_names"])
    boxes = gt + rng.normal(0, [0.05, 0.05, 0.02, 0.01, 0.05, 0.02, 0.15],
                            gt.shape)
    boxes[::5, 6] += np.pi / 2
    false = _boxes_3d(rng, n_false)
    false[:, :2] = rng.uniform(0, 16, (n_false, 2))
    labels = np.array([building.CLASSES.index(n) for n in names]
                      + list(rng.integers(0, 3, n_false)), np.int32)
    return {"box3d_lidar": np.concatenate([boxes, false]).astype(np.float32),
            "scores": rng.uniform(0.1, 1.0, len(labels)).astype(np.float32),
            "label_preds": labels}


@pytest.mark.parametrize("kw", [
    dict(classes=(0, 2), recenter=True),
    dict(classes=(2,)),
    dict(classes=(0, 2), recenter=True, trim_length=True),
], ids=["walls_doors_recenter", "doors_yaw_only", "trim"])
def test_point_refine_equals_reference(kw):
    """The same detections and points give the same boxes, exactly."""
    rng = np.random.default_rng(21)
    scene = building.generate_building_scene(7 * 100003 + 2)
    det = _noisy_detections(rng, scene)
    got = point_refine.refine_detections(det, scene["points"], **kw)
    ref = jax_point_refine.refine_detections(det, scene["points"], **kw)
    np.testing.assert_array_equal(got["box3d_lidar"], ref["box3d_lidar"])
    moved = np.abs(got["box3d_lidar"] - det["box3d_lidar"]).max(-1) > 1e-6
    assert moved.sum() > 2 and not moved[det["label_preds"] == 1].any()
    np.testing.assert_array_equal(got["scores"], det["scores"])
    assert point_refine.refine_yaw_by_points(
        scene["points"], np.zeros((0, 7)), np.zeros(0)).shape == (0, 7)


def test_evaluate_lidar_ap_equals_reference():
    rng = np.random.default_rng(31)
    gts, dets = [], []
    for i in range(3):
        scene = building.generate_building_scene(7 * 100003 + i)
        gts.append({"boxes": np.asarray(scene["gt_boxes"], np.float64),
                    "names": scene["gt_names"]})
        dets.append(_noisy_detections(rng, scene))
    dets[2] = {k: v[:0] for k, v in dets[2].items()}     # a scan with none
    thr = {"wall": 0.25, "column": 0.25, "door": 0.25}
    got = eval_mod.evaluate_lidar_ap(gts, dets, building.CLASSES, thr)
    with numpy_reference():
        ref = jax_eval.evaluate_lidar_ap(gts, dets, building.CLASSES, thr)
    assert got == ref
    # as the reference runs here its 3D overlaps are float32 C++: on these
    # noisy boxes an IoU near 0.25 can fall on the other side, so only the
    # BEV numbers (numpy on both sides) and the counts are held
    as_run = jax_eval.evaluate_lidar_ap(gts, dets, building.CLASSES, thr)
    assert sorted(got) == sorted(as_run)
    for k in as_run:
        if ".bev." in k or k.endswith("num_gt"):
            assert got[k] == as_run[k], k
    assert 0.2 < got["mAP.bev"] < 1.0 and got["wall.bev.num_gt"] > 50
    # pieces
    rec = np.array([0.1, 0.4, 0.4, 0.9])
    prec = np.array([1.0, 0.8, 0.9, 0.5])
    assert eval_mod._ap_interp(rec, prec) == jax_eval._ap_interp(rec, prec)
    assert eval_mod._pr_ap(np.zeros(0, bool), 5) == 0.0


# --------------------------------------------------------------------------
# predict with an anchor mask (tiny config)
# --------------------------------------------------------------------------

def test_predict_honours_anchors_mask_like_reference():
    cfg, vg, jta, fmap = jax_model_cfg("asbuilt_pillars_tiny")
    cfg = dataclasses.replace(cfg, nms_score_threshold=0.3)
    variables = random_variables(cfg, seed=4)
    anchors = jta.generate_anchors(fmap)["anchors"].reshape(-1, 7).astype(
        np.float32)
    rng = np.random.default_rng(4)
    A = len(anchors)
    preds = {"box_preds": rng.normal(0, 0.2, (2, *fmap[1:], cfg.num_anchor_per_loc * 7)),
             "cls_preds": rng.normal(-6, 2, (2, *fmap[1:], cfg.num_anchor_per_loc * cfg.num_class)),
             "dir_cls_preds": rng.normal(0, 1, (2, *fmap[1:], cfg.num_anchor_per_loc * 2))}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    mask = rng.random((2, A)) < 0.5
    batch_anchors = np.broadcast_to(anchors, (2, A, 7))
    _, tcfg, _ = build_from_config(PORT_CFG / "asbuilt_pillars_tiny.config")
    tcfg = dataclasses.replace(tcfg, nms_score_threshold=0.3)
    tpreds = {k: torch.from_numpy(v).permute(0, 3, 1, 2)
              for k, v in preds.items()}
    outs = {}
    for name, m in (("masked", mask), ("unmasked", None)):
        ref = jvn.predict({k: jnp.asarray(v) for k, v in preds.items()},
                          jnp.asarray(batch_anchors), cfg,
                          anchors_mask=None if m is None else jnp.asarray(m))
        got = tvn.predict(tpreds, torch.from_numpy(batch_anchors.copy()),
                          tcfg, anchors_mask=None if m is None
                          else torch.from_numpy(m))
        got = {k: v.numpy() for k, v in got.items()}
        diff = detections_mismatch(
            got, {k: np.asarray(v) for k, v in ref.items()}, cfg.num_class,
            BOX_ATOL, SCORE_ATOL)
        assert diff is None, (name, diff)
        outs[name] = got
    assert 0 < outs["masked"]["valid"].sum() < outs["unmasked"]["valid"].sum()


# --------------------------------------------------------------------------
# evaluate
# --------------------------------------------------------------------------

@contextlib.contextmanager
def shortened_val_split(n):
    """Both packages' readers build the synthetic val split (seed 7) with
    its first ``n`` scenes only."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_reader_builder, "_build_dataset",
               lambda ds, names, training=True: jax_building.BuildingDataset(
                   class_names=names, num_synthetic=n, synthetic_seed=7))
    mp.setattr(input_reader_builder, "_build_dataset",
               lambda ds, names, training: building.BuildingDataset(
                   class_names=names, num_synthetic=n, synthetic_seed=7))
    try:
        yield
    finally:
        mp.undo()


@contextlib.contextmanager
def recorded(module, cls):
    """Record what ``evaluate`` hands to the refinement (raw detections)
    and to the dataset's evaluation (final detections)."""
    log = {"raw": [], "final": None}
    mp = pytest.MonkeyPatch()
    refine, evaluation = module.refine_detections, cls.evaluation

    def rec_refine(det, points, **kw):
        log["raw"].append(det)
        return refine(det, points, **kw)

    def rec_evaluation(self, detections, output_dir=None):
        log["final"] = list(detections)
        return evaluation(self, detections, output_dir)

    mp.setattr(module, "refine_detections", rec_refine)
    mp.setattr(cls, "evaluation", rec_evaluation)
    try:
        yield log
    finally:
        mp.undo()


def run_both(n_scenes, config="asbuilt_pillars", variables=None):
    """``evaluate`` of both packages on the first ``n_scenes`` val scenes.
    -> {"port" / "jax": {"result", "raw", "final"}}."""
    if variables is None:
        with open(CKPT, "rb") as f:
            variables = pickle.load(f)
    out = {}
    with shortened_val_split(n_scenes):
        with recorded(point_refine, building.BuildingDataset) as log:
            result = train.evaluate(PORT_CFG / f"{config}.config",
                                    variables=variables, device="cpu")
        out["port"] = dict(log, result=result)
        with recorded(jax_point_refine, jax_building.BuildingDataset) as log:
            bundle = jax_train.Bundle(JAX_CFG / f"{config}.config")
            result = jax_train.evaluate(None, None, bundle=bundle,
                                        state=variables)
        out["jax"] = dict(log, result=result)
    return out


def padded(dets):
    """Per-scan detection dicts -> the padded dict detections_mismatch
    takes."""
    n = max(max(len(d["scores"]) for d in dets), 1)
    out = {"box3d_lidar": np.zeros((len(dets), n, 7)),
           "scores": np.zeros((len(dets), n)),
           "label_preds": np.zeros((len(dets), n), np.int32),
           "valid": np.zeros((len(dets), n), bool)}
    for i, d in enumerate(dets):
        k = len(d["scores"])
        for key in ("box3d_lidar", "scores", "label_preds"):
            out[key][i, :k] = d[key]
        out["valid"][i, :k] = True
    return out


def assert_same_ap(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if k.endswith("num_gt"):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= AP_ATOL, (k, got[k], v)


@pytest.fixture(scope="module")
def four_scenes():
    return run_both(4)


def test_evaluate_four_scenes_detections_match_reference(four_scenes):
    """Full width, trained checkpoint, the first four val scenes: what the
    network and ``predict`` give (before the refinement) as sets."""
    port, ref = four_scenes["port"], four_scenes["jax"]
    assert len(port["raw"]) == len(ref["raw"]) == 4
    diff = detections_mismatch(padded(port["raw"]), padded(ref["raw"]), 3,
                               BOX_ATOL, SCORE_ATOL)
    assert diff is None, diff
    assert all(len(d["scores"]) > 20 for d in port["raw"])
    assert [d["metadata"]["scene_id"] for d in port["final"]] == [
        7 * 100003 + i for i in range(4)]


def test_evaluate_four_scenes_refinement_attributed(four_scenes):
    """The refinement on identical detections is the reference's to the
    bit; on each side's own detections the refined boxes agree as sets
    except where a slab gained or lost a point (boxes that moved by under
    1e-3 m can count another point: at most a few detections)."""
    port, ref = four_scenes["port"], four_scenes["jax"]
    cfg = train.Bundle(PORT_CFG / "asbuilt_pillars.config").model_cfg
    assert cfg.yaw_point_refine_classes == (0, 2)
    assert cfg.yaw_point_refine_recenter and not cfg.yaw_point_refine_trim
    ds = building.BuildingDataset(num_synthetic=4, synthetic_seed=7)
    for i, (raw, final) in enumerate(zip(ref["raw"], ref["final"])):
        pts = ds.get_sensor_data(i)["lidar"]["points"]
        again = point_refine.refine_detections(
            raw, pts, classes=cfg.yaw_point_refine_classes,
            recenter=cfg.yaw_point_refine_recenter,
            trim_length=cfg.yaw_point_refine_trim)
        np.testing.assert_array_equal(again["box3d_lidar"],
                                      final["box3d_lidar"])
    unmatched = 0
    for p, r in zip(port["final"], ref["final"]):
        assert len(p["scores"]) == len(r["scores"])
        d = np.abs(p["box3d_lidar"][:, None] - r["box3d_lidar"][None]).max(-1)
        same_cls = p["label_preds"][:, None] == r["label_preds"][None]
        unmatched += int((~((d <= BOX_ATOL) & same_cls).any(1)).sum())
    total = sum(len(p["scores"]) for p in port["final"])
    print(f"refined detections without a counterpart within {BOX_ATOL}: "
          f"{unmatched} of {total}")
    assert unmatched <= 0.02 * total


def test_evaluate_four_scenes_ap_matches_reference(four_scenes):
    got, ref = four_scenes["port"]["result"], four_scenes["jax"]["result"]
    print("port", got)
    print("jax ", ref)
    assert_same_ap(got, ref)
    assert ref["wall.bev.num_gt"] == 141 and ref["mAP.bev"] > 0.8


def test_evaluate_tiny_seeded_weights_and_timers(capsys):
    """With no checkpoint it warns and evaluates seeded weights;
    ``measure_time`` prints the three timers and the four stages."""
    with shortened_val_split(3):
        result = train.evaluate(PORT_CFG / "asbuilt_pillars_tiny.config",
                                device="cpu", measure_time=True, seed=3)
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint" in out
    for word in ("host_feed", "device", "convert", "stage vfe",
                 "stage middle", "stage rpn", "stage predict"):
        assert f"[measure_time] {word}:" in out, word
    assert result["wall.bev.num_gt"] > 50
    assert set(result) == {f"{c}.{m}.{k}" for c in building.CLASSES
                           for m in ("bev", "3d")
                           for k in ("ap", "num_gt")} | {"mAP.bev", "mAP.3d"}


def test_evaluate_refuses_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        train.evaluate(PORT_CFG / "asbuilt_pillars_tiny.config")   # cuda
    with pytest.raises(NotImplementedError, match="multi-device"):
        train.evaluate(PORT_CFG / "asbuilt_pillars_tiny.config",
                       device="cpu", num_devices=4)
    text = (PORT_CFG / "asbuilt_pillars_tiny.config").read_text()
    mixed = tmp_path / "mixed.config"
    mixed.write_text(text.replace("train_config: {",
                                  "train_config: {\n  enable_mixed_precision: true", 1))
    with pytest.raises(NotImplementedError, match="mixed_precision"):
        train.Bundle(mixed)


@pytest.mark.slow
def test_evaluate_all_val_scenes_ap_matches_reference():
    """All 32 val scenes (several minutes on the CPU).  Prints the JAX
    package's AP dict: the constants ``chip_smoke.py`` pins."""
    both = run_both(32)
    got, ref = both["port"]["result"], both["jax"]["result"]
    print("JAX_EVAL_AP =", {k: (v if k.endswith("num_gt") else round(v, 6))
                            for k, v in ref.items()})
    print("port        =", got)
    diff = detections_mismatch(padded(both["port"]["raw"]),
                               padded(both["jax"]["raw"]), 3, BOX_ATOL,
                               SCORE_ATOL)
    print("raw detections as sets:", diff)
    assert_same_ap(got, ref)
