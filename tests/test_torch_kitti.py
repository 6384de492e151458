"""Port vs JAX package: the KITTI data path of SECOND training and
evaluation, on a small synthetic KITTI clone.

- the port's clone generator (``data/synth_kitti.py``) against
  ``tools/make_synth_kitti.py`` from the same seed: every file byte for
  byte, the offline prep's infos, reduced clouds and gt database included
  (the reference on its numpy path, ``native.AVAILABLE = False``, as the
  other data tests run it);
- the KITTI readers, infos and result writers; the camera box functions;
  ``KittiDataset.get_sensor_data``;
- the gt-database sampler (``sample_all``, ``dbsampler_builder``) and
  the first training examples with it, bit for bit (the examples against the
  reference as it runs: the port's voxelizer follows its C++ one);
- the KITTI protocol (``get_official_eval_result``) on random and on
  perfect detections: equal to the reference's Python statistics, and
  within 1e-4 AP points of its C++ statistics;
- the loader's pools: pooled batches equal the sequential ones (threads
  and processes) where no sampler shares a generator.
"""
import importlib.util
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

from automatic_as_built_reconstruction_tpu.builder import (
    config_io as jax_config_io, dbsampler_builder as jax_dbsampler_builder)
from automatic_as_built_reconstruction_tpu.core import (
    box_ops as jax_box_ops, sample_ops as jax_sample_ops)
from automatic_as_built_reconstruction_tpu.data import (
    kitti_common as jax_kitti, kitti_dataset as jax_kitti_dataset)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.utils import eval as jax_eval
from automatic_as_built_reconstruction_tpu_torch.builder import (
    config_io, dbsampler_builder)
from automatic_as_built_reconstruction_tpu_torch.core import (
    box_ops, sample_ops)
from automatic_as_built_reconstruction_tpu_torch.data import (
    kitti_common, kitti_dataset, synth_kitti)
from automatic_as_built_reconstruction_tpu_torch.train import train
from automatic_as_built_reconstruction_tpu_torch.utils import eval as eval_mod

from test_torch_train_data import assert_same, numpy_reference

REPO = Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "make_synth_kitti.py"
CAR_FHD = (REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
           / "second" / "car" / "car.fhd.config")
NUM_TRAIN, NUM_VAL = 6, 3


def kitti_config(text: str, root: Path, tmp: Path, name: str,
                 **replace) -> Path:
    """``text`` with its data paths under ``root`` and the given
    replacements, written to ``tmp / name``."""
    text = text.replace('"data/kitti', f'"{root}')
    for old, new in replace.items():
        assert text.count(old) >= 1, old
        text = text.replace(old, new)
    path = tmp / name
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def clones(tmp_path_factory):
    """The same clone written by the tool (into ``ref``) and by the port
    (into ``port``), each with its package's offline prep."""
    tmp = tmp_path_factory.mktemp("kitti")
    spec = importlib.util.spec_from_file_location("make_synth_kitti", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    argv = sys.argv
    sys.argv = ["make_synth_kitti.py", "--root", str(tmp / "ref"),
                "--num_train", str(NUM_TRAIN), "--num_val", str(NUM_VAL),
                "--seed", "0"]
    try:
        with numpy_reference():
            tool.main()
    finally:
        sys.argv = argv
    synth_kitti.write_clone(tmp / "port", NUM_TRAIN, NUM_VAL, seed=0)
    return tmp / "ref", tmp / "port", tmp


def assert_same_tree(got, want, what=""):
    """Nested dicts / lists / arrays / scalars equal, types included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), what
        for k in want:
            assert_same_tree(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert_same(got, want, what)
    else:
        assert type(got) is type(want) and got == want, what


def test_synthetic_clone_equals_the_tool_byte_for_byte(clones):
    """Frames, labels, calibration, splits, reduced clouds and the gt
    database's object files byte for byte; the info pickles equal."""
    ref, port, _ = clones
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(port) for p in port.rglob("*")
                           if p.is_file())
    kinds = {p.parts[0] if len(p.parts) == 1 else p.parts[-2] for p in files}
    assert {"velodyne", "velodyne_reduced", "label_2", "calib",
            "gt_database", "ImageSets"} <= kinds
    for rel in files:
        if rel.suffix == ".pkl":
            with open(ref / rel, "rb") as f, open(port / rel, "rb") as g:
                assert_same_tree(pickle.load(g), pickle.load(f), str(rel))
        else:
            assert (port / rel).read_bytes() == (ref / rel).read_bytes(), rel
    with open(port / "kitti_dbinfos_train.pkl", "rb") as f:
        assert len(pickle.load(f)["Car"]) > 10


def test_kitti_readers_and_writers_equal_reference(clones):
    ref, port, tmp = clones
    lines = (port / "training" / "label_2" / "000001.txt").read_text(
        ).splitlines()
    lines.append("DontCare -1 -1 -10 500.0 170.0 590.0 200.0 -1 -1 -1 "
                 "-1000 -1000 -1000 -10")
    lines.append("Van 0.30 1 1.50 100.0 150.0 200.0 230.0 2.0 1.9 4.8 "
                 "-3.0 1.6 15.0 1.40 0.75")
    for src in (lines, port / "training" / "label_2" / "000002.txt"):
        want, got = jax_kitti.get_label_anno(src), kitti_common.get_label_anno(
            src)
        assert_same_tree(got, want)
        assert_same_tree(kitti_common.remove_dontcare(got),
                         jax_kitti.remove_dontcare(want))
        assert_same_tree(kitti_common.filter_kitti_anno(got, ["Car"]),
                         jax_kitti.filter_kitti_anno(want, ["Car"]))
        assert_same(kitti_common.anno_to_rbboxes(got),
                    jax_kitti.anno_to_rbboxes(want))
        assert (kitti_common.anno_to_kitti_label_lines(got)
                == jax_kitti.anno_to_kitti_label_lines(want))
        assert_same(eval_mod.kitti_difficulty(got),
                    jax_eval.kitti_difficulty(want))
    assert "DontCare" in list(kitti_common.get_label_anno(lines)["name"])
    calib = port / "training" / "calib" / "000003.txt"
    assert_same_tree(kitti_common.get_calib(calib), jax_kitti.get_calib(calib))
    assert_same_tree(kitti_common.get_kitti_image_info(port, image_ids=[0, 4]),
                     jax_kitti.get_kitti_image_info(port, image_ids=[0, 4]))
    assert_same_tree(kitti_common.empty_result_anno(),
                     jax_kitti.empty_result_anno())
    anno = kitti_common.get_label_anno(lines)
    kitti_common.write_kitti_results([anno, anno], [3, 17], tmp / "w_port")
    jax_kitti.write_kitti_results([anno, anno], [3, 17], tmp / "w_ref")
    for name in ("000003.txt", "000017.txt"):
        assert ((tmp / "w_port" / name).read_bytes()
                == (tmp / "w_ref" / name).read_bytes())


def test_camera_box_functions_equal_reference(clones):
    _, port, _ = clones
    c = kitti_common.get_calib(port / "training" / "calib" / "000000.txt")
    r_rect, v2c, P2 = c["R0_rect"], c["Tr_velo_to_cam"], c["P2"]
    # a calibration with a real rotation and rectification as well
    rng = np.random.default_rng(5)
    a = rng.uniform(-0.1, 0.1, 3)
    rot = (np.array([[1, 0, 0], [0, np.cos(a[0]), -np.sin(a[0])],
                     [0, np.sin(a[0]), np.cos(a[0])]])
           @ np.array([[np.cos(a[1]), 0, np.sin(a[1])], [0, 1, 0],
                       [-np.sin(a[1]), 0, np.cos(a[1])]]))
    r2 = np.eye(4)
    r2[:3, :3] = rot
    v2 = v2c.copy()
    v2[:3, 3] += rng.uniform(-0.3, 0.3, 3)
    pts = np.concatenate([rng.uniform([0, -30, -3], [60, 30, 2], (400, 3)),
                          rng.random((400, 1))], 1).astype(np.float32)
    boxes = np.concatenate([rng.uniform([2, -20, -2], [50, 20, 0], (30, 3)),
                            rng.uniform(1, 4, (30, 3)),
                            rng.uniform(-np.pi, np.pi, (30, 1))], 1)
    for rr, vc in ((r_rect, v2c), (r2, v2)):
        for fn, arg in (("camera_to_lidar", pts[:, :3]),
                        ("lidar_to_camera", pts[:, :3]),
                        ("box_camera_to_lidar", boxes),
                        ("box_lidar_to_camera", boxes)):
            assert_same(getattr(box_ops, fn)(arg, rr, vc),
                        getattr(jax_box_ops, fn)(arg, rr, vc), fn)
        kept = box_ops.remove_outside_points(pts, rr, vc, P2, (375, 1242))
        assert_same(kept, jax_box_ops.remove_outside_points(
            pts, rr, vc, P2, (375, 1242)), "remove_outside_points")
        assert 0 < len(kept) < len(pts)
    cam = box_ops.lidar_to_camera(pts[:, :3].astype(np.float64), r_rect, v2c)
    assert_same(box_ops.project_to_image(cam, P2),
                jax_box_ops.project_to_image(cam, P2))
    assert_same(box_ops.center_to_minmax_2d(boxes[:, :2], boxes[:, 3:5]),
                jax_box_ops.center_to_minmax_2d(boxes[:, :2], boxes[:, 3:5]))
    bbox = np.array([10.0, 20.0, 900.0, 300.0])
    assert_same(box_ops.image_bbox_to_camera_frustum(P2, bbox),
                jax_box_ops.image_bbox_to_camera_frustum(P2, bbox))
    keep_pts = np.concatenate([pts, pts[:5]])
    assert_same(box_ops.remove_points_in_boxes(keep_pts, boxes[:, [0, 1, 2, 4,
                                                                   3, 5, 6]]),
                jax_box_ops.remove_points_in_boxes(
                    keep_pts.astype(np.float64),
                    boxes[:, [0, 1, 2, 4, 3, 5, 6]]).astype(np.float32))


def test_kitti_dataset_sensor_data_equals_reference(clones):
    ref, port, _ = clones
    for split in ("train", "val"):
        want = jax_kitti_dataset.KittiDataset(
            ref, ref / f"kitti_infos_{split}.pkl", ["Car"])
        got = kitti_dataset.KittiDataset(
            port, port / f"kitti_infos_{split}.pkl", ["Car"])
        assert len(got) == len(want) == (NUM_TRAIN if split == "train"
                                         else NUM_VAL)
        for i in range(len(want)):
            assert_same_tree(got.get_sensor_data(i), want.get_sensor_data(i))
    assert_same_tree(got.ground_truth_annotations(),
                     want.ground_truth_annotations())


def _sampler_pair(ref, port, tmp):
    """The sampler of car.fhd.config's training reader, built by each
    package's builder from the config file (paths under its clone)."""
    text = CAR_FHD.read_text()
    jcfg = jax_config_io.load_config(kitti_config(text, ref, tmp, "ref.cfg"))
    tcfg = config_io.load_config(kitti_config(text, port, tmp, "port.cfg"))
    want = jax_dbsampler_builder.build(
        jcfg.train_input_reader.preprocess.database_sampler,
        rng=np.random.default_rng(0))
    got = dbsampler_builder.build(
        tcfg["train_input_reader"]["preprocess"]["database_sampler"],
        rng=np.random.default_rng(0))
    return got, want


def test_sample_all_equals_reference(clones):
    """sample_all on every training scene's boxes, twice over (the
    generator and the per-class epoch shuffles carry on), bit for bit."""
    ref, port, tmp = clones
    with numpy_reference():
        got, want = _sampler_pair(ref, port, tmp)
        assert isinstance(got, sample_ops.DataBaseSampler)
        assert isinstance(want, jax_sample_ops.DataBaseSampler)
        ds = kitti_dataset.KittiDataset(port, port / "kitti_infos_train.pkl",
                                        ["Car"])
        n_sampled = 0
        for _ in range(2):
            for i in range(len(ds)):
                ann = ds.get_sensor_data(i)["annotations"]
                g = got.sample_all(ann["boxes"], ann["names"])
                w = want.sample_all(ann["boxes"], ann["names"])
                assert (g is None) == (w is None)
                if w is not None:
                    assert_same_tree(g, w, f"scene {i}")
                    n_sampled += len(w["gt_boxes"])
    assert n_sampled > 20


def test_first_training_examples_with_the_sampler_equal_reference(clones):
    """The first three training examples of car.fhd.config (full width:
    17 000 voxels, 70 400 anchors; the gt-database paste-in and the
    config's augmentation), taken in the loader's stream order, bit for
    bit, against the reference as it runs (its voxelizer, which the port
    follows, is its C++ one)."""
    ref, port, tmp = clones
    text = CAR_FHD.read_text()
    jds, jloader = jax_train.Bundle(kitti_config(
        text, ref, tmp, "ref_ex.cfg")).input_reader(training=True)
    tds, tloader = train.Bundle(kitti_config(
        text, port, tmp, "port_ex.cfg")).input_reader(training=True)
    stream = tloader._index_stream()
    jstream = jloader._index_stream()
    for _ in range(3):
        idx, seed = next(stream)
        assert next(jstream) == (idx, seed)
        got, want = tds.example(idx, seed), jds.example(idx, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            if k in ("metadata", "calib"):
                assert_same_tree(got[k], want[k])
            else:
                assert_same(got[k], want[k], k)
        # more objects than the scan's own: the sampler pasted some in
        n_own = len(tds.dataset.get_sensor_data(idx)["annotations"][
            "boxes"])
        assert len(got["gt_boxes"]) > n_own


def _perturbed(annos, rng):
    """Detections near the ground truth, some missed, some false."""
    out = []
    for a in annos:
        a = kitti_common.remove_dontcare(a)
        n = len(a["name"])
        keep = rng.random(n) < 0.8
        loc = a["location"][keep] + rng.normal(0, 0.3, (keep.sum(), 3))
        dims = a["dimensions"][keep] * rng.uniform(0.9, 1.1,
                                                   (keep.sum(), 3))
        ry = a["rotation_y"][keep] + rng.normal(0, 0.2, keep.sum())
        bbox = a["bbox"][keep] + rng.normal(0, 5, (keep.sum(), 4))
        nf = int(rng.integers(0, 3))
        loc = np.concatenate([loc, rng.uniform([-10, 1, 5], [10, 2, 50],
                                               (nf, 3))])
        dims = np.concatenate([dims, rng.uniform(1, 4, (nf, 3))])
        ry = np.concatenate([ry, rng.uniform(-np.pi, np.pi, nf)])
        bbox = np.concatenate([bbox, np.sort(rng.uniform(0, 600, (nf, 4))
                                             .reshape(nf, 2, 2), 1)
                               .reshape(nf, 4)])
        m = len(loc)
        out.append({"name": np.array(["Car"] * m), "truncated": np.zeros(m),
                    "occluded": np.zeros(m, np.int64),
                    "alpha": rng.uniform(-np.pi, np.pi, m), "bbox": bbox,
                    "dimensions": dims, "location": loc, "rotation_y": ry,
                    "score": rng.random(m)})
    return out


def perfect_detections(annos):
    """The ground truth as detections, scores distinct and descending."""
    out, s = [], 1.0
    for a in annos:
        a = kitti_common.remove_dontcare(a)
        n = len(a["name"])
        d = {k: a[k] for k in ("name", "truncated", "occluded", "alpha",
                               "bbox", "dimensions", "location",
                               "rotation_y")}
        d["score"] = s - 1e-3 * np.arange(n)
        s -= 1e-3 * n
        out.append(d)
    return out


@pytest.mark.parametrize("dets", ["random", "perfect"])
def test_official_eval_result_equals_reference(clones, dets):
    ref, _, _ = clones
    with open(ref / "kitti_infos_train.pkl", "rb") as f:
        gt = [i["annos"] for i in pickle.load(f)]
    dt = (_perturbed(gt, np.random.default_rng(9)) if dets == "random"
          else perfect_detections(gt))
    got = eval_mod.get_official_eval_result(gt, dt, ["Car", "Pedestrian"])
    with numpy_reference():      # its Python statistics: the same bits
        want = jax_eval.get_official_eval_result(gt, dt, ["Car", "Pedestrian"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    # its C++ statistics: the AOS similarity summed in float32 there
    native = jax_eval.get_official_eval_result(gt, dt, ["Car", "Pedestrian"])
    for k in want:
        if k != "result_str":
            assert got[k] == pytest.approx(native[k], abs=1e-4), k
    if dets == "perfect":
        # every threshold the protocol samples has precision 1 (AP 100
        # where the ground truth fills the 41 recall slots)
        for diff in range(3):
            r = eval_mod.eval_class(gt, dt, "Car", diff, 1, 0.7)
            T = len(r["thresholds"])
            assert T > 0 and (r["precision"][:T] == 1).all()
            assert r["recall"][T - 1] == 1.0
    else:
        assert 0 < got["Car.bev.moderate"] < 100


def test_loader_pools_give_the_sequential_batches(clones, tmp_path):
    """Threads and forked processes: the first batches of a KITTI training
    reader without the sampler (its own seed an example) equal the
    sequential loader's."""
    _, port, tmp = clones
    text = CAR_FHD.read_text()
    a = text.index("    database_sampler {")
    b = text.index("    }\n  }\n  num_workers", a) + len("    }\n")
    text = text[:a] + text[b:]
    batches = {}
    for name, pool in (("sequential", "num_workers: 1"),
                       ("threads", "num_workers: 3"),
                       ("processes", "num_workers: 2\n  process_workers: "
                                     "true")):
        cfg = kitti_config(text, port, tmp_path, f"{name}.cfg", **{
            "num_workers: 3": pool,
            "max_number_of_voxels: 17000": "max_number_of_voxels: 3000",
            "voxel_size: [0.05, 0.05, 0.1]": "voxel_size: [0.4, 0.4, 0.1]",
            "batch_size: 6": "batch_size: 2"})
        _, loader = train.Bundle(cfg).input_reader(training=True)
        it = iter(loader)
        batches[name] = [next(it) for _ in range(2)]
        it.close()
    for name in ("threads", "processes"):
        for got, want in zip(batches[name], batches["sequential"]):
            assert sorted(got) == sorted(want)
            for k in want:
                if k in ("voxels", "coordinates", "labels", "reg_targets"):
                    assert_same(got[k], want[k], f"{name} {k}")
