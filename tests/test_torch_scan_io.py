"""Scan ingestion and the building-data prep of the port
(``data/scan_io.py``, ``data/create_data.py::building_data_prep`` and
``building_data_prep_from_scans``), held to the JAX package on the same
inputs: every case of ``tests/test_scan_io.py``, with the port's reader
giving the JAX reader's arrays bit for bit (dtype and shape included) and
the port's writers the same bytes; the two preps writing equal info
pickles, equal scene point arrays, byte-identical ``gt_database/*.bin``
files and equal db-info pickles (the reference on its numpy path,
``native.AVAILABLE = False``, as the other data tests run it: its C++
``points_in_rbbox`` takes a point on a box face that the numpy path, and
the port, leave out)."""
import pickle

import numpy as np
import pytest

from automatic_as_built_reconstruction_tpu.data import (
    building as jax_building, create_data as jax_create_data,
    scan_io as jax_scan_io)
from automatic_as_built_reconstruction_tpu_torch.data import (
    building, create_data, scan_io)
from automatic_as_built_reconstruction_tpu_torch.train import train

from test_torch_eval import numpy_reference
from test_torch_train import MICRO_CONFIG


@pytest.fixture()
def cloud():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(500, 4)).astype(np.float32)
    pts[:, 3] = rng.random(500)
    return pts


def same_array(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def same_tree(got, want):
    """Pickled infos: the same keys, types and values, arrays bit for
    bit."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same_tree(g, w)
    elif isinstance(want, np.ndarray):
        same_array(got, want)
    else:
        assert got == want


def read_both(path):
    """The port's and the JAX package's ``read_scan`` of one file, equal
    bit for bit.  -> the port's array."""
    got = scan_io.read_scan(path)
    same_array(got, jax_scan_io.read_scan(path))
    return got


class TestPly:
    @pytest.mark.parametrize("binary", [True, False])
    def test_roundtrip(self, tmp_path, cloud, binary):
        p, q = tmp_path / "a.ply", tmp_path / "ref.ply"
        scan_io.write_ply(cloud, p, binary=binary)
        jax_scan_io.write_ply(cloud, q, binary=binary)
        assert p.read_bytes() == q.read_bytes()
        back = scan_io.read_ply(p)
        same_array(back, jax_scan_io.read_ply(p))
        np.testing.assert_allclose(back, cloud, atol=1e-5)

    def test_xyz_only(self, tmp_path, cloud):
        p, q = tmp_path / "b.ply", tmp_path / "ref.ply"
        scan_io.write_ply(cloud[:, :3], p)
        jax_scan_io.write_ply(cloud[:, :3], q)
        assert p.read_bytes() == q.read_bytes()
        assert read_both(p).shape == (500, 3)

    def test_nan_points_dropped(self, tmp_path, cloud):
        bad = cloud.copy()
        bad[7, 0] = np.nan
        p = tmp_path / "c.ply"
        scan_io.write_ply(bad, p)
        assert read_both(p).shape[0] == 499

    def test_extra_vertex_props_and_faces_ignored(self, tmp_path):
        body = "\n".join(
            f"{i} {i+0.5} {-i} 12 0.25" for i in range(4))
        p = tmp_path / "d.ply"
        p.write_text(
            "ply\nformat ascii 1.0\nelement vertex 4\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty float intensity\n"
            "element face 1\nproperty list uchar int vertex_index\n"
            "end_header\n" + body + "\n3 0 1 2\n")
        pts = read_both(p)
        assert pts.shape == (4, 4)
        np.testing.assert_allclose(pts[2], [2, 2.5, -2, 0.25])

    def test_bad_files_raise_as_the_reference(self, tmp_path):
        for name, text in (("x.ply", "plx\n"),
                           ("y.ply", "ply\nformat ascii 1.0\nend_header\n"),
                           ("z.ply", "ply\nformat binary_big_endian 1.0\n"
                                     "element vertex 0\nend_header\n")):
            p = tmp_path / name
            p.write_text(text)
            with pytest.raises(ValueError) as want:
                jax_scan_io.read_ply(p)
            with pytest.raises(ValueError) as got:
                scan_io.read_ply(p)
            assert str(got.value) == str(want.value)


class TestPcd:
    def _write_pcd(self, path, pts, mode, fields="x y z intensity"):
        n = pts.shape[0]
        header = (f"# .PCD v0.7\nVERSION 0.7\nFIELDS {fields}\n"
                  "SIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
                  f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                  f"POINTS {n}\nDATA {mode}\n")
        with open(path, "wb") as f:
            f.write(header.encode())
            if mode == "binary":
                f.write(np.ascontiguousarray(pts, "<f4").tobytes())
            else:
                np.savetxt(f, pts, fmt="%.6f")

    @pytest.mark.parametrize("mode", ["binary", "ascii"])
    def test_read(self, tmp_path, cloud, mode):
        p = tmp_path / "a.pcd"
        self._write_pcd(p, cloud, mode)
        back = scan_io.read_pcd(p)
        same_array(back, jax_scan_io.read_pcd(p))
        np.testing.assert_allclose(back, cloud, atol=1e-5)

    def test_first_intensity_name_present_wins(self, tmp_path, cloud):
        p = tmp_path / "r.pcd"
        self._write_pcd(p, cloud, "binary", fields="x y z reflectance")
        np.testing.assert_array_equal(read_both(p)[:, 3], cloud[:, 3])

    def test_dispatch(self, tmp_path, cloud):
        p = tmp_path / "a.pcd"
        self._write_pcd(p, cloud, "binary")
        np.testing.assert_allclose(read_both(p), cloud, atol=1e-5)
        b = tmp_path / "a.bin"
        cloud.tofile(b)
        np.testing.assert_array_equal(read_both(b), cloud)
        z = tmp_path / "a.npz"
        np.savez(z, points=cloud.astype(np.float64))
        np.testing.assert_array_equal(read_both(z), cloud)
        y = tmp_path / "a.npy"
        np.save(y, cloud)
        np.testing.assert_array_equal(read_both(y), cloud)
        with pytest.raises(ValueError, match="unsupported scan format"):
            scan_io.read_scan(tmp_path / "a.las")


def test_annotations_write_the_same_bytes_and_read_back(tmp_path):
    scene = building.generate_building_scene(3)
    p, q = tmp_path / "a.json", tmp_path / "ref.json"
    scan_io.write_annotations(p, scene["gt_boxes"], scene["gt_names"])
    jax_scan_io.write_annotations(q, scene["gt_boxes"], scene["gt_names"])
    assert p.read_bytes() == q.read_bytes()
    boxes, names = scan_io.read_annotations(p)
    jboxes, jnames = jax_scan_io.read_annotations(p)
    same_array(boxes, jboxes)
    same_array(names, jnames)
    q.write_text('{"boxes": [[0, 0, 0, 1, 1, 1, 0]], "names": []}')
    with pytest.raises(ValueError, match="1 boxes vs 0 names"):
        scan_io.read_annotations(q)


def same_layout(root, ref):
    """The port's prep under ``root`` against the JAX package's under
    ``ref``: the same files; info and db-info pickles equal, scene point
    arrays equal, gt-database files byte for byte."""
    files = sorted(p.relative_to(root) for p in root.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(ref) for p in ref.rglob("*")
                           if p.is_file())
    for rel in files:
        got, want = root / rel, ref / rel
        if rel.suffix == ".pkl":
            with open(got, "rb") as f, open(want, "rb") as g:
                same_tree(pickle.load(f), pickle.load(g))
        elif rel.suffix == ".npz":
            same_array(np.load(got)["points"], np.load(want)["points"])
        else:
            assert got.read_bytes() == want.read_bytes(), rel
    return files


def test_building_data_prep_equals_reference(tmp_path):
    """Synthetic prep at 3 + 1 scenes from seed 1: scene ids
    ``seed * 100003 + i``, the same paths, arrays and bytes."""
    root, ref = tmp_path / "port", tmp_path / "jax"
    create_data.building_data_prep(root, num_scenes=3, num_val=1, seed=1)
    with numpy_reference():
        jax_create_data.building_data_prep(ref, num_scenes=3, num_val=1,
                                           seed=1)
    files = same_layout(root, ref)
    assert sum(f.parent.name == "gt_database" for f in files) > 10
    with open(root / "building_infos_val.pkl", "rb") as f:
        assert [i["scene_id"] for i in pickle.load(f)] == [100003 + 3]


class TestFromScansPrep:
    @pytest.fixture(scope="class")
    def scan_root(self, tmp_path_factory):
        """Synthetic scenes written out as ply + json sidecars, ingested
        back by both packages."""
        scan_dir = tmp_path_factory.mktemp("scans")
        for i in range(4):
            scene = building.generate_building_scene(100 + i)
            scan_io.write_ply(scene["points"],
                              scan_dir / f"scan_{i}.ply",
                              binary=(i % 2 == 0))
            scan_io.write_annotations(scan_dir / f"scan_{i}.json",
                                      scene["gt_boxes"],
                                      scene["gt_names"])
        root = tmp_path_factory.mktemp("ingested")
        ref = tmp_path_factory.mktemp("ingested_ref")
        create_data.building_data_prep_from_scans(scan_dir, root,
                                                  val_fraction=0.25)
        with numpy_reference():
            jax_create_data.building_data_prep_from_scans(
                scan_dir, ref, val_fraction=0.25)
        return root, ref

    def test_layout(self, scan_root):
        root, ref = scan_root
        same_layout(root, ref)
        assert (root / "building_infos_train.pkl").exists()
        assert (root / "building_infos_val.pkl").exists()
        assert (root / "building_dbinfos_train.pkl").exists()
        assert len(list((root / "scenes").glob("*.npz"))) == 4

    def test_dataset_reads_ingested_scans(self, scan_root):
        root, _ = scan_root
        ds = building.BuildingDataset(
            root_path=root, info_path=root / "building_infos_train.pkl")
        ref = jax_building.BuildingDataset(
            root_path=root, info_path=root / "building_infos_train.pkl")
        assert len(ds) == len(ref) == 3
        sd = ds.get_sensor_data(0)
        same_array(sd["lidar"]["points"],
                   ref.get_sensor_data(0)["lidar"]["points"])
        assert sd["lidar"]["points"].shape[1] == 4
        assert "wall" in set(sd["annotations"]["names"])

    def test_trainer_runs_from_ingested_scans(self, scan_root, tmp_path):
        """One step of the port's ``train`` on the CPU from the ingested
        layout."""
        root, _ = scan_root
        cfg = MICRO_CONFIG.replace(
            'dataset: { dataset_class_name: "BuildingDataset" }',
            'dataset: {\n'
            '      dataset_class_name: "BuildingDataset"\n'
            f'      kitti_root_path: "{root}"\n'
            f'      kitti_info_path: '
            f'"{root / "building_infos_train.pkl"}"\n'
            '    }')
        assert cfg != MICRO_CONFIG
        p = tmp_path / "ingested.config"
        p.write_text(cfg)
        state = train.train(p, tmp_path / "run", max_steps=1,
                            display_step=1, device="cpu")
        assert state.step == 1

    def test_annotation_boxes_survive_roundtrip(self, scan_root):
        scene = building.generate_building_scene(100)
        with open(scan_root[0] / "building_infos_train.pkl", "rb") as f:
            infos = pickle.load(f)
        np.testing.assert_allclose(infos[0]["gt_boxes"],
                                   scene["gt_boxes"], atol=1e-5)
        assert infos[0]["source"] == "scan_0.ply"

    def test_missing_sidecar_means_no_boxes(self, tmp_path):
        scan_dir = tmp_path / "s"
        scan_dir.mkdir()
        scene = building.generate_building_scene(7)
        scan_io.write_ply(scene["points"], scan_dir / "only.ply")
        root, ref = tmp_path / "r", tmp_path / "ref"
        create_data.building_data_prep_from_scans(scan_dir, root)
        with numpy_reference():
            jax_create_data.building_data_prep_from_scans(scan_dir, ref)
        same_layout(root, ref)
        with open(root / "building_infos_train.pkl", "rb") as f:
            infos = pickle.load(f)
        assert infos[0]["gt_boxes"].shape == (0, 7)
        (tmp_path / "empty").mkdir()
        with pytest.raises(FileNotFoundError, match="no scans"):
            create_data.building_data_prep_from_scans(tmp_path / "empty",
                                                      root)
