"""Port vs JAX package: the host half of training, equal arrays bit for
bit (the port's modules are the reference's numpy on the same seeds).

Box coders, the three region similarities, target assignment on the
as-built config's real anchors (A = 32 000) with the synthetic training
scenes' boxes, every augmentation function from one seed, the training
branch of ``prep_pointcloud`` at the full width of ``asbuilt_pillars``,
the first three batches of the training reader, and the builders of
coder, similarity and assigner on every config.  Where the reference
prefers its C++ library (points in boxes and the box collision test on
float32 input) it runs with the library switched off: the port keeps the
numpy forms.
"""
import contextlib
from pathlib import Path

import numpy as np
import pytest

from automatic_as_built_reconstruction_tpu import native as jax_native
from automatic_as_built_reconstruction_tpu.builder import (
    box_coder_builder as jax_box_coder_builder,
    config_io as jax_config_io,
    target_assigner_builder as jax_ta_builder)
from automatic_as_built_reconstruction_tpu.core import (
    augment as jax_augment, box_coders as jax_box_coders,
    region_similarity as jax_similarity, target_assign as jax_target_assign)
from automatic_as_built_reconstruction_tpu.data import (
    preprocess as jax_preprocess)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu_torch.builder import (
    box_coder_builder, config_io, target_assigner_builder)
from automatic_as_built_reconstruction_tpu_torch.core import (
    augment, box_coders, region_similarity, target_assign)
from automatic_as_built_reconstruction_tpu_torch.data import (
    building, preprocess)
from automatic_as_built_reconstruction_tpu_torch.train import train

REPO = Path(__file__).resolve().parents[1]
JAX_CONFIGS = sorted((REPO / "automatic_as_built_reconstruction_tpu"
                      / "configs").rglob("*.config"))
PILLARS = (REPO / "automatic_as_built_reconstruction_tpu" / "configs"
           / "building" / "asbuilt_pillars.config")
PORT_PILLARS = (REPO / "automatic_as_built_reconstruction_tpu_torch"
                / "configs" / "building" / "asbuilt_pillars.config")


@contextlib.contextmanager
def numpy_reference():
    """The reference with its C++ library switched off: its numpy path."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "AVAILABLE", False)
    try:
        yield
    finally:
        mp.undo()


def assert_same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _boxes(rng, n, dtype=np.float32):
    b = np.concatenate([rng.uniform(0, 16, (n, 2)),
                        rng.uniform(-0.5, 1, (n, 1)),
                        rng.uniform(0.05, 3, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    return b.astype(dtype)


@pytest.fixture(scope="module")
def bundles():
    return jax_train.Bundle(PILLARS), train.Bundle(PORT_PILLARS)


@pytest.fixture(scope="module")
def training_scenes():
    """Sensor data of the first training scenes (256 synthetic, seed 0)."""
    ds = building.BuildingDataset(num_synthetic=256, synthetic_seed=0)
    return [ds.get_sensor_data(i) for i in range(4)]


@pytest.mark.parametrize("linear_dim", [False, True])
@pytest.mark.parametrize("vec_encode", [False, True])
@pytest.mark.parametrize("coder", ["GroundBox3dCoder", "BevBoxCoder"])
def test_box_coders_equal_reference(coder, vec_encode, linear_dim):
    rng = np.random.default_rng(0)
    boxes, anchors = _boxes(rng, 500), _boxes(rng, 500)
    got = getattr(box_coders, coder)(linear_dim=linear_dim,
                                     vec_encode=vec_encode)
    want = getattr(jax_box_coders, coder)(linear_dim=linear_dim,
                                          vec_encode=vec_encode)
    assert got.code_size == want.code_size
    enc = want.encode(boxes, anchors)
    assert_same(got.encode(boxes, anchors), enc, "encode")
    assert_same(got.decode(enc, anchors), want.decode(enc, anchors),
                "decode")


@pytest.mark.parametrize("name,kwargs", [
    ("DistanceSimilarity", dict(distance_norm=0.5, with_rotation=True,
                                rotation_alpha=0.5)),
    ("DistanceSimilarity", dict(distance_norm=2.0)),
    ("NearestIouSimilarity", {}),
    ("RotateIouSimilarity", {}),
], ids=["distance_rot", "distance", "nearest_iou", "rotate_iou"])
def test_similarities_equal_reference(name, kwargs):
    rng = np.random.default_rng(1)
    n = 40 if name == "RotateIouSimilarity" else 2000
    a = _boxes(rng, n)[:, [0, 1, 3, 4, 6]]
    b = _boxes(rng, 30)[:, [0, 1, 3, 4, 6]]
    with numpy_reference():
        want = getattr(jax_similarity, name)(**kwargs).compare(a, b)
    got = getattr(region_similarity, name)(**kwargs).compare(a, b)
    assert_same(got, want, name)
    assert (want > 0).any()


@pytest.mark.parametrize("path", JAX_CONFIGS, ids=lambda p: p.stem)
def test_coder_similarity_and_assigner_builders_match(path):
    jm = jax_config_io.load_config(path).model.second
    tm = config_io.load_config(path)["model"]["second"]
    jcoder = jax_box_coder_builder.build(jm.box_coder)
    jta = jax_ta_builder.build(jm.target_assigner, jcoder)
    tcoder = box_coder_builder.build(tm.get("box_coder", {}))
    tta = target_assigner_builder.build(tm["target_assigner"],
                                        tm.get("box_coder", {}))
    for got, want in ((tcoder, jcoder), (tta.box_coder, jcoder),
                      (tta.region_similarity_calculator,
                       jta.region_similarity_calculator)):
        assert type(got).__name__ == type(want).__name__
        assert vars(got) == vars(want)
    assert (tta.positive_fraction, tta.sample_size) == (
        jta.positive_fraction, jta.sample_size)


@pytest.mark.parametrize("masked", [False, True])
def test_assign_on_the_real_anchors_equals_reference(bundles,
                                                     training_scenes, masked):
    """create_targets / assign at A = 32 000 with the training scenes'
    boxes (and an anchor mask over half the map)."""
    jb, tb = bundles
    fmap = tb.feature_map_size
    ret = tb.target_assigner.generate_anchors(fmap)
    jret = jb.target_assigner.generate_anchors(jb.feature_map_size)
    for k in ret:
        assert_same(ret[k], jret[k], k)
    anchors = ret["anchors"].reshape(-1, 7).astype(np.float32)
    assert anchors.shape[0] == 32000
    mask = (anchors[:, 0] < 8.0) if masked else None
    n_pos = 0
    for sd in training_scenes:
        gt = np.asarray(sd["annotations"]["boxes"], np.float32)
        names = list(sd["annotations"]["names"])
        classes = np.array([tb.target_assigner.classes.index(n) + 1
                            for n in names], np.int32)
        kw = dict(anchors_mask=mask, gt_classes=classes,
                  matched_thresholds=ret["matched_thresholds"],
                  unmatched_thresholds=ret["unmatched_thresholds"])
        got = tb.target_assigner.assign(anchors, gt, **kw)
        want = jb.target_assigner.assign(anchors, gt, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], k)
        n_pos += int((got["labels"] > 0).sum())
        # the free function with the coder and similarity passed in
        ct = target_assign.create_targets(
            anchors, gt, tb.target_assigner.region_similarity_calculator
            .compare, tb.target_assigner.box_coder.encode,
            gt_classes=classes, anchor_mask=mask)
        cw = jax_target_assign.create_targets(
            anchors, gt, jb.target_assigner.region_similarity_calculator
            .compare, jb.target_assigner.box_coder.encode,
            gt_classes=classes, anchor_mask=mask)
        for k in cw:
            assert_same(ct[k], cw[k], k)
    assert n_pos > 1000


AUGMENT_CASES = {
    "noise_per_object": lambda m, b, p, rng: m.noise_per_object(
        b, p, rotation_perturb=(-0.3, 0.3), center_noise_std=(0.5, 0.5, 0.1),
        rng=rng),
    "global_rotation": lambda m, b, p, rng: m.global_rotation(
        b, p, (-0.2, 0.2), rng=rng),
    "global_scaling": lambda m, b, p, rng: m.global_scaling(
        b, p, (0.97, 1.03), rng=rng),
    "random_flip": lambda m, b, p, rng: m.random_flip(
        b, p, flip_x=True, flip_y=True, rng=rng),
    "global_translate": lambda m, b, p, rng: m.global_translate(
        b, p, (0.2, 0.2, 0.05), rng=rng),
    # the scanner at the middle of the 16 m scene
    "frustum_dropout": lambda m, b, p, rng: (b, m.frustum_dropout(
        p - np.float32([8, 8, 0, 0]), 1.0, np.pi / 6,
        max_range_fraction=0.5, rng=rng)),
    "drop_points_in_gt": lambda m, b, p, rng: (b, m.drop_points_in_gt(
        p, b, 0.6, 5, rng=rng)),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", sorted(AUGMENT_CASES))
def test_augmentation_equals_reference(training_scenes, fn, seed):
    """Each function on a training scene from one seed: the boxes, points
    and draws equal the reference's, and the generator is left in the
    same state (the same rng calls in the same order)."""
    sd = training_scenes[seed]
    boxes = np.asarray(sd["annotations"]["boxes"], np.float32)
    points = np.asarray(sd["lidar"]["points"], np.float32)
    out = []
    for mod in (augment, jax_augment):
        rng = np.random.default_rng(seed)
        with numpy_reference():
            res = AUGMENT_CASES[fn](mod, boxes.copy(), points.copy(), rng)
        out.append((res, rng.random()))
    (got, got_next), (want, want_next) = out
    assert got_next == want_next
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, np.ndarray):
            assert_same(g, w, f"{fn} output {i}")
        else:
            assert g == w, f"{fn} output {i}"
    if fn in ("frustum_dropout", "drop_points_in_gt"):
        assert len(got[1]) < len(points)


def test_prep_pointcloud_training_equals_reference_full_width(
        bundles, training_scenes):
    """Every key of the training example of asbuilt_pillars (160 x 160
    pillars, 25 600 voxels, A = 32 000) on four training scenes, through
    each package's own reader (PrepConfig and anchor cache from the
    config)."""
    jb, tb = bundles
    jds, _ = jb.input_reader(training=True, seed=0)
    tds, _ = tb.input_reader(training=True, seed=0)
    for i in range(4):
        want = jds.example(i, 1000 + i)
        got = tds.example(i, 1000 + i)
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "metadata":
                assert got[k] == want[k]
            else:
                assert_same(got[k], want[k], k)
        assert got["voxels"].shape == (25600, 24, 4)
        assert got["labels"].shape == (32000,)
        assert (got["labels"] > 0).sum() > 100
        assert len(got["gt_boxes"]) == len(got["gt_names"]) > 0


def test_prep_pointcloud_training_with_every_augmentation(bundles,
                                                          training_scenes):
    """The training branch with the options the KITTI configs set (per-
    object noise, point drops, frustum dropout, translation, min points
    in gt, an anchor mask; the flips would carry this scene out of its
    [0, 16] m range and are held above): equal to the reference's numpy
    path."""
    jb, tb = bundles
    pp = dict(class_names=("wall", "column", "door"), max_voxels=25600,
              shuffle_points=True, gt_loc_noise_std=(0.25, 0.25, 0.1),
              gt_rotation_noise=(-0.1, 0.1),
              global_translate_noise_std=(0.2, 0.2, 0.05),
              min_points_in_gt=5, gt_points_drop_percentage=0.3,
              gt_drop_max_keep_points=20, frustum_dropout_prob=1.0,
              anchor_area_threshold=1.0, symmetric_yaw=True)
    fmap = tb.feature_map_size
    for i, sd in enumerate(training_scenes[:2]):
        with numpy_reference():
            want = jax_preprocess.prep_pointcloud(
                sd, jb.voxel_generator, jb.target_assigner,
                jax_preprocess.PrepConfig(**pp), training=True,
                rng=np.random.default_rng(i), feature_map_size=fmap)
        got = preprocess.prep_pointcloud(
            sd, tb.voxel_generator, tb.target_assigner,
            preprocess.PrepConfig(**pp), training=True,
            rng=np.random.default_rng(i), feature_map_size=fmap)
        assert sorted(got) == sorted(want)
        for k in want:
            if k != "metadata":
                assert_same(got[k], want[k], k)
        assert len(got["gt_boxes"]) > 0 and (got["labels"] > 0).any()
        assert got["anchors_mask"].any() and (got["labels"] == -1).any()


def test_training_reader_first_batches_equal_reference(bundles):
    """The first three batches of the training reader (shuffled, seed 0,
    B = 2) against the reference's BatchLoader."""
    jb, tb = bundles
    _, jloader = jb.input_reader(training=True, seed=0)
    _, tloader = tb.input_reader(training=True, seed=0)   # two threads
    jit, tit = iter(jloader), iter(tloader)
    for n in range(3):
        want, got = next(jit), next(tit)
        assert sorted(got) == sorted(want)
        for k in want:
            if k in ("metadata", "gt_names", "gt_boxes"):
                assert len(got[k]) == len(want[k]) == 2
                for g, w in zip(got[k], want[k]):
                    if k == "metadata":
                        assert g == w
                    else:
                        assert_same(g, w, k)
            else:
                assert_same(got[k], want[k], k)
        assert got["voxels"].shape[0] == 2
