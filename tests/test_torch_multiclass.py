"""Port vs JAX package: multi-class KITTI (Car / Pedestrian / Cyclist) on
the CPU.

- the multi-class synthetic clone (``data/synth_kitti.py``,
  ``multiclass=True``) against ``tools/make_synth_kitti.py --multiclass``
  from the same seed: every file byte for byte, the offline prep's infos
  and the gt database with its Pedestrian and Cyclist objects included
  (the reference on its numpy path, as ``tests/test_torch_kitti.py``
  runs it);
- ``second/all.fhd.config``'s gt-database sampler (three sample groups:
  Car 11, Pedestrian 6, Cyclist 6) through ``sample_all``, and the first
  training examples of the sequential loader at full width, bit for bit
  (the pooled loaders' draws depend on worker order, in the reference
  too);
- one training step of a micro twin of ``all.fhd.config`` (cut as
  ``tests/test_torch_second_train.py`` cuts ``car.fhd.config``: 0.4 m
  voxels in xy, 3 000 voxels, B = 2; the three classes' anchors, the
  sampler and the augmentation kept) against the JAX package's exact XLA
  mode, at that file's tolerances: loss terms rtol 1e-4; gradients rtol
  1e-3, atol 5e-3 * max|g| of the tensor; parameters after the update
  and BatchNorm statistics rtol 1e-5, atol 1e-7, an element whose two
  gradients differ by more than 1e-3 of themselves or lie within 1e-4 *
  max|g| of zero excused up to 2 * lr; and the port's float64 step
  against the JAX package's key-match step (the port's mode: its Pallas
  kernels in interpret mode) run in float64 (its modules' float32 read as
  float64 inside the test): loss terms rtol 1e-10, gradients rtol 1e-10,
  atol 1e-10 * max|g| of the tensor (they agree to 6e-14 of max|g|).
  Not against its key-match step in float32: on this batch float32
  rounding flips ReLUs there, and that step lies up to 8.7e-3 of max|g|
  from its own float64 step and from its exact mode, while the exact
  mode and the port's float32 step lie within 4.2e-5 and 3.4e-5 of the
  float64 steps;
- the three-class KITTI table (``get_official_eval_result`` over Car,
  Pedestrian and Cyclist, and ``KittiDataset.evaluation``'s lidar-to-
  camera conversion) on perturbed ground truth and on the detections of
  a micro twin of ``pointpillars/all/xyres_16.config`` (cut as
  ``tests/test_torch_kitti_pillars.py`` cuts the car config, and to 200
  boxes a class before NMS and 20 after): equal to the
  reference's Python statistics bit for bit (so to 6 decimals), and within
  1e-4 AP points of its C++ statistics.
"""
import functools
import importlib.util
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automatic_as_built_reconstruction_tpu.builder import (
    config_io as jax_config_io, dbsampler_builder as jax_dbsampler_builder,
    optimizer_builder as jax_optimizer_builder)
from automatic_as_built_reconstruction_tpu.data import (
    batching as jax_batching, kitti_dataset as jax_kitti_dataset)
from automatic_as_built_reconstruction_tpu.models import (
    losses as jax_losses, middle as jax_middle, rpn as jax_rpn,
    voxel_encoder as jax_voxel_encoder, voxelnet as jax_voxelnet)
from automatic_as_built_reconstruction_tpu.ops import (
    sparse_conv as jax_sparse_conv)
from automatic_as_built_reconstruction_tpu.ops.pallas import (
    sparse_gather_gemm as jax_pallas_sgg)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.utils import (
    eval as jax_eval, weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu_torch.builder import (
    config_io, dbsampler_builder)
from automatic_as_built_reconstruction_tpu_torch.data import (
    batching, kitti_common, kitti_dataset, synth_kitti)
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet
from automatic_as_built_reconstruction_tpu_torch.train import train
from automatic_as_built_reconstruction_tpu_torch.utils import (
    eval as eval_mod, weight_import)

from test_torch_kitti import assert_same_tree, kitti_config
from test_torch_kitti_pillars import _Float64Numpy
from test_torch_second_train import recorded_step
from test_torch_train_data import assert_same, numpy_reference

REPO = Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "make_synth_kitti.py"
PORT_CONFIGS = REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
ALL_FHD = PORT_CONFIGS / "second" / "all.fhd.config"
PP_ALL = PORT_CONFIGS / "pointpillars" / "all" / "xyres_16.config"
CLASSES = ["Car", "Pedestrian", "Cyclist"]
NUM_TRAIN, NUM_VAL = 6, 3
TOTAL_STEPS = 40
LOSS_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
G_NOISE, G_AGREE = 1e-4, 1e-3
GRAD_SHARE = 5e-3
F64_LOSS_TOL = dict(rtol=1e-10, atol=0)
F64_GRAD_SHARE = 1e-10
# the JAX modules of the key-match step whose ``jnp.float32`` the float64
# step reads as float64
F64_MODULES = [jax_voxelnet, jax_middle, jax_rpn, jax_voxel_encoder,
               jax_losses, jax_sparse_conv, jax_pallas_sgg]
NATIVE_AP_ATOL = 1e-4


@pytest.fixture(scope="module")
def clones(tmp_path_factory):
    """The multi-class clone written by the tool (``ref``) and by the
    port (``port``), each with its package's offline prep."""
    tmp = tmp_path_factory.mktemp("kitti_mc")
    spec = importlib.util.spec_from_file_location("make_synth_kitti", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    argv = sys.argv
    sys.argv = ["make_synth_kitti.py", "--root", str(tmp / "ref"),
                "--num_train", str(NUM_TRAIN), "--num_val", str(NUM_VAL),
                "--seed", "0", "--multiclass"]
    try:
        with numpy_reference():
            tool.main()
    finally:
        sys.argv = argv
    synth_kitti.write_clone(tmp / "port", NUM_TRAIN, NUM_VAL, seed=0,
                            multiclass=True)
    return tmp / "ref", tmp / "port", tmp


def test_multiclass_clone_equals_the_tool_byte_for_byte(clones):
    ref, port, _ = clones
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(port) for p in port.rglob("*")
                           if p.is_file())
    for rel in files:
        if rel.suffix == ".pkl":
            with open(ref / rel, "rb") as f, open(port / rel, "rb") as g:
                assert_same_tree(pickle.load(g), pickle.load(f), str(rel))
        else:
            assert (port / rel).read_bytes() == (ref / rel).read_bytes(), rel
    with open(port / "kitti_dbinfos_train.pkl", "rb") as f:
        db = pickle.load(f)
    assert all(len(db[c]) > 0 for c in CLASSES), {k: len(v)
                                                 for k, v in db.items()}
    for c in ("Pedestrian", "Cyclist"):
        for info in db[c]:
            assert info["name"] == c
            assert (port / info["path"]).stat().st_size \
                == 16 * info["num_points_in_gt"], info["path"]


def _all_fhd_sampler_pair(ref, port, tmp):
    text = ALL_FHD.read_text()
    jcfg = jax_config_io.load_config(kitti_config(text, ref, tmp,
                                                  "ref_all.cfg"))
    tcfg = config_io.load_config(kitti_config(text, port, tmp,
                                              "port_all.cfg"))
    want = jax_dbsampler_builder.build(
        jcfg.train_input_reader.preprocess.database_sampler,
        rng=np.random.default_rng(0))
    got = dbsampler_builder.build(
        tcfg["train_input_reader"]["preprocess"]["database_sampler"],
        rng=np.random.default_rng(0))
    return got, want


def test_all_fhd_sampler_draws_the_three_groups_as_the_reference(clones):
    """sample_all on every training scene twice over, bit for bit; each of
    the three groups draws."""
    ref, port, tmp = clones
    with numpy_reference():
        got, want = _all_fhd_sampler_pair(ref, port, tmp)
        ds = kitti_dataset.KittiDataset(port, port / "kitti_infos_train.pkl",
                                        CLASSES)
        names = []
        for _ in range(2):
            for i in range(len(ds)):
                ann = ds.get_sensor_data(i)["annotations"]
                g = got.sample_all(ann["boxes"], ann["names"])
                w = want.sample_all(ann["boxes"], ann["names"])
                assert (g is None) == (w is None)
                if w is not None:
                    assert_same_tree(g, w, f"scene {i}")
                    names += list(w["gt_names"])
    assert set(names) == set(CLASSES), sorted(set(names))


def test_all_fhd_first_training_examples_equal_reference(clones):
    """The first two training examples of all.fhd.config at full width
    (17 000 voxels, three classes' anchors, the sampler, the
    augmentation), in the sequential loader's stream order, bit for bit
    (the reference as it runs: its voxelizer, which the port follows, is
    its C++ one)."""
    ref, port, tmp = clones
    text = ALL_FHD.read_text()
    jds, jloader = jax_train.Bundle(kitti_config(
        text, ref, tmp, "ref_all_ex.cfg")).input_reader(training=True)
    tds, tloader = train.Bundle(kitti_config(
        text, port, tmp, "port_all_ex.cfg")).input_reader(training=True)
    stream, jstream = tloader._index_stream(), jloader._index_stream()
    labels = set()
    for _ in range(2):
        idx, seed = next(stream)
        assert next(jstream) == (idx, seed)
        got, want = tds.example(idx, seed), jds.example(idx, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            if k in ("metadata", "calib"):
                assert_same_tree(got[k], want[k])
            else:
                assert_same(got[k], want[k], k)
        labels |= set(np.unique(got["labels"]).tolist())
    assert got["anchors"].shape == (3 * 200 * 176 * 2, 7)
    assert labels >= {0, 1}, labels


# --------------------------------------------------------------------------
# all.fhd: one training step of a micro twin
# --------------------------------------------------------------------------

ALL_FHD_MICRO = {
    "voxel_size: [0.05, 0.05, 0.1]": "voxel_size: [0.4, 0.4, 0.1]",
    "batch_size: 6": "batch_size: 2",
    "max_number_of_voxels: 17000": "max_number_of_voxels: 3000",
    "max_number_of_voxels: 40000": "max_number_of_voxels: 3000",
    "nms_score_threshold: 0.3": "nms_score_threshold: 0.05",
}


@pytest.fixture(scope="module")
def all_micro_cfg(clones):
    _, port, tmp = clones
    path = kitti_config(ALL_FHD.read_text(), port, tmp,
                        "all.fhd.micro.config", **ALL_FHD_MICRO)
    exact = tmp / "all.fhd.micro.exact.config"
    exact.write_text(path.read_text().replace(
        "use_pallas_sparse_gemm: true", "use_pallas_sparse_gemm: false"))
    return path, exact


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def reference(all_micro_cfg):
    """The JAX package on the micro twin in its exact XLA mode: initial
    variables, the first training batch (two examples of its reader in
    stream order), the loss terms and gradients of one forward in train
    mode, and the state after one step."""
    port_cfg, jax_cfg = all_micro_cfg
    prep_ds, loader = train.Bundle(port_cfg).input_reader(training=True)
    stream = loader._index_stream()
    batch = batching.merge_batch(
        [prep_ds.example(*next(stream)) for _ in range(2)])
    bundle = jax_train.Bundle(jax_cfg)
    model, cfg = bundle.model, bundle.model_cfg
    assert cfg.num_class == 3
    init = _np_tree(jax.jit(functools.partial(model.init, train=True))(
        jax.random.key(0), np.zeros((1, 64, 5, 4), np.float32),
        np.zeros((1, 64), np.int32), np.full((1, 64, 3), -1, np.int32)))
    tx = jax_optimizer_builder.build(bundle.config.train_config.optimizer,
                                     TOTAL_STEPS)
    example = jax_train._to_device(jax_batching.device_example(batch))

    @jax.jit
    def grads_fn(params, batch_stats, example):
        def loss_fn(p):
            preds, mut = model.apply(
                {"params": p, "batch_stats": batch_stats},
                example["voxels"], example["num_points"],
                example["coordinates"], train=True, mutable=["batch_stats"])
            loss, metrics = jax_voxelnet.compute_loss(preds, example, cfg)
            return loss, (metrics, mut["batch_stats"])
        return jax.grad(loss_fn, has_aux=True)(params)

    @jax.jit
    def update(grads, params):
        clipped = jax_train.clip_by_global_norm(grads, 10.0)
        updates, _ = tx.update(clipped, tx.init(params), params)
        return optax.apply_updates(params, updates)

    grads, (terms, new_bs) = grads_fn(init["params"], init["batch_stats"],
                                      example)
    after_one = _np_tree({"params": update(grads, init["params"]),
                          "batch_stats": new_bs})
    return {"init": init, "batch": batch, "grads": _np_tree(grads),
            "terms": {k: float(v) for k, v in terms.items()},
            "after_one": after_one}


def test_one_all_fhd_train_step_matches_jax(all_micro_cfg, reference):
    """Loss terms, every gradient, then every parameter and BatchNorm
    statistic after one make_train_step (key-match mode, three
    classes).  The terms and gradients are the step's own, before its
    clip (``recorded_step``)."""
    batch = reference["batch"]
    assert {1, 2, 3} & set(np.unique(batch["labels"]).tolist())
    bundle = train.Bundle(all_micro_cfg[0])
    assert bundle.model_cfg.num_class == 3
    state = train.init_state(bundle, total_steps=TOTAL_STEPS, device="cpu")
    weight_import.load_variables(state.model, reference["init"])
    example = train.to_device(batch, "cpu")
    metrics, terms, port_grads = recorded_step(bundle, state, example)
    for k, want in reference["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), want,
                                   **LOSS_TOL, err_msg=k)
    grads = jax_weight_import.to_torch_state_dict(
        {"params": reference["grads"],
         "batch_stats": reference["init"]["batch_stats"]})
    worst = 0.0
    for name, got in port_grads.items():
        want = grads[name]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=GRAD_SHARE * scale, err_msg=name)
        worst = max(worst, float(np.abs(got - want).max()) / scale)

    np.testing.assert_allclose(float(metrics["loss"]),
                               reference["terms"]["loss"], **LOSS_TOL)
    assert int(metrics["mid_capacity_saturated"]) == 0
    want = jax_weight_import.to_torch_state_dict(reference["after_one"])
    got = state.model.state_dict()
    excused = 0
    for name, w in want.items():
        g = got[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, **PARAM_TOL, err_msg=name)
            continue
        gj = grads[name]
        noise = ((np.abs(port_grads[name] - gj) > G_AGREE * np.abs(gj))
                 | (np.abs(gj) < G_NOISE * np.abs(gj).max()))
        excused += int((noise & ~np.isclose(g, w, **PARAM_TOL)).sum())
        np.testing.assert_allclose(g[~noise], w[~noise], **PARAM_TOL,
                                   err_msg=name)
        assert np.abs(g - w).max() <= 2 * state.schedule(0) * 1.01, name
    print(f"all.fhd micro step: gradients within {worst:.3g} of max|g|; "
          f"{excused} parameter elements excused")


@pytest.fixture(scope="module")
def keymatch_reference64(all_micro_cfg, reference):
    """The JAX package's loss terms and gradients of the same batch from
    the same variables in its key-match mode (the port's mode; its Pallas
    kernels in interpret mode), float64 throughout."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for module in F64_MODULES:
            mp.setattr(module, "jnp", _Float64Numpy())
        bundle = jax_train.Bundle(all_micro_cfg[0])
        model, cfg = bundle.model, bundle.model_cfg
        assert cfg.sparse_keymatch and cfg.sparse_use_pallas_gemm
        assert cfg.num_class == 3

        def f64(x):
            x = np.asarray(x)
            return jnp.asarray(x, jnp.float64 if x.dtype == np.float32
                               else x.dtype)

        variables = jax.tree_util.tree_map(f64, reference["init"])
        example = {k: f64(v) for k, v in jax_batching.device_example(
            reference["batch"]).items()}

        def loss_fn(p):
            preds, _ = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                example["voxels"], example["num_points"],
                example["coordinates"], train=True, mutable=["batch_stats"])
            return jax_voxelnet.compute_loss(preds, example, cfg)

        grads, terms = jax.jit(jax.grad(loss_fn, has_aux=True))(
            variables["params"])
        grads = _np_tree(grads)
        terms = {k: float(v) for k, v in terms.items()}
    assert all(g.dtype == np.float64
               for g in jax.tree_util.tree_leaves(grads))
    return {"grads": grads, "terms": terms}


def test_float64_all_fhd_train_step_matches_jax_keymatch(
        all_micro_cfg, reference, keymatch_reference64):
    """The port's all.fhd step in float64 (the plain joins, float64
    throughout) against the JAX package's key-match step in float64: loss
    terms and every gradient, the three-class head's included."""
    bundle = train.Bundle(all_micro_cfg[0])
    weight_import.load_variables(bundle.model, reference["init"])
    model = bundle.model.to(torch.float64).train()
    example = {k: v.double() if v.is_floating_point() else v
               for k, v in train.to_device(reference["batch"],
                                           "cpu").items()}
    preds = model(example["voxels"], example["num_points"],
                  example["coordinates"])
    loss, terms = voxelnet.compute_loss(preds, example, bundle.model_cfg)
    for k, want in keymatch_reference64["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), want,
                                   **F64_LOSS_TOL, err_msg=k)
    loss.backward()
    grads = jax_weight_import.to_torch_state_dict(
        {"params": keymatch_reference64["grads"],
         "batch_stats": reference["init"]["batch_stats"]})
    worst = {}
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float64, name
        want = grads[name]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   rtol=F64_GRAD_SHARE,
                                   atol=F64_GRAD_SHARE * scale,
                                   err_msg=name)
        worst[name] = float(np.abs(p.grad.numpy() - want).max()) / scale
    head = {n: e for n, e in worst.items() if n.startswith("rpn.conv_cls")}
    assert head, sorted(worst)
    terms_err = max(abs(float(terms[k].detach()) - v) / abs(v)
                    for k, v in keymatch_reference64["terms"].items())
    print(f"all.fhd float64 step vs the JAX key-match step: gradients "
          f"within {max(worst.values()):.3g} of max|g| (class head "
          f"{max(head.values()):.3g}), loss terms within {terms_err:.3g}")


# --------------------------------------------------------------------------
# the three-class KITTI protocol
# --------------------------------------------------------------------------

def _perturbed(annos, rng):
    """Detections near the ground truth of every class, some missed, some
    false, each false one of a random class."""
    out = []
    for a in annos:
        a = kitti_common.remove_dontcare(a)
        keep = rng.random(len(a["name"])) < 0.8
        n = int(keep.sum())
        nf = int(rng.integers(0, 3))
        m = n + nf
        loc = np.concatenate([a["location"][keep]
                              + rng.normal(0, 0.05, (n, 3)),
                              rng.uniform([-10, 1, 5], [10, 2, 50],
                                          (nf, 3))])
        dims = np.concatenate([a["dimensions"][keep]
                               * rng.uniform(0.95, 1.05, (n, 3)),
                               rng.uniform(0.5, 4, (nf, 3))])
        bbox = np.concatenate([
            a["bbox"][keep] + rng.normal(0, 3, (n, 4)),
            np.sort(rng.uniform(0, 600, (nf, 2, 2)), 1).reshape(nf, 4)])
        out.append({
            "name": np.concatenate([a["name"][keep],
                                    rng.choice(CLASSES, nf)]),
            "truncated": np.zeros(m), "occluded": np.zeros(m, np.int64),
            "alpha": rng.uniform(-np.pi, np.pi, m), "bbox": bbox,
            "dimensions": dims, "location": loc,
            "rotation_y": np.concatenate([
                a["rotation_y"][keep] + rng.normal(0, 0.05, n),
                rng.uniform(-np.pi, np.pi, nf)]),
            "score": rng.random(m)})
    return out


def _assert_tables_equal(gt, dt):
    got = eval_mod.get_official_eval_result(gt, dt, CLASSES)
    with numpy_reference():      # its Python statistics: the same bits
        want = jax_eval.get_official_eval_result(gt, dt, CLASSES)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    native = jax_eval.get_official_eval_result(gt, dt, CLASSES)
    for k in want:
        if k != "result_str":
            assert got[k] == pytest.approx(native[k], abs=NATIVE_AP_ATOL), k
    for c in CLASSES:
        assert f"{c} AP@" in got["result_str"], c
    return got


def test_three_class_table_on_perturbed_ground_truth(clones):
    ref, _, _ = clones
    # the training split: the validation split's one cyclist is hard
    with open(ref / "kitti_infos_train.pkl", "rb") as f:
        gt = [i["annos"] for i in pickle.load(f)]
    got = _assert_tables_equal(gt, _perturbed(gt, np.random.default_rng(4)))
    for c in CLASSES:
        assert 0 < got[f"{c}.bev.moderate"] <= 100, c


def test_three_class_table_on_a_micro_twin_detections(clones, tmp_path,
                                                      monkeypatch):
    """``evaluate`` of a micro twin of pointpillars/all/xyres_16.config
    (seeded weights) on the validation frames: its lidar detections go
    through each package's ``KittiDataset.evaluation`` (lidar-to-camera
    conversion, then the protocol), and both annotation lists through
    both protocols."""
    _, port, _ = clones
    cfg = kitti_config(PP_ALL.read_text(), port, tmp_path, "pp_all.config",
                       **{"voxel_size: [0.16, 0.16, 4.0]":
                          "voxel_size: [0.32, 0.32, 4.0]",
                          "strides: [0.32, 0.32, 0.0]":
                          "strides: [0.64, 0.64, 0.0]",
                          "offsets: [0.16, -39.52, -1.78]":
                          "offsets: [0.32, -39.36, -1.78]",
                          "offsets: [0.16, -39.52, -1.465]":
                          "offsets: [0.32, -39.36, -1.465]",
                          "max_number_of_voxels: 12000":
                          "max_number_of_voxels: 7200",
                          "num_filters: [64]\n": "num_filters: [16]\n",
                          "num_filters: [64, 128, 256]":
                          "num_filters: [16, 32, 64]",
                          "num_upsample_filters: [128, 128, 128]":
                          "num_upsample_filters: [32, 32, 32]",
                          "layer_nums: [3, 5, 5]": "layer_nums: [1, 2, 2]",
                          "nms_pre_max_size: 1000":
                          "nms_pre_max_size: 200",
                          "nms_post_max_size: 100":
                          "nms_post_max_size: 20"})
    seen = {}
    evaluation = kitti_dataset.KittiDataset.evaluation

    def recording(self, detections, output_dir=None):
        seen["detections"] = detections
        return evaluation(self, detections, output_dir=output_dir)

    monkeypatch.setattr(kitti_dataset.KittiDataset, "evaluation", recording)
    got = train.evaluate(cfg, None, device="cpu")
    dets = seen["detections"]
    assert len(dets) == NUM_VAL and sum(len(d["scores"]) for d in dets)
    assert set(np.concatenate([d["label_preds"] for d in dets])) \
        == {0, 1, 2}
    jds = jax_kitti_dataset.KittiDataset(port, port / "kitti_infos_val.pkl",
                                         CLASSES)
    with numpy_reference():
        want = jds.evaluation(dets)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    tds = kitti_dataset.KittiDataset(port, port / "kitti_infos_val.pkl",
                                     CLASSES)
    annos = tds.convert_detection_to_kitti_annos(dets)
    assert_same_tree(annos, jds.convert_detection_to_kitti_annos(dets))
    _assert_tables_equal(tds.ground_truth_annotations(), annos)
