"""Port vs JAX package: KITTI PointPillars training with bucketed static
shapes, on the CPU.

The micro twin of ``pointpillars/car/xyres_16.config`` keeps the config's
structure (the gt-database sampler, the augmentation, the anchor mask at
``anchor_area_threshold: 1.0``, RPNV2 with upsample strides [1, 2, 4],
two anchors a cell) and is cut in the pillars' xy size (0.32 m for 0.16
m: a 248 x 216 canvas, 26 784 anchors), in the widths (PFN 16, RPN
16/32/64, upsample 32), in the RPN's depth (1/2/2 layers), in the voxel
capacity (7 200; buckets 6 200 and 6 800, the builder appends 7 200) and
in the loader (one worker: the sampler's single generator makes pooled
batches depend on worker order, in the reference too).  Its data is a
synthetic KITTI clone of the port's generator (6 + 2 frames, seed 0).

Tolerances:
- ``pick_bucket``, ``shrink_to_bucket``, the bucketed batches and the
  training examples: bit for bit, the bucket each batch takes included;
- one bucketed training step: loss terms rtol 1e-4; gradients rtol 1e-3,
  atol 1e-5 * max|g| of the tensor; parameters after the update and
  BatchNorm statistics rtol 1e-5, atol 1e-7, as the pillar step of
  ``tests/test_torch_train.py`` holds them.  On this batch the JAX
  package's float32 gradients lie up to 1.2e-2 of max|g| from its own
  float64 step in the RPN's first two blocks and the PFN (XLA's float32
  arithmetic on the CPU), while the port's float32 gradients lie 5e-6
  from float64: the gradients are held to the JAX package's step run in
  float64 (its modules' compute dtype switched inside the test), which
  the port's float64 step meets to 1e-13.  The update is held to the JAX
  package's float32 step; an element whose two float32 gradients differ
  by more than 1e-3 of themselves, or lie within 1e-4 * max|g| of zero,
  may take Adam's first step the other way (bounded by 2 * lr), as
  ``tests/test_torch_second_train.py`` holds it.  The PFN's BatchNorm is
  unmasked in both packages, so its statistics count the bucket's padded
  rows: the step is held against the JAX package's step at the same
  bucket, never at full capacity;
- the config copies: the same text and the same parse.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.builder import (
    config_io as jax_config_io)
from automatic_as_built_reconstruction_tpu.data import (
    batching as jax_batching)
from automatic_as_built_reconstruction_tpu.models import (
    voxelnet as jax_voxelnet)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.utils import (
    weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu_torch import cli
from automatic_as_built_reconstruction_tpu_torch.builder import config_io
from automatic_as_built_reconstruction_tpu_torch.data import (
    batching, synth_kitti)
from automatic_as_built_reconstruction_tpu_torch.train import (
    input_pipeline, train)
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

from test_torch_config_anchors import _compare
from test_torch_kitti import kitti_config
from test_torch_second_train import recorded_step
from test_torch_train_data import assert_same

REPO = Path(__file__).resolve().parents[1]
JAX_CONFIGS = REPO / "automatic_as_built_reconstruction_tpu" / "configs"
PORT_CONFIGS = REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
PP_CAR = PORT_CONFIGS / "pointpillars" / "car" / "xyres_16.config"
COPIES = ["pointpillars/car/xyres_16.config",
          "pointpillars/car/xyres_20.config",
          "pointpillars/ped_cycle/xyres_16.config",
          "pointpillars/all/xyres_16.config",
          "second/all.fhd.config"]
MICRO = {
    "voxel_size: [0.16, 0.16, 4.0]": "voxel_size: [0.32, 0.32, 4.0]",
    "strides: [0.32, 0.32, 0.0]": "strides: [0.64, 0.64, 0.0]",
    "offsets: [0.16, -39.52, -1.78]": "offsets: [0.32, -39.36, -1.78]",
    "max_number_of_voxels: 12000": "max_number_of_voxels: 7200",
    "static_shape_buckets: [4000, 8000, 12000]":
        "static_shape_buckets: [6200, 6800]",
    "num_filters: [64]\n": "num_filters: [16]\n",
    "num_filters: [64, 128, 256]": "num_filters: [16, 32, 64]",
    "num_upsample_filters: [128, 128, 128]":
        "num_upsample_filters: [32, 32, 32]",
    "layer_nums: [3, 5, 5]": "layer_nums: [1, 2, 2]",
    "num_workers: 2": "num_workers: 1",
}
BUCKETS = (6200, 6800, 7200)
TOTAL_STEPS = 40
LOSS_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
G_NOISE, G_AGREE = 1e-4, 1e-3


@pytest.fixture(scope="module")
def clone(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_kitti")
    synth_kitti.write_clone(tmp / "clone", 6, 2, seed=0)
    return tmp / "clone", tmp


@pytest.fixture(scope="module")
def micro_cfg(clone):
    root, tmp = clone
    return kitti_config(PP_CAR.read_text(), root, tmp, "pp_micro.config",
                        **MICRO)


@pytest.mark.parametrize("rel", COPIES)
def test_config_copies_parse_to_the_reference(rel):
    """The port's copy has the reference's text, and the port's reader
    gives what protobuf gives for it."""
    port, ref = PORT_CONFIGS / rel, JAX_CONFIGS / rel
    assert port.read_text() == ref.read_text()
    parsed = config_io.load_config(port)
    _compare(jax_config_io.load_config(ref), parsed)
    assert parsed == config_io.load_config(ref)


def test_pick_bucket_and_shrink_to_bucket_equal_reference():
    rng = np.random.default_rng(0)
    buckets = (4000, 8000, 12000)
    for nv in (0, 1, 3999, 4000, 4001, 7999, 8000, 11999, 12000, 12001,
               50000):
        assert batching.pick_bucket(nv, buckets) == \
            jax_batching.pick_bucket(nv, buckets) == \
            next((b for b in buckets if nv <= b), 12000)
    for nv, bucket in ((2500, 4000), (4000, 4000), (9000, 8000),
                       (12000, 12000)):
        ex = {"voxels": rng.normal(size=(12000, 5, 4)).astype(np.float32),
              "num_points": rng.integers(0, 6, 12000).astype(np.int32),
              "coordinates": rng.integers(-1, 400, (12000, 3)).astype(
                  np.int32),
              "num_voxels": np.asarray(nv, np.int32),
              "anchors": rng.normal(size=(64, 7)).astype(np.float32),
              "anchors_mask": rng.random(64) < 0.5}
        got = batching.shrink_to_bucket(ex, bucket)
        want = jax_batching.shrink_to_bucket(ex, bucket)
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k], f"{k} at {nv} -> {bucket}")
        assert got["voxels"].shape[0] == bucket
        assert int(got["num_voxels"]) == min(nv, bucket)
        assert got["anchors"] is ex["anchors"]


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def test_bucketed_batches_equal_reference(micro_cfg, capsys):
    """The training reader of the micro twin (the sampler and the
    augmentation on): the first four batches of each package equal bit
    for bit, and at least two buckets are hit."""
    _, loader = train.Bundle(micro_cfg).input_reader(training=True)
    _, jloader = jax_train.Bundle(micro_cfg).input_reader(training=True)
    out = capsys.readouterr().out
    assert out.count("appending 7200") == 2, out
    assert loader._buckets == jloader._buckets == BUCKETS
    got, want = _batches(loader, 4), _batches(jloader, 4)
    shapes = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        V = w["voxels"].shape[1]
        assert V == batching.pick_bucket(int(w["num_voxels"].max()),
                                         BUCKETS)
        shapes.append(V)
        for k in w:
            if k in ("metadata", "calib", "gt_boxes", "gt_names"):
                continue
            assert_same(g[k], w[k], f"batch {i} {k}")
        for k in ("gt_boxes", "gt_names"):
            for a, b in zip(g[k], w[k]):
                assert_same(a, b, f"batch {i} {k}")
    assert len(set(shapes)) >= 2, shapes
    print(f"buckets of the first four batches: {shapes}")


def test_pools_bucket_as_the_sequential_loader(clone, tmp_path):
    """Without the sampler the thread and process pools give the
    sequential loader's bucketed batches, shapes included."""
    root, _ = clone
    text = PP_CAR.read_text()
    a = text.index("    database_sampler {")
    b = text.index("      rate: 1.0\n    }\n", a) + len("      rate: 1.0\n"
                                                      "    }\n")
    text = text[:a] + text[b:]
    batches = {}
    for name, pool in (("sequential", "num_workers: 1"),
                       ("threads", "num_workers: 3"),
                       ("processes", "num_workers: 2\n  process_workers: "
                                     "true")):
        cfg = kitti_config(text, root, tmp_path, f"{name}.config",
                           **{**MICRO, "num_workers: 2": pool})
        _, loader = train.Bundle(cfg).input_reader(training=True)
        batches[name] = _batches(loader, 3)
    shapes = [b["voxels"].shape[1] for b in batches["sequential"]]
    assert set(shapes) <= set(BUCKETS)
    for name in ("threads", "processes"):
        for got, want in zip(batches[name], batches["sequential"]):
            for k in ("voxels", "num_points", "coordinates", "num_voxels",
                      "anchors_mask", "labels", "reg_targets"):
                assert_same(got[k], want[k], f"{name} {k}")


def test_loader_refuses_bucket_plans():
    """``bucket_plans`` were refused until the port had them (host
    rulebooks padded to a bucket's plan, ``tests/test_torch_sparse_
    builders.py``); a batch without host rulebooks is shrunk to its
    bucket as without them."""
    loader = input_pipeline.BatchLoader(None, 2, False, buckets=(4, 8),
                                        bucket_plans={4: [], 8: []})
    ex = {"voxels": np.zeros((8, 3, 4), np.float32),
          "num_points": np.zeros((8,), np.int32),
          "coordinates": np.full((8, 3), -1, np.int32),
          "num_voxels": np.asarray(3, np.int32)}
    batch = loader._merge([ex, dict(ex)])
    assert batch["voxels"].shape == (2, 4, 3, 4)
    assert batch["coordinates"].shape == (2, 4, 3)


def test_full_width_training_examples_equal_reference(clone, tmp_path):
    """pointpillars/car/xyres_16.config at full width (12 000 pillars of
    100 points, 107 136 anchors, the anchor mask, the sampler, the
    augmentation): the first two training examples in stream order and
    the first eval example, bit for bit."""
    root, _ = clone
    cfg = kitti_config(PP_CAR.read_text(), root, tmp_path, "pp.config")
    bundle, jbundle = train.Bundle(cfg), jax_train.Bundle(cfg)
    for training, n in ((True, 2), (False, 1)):
        tds, tloader = bundle.input_reader(training=training)
        jds, jloader = jbundle.input_reader(training=training)
        stream, jstream = tloader._index_stream(), jloader._index_stream()
        for _ in range(n):
            idx, seed = next(stream)
            assert next(jstream) == (idx, seed)
            got, want = tds.example(idx, seed), jds.example(idx, seed)
            assert sorted(got) == sorted(want)
            for k in want:
                if k not in ("metadata", "calib"):
                    assert_same(got[k], want[k], f"{training} {k}")
            assert got["anchors"].shape == (107136, 7)
            mask = got["anchors_mask"]
            assert mask.dtype == bool and 0 < mask.sum() < mask.size
            if training:
                assert (got["labels"] > 0).sum() > 0
                n_own = len(tds.dataset.get_sensor_data(idx)[
                    "annotations"]["boxes"])
                assert len(got["gt_boxes"]) > n_own   # the sampler pasted


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def reference(micro_cfg):
    """The JAX package's first training batch of the micro twin that sits
    below full capacity, the loss terms and gradients of one forward in
    train mode from its initial variables, and the state after one of its
    train steps."""
    bundle = jax_train.Bundle(micro_cfg)
    _, loader = bundle.input_reader(training=True, seed=0)
    batch = next(b for b in _batches(loader, 4)
                 if b["voxels"].shape[1] < BUCKETS[-1])
    state, tx = jax_train.init_state(bundle, rng_seed=0,
                                     total_steps=TOTAL_STEPS)
    init = _np_tree({"params": state["params"],
                     "batch_stats": state["batch_stats"]})
    example = jax_train._to_device(jax_batching.device_example(batch))
    model, cfg = bundle.model, bundle.model_cfg

    @jax.jit
    def grads_fn(params, batch_stats, example):
        def loss_fn(p):
            preds, _ = model.apply(
                {"params": p, "batch_stats": batch_stats},
                example["voxels"], example["num_points"],
                example["coordinates"], train=True, mutable=["batch_stats"])
            return jax_voxelnet.compute_loss(preds, example, cfg)
        return jax.grad(loss_fn, has_aux=True)(params)

    grads, terms = grads_fn(state["params"], state["batch_stats"], example)
    state, metrics = jax_train.make_train_step(bundle, tx)(state, example)
    return {"init": init, "batch": batch, "grads": _np_tree(grads),
            "grads64": _float64_grads(micro_cfg, init, batch),
            "terms": {k: float(v) for k, v in terms.items()},
            "loss": float(metrics["loss"]),
            "after_one": _np_tree({"params": state["params"],
                                   "batch_stats": state["batch_stats"]})}


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX
    VoxelNet builds its modules with ``dtype=jnp.float32``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _float64_grads(micro_cfg, init, batch):
    """Gradients of the JAX package's training forward computed in
    float64 throughout, from the same variables and batch."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_voxelnet, "jnp", _Float64Numpy())
        bundle = jax_train.Bundle(micro_cfg)
        model, cfg = bundle.model, bundle.model_cfg

        def f64(x):
            x = np.asarray(x)
            return jnp.asarray(x, jnp.float64 if x.dtype == np.float32
                               else x.dtype)

        variables = jax.tree_util.tree_map(f64, init)
        example = {k: f64(v) for k, v in
                   jax_batching.device_example(batch).items()}

        def loss_fn(p):
            preds, _ = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                example["voxels"], example["num_points"],
                example["coordinates"], train=True, mutable=["batch_stats"])
            return jax_voxelnet.compute_loss(preds, example, cfg)[0]

        grads = jax.jit(jax.grad(loss_fn))(variables["params"])
        grads = _np_tree(grads)
    assert all(g.dtype == np.float64
               for g in jax.tree_util.tree_leaves(grads))
    return grads


def test_one_bucketed_train_step_matches_jax(micro_cfg, reference):
    """At the batch's bucket: loss terms and every gradient of the
    forward of one make_train_step of the port (before its clip:
    ``recorded_step``), then every parameter and BatchNorm statistic
    after it."""
    batch = reference["batch"]
    assert batch["voxels"].shape[1] in BUCKETS[:-1]
    assert not batch["anchors_mask"].all()
    bundle = train.Bundle(micro_cfg)
    state = train.init_state(bundle, total_steps=TOTAL_STEPS, device="cpu")
    weight_import.load_variables(state.model, reference["init"])
    example = train.to_device(batch, "cpu")
    metrics, terms, port_grads = recorded_step(bundle, state, example)
    for k, want in reference["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), want,
                                   **LOSS_TOL, err_msg=k)
    stats = reference["init"]["batch_stats"]
    grads = jax_weight_import.to_torch_state_dict(
        {"params": reference["grads"], "batch_stats": stats})
    grads64 = jax_weight_import.to_torch_state_dict(
        {"params": reference["grads64"], "batch_stats": stats})
    worst = {"port": 0.0, "jax": 0.0}
    for name, got in port_grads.items():
        want = grads64[name]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * scale,
                                   err_msg=name)
        worst["port"] = max(worst["port"],
                            float(np.abs(got - want).max()) / scale)
        worst["jax"] = max(worst["jax"],
                           float(np.abs(grads[name] - want).max()) / scale)
    print(f"float32 gradients against the JAX package's float64 step, "
          f"worst share of max|g|: {worst}")

    np.testing.assert_allclose(float(metrics["loss"]), reference["loss"],
                               **LOSS_TOL)
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
    print(f"bucket {batch['voxels'].shape[1]}: {excused} parameter "
          f"elements whose float32 gradients differ or are near zero "
          f"differ beyond {PARAM_TOL}")


def test_cli_help_lists_the_ported_verbs():
    proc = subprocess.run(
        [sys.executable, "-m", "automatic_as_built_reconstruction_tpu_torch"
         ".cli", "--help"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    for verb in ("train", "evaluate", "kitti_data_prep", "building_data_prep",
                 "export_asbuilt", "viewer"):
        assert verb in proc.stdout
    with pytest.raises(SystemExit):      # every verb is ported: no such verb
        cli.main(["no_such_verb", "--config_path", "x"])


def test_cli_prep_train_and_evaluate_on_the_cpu(tmp_path, capsys):
    """``kitti_data_prep`` on a fresh clone, then ``train`` (two bucketed
    steps, a resume) and ``evaluate`` of the micro twin with ``--device
    cpu``; without ``--device`` the verbs ask for the GPU."""
    root = tmp_path / "clone"
    synth_kitti.write_clone(root, 4, 2, seed=3, prep=False)
    cli.main(["kitti_data_prep", "--root_path", str(root)])
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_dbinfos_train.pkl"):
        assert (root / name).exists(), name
    cfg = kitti_config(PP_CAR.read_text(), root, tmp_path, "pp.config",
                       **MICRO)
    model_dir = tmp_path / "model"
    cli.main(["train", "--config_path", str(cfg), "--model_dir",
              str(model_dir), "--max_steps", "2", "--display_step", "1",
              "--device", "cpu"])
    cli.main(["train", "--config_path", str(cfg), "--model_dir",
              str(model_dir), "--max_steps", "3", "--display_step", "1",
              "--device", "cpu"])
    log = (model_dir / "log.txt").read_text()
    assert "resumed from checkpoint at step 2" in log
    assert "training finished at step 3" in log
    # each run's batches by bucket, in metrics.jsonl
    hists = [json.loads(line) for line in
             (model_dir / "metrics.jsonl").read_text().splitlines()
             if '"prefix": "batches_by_voxel_capacity"' in line]
    assert [h.pop("step") for h in hists] == [2, 3]
    for h, n in zip(hists, (2, 1)):
        del h["prefix"]
        assert set(map(int, h)) <= set(BUCKETS) and sum(h.values()) == n, h
    capsys.readouterr()
    cli.main(["evaluate", "--config_path", str(cfg), "--model_dir",
              str(model_dir), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "evaluating checkpoint at step 3" in out
    assert "Car AP@0.70" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(["evaluate", "--config_path", str(cfg), "--model_dir",
                      str(model_dir)])
