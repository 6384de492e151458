"""SECOND training and KITTI evaluation of the port, held to the JAX
package on a micro twin of ``car.fhd.config`` over a tiny synthetic KITTI
clone (the port's ``data/synth_kitti.py``: 6 training and 2 validation
frames from seed 0).

The twin keeps the config's SpMiddleFHD plan and widths (16/32, 64/64;
depth 41), RPN 128, key-match mode, the gt-database sampler and the
augmentation; it is cut in the voxels' xy size (0.4 m for 0.05 m, a 176 x
200 x 40 grid and 1 100 anchors), in ``max_number_of_voxels`` (3 000) and
in the batch (B = 2).  The port runs key-match mode.  For the step and
``evaluate`` the JAX package runs the same network in its exact XLA mode
(``use_pallas_sparse_gemm: false``: rulebooks merged on the device),
which compiles about five times faster on a CPU than its key-match
Pallas kernels in interpret mode; its key-match mode (Pallas in
interpret mode, ~45 s) gives the gradients that the port's float64 step
is held to.

Tolerances:
- loss terms of one step: rtol 1e-4;
- gradients: rtol 1e-3, atol 5e-3 * max|g| of the tensor.  On this batch
  float32 rounding moves single ReLU inputs (|x| ~ 2e-6) across zero in
  the RPN's last blocks, and a ReLU that flips moves those blocks'
  gradients, and through them the middle's, by up to 3.3e-3 of max|g|:
  the port's float32 step lies 3.3e-3 from its float64 step, the JAX
  package's exact mode 1.2e-3 from its own key-match mode, which agrees
  with the port's float64 step to 2.5e-5 (on a CPU);
- the port's float64 step against the JAX package's key-match float32
  step, where no ReLU flips: loss terms rtol 1e-5, gradients rtol 1e-4,
  atol 1e-4 * max|g| of the tensor;
- parameters after the update and BatchNorm statistics: rtol 1e-5, atol
  1e-7.  Adam's first step moves a parameter by about lr * g / |g|, so an
  element whose two gradients differ by more than 1e-3 of themselves, or
  lie within 1e-4 * max|g| of zero, may take another step (bounded by 2
  * lr), as ``chip_smoke.py`` holds the card's step;
- ``evaluate``: the JAX package's ``evaluate`` on the port's state dict
  after two steps gives the port's KITTI table, every AP within 1e-4
  points (detections decoded in float32 on each side).
"""
import functools
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from automatic_as_built_reconstruction_tpu.builder import (
    optimizer_builder as jax_optimizer_builder)
from automatic_as_built_reconstruction_tpu.models import (
    voxelnet as jax_voxelnet)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.data import (
    batching as jax_batching)
from automatic_as_built_reconstruction_tpu.utils import (
    weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu_torch.data import (
    batching, synth_kitti)
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet
from automatic_as_built_reconstruction_tpu_torch.ops import (
    sparse_gather_gemm as sgg)
from automatic_as_built_reconstruction_tpu_torch.train import train
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

REPO = Path(__file__).resolve().parents[1]
CAR_FHD = (REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
           / "second" / "car" / "car.fhd.config")
TOTAL_STEPS = 40
LOSS_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
G_NOISE, G_AGREE = 1e-4, 1e-3
F64_LOSS_TOL = dict(rtol=1e-5, atol=0)
F64_GRAD_SHARE = 1e-4
AP_ATOL = 1e-4


@pytest.fixture(scope="module")
def micro_cfg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("second")
    root = tmp / "clone"
    synth_kitti.write_clone(root, 6, 2, seed=0)
    text = CAR_FHD.read_text().replace('"data/kitti', f'"{root}')
    for old, new in [("voxel_size: [0.05, 0.05, 0.1]",
                      "voxel_size: [0.4, 0.4, 0.1]"),
                     ("batch_size: 6", "batch_size: 2"),
                     ("max_number_of_voxels: 17000",
                      "max_number_of_voxels: 3000"),
                     ("max_number_of_voxels: 40000",
                      "max_number_of_voxels: 3000"),
                     ("nms_score_threshold: 0.3",
                      "nms_score_threshold: 0.05")]:
        assert old in text, old
        text = text.replace(old, new)
    path = tmp / "car.fhd.micro.config"
    path.write_text(text)
    exact = tmp / "car.fhd.micro.exact.config"
    exact.write_text(text.replace("use_pallas_sparse_gemm: true",
                                  "use_pallas_sparse_gemm: false"))
    return path, exact


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def reference(micro_cfg):
    """The JAX package on the micro twin: initial variables, the first
    training batch (two examples of its reader in stream order), the loss
    terms, gradients and BatchNorm statistics of one forward in train
    mode, and the state after one step (its train step's clip and
    optimizer, applied to those gradients)."""
    port_cfg, jax_cfg = micro_cfg
    # the first two examples of the training reader in stream order (the
    # port's reader gives the reference's examples: test_torch_kitti.py)
    prep_ds, loader = train.Bundle(port_cfg).input_reader(training=True)
    stream = loader._index_stream()
    batch = batching.merge_batch(
        [prep_ds.example(*next(stream)) for _ in range(2)])
    bundle = jax_train.Bundle(jax_cfg)
    model, cfg = bundle.model, bundle.model_cfg
    # jax_train.init_state's initialisation and optimizer, under jit (its
    # eager init compiles op by op)
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


@pytest.fixture(scope="module")
def keymatch_reference(micro_cfg, reference):
    """The JAX package's loss terms and gradients of the same batch from
    the same variables in its key-match mode (the port's mode; its Pallas
    kernels in interpret mode)."""
    bundle = jax_train.Bundle(micro_cfg[0])
    model, cfg = bundle.model, bundle.model_cfg
    assert cfg.sparse_keymatch and cfg.sparse_use_pallas_gemm
    example = jax_train._to_device(
        jax_batching.device_example(reference["batch"]))
    init = reference["init"]

    @jax.jit
    def grads_fn(params, batch_stats, example):
        def loss_fn(p):
            preds, _ = model.apply(
                {"params": p, "batch_stats": batch_stats},
                example["voxels"], example["num_points"],
                example["coordinates"], train=True, mutable=["batch_stats"])
            return jax_voxelnet.compute_loss(preds, example, cfg)
        return jax.grad(loss_fn, has_aux=True)(params)

    grads, terms = grads_fn(init["params"], init["batch_stats"], example)
    return {"grads": _np_tree(grads),
            "terms": {k: float(v) for k, v in terms.items()}}


def port_state(micro_cfg, variables):
    bundle = train.Bundle(micro_cfg[0])
    state = train.init_state(bundle, total_steps=TOTAL_STEPS, device="cpu")
    weight_import.load_variables(state.model, variables)
    return bundle, state


def test_one_second_train_step_matches_jax(micro_cfg, reference):
    """Loss terms, every gradient, then (after make_train_step) every
    parameter and BatchNorm statistic."""
    bundle, state = port_state(micro_cfg, reference["init"])
    example = train.to_device(reference["batch"], "cpu")
    model = state.model.train()
    preds = model(example["voxels"], example["num_points"],
                  example["coordinates"])
    loss, terms = voxelnet.compute_loss(preds, example, bundle.model_cfg)
    for k, want in reference["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), want,
                                   **LOSS_TOL, err_msg=k)
    loss.backward()
    grads = jax_weight_import.to_torch_state_dict(
        {"params": reference["grads"],
         "batch_stats": reference["init"]["batch_stats"]})
    names = dict(model.named_parameters())
    assert any(n.startswith("middle_feature_extractor") for n in names)
    port_grads = {n: p.grad.numpy() for n, p in names.items()}
    for name, p in names.items():
        want = grads[name]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=5e-3 * scale, err_msg=name)

    bundle, state = port_state(micro_cfg, reference["init"])
    metrics = train.make_train_step(bundle)(state, example)
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
    print(f"{excused} parameter elements whose gradients differ or are "
          f"near zero differ beyond {PARAM_TOL}")


def test_float64_second_train_step_matches_jax_keymatch(
        micro_cfg, reference, keymatch_reference):
    """The port's step in float64 (the plain joins, float64 throughout)
    against the JAX package's key-match float32 step: loss terms and
    every gradient, where only the JAX side's float32 rounding differs."""
    bundle, state = port_state(micro_cfg, reference["init"])
    model = state.model.to(torch.float64).train()
    example = {k: v.double() if v.is_floating_point() else v
               for k, v in train.to_device(reference["batch"],
                                           "cpu").items()}
    preds = model(example["voxels"], example["num_points"],
                  example["coordinates"])
    loss, terms = voxelnet.compute_loss(preds, example, bundle.model_cfg)
    for k, want in keymatch_reference["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), want,
                                   **F64_LOSS_TOL, err_msg=k)
    loss.backward()
    grads = jax_weight_import.to_torch_state_dict(
        {"params": keymatch_reference["grads"],
         "batch_stats": reference["init"]["batch_stats"]})
    worst = 0.0
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float64, name
        want = grads[name]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   rtol=F64_GRAD_SHARE,
                                   atol=F64_GRAD_SHARE * scale,
                                   err_msg=name)
        worst = max(worst, float(np.abs(p.grad.numpy() - want).max())
                    / scale)
    terms_err = max(abs(float(terms[k].detach()) - v) / abs(v)
                    for k, v in keymatch_reference["terms"].items())
    print(f"float64 step vs the JAX key-match step: gradients within "
          f"{worst:.3g} of max|g|, loss terms within {terms_err:.3g}")


def test_train_then_evaluate_matches_jax(micro_cfg, reference, tmp_path):
    """train() two steps on the CPU (the loader's thread pool, the
    sampler), a resume, then evaluate(config, model_dir): the KITTI table
    equals the JAX package's evaluate on the port's state dict."""
    port_cfg, jax_cfg = micro_cfg
    model_dir = tmp_path / "model"
    before = sgg.keymatch_gemm.launches
    state = train.train(port_cfg, model_dir, max_steps=2, display_step=1,
                        device="cpu")
    assert state.step == 2 and sgg.keymatch_gemm.launches == before
    state = train.train(port_cfg, model_dir, max_steps=3, display_step=1,
                        device="cpu")
    assert state.step == 3
    assert "resumed from checkpoint at step 2" in (
        model_dir / "log.txt").read_text()
    got = train.evaluate(port_cfg, model_dir, device="cpu")
    assert "Car AP@0.70" in got["result_str"]

    sd = {k: v.numpy() for k, v in state.model.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    variables = jax_weight_import.from_torch_state_dict(sd,
                                                        reference["init"])
    want = jax_train.evaluate(jax_cfg, None, state=variables)
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "result_str":
            assert got[k] == pytest.approx(want[k], abs=AP_ATOL), k
