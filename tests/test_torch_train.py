"""The port's training step, held to the JAX package's on the micro config
of ``tests/test_train_runtime.py`` (copied here, its optimizer the
``adam_optimizer`` + ``one_cycle`` + ``fixed_weight_decay`` branch every
config in the repository sets), and ``train()`` / ``evaluate()`` end to
end on the CPU.

Tolerances:
- loss terms of one step: rtol 1e-4 (fp32 sums of thousands of anchors
  in another order on each side);
- gradients: rtol 1e-3, atol 1e-5 * max|g| of the tensor (the backward
  of the BatchNorms and convolutions sums in another order on oneDNN than
  on XLA);
- parameters after the update and BatchNorm statistics: rtol 1e-5, atol
  1e-7.  Adam's first step moves a parameter by about lr * sign(g), so an
  element whose gradient is within rounding of zero (|g| below
  ``G_NOISE`` * max|g| of its tensor) may move the other way: those are
  excused, counted and printed;
- three steps: losses rtol 1e-3.
"""
import json
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automatic_as_built_reconstruction_tpu.data import (
    batching as jax_batching)
from automatic_as_built_reconstruction_tpu.models import (
    voxelnet as jax_voxelnet)
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu.utils import (
    weight_import as jax_weight_import)
from automatic_as_built_reconstruction_tpu_torch.models import voxelnet
from automatic_as_built_reconstruction_tpu_torch.ops import pillar_scatter
from automatic_as_built_reconstruction_tpu_torch.train import (
    checkpoint, train)
from automatic_as_built_reconstruction_tpu_torch.utils import weight_import

REPO = Path(__file__).resolve().parents[1]
MICRO_CONFIG = re.search(
    r'MICRO_CONFIG = """(.*?)"""',
    (REPO / "tests" / "test_train_runtime.py").read_text(), re.S).group(1)
MICRO_CONFIG = MICRO_CONFIG.replace(
    "learning_rate: { constant_learning_rate: { learning_rate: 0.001 } }\n"
    "    }",
    "learning_rate: { one_cycle: { lr_max: 0.002 div_factor: 10.0 "
    "pct_start: 0.4 } }\n      weight_decay: 0.01\n    }\n"
    "    fixed_weight_decay: true")
assert "fixed_weight_decay" in MICRO_CONFIG
TOTAL_STEPS = 40
LOSS_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
G_NOISE = 1e-4


@pytest.fixture(scope="module")
def micro_cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "micro.config"
    p.write_text(MICRO_CONFIG)
    return p


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def reference(micro_cfg):
    """The JAX package on the micro config: initial variables, three
    batches of its training reader, the loss terms and gradients of the
    first batch, and the state after one and after three steps."""
    bundle = jax_train.Bundle(micro_cfg)
    _, loader = bundle.input_reader(training=True, seed=0)
    it = iter(loader)
    batches = [next(it) for _ in range(3)]
    state, tx = jax_train.init_state(bundle, rng_seed=0,
                                     total_steps=TOTAL_STEPS)
    init = _np_tree({"params": state["params"],
                     "batch_stats": state["batch_stats"]})
    examples = [jax_train._to_device(jax_batching.device_example(b))
                for b in batches]
    model, cfg = bundle.model, bundle.model_cfg

    @jax.jit
    def grads_fn(params, batch_stats, example):
        def loss_fn(p):
            preds, mut = model.apply(
                {"params": p, "batch_stats": batch_stats},
                example["voxels"], example["num_points"],
                example["coordinates"], train=True, mutable=["batch_stats"])
            loss, metrics = jax_voxelnet.compute_loss(preds, example, cfg)
            return loss, metrics
        return jax.grad(loss_fn, has_aux=True)(params)

    grads, terms = grads_fn(state["params"], state["batch_stats"],
                            examples[0])
    step = jax_train.make_train_step(bundle, tx)
    losses = []
    for i, ex in enumerate(examples):
        state, metrics = step(state, ex)
        losses.append(float(metrics["loss"]))
        if i == 0:
            after_one = _np_tree({"params": state["params"],
                                  "batch_stats": state["batch_stats"]})
    return {"init": init, "batches": batches, "grads": _np_tree(grads),
            "terms": {k: float(v) for k, v in terms.items()},
            "after_one": after_one, "losses": losses}


def port_state(micro_cfg, variables):
    bundle = train.Bundle(micro_cfg)
    state = train.init_state(bundle, total_steps=TOTAL_STEPS, device="cpu")
    weight_import.load_variables(state.model, variables)
    return bundle, state


def jax_state_dict(variables):
    """JAX variables -> the port's parameter and buffer names, as numpy."""
    return jax_weight_import.to_torch_state_dict(variables)


def test_one_step_loss_terms_and_gradients_match_jax(micro_cfg, reference):
    bundle, state = port_state(micro_cfg, reference["init"])
    example = train.to_device(reference["batches"][0], "cpu")
    model = state.model.train()
    preds = model(example["voxels"], example["num_points"],
                  example["coordinates"])
    loss, terms = voxelnet.compute_loss(preds, example, bundle.model_cfg)
    for k, want in reference["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), want,
                                   **LOSS_TOL, err_msg=k)
    loss.backward()
    ref = jax_state_dict({"params": reference["grads"],
                          "batch_stats": reference["init"]["batch_stats"]})
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(k for k in ref if not k.endswith(
        ("running_mean", "running_var")))
    for name, p in names.items():
        want = ref[name]
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=name)


def test_one_train_step_matches_jax(micro_cfg, reference):
    """Parameters and BatchNorm statistics after one make_train_step."""
    bundle, state = port_state(micro_cfg, reference["init"])
    step = train.make_train_step(bundle)
    metrics = step(state, train.to_device(reference["batches"][0], "cpu"))
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]),
                               reference["losses"][0], **LOSS_TOL)
    grads = jax_state_dict({"params": reference["grads"],
                            "batch_stats": reference["init"]["batch_stats"]})
    want = jax_state_dict(reference["after_one"])
    got = state.model.state_dict()
    excused = 0
    for name, w in want.items():
        g = got[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, **PARAM_TOL, err_msg=name)
            continue
        noise = np.abs(grads[name]) < G_NOISE * np.abs(grads[name]).max()
        excused += int((noise & ~np.isclose(g, w, **PARAM_TOL)).sum())
        np.testing.assert_allclose(g[~noise], w[~noise], **PARAM_TOL,
                                   err_msg=name)
        # a sign flip of a near-zero gradient moves Adam's first step by
        # at most 2 * lr
        assert np.abs(g - w).max() <= 2 * state.schedule(0) * 1.01, name
    print(f"{excused} parameter elements with |g| < {G_NOISE} * max|g| "
          f"differ beyond {PARAM_TOL}")


def test_three_steps_losses_match_jax(micro_cfg, reference):
    bundle, state = port_state(micro_cfg, reference["init"])
    step = train.make_train_step(bundle)
    losses = [float(step(state, train.to_device(b, "cpu"))["loss"])
              for b in reference["batches"]]
    np.testing.assert_allclose(losses, reference["losses"], rtol=1e-3)


def test_pillar_scatter_gradient_on_cpu_is_the_gather():
    """The plain scatter's autograd gradient equals pillar_gather_plain
    (rows dropped outside [0, hw), shuffled unique ids)."""
    g = torch.Generator().manual_seed(3)
    B, V, C, hw = 3, 200, 16, 400
    lin = torch.stack([torch.randperm(hw + 60, generator=g)[:V] - 30
                       for _ in range(B)]).int()
    feats = torch.randn(B, V, C, generator=g, requires_grad=True)
    canvas = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    dcanvas = torch.randn(B, hw, C, generator=g)
    canvas.backward(dcanvas)
    want = pillar_scatter.pillar_gather_plain(dcanvas, lin)
    assert torch.equal(feats.grad, want)
    assert torch.equal(pillar_scatter.pillar_gather(dcanvas, lin), want)
    assert int((want.abs().sum(-1) == 0).sum()) == int(
        ((lin < 0) | (lin >= hw)).sum())


def test_clip_by_global_norm_is_the_reference_formula():
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (1.0, 100.0):      # above the norm and below it
        got = train.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                        max_norm)
        want = jax_train.clip_by_global_norm(
            [jnp.asarray(g) for g in grads], max_norm)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    norm = float(train.global_norm([torch.from_numpy(g) for g in grads]))
    assert 1.0 < norm < 100.0


def test_train_evaluate_resume_and_restart(micro_cfg, tmp_path):
    """train() trains (the loss falls), writes its files and checkpoints,
    resumes at the latest step, restarts with resume=False, and
    evaluate(config, model_dir) reads its checkpoint."""
    model_dir = tmp_path / "run"
    state = train.train(micro_cfg, model_dir, max_steps=TOTAL_STEPS,
                        display_step=10, device="cpu")
    assert state.step == TOTAL_STEPS
    for f in ("log.txt", "metrics.jsonl", "pipeline.config"):
        assert (model_dir / f).exists(), f
    assert (model_dir / "pipeline.config").read_text() == MICRO_CONFIG
    windows = [json.loads(line) for line in
               (model_dir / "metrics.jsonl").read_text().splitlines()]
    assert [w["step"] for w in windows] == [10, 20, 30, 40]
    assert all(math.isfinite(w["loss"]) for w in windows)
    assert windows[-1]["loss"] < 0.8 * windows[0]["loss"], windows
    assert "PR @0.1" in (model_dir / "log.txt").read_text()
    mgr = checkpoint.CheckpointManager(model_dir)
    assert mgr.latest_step() == TOTAL_STEPS

    # resumed from the run's own copy of its config
    state2 = train.train(model_dir / "pipeline.config", model_dir,
                         max_steps=TOTAL_STEPS + 5, display_step=5,
                         device="cpu")
    assert state2.step == TOTAL_STEPS + 5
    assert (f"resumed from checkpoint at step {TOTAL_STEPS}"
            in (model_dir / "log.txt").read_text())
    assert mgr.all_steps() == [TOTAL_STEPS, TOTAL_STEPS + 5]

    state3 = train.train(micro_cfg, model_dir, max_steps=3, display_step=1,
                         device="cpu", resume=False)
    assert state3.step == 3
    assert mgr.all_steps() == [3]

    result = train.evaluate(micro_cfg, model_dir, device="cpu")
    assert "mAP.bev" in result and math.isfinite(result["mAP.bev"])


def test_checkpoint_manager_semantics(micro_cfg, tmp_path):
    """Latest step, max_to_keep, skipped and forced saves, restore."""
    bundle = train.Bundle(micro_cfg)
    state = train.init_state(bundle, total_steps=10, device="cpu")
    mgr = checkpoint.CheckpointManager(tmp_path, max_to_keep=2)
    assert mgr.latest_step() is None
    assert checkpoint.try_restore_latest(tmp_path, state) == (None, 0)
    for s in (1, 2, 3):
        assert mgr.save(s, state)
    assert mgr.all_steps() == [2, 3]
    assert not mgr.save(3, state)              # not past the latest
    with pytest.raises(checkpoint.StepAlreadyExistsError):
        mgr.save(3, state, force=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    restored, step = checkpoint.try_restore_latest(tmp_path, state)
    assert step == 3 and restored.step == 3
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_capacity_saturation_aborts(micro_cfg, tmp_path, monkeypatch):
    """A sparse middle that keeps reporting saturated capacities aborts
    training after saturation_abort_windows display windows, with a
    checkpoint written (the reference's test_capacity_saturation_aborts;
    the pillar model reports none, so the step is wrapped)."""
    real = train.make_train_step

    def saturating(bundle):
        step = real(bundle)

        def wrapped(state, example):
            metrics = step(state, example)
            metrics["mid_capacity_saturated"] = torch.tensor(3.0)
            return metrics
        return wrapped

    monkeypatch.setattr(train, "make_train_step", saturating)
    with pytest.raises(train.CapacitySaturationError, match="out_site_caps"):
        train.train(micro_cfg, tmp_path / "sat", max_steps=10,
                    display_step=1, saturation_abort_windows=2,
                    device="cpu")
    assert checkpoint.CheckpointManager(tmp_path / "sat").latest_step() == 2


def test_in_loop_evaluation_logs_the_ap(micro_cfg, tmp_path):
    """steps_per_eval: a checkpoint and an evaluation of the live state
    every that many steps, logged under the ``eval`` prefix."""
    cfg = tmp_path / "eval_every_2.config"
    cfg.write_text(MICRO_CONFIG.replace("steps: 6",
                                        "steps: 6\n  steps_per_eval: 2"))
    model_dir = tmp_path / "run"
    state = train.train(cfg, model_dir, max_steps=4, display_step=2,
                        device="cpu")
    assert state.step == 4
    evals = [json.loads(line) for line in
             (model_dir / "metrics.jsonl").read_text().splitlines()
             if '"prefix": "eval"' in line]
    assert [e["step"] for e in evals] == [2, 4]
    assert all(math.isfinite(e["mAP.bev"]) for e in evals)
    assert checkpoint.CheckpointManager(model_dir).all_steps() == [2, 4]
