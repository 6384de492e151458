"""Port vs JAX package: the losses, ``prepare_loss_weights``,
``compute_loss`` on real targets, the one-cycle learning rate and the
AdamW update.

Tolerances:
- losses and ``compute_loss`` terms: rtol 1e-5, atol 1e-6 (the same fp32
  formulas; sums over 32 000 anchors in another order);
- the learning rate at each of the config's 8000 steps: rtol 1e-6, atol
  ``LR_ATOL``.  optax evaluates the schedule in float32; near the end of
  each phase its cosine term cancels (cos(pi * pct) + 1 -> 0), which
  leaves an absolute error of a few float32 ulps of the peak rate
  (optax's own jitted and scalar evaluations differ by 2.3e-10 there) and
  no relative bound; the port evaluates it in float64;
- three AdamW steps: rtol 1e-5.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automatic_as_built_reconstruction_tpu.builder import (
    config_io as jax_config_io, optimizer_builder as jax_optimizer_builder)
from automatic_as_built_reconstruction_tpu.models import (
    losses as jax_losses, voxelnet as jax_voxelnet)
from automatic_as_built_reconstruction_tpu.ops import box_jax
from automatic_as_built_reconstruction_tpu.train import train as jax_train
from automatic_as_built_reconstruction_tpu_torch.builder import (
    config_io, losses_builder, optimizer_builder)
from automatic_as_built_reconstruction_tpu_torch.models import (
    losses, voxelnet)
from automatic_as_built_reconstruction_tpu_torch.ops import box_ops
from automatic_as_built_reconstruction_tpu_torch.train import train

REPO = Path(__file__).resolve().parents[1]
JAX_CFG = (REPO / "automatic_as_built_reconstruction_tpu" / "configs"
           / "building" / "asbuilt_pillars.config")
PORT_CFG = (REPO / "automatic_as_built_reconstruction_tpu_torch" / "configs"
            / "building" / "asbuilt_pillars.config")
JAX_CONFIGS = sorted((REPO / "automatic_as_built_reconstruction_tpu"
                      / "configs").rglob("*.config"))
TOL = dict(rtol=1e-5, atol=1e-6)
LR_ATOL = 2 * 0.002 * 2.0**-23


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=err_msg, **(tol or TOL))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_sigmoid_focal_loss(rng):
    logits = rng.normal(0, 3, (2, 500, 3)).astype(np.float32)
    targets = (rng.random((2, 500, 3)) < 0.2).astype(np.float32)
    w = rng.random((2, 500)).astype(np.float32)
    for gamma, alpha in ((2.0, 0.25), (0.0, None), (1.5, 0.5)):
        got = losses.SigmoidFocalClassificationLoss(gamma, alpha)(
            t(logits), t(targets), t(w))
        want = jax_losses.SigmoidFocalClassificationLoss(gamma, alpha)(
            logits, targets, w)
        close(got, want)


def test_weighted_smooth_l1_loss(rng):
    pred = rng.normal(0, 0.5, (2, 500, 7)).astype(np.float32)
    tgt = rng.normal(0, 0.5, (2, 500, 7)).astype(np.float32)
    w = rng.random((2, 500)).astype(np.float32)
    for sigma, cw in ((3.0, None), (1.0, (1, 1, 2, 1, 1, 2, 0.5))):
        got = losses.WeightedSmoothL1LocalizationLoss(sigma, cw)(
            t(pred), t(tgt), t(w))
        want = jax_losses.WeightedSmoothL1LocalizationLoss(sigma, cw)(
            pred, tgt, w)
        close(got, want)


def test_weighted_softmax_loss(rng):
    logits = rng.normal(0, 2, (2, 500, 2)).astype(np.float32)
    onehot = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, 500))]
    w = rng.random((2, 500)).astype(np.float32)
    for scale in (1.0, 2.5):
        got = losses.WeightedSoftmaxClassificationLoss(scale)(
            t(logits), t(onehot), t(w))
        want = jax_losses.WeightedSoftmaxClassificationLoss(scale)(
            logits, onehot, w)
        close(got, want)


@pytest.mark.parametrize("norm", ["NormByNumPositives", "NormByNumExamples",
                                  "NormByNumPosNeg", "DontNorm"])
def test_prepare_loss_weights(rng, norm):
    labels = rng.integers(-1, 4, (3, 400)).astype(np.int32)
    labels[2] = 0                                   # a scan without positives
    got = losses.prepare_loss_weights(t(labels), 2.0, 0.5, norm)
    want = jax_losses.prepare_loss_weights(labels, 2.0, 0.5, norm)
    for g, w in zip(got, want):
        close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError):
        losses.prepare_loss_weights(t(labels), loss_norm_type="bogus")


def test_box_loss_helpers(rng):
    a = rng.normal(0, 2, (2, 300, 7)).astype(np.float32)
    b = rng.normal(0, 2, (2, 300, 7)).astype(np.float32)
    for g, w in zip(box_ops.add_sin_difference(t(a), t(b)),
                    box_jax.add_sin_difference(a, b)):
        close(g, w)
    for offset, bins in ((0.0, 2), (0.7854, 4)):
        close(box_ops.get_direction_target(t(a), t(b), offset, bins),
              box_jax.get_direction_target(a, b, offset, bins),
              rtol=0, atol=0)


@pytest.fixture(scope="module")
def real_batch():
    """Two training examples of asbuilt_pillars (A = 32 000) and the
    model configs of both packages."""
    jb = jax_train.Bundle(JAX_CFG)
    tb = train.Bundle(PORT_CFG)
    ds, _ = tb.input_reader(training=True, seed=0)
    ex = [ds.example(i, 7 + i) for i in range(2)]
    batch = {k: np.stack([e[k] for e in ex])
             for k in ("labels", "reg_targets", "anchors")}
    return jb.model_cfg, tb.model_cfg, batch


def test_compute_loss_on_real_targets(real_batch):
    jcfg, tcfg, batch = real_batch
    assert (batch["labels"] > 0).sum() > 200
    B, H, W = 2, 80, 80
    A = tcfg.num_anchor_per_loc
    rng = np.random.default_rng(3)
    nhwc = {"cls_preds": rng.normal(-3, 2, (B, H, W, A * tcfg.num_class)),
            "box_preds": rng.normal(0, 0.3, (B, H, W, A * 7)),
            "dir_cls_preds": rng.normal(0, 1, (B, H, W, A * 2))}
    nhwc = {k: v.astype(np.float32) for k, v in nhwc.items()}
    _, want = jax_voxelnet.compute_loss(
        {k: jnp.asarray(v) for k, v in nhwc.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    total, got = voxelnet.compute_loss(
        {k: t(v).permute(0, 3, 1, 2) for k, v in nhwc.items()},
        {k: t(v) for k, v in batch.items()}, tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], err_msg=k)
    assert got["loss"] is total


def test_loss_fields_and_builder_match_reference():
    """Every config's loss message reads into the same hyperparameters."""
    from automatic_as_built_reconstruction_tpu.builder import (
        losses_builder as jax_losses_builder)
    for path in JAX_CONFIGS:
        want = jax_losses_builder.build(
            jax_config_io.load_config(path).model.second.loss)
        got = losses_builder.build(
            config_io.load_config(path)["model"]["second"].get("loss", {}))
        assert vars(got) == vars(want), path.name


def test_one_cycle_lr_at_every_step_matches_optax():
    cfg = config_io.load_config(PORT_CFG)["train_config"]
    jcfg = jax_config_io.load_config(JAX_CFG).train_config
    steps = int(cfg["steps"])
    assert steps == 8000
    got = optimizer_builder.build_lr_schedule(
        cfg["optimizer"]["adam_optimizer"]["learning_rate"], steps)
    want = jax_optimizer_builder.build_lr_schedule(
        jcfg.optimizer.adam_optimizer.learning_rate, steps)
    counts = np.arange(steps + 3)
    want_v = np.asarray(jax.jit(jax.vmap(want))(jnp.asarray(counts,
                                                            jnp.int32)))
    got_v = np.array([got(int(c)) for c in counts])
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=LR_ATOL)
    assert got(0) == pytest.approx(0.0002, rel=1e-6)
    assert got(3200) == pytest.approx(0.002, rel=1e-6)


def test_adamw_steps_match_optax():
    """Three updates of the config's AdamW (one-cycle LR at the step count
    before each update) on random parameters and gradients."""
    cfg = config_io.load_config(PORT_CFG)["train_config"]["optimizer"]
    jcfg = jax_config_io.load_config(JAX_CFG).train_config.optimizer
    rng = np.random.default_rng(5)
    shapes = [(16, 9), (64,), (3, 3, 8, 4)]
    params = [rng.normal(0, 0.3, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tparams = [torch.nn.Parameter(t(p.copy())) for p in params]
    opt, schedule = optimizer_builder.build(cfg, 8000, tparams)
    tx = jax_optimizer_builder.build(jcfg, 8000)
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    for step, gs in enumerate(grads):
        for p, g in zip(tparams, gs):
            p.grad = t(g)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in gs], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, w in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-5, atol=0)
    assert len(opt.param_groups) == 1
    group = opt.param_groups[0]
    assert (group["betas"], group["eps"]) == ((0.9, 0.999), 1e-8)
    assert group["weight_decay"] == pytest.approx(0.01)


@pytest.mark.parametrize("optimizer,match", [
    ({"adam_optimizer": {"learning_rate": {"constant_learning_rate": {
        "learning_rate": 0.001}}, "weight_decay": 0.01},
      "fixed_weight_decay": True}, "constant_learning_rate"),
    ({"adam_optimizer": {"learning_rate": {"one_cycle": {"lr_max": 0.002}},
                         "weight_decay": 0.01}}, "adamw"),
    ({"adam_optimizer": {"learning_rate": {"one_cycle": {"lr_max": 0.002}}}},
     "adamw"),
    ({"momentum_optimizer": {}}, "momentum_optimizer"),
    ({"rms_prop_optimizer": {}}, "rms_prop_optimizer"),
], ids=["constant_lr", "adam_add_decayed_weights", "adam", "momentum",
        "rmsprop"])
def test_unported_optimizer_branches_raise(optimizer, match):
    """These branches were refused until the port had them; each now
    builds the optimizer the JAX package's builder names (``match``), and
    ``tests/test_torch_optimizers.py`` holds its updates to optax."""
    opt, schedule = optimizer_builder.build(
        optimizer, 100, [torch.nn.Parameter(torch.zeros(3))])
    kinds = {"constant_learning_rate": torch.optim.AdamW,
             "adamw": optimizer_builder.Adam,
             "momentum_optimizer": optimizer_builder.MomentumSGD,
             "rms_prop_optimizer": optimizer_builder.RMSprop}
    assert type(opt) is kinds[match]
    assert len(opt.param_groups) == 1
    assert schedule(0) > 0 and opt.param_groups[0]["lr"] == schedule(0)
