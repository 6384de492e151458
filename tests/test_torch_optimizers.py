"""Every optimizer and learning-rate schedule of the port's
``builder/optimizer_builder.py`` against optax as the JAX package's
``builder/optimizer_builder.py`` builds it from the same ``optimizer``
message: about 20 updates of a small parameter tree in float64 (JAX in
64-bit mode), the steps at the schedules' boundaries included, every
parameter within rtol 1e-12 after every step.  The same text is read by
protobuf for the JAX package and by the port's own text-format reader.

The updates are applied as the port's trainer applies them: the group's
learning rate set from the schedule at the step count before each
update, then ``step()``.

optax divides its int32 step count by ``decay_steps`` in float32 even in
64-bit mode, so its ``exponential_decay`` is a float32 value; the port's
schedule is the float64 one.  The update tests therefore let optax read
that schedule at an int64 count (:func:`float64_counts`); the schedule
test holds the port's values to optax's float64 ones at 1e-12 and to
the float32 ones the JAX package trains with within float32 rounding,
with the staircase's steps at the same counts.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from google.protobuf import text_format

from automatic_as_built_reconstruction_tpu.builder import (
    optimizer_builder as jax_optimizer_builder)
from automatic_as_built_reconstruction_tpu.protos import optimizer_pb2
from automatic_as_built_reconstruction_tpu_torch.builder import (
    config_io, optimizer_builder)

STEPS = 20
TOTAL_STEPS = 20
F64_TOL = dict(rtol=1e-12, atol=1e-15)

SCHEDULES = {
    "constant": "constant_learning_rate { learning_rate: 0.003 }",
    "exponential": ("exponential_decay_learning_rate { initial_learning_rate:"
                    " 0.004 decay_steps: 6 decay_factor: 0.7 }"),
    "exponential_staircase": (
        "exponential_decay_learning_rate { initial_learning_rate: 0.004 "
        "decay_steps: 6 decay_factor: 0.7 staircase: true }"),
    "manual_stepping": ("manual_stepping_learning_rate { boundaries: [5, 12] "
                        "rates: [0.01, 0.003, 0.0007] }"),
    "one_cycle": ("one_cycle { lr_max: 0.003 moms: [0.95, 0.85] "
                  "div_factor: 10.0 pct_start: 0.4 }"),
    "proto_default": "",
}
OPTIMIZERS = {
    "adamw": ("adam_optimizer {{ learning_rate {{ {lr} }} "
              "weight_decay: 0.01 }} fixed_weight_decay: true"),
    "adam": "adam_optimizer {{ learning_rate {{ {lr} }} }}",
    "adam_decayed_weights": ("adam_optimizer {{ learning_rate {{ {lr} }} "
                             "weight_decay: 0.01 }}"),
    "momentum": "momentum_optimizer {{ learning_rate {{ {lr} }} }}",
    "momentum_0.8": ("momentum_optimizer {{ learning_rate {{ {lr} }} "
                     "momentum_optimizer_value: 0.8 weight_decay: 0.1 }}"),
    "rmsprop": "rms_prop_optimizer {{ learning_rate {{ {lr} }} }}",
    "rmsprop_set": ("rms_prop_optimizer {{ learning_rate {{ {lr} }} "
                    "momentum_optimizer_value: 0.5 decay: 0.95 "
                    "epsilon: 0.001 weight_decay: 0.1 }}"),
}
KINDS = {"adamw": torch.optim.AdamW, "adam": optimizer_builder.Adam,
         "adam_decayed_weights": optimizer_builder.Adam,
         "momentum": optimizer_builder.MomentumSGD,
         "momentum_0.8": optimizer_builder.MomentumSGD,
         "rmsprop": optimizer_builder.RMSprop,
         "rmsprop_set": optimizer_builder.RMSprop}


@contextlib.contextmanager
def float64_counts():
    """optax's ``exponential_decay`` evaluated at an int64 count (a float64
    value in 64-bit mode) while the JAX builder builds a schedule."""
    decay = optax.exponential_decay

    def wrapped(*args, **kwargs):
        schedule = decay(*args, **kwargs)
        return lambda count: schedule(jnp.asarray(count, jnp.int64))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "exponential_decay", wrapped)
        yield


def _tree(rng):
    return [rng.normal(0, 0.3, (7, 5)), rng.normal(0, 0.3, (11,)),
            rng.normal(0, 0.3, (2, 3, 4))]


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_optimizer_steps_match_optax(optimizer, schedule):
    text = OPTIMIZERS[optimizer].format(lr=SCHEDULES[schedule])
    msg = text_format.Parse(text, optimizer_pb2.Optimizer())
    cfg = config_io.parse_text(text)
    rng = np.random.default_rng(abs(hash((optimizer, schedule))) % 2 ** 32)
    params = _tree(rng)
    grads = [[g * (1 + 0.5 * np.sin(i)) for g in _tree(rng)]
             for i in range(STEPS)]
    grads[3] = [np.zeros_like(g) for g in grads[3]]     # a zero gradient
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, sched = optimizer_builder.build(cfg, TOTAL_STEPS, tparams)
    assert type(opt) is KINDS[optimizer]
    with jax.enable_x64(True):
        with float64_counts():
            tx = jax_optimizer_builder.build(msg, TOTAL_STEPS)
        jparams = [jnp.asarray(p) for p in params]
        state = tx.init(jparams)
        for step, gs in enumerate(grads):
            for p, g in zip(tparams, gs):
                p.grad = torch.from_numpy(g)
            for group in opt.param_groups:
                group["lr"] = sched(step)
            opt.step()
            updates, state = tx.update([jnp.asarray(g) for g in gs], state,
                                       jparams)
            jparams = optax.apply_updates(jparams, updates)
            for i, (p, w) in enumerate(zip(tparams, jparams)):
                assert p.dtype == torch.float64 and w.dtype == jnp.float64
                np.testing.assert_allclose(
                    p.detach().numpy(), np.asarray(w), **F64_TOL,
                    err_msg=f"{optimizer} {schedule} step {step} param {i}")
        moved = max(float(np.abs(p.detach().numpy() - p0).max())
                    for p, p0 in zip(tparams, params))
    assert moved > 1e-4


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedule_matches_optax_at_every_step(schedule):
    """The schedule itself, from step 0 past the last boundary and the
    end of the one-cycle, against optax's in 64-bit mode; the boundaries
    themselves (a count equal to a boundary is past it)."""
    text = OPTIMIZERS["adam"].format(lr=SCHEDULES[schedule])
    msg = text_format.Parse(text, optimizer_pb2.Optimizer())
    lr = config_io.parse_text(text)["adam_optimizer"].get(
        "learning_rate", {})
    got = optimizer_builder.build_lr_schedule(lr, TOTAL_STEPS)
    with jax.enable_x64(True):
        want = jax_optimizer_builder.build_lr_schedule(
            msg.adam_optimizer.learning_rate, TOTAL_STEPS)
        for count in range(TOTAL_STEPS + 5):
            np.testing.assert_allclose(
                got(count), float(want(jnp.asarray(count, jnp.int64))),
                rtol=1e-12, err_msg=f"{schedule} at {count}")
            # the int32 count of optax's own state
            w32 = want(jnp.asarray(count, jnp.int32))
            np.testing.assert_allclose(
                got(count), float(w32),
                rtol=1e-12 if np.asarray(w32).dtype == np.float64 else 3e-7,
                err_msg=f"{schedule} at {count} (int32 count)")
            if count:
                assert (got(count) == got(count - 1)) == (
                    float(w32) == float(want(jnp.asarray(count - 1,
                                                         jnp.int32))))
    if schedule == "manual_stepping":
        assert got(4) == pytest.approx(0.01, rel=1e-7)
        assert got(5) == pytest.approx(0.003, rel=1e-6)
        assert got(12) == pytest.approx(0.0007, rel=1e-6)
    if schedule == "exponential_staircase":
        assert got(5) == got(0) and got(6) < got(5) and got(11) == got(6)
    if schedule == "proto_default":
        assert got(0) == got(100) == 2e-4
