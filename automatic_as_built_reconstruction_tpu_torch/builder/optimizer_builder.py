"""``optimizer`` config message -> torch optimizer + learning-rate schedule,
as the JAX package's ``builder/optimizer_builder.py`` builds its optax
transformation.

Every config in the repository sets ``adam_optimizer`` with a
``one_cycle`` learning rate and ``fixed_weight_decay: true``, which the
reference builds as ``optax.adamw(schedule, weight_decay=wd)`` over
``optax.cosine_onecycle_schedule(total_steps, lr_max, pct_start,
div_factor, final_div_factor=1e4)``.  That branch is ported: a torch
``AdamW`` with one parameter group (decay on every tensor, as optax's
unmasked ``adamw``), betas (0.9, 0.999), eps 1e-8, whose learning rate the
trainer sets from the schedule at the step count before each update (as
optax's ``scale_by_learning_rate`` reads its count).  The other branches
raise ``NotImplementedError`` with their names.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from .config_io import f32

Schedule = Callable[[int], float]


def one_cycle_schedule(total_steps: int, peak_value: float,
                       pct_start: float = 0.3, div_factor: float = 25.0,
                       final_div_factor: float = 1e4) -> Schedule:
    """optax's ``cosine_onecycle_schedule`` as a plain function of the
    step count: from ``peak / div_factor`` up to ``peak`` over the first
    ``int(pct_start * total_steps)`` steps, down to ``peak / div_factor /
    final_div_factor`` at ``total_steps`` (and held there), each phase a
    half cosine.  In float64 (optax rounds each term to float32)."""
    if total_steps <= 0:
        raise ValueError(f"one-cycle schedule over {total_steps} steps")
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    values = [peak_value / div_factor]
    values.append(values[0] * div_factor)
    values.append(values[1] / (div_factor * final_div_factor))

    def schedule(count: int) -> float:
        if count >= bounds[2]:
            return values[2]
        i = 0 if count < bounds[1] else 1
        pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
        return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
            math.cos(math.pi * pct) + 1)

    return schedule


def _which(msg: dict, names: Tuple[str, ...]):
    return next((k for k in msg if k in names), None)


def build_lr_schedule(lr_cfg: dict, total_steps: int) -> Schedule:
    which = _which(lr_cfg, (
        "constant_learning_rate", "exponential_decay_learning_rate",
        "manual_stepping_learning_rate", "one_cycle"))
    if which != "one_cycle":
        raise NotImplementedError(
            f"learning rate {which or 'constant (the proto default)'} is "
            f"not ported: only one_cycle")
    c = lr_cfg["one_cycle"]
    return one_cycle_schedule(
        total_steps, f32(c.get("lr_max", 0.0)),
        pct_start=f32(c.get("pct_start", 0.0)) or 0.3,
        div_factor=f32(c.get("div_factor", 0.0)) or 25.0,
        final_div_factor=1e4)


def build(optimizer_cfg: dict, total_steps: int,
          params: Iterable[torch.nn.Parameter]
          ) -> Tuple[torch.optim.AdamW, Schedule]:
    """-> (``AdamW`` over ``params``, its learning-rate schedule)."""
    which = _which(optimizer_cfg, ("adam_optimizer", "momentum_optimizer",
                                   "rms_prop_optimizer")) or "adam_optimizer"
    if which != "adam_optimizer":
        raise NotImplementedError(f"optimizer {which} is not ported: only "
                                  f"adam_optimizer")
    c = optimizer_cfg.get("adam_optimizer", {})
    wd = f32(c.get("weight_decay", 0.0))
    if not (wd and optimizer_cfg.get("fixed_weight_decay", False)):
        raise NotImplementedError(
            "adam_optimizer without fixed_weight_decay and a weight_decay "
            "(optax.adam, or add_decayed_weights + adam) is not ported: "
            "only adamw")
    schedule = build_lr_schedule(c.get("learning_rate", {}), total_steps)
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=wd)
    return opt, schedule
