"""``optimizer`` config message -> torch optimizer + learning-rate schedule,
as the JAX package's ``builder/optimizer_builder.py`` builds its optax
transformation, branch for branch:

- ``adam_optimizer`` with a ``weight_decay`` and ``fixed_weight_decay``:
  ``optax.adamw(schedule, weight_decay=wd)`` -> torch ``AdamW`` (one
  parameter group, decay on every tensor as optax's unmasked ``adamw``);
- ``adam_optimizer`` otherwise (and no optimizer at all):
  ``optax.adam(schedule)``, after ``optax.add_decayed_weights(wd)`` where
  a ``weight_decay`` is set -> :class:`Adam`;
- ``momentum_optimizer``: ``optax.sgd(schedule, momentum=m or 0.9)`` ->
  :class:`MomentumSGD`;
- ``rms_prop_optimizer``: ``optax.rmsprop(schedule, decay=d or 0.9,
  momentum=m or 0.9, eps=e or 1e-8)`` -> :class:`RMSprop`.

The JAX builder reads no ``weight_decay`` for momentum or RMSprop, so
neither does the port.  The update rules are optax's, not
``torch.optim``'s: optax's RMSprop puts eps inside the square root and
applies its momentum trace after the learning rate, and its SGD scales
the trace (not the gradient) by the learning rate.  Each optimizer takes
the learning rate of its (one) parameter group, which the trainer sets
from the schedule at the step count before each update, as optax's
``scale_by_learning_rate`` reads its count (from 0).

Schedules: ``one_cycle`` (optax's ``cosine_onecycle_schedule``),
``constant_learning_rate``, ``exponential_decay_learning_rate`` (staircase
or not) and ``manual_stepping_learning_rate`` (optax's
``piecewise_constant_schedule``: the rate changes AT each boundary step),
and the proto3 default, a constant 2e-4.  They are plain functions of the
step count in float64 (optax computes them in float32 unless JAX runs in
64-bit mode).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import torch

from .config_io import as_list, f32

Schedule = Callable[[int], float]

# the proto3 default: the lineage's adam default rate
DEFAULT_LEARNING_RATE = 2e-4


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


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def exponential_decay_schedule(init_value: float, transition_steps: int,
                               decay_rate: float,
                               staircase: bool = False) -> Schedule:
    """optax's ``exponential_decay`` (no ``transition_begin``, no end
    value): ``init * rate ** (count / steps)``, the exponent floored with
    ``staircase``; ``init`` at count 0 and, as optax has it, for every
    count when ``steps <= 0`` or ``rate == 0``."""
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        if count <= 0:
            return init_value
        p = count / transition_steps
        if staircase:
            p = math.floor(p)
        return init_value * decay_rate ** p

    return schedule


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: Dict[int, float]
                                ) -> Schedule:
    """optax's ``piecewise_constant_schedule``: from ``init_value``, the
    value times each boundary's scale from that boundary's step on (the
    boundaries in ascending order; a count equal to a boundary is past
    it)."""
    steps = sorted(boundaries_and_scales.items())

    def schedule(count: int) -> float:
        v = init_value
        for boundary, scale in steps:
            if count >= boundary:
                v = scale * v
        return v

    return schedule


def _which(msg: dict, names: Tuple[str, ...]):
    return next((k for k in msg if k in names), None)


def build_lr_schedule(lr_cfg: dict, total_steps: int) -> Schedule:
    which = _which(lr_cfg, (
        "constant_learning_rate", "exponential_decay_learning_rate",
        "manual_stepping_learning_rate", "one_cycle"))
    if which == "constant_learning_rate":
        return constant_schedule(f32(lr_cfg[which].get("learning_rate",
                                                       0.0)))
    if which == "exponential_decay_learning_rate":
        c = lr_cfg[which]
        return exponential_decay_schedule(
            f32(c.get("initial_learning_rate", 0.0)),
            int(c.get("decay_steps", 0)), f32(c.get("decay_factor", 0.0)),
            staircase=bool(c.get("staircase", False)))
    if which == "manual_stepping_learning_rate":
        c = lr_cfg[which]
        boundaries = [int(b) for b in as_list(c.get("boundaries"))]
        rates = [f32(r) for r in as_list(c.get("rates"))]
        return piecewise_constant_schedule(
            rates[0], {b: rates[i + 1] / rates[i]
                       for i, b in enumerate(boundaries)})
    if which == "one_cycle":
        c = lr_cfg["one_cycle"]
        return one_cycle_schedule(
            total_steps, f32(c.get("lr_max", 0.0)),
            pct_start=f32(c.get("pct_start", 0.0)) or 0.3,
            div_factor=f32(c.get("div_factor", 0.0)) or 25.0,
            final_div_factor=1e4)
    return constant_schedule(DEFAULT_LEARNING_RATE)


class Adam(torch.optim.Optimizer):
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), after
    ``add_decayed_weights(weight_decay)`` where it is set: the gradient
    plus ``weight_decay * param``, then the bias-corrected moments, and
    the update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
                mu = st["mu"].mul_(b1).add_((1 - b1) * g)
                nu = st["nu"].mul_(b2).add_((1 - b2) * (g * g))
                mu_hat = mu / (1 - b1 ** st["count"])
                nu_hat = nu / (1 - b2 ** st["count"])
                p.add_(mu_hat / (torch.sqrt(nu_hat) + group["eps"]),
                       alpha=-group["lr"])


class MomentumSGD(torch.optim.Optimizer):
    """optax's ``sgd`` with momentum: the trace ``t = g + momentum * t``,
    then the update ``-lr * t``."""

    def __init__(self, params, lr: float, momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["trace"] = torch.zeros_like(p)
                t = st["trace"].mul_(group["momentum"]).add_(p.grad)
                p.add_(t, alpha=-group["lr"])


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` (not centred, no bias correction, initial scale
    0): ``nu = decay * nu + (1 - decay) * g^2``, the scaled gradient
    ``lr * g / sqrt(nu + eps)`` (eps inside the root), then the momentum
    trace of those scaled gradients, ``t = u + momentum * t``, is the
    step."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 momentum: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, momentum=momentum,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            d = group["decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    st["trace"] = torch.zeros_like(p)
                nu = st["nu"].mul_(d).add_((1 - d) * (g * g))
                u = group["lr"] * (torch.rsqrt(nu + group["eps"]) * g)
                t = st["trace"].mul_(group["momentum"]).add_(u)
                p.sub_(t)


def build(optimizer_cfg: dict, total_steps: int,
          params: Iterable[torch.nn.Parameter]
          ) -> Tuple[torch.optim.Optimizer, Schedule]:
    """-> (the optimizer over ``params``, its learning-rate schedule)."""
    which = _which(optimizer_cfg, ("adam_optimizer", "momentum_optimizer",
                                   "rms_prop_optimizer")) or "adam_optimizer"
    c = optimizer_cfg.get(which, {})
    schedule = build_lr_schedule(c.get("learning_rate", {}), total_steps)
    lr = schedule(0)
    if which == "momentum_optimizer":
        return MomentumSGD(params, lr, momentum=f32(
            c.get("momentum_optimizer_value", 0.0)) or 0.9), schedule
    if which == "rms_prop_optimizer":
        return RMSprop(
            params, lr, decay=f32(c.get("decay", 0.0)) or 0.9,
            momentum=f32(c.get("momentum_optimizer_value", 0.0)) or 0.9,
            eps=f32(c.get("epsilon", 0.0)) or 1e-8), schedule
    wd = f32(c.get("weight_decay", 0.0))
    if wd and optimizer_cfg.get("fixed_weight_decay", False):
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=wd), schedule
    return Adam(params, lr, weight_decay=wd), schedule
