"""The weights a cell serves, made by the benchmark and handed to both the
program and the reference: a trained checkpoint read from the repository,
or weights drawn from the run's seed on the device.

Drawn weights follow the spread a trained detector's have, so that NMS and
the score threshold do real work: He-normal convolutions and linear
layers (a sparse convolution's fan-in counted over half its taps, the
share that finds a neighbour), the class head 3x wider with bias -2 and
the box head 0.2x, BatchNorm scale 1 + N(0, 0.1), bias and running mean
N(0, 0.1), running variance U(0.5, 1.5), other biases N(0, 0.1).  All of
it comes from one normal and one uniform draw of a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import checkpoint, network

GAIN = {"head_cls": 3.0, "head_box": 0.2}
CLS_BIAS = -2.0
SPARSE_TAP_SHARE = 0.5
NORMAL_KINDS = ("conv", "convt", "linear", "sparse", "head_cls", "head_box",
                "head", "bias", "bn_weight", "bn_bias", "bn_mean")


def _fan_in(shape, kind) -> float:
    if kind == "sparse":
        return SPARSE_TAP_SHARE * math.prod(shape[:4])
    if kind == "convt":
        return shape[0]
    return math.prod(shape[1:])


def seeded(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    specs = network.param_specs(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = {name: math.prod(shape) for name, shape, _ in specs}
    normal = torch.randn(sum(sizes[n] for n, _, k in specs
                             if k in NORMAL_KINDS),
                         generator=gen, device=device)
    uniform = torch.rand(sum(sizes[n] for n, _, k in specs if k == "bn_var"),
                         generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at_n = at_u = 0
    for name, shape, kind in specs:
        size = sizes[name]
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        if kind == "bias_cls":
            out[name] = torch.full(shape, CLS_BIAS, device=device)
            continue
        if kind == "bn_var":
            out[name] = 0.5 + uniform[at_u:at_u + size].view(shape)
            at_u += size
            continue
        x = normal[at_n:at_n + size].view(shape)
        at_n += size
        if kind == "bn_weight":
            x = 1.0 + 0.1 * x
        elif kind in ("bn_bias", "bn_mean", "bias"):
            x = 0.1 * x
        else:
            x = x * (math.sqrt(2.0 / _fan_in(shape, kind))
                     * GAIN.get(kind, 1.0))
        out[name] = x.contiguous()
    return out


def cell_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of a configuration file's ``weights`` entry."""
    spec = config["weights"]
    if spec.get("seeded"):
        return seeded(config["model"], seed, device)
    if spec.get("layout") == "flax":
        return checkpoint.load_flax_pillars(spec["checkpoint"], device)
    raise ValueError(f"weights {spec}: want seeded or a flax checkpoint")
