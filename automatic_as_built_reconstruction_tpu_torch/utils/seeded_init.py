"""Weights and BatchNorm statistics from a seed: for serving a config that
has no checkpoint (:func:`load_seeded`), and the trainer's initial state
drawn with flax's default initialisers (:func:`load_flax_init`).

A framework's fresh initialisation gives identity BatchNorms and
near-constant class scores, which exercise neither the masked BatchNorm
nor the score threshold.  Here every tensor is drawn with numpy from one
seed: He-normal conv and linear weights, BatchNorm scale 1 + N(0, 0.1),
bias and running mean N(0, 0.1), running variance U(0.5, 1.5), class
logits spread around a negative bias so that scores lie on both sides of
a detection threshold, and small box residuals so that boxes stay near
their anchors.  The same seed gives the same state on any device.

The trainer starts where the JAX package's ``model.init`` starts, in
distribution (not in values: the draws come from a ``torch.Generator``):
lecun-normal kernels (a normal truncated at two standard deviations, scaled to
variance 1 / fan_in), zero biases except the class head's focal prior and the
yaw-quality head's 2.0, BatchNorm scale 1, bias 0, running mean 0, variance 1,
and the sparse middle's kernels as ``models/middle.py::_sparse_kernel_init``
draws them: a unit normal truncated at two standard deviations times sqrt(2 /
(taps * Cin)). The truncated normal is drawn by its inverse CDF, one uniform
draw an element (``models/middle.py::trunc_normal``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models.middle import MaskedBatchNorm, SparseConvWeight, trunc_normal

# a sparse conv's output row sums about this share of its K taps (the rest
# find no neighbour), so its weights are drawn that much wider
SPARSE_TAP_DENSITY = 0.5
HEAD_GAIN = {"conv_cls": 3.0, "conv_box": 0.2}
CLS_LOGIT_BIAS = -2.0
# the JAX package's RPN class-head bias init: -log((1 - pi) / pi) at
# pi = 0.01, so a fresh head scores every anchor about 0.01
FOCAL_PRIOR_BIAS = -4.59511985013459
# the heads' bias inits: the class head's focal prior, and the yaw-quality
# head's 2.0 (sigmoid ~0.88: a fresh head leaves the scores nearly as
# they are)
INIT_BIAS = {"conv_cls": FOCAL_PRIOR_BIAS, "conv_quality": 2.0}
# flax's truncated_normal lecun init divides by the standard deviation of
# a unit normal truncated to [-2, 2]
TRUNC_NORMAL_STD = .87962566103423978


def seeded_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` for ``model`` drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, values) -> None:
        out[name] = torch.from_numpy(np.asarray(values, np.float32))

    for mod_name, mod in model.named_modules():
        base = f"{mod_name}." if mod_name else ""
        if isinstance(mod, (nn.modules.batchnorm._BatchNorm,
                            MaskedBatchNorm)):
            n = mod.weight.shape
            put(f"{base}weight", 1.0 + rng.normal(0, 0.1, n))
            put(f"{base}bias", rng.normal(0, 0.1, n))
            put(f"{base}running_mean", rng.normal(0, 0.1, n))
            put(f"{base}running_var", rng.uniform(0.5, 1.5, n))
            if hasattr(mod, "num_batches_tracked"):
                out[f"{base}num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.long)
        elif isinstance(mod, SparseConvWeight):
            shape = tuple(mod.weight.shape)
            fan_in = SPARSE_TAP_DENSITY * np.prod(shape[:4])
            put(f"{base}weight", rng.normal(0, (2.0 / fan_in) ** 0.5, shape))
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                              nn.Linear)):
            shape = tuple(mod.weight.shape)
            if isinstance(mod, nn.ConvTranspose2d):
                # kernel == stride: one tap per output pixel
                fan_in = shape[0]
            else:
                fan_in = int(np.prod(shape[1:]))
            w = rng.normal(0, (2.0 / fan_in) ** 0.5, shape)
            head = mod_name.rsplit(".", 1)[-1]
            put(f"{base}weight", w * HEAD_GAIN.get(head, 1.0))
            if mod.bias is not None:
                put(f"{base}bias",
                    np.full(mod.bias.shape, CLS_LOGIT_BIAS)
                    if head == "conv_cls"
                    else rng.normal(0, 0.1, mod.bias.shape))
    return out


def load_seeded(model: nn.Module, seed: int) -> None:
    """Load :func:`seeded_state_dict` into ``model`` with ``strict=True``
    (so a module this function does not know fails loudly)."""
    model.load_state_dict(seeded_state_dict(model, seed), strict=True)


def flax_init_state_dict(model: nn.Module,
                         seed: int) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` for ``model`` drawn from ``seed`` with flax's
    default initialisers (the module docstring)."""
    gen = torch.Generator().manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for mod_name, mod in model.named_modules():
        base = f"{mod_name}." if mod_name else ""
        if isinstance(mod, MaskedBatchNorm):
            out[f"{base}weight"] = torch.ones_like(mod.weight)
            out[f"{base}bias"] = torch.zeros_like(mod.bias)
            out[f"{base}running_mean"] = torch.zeros_like(mod.running_mean)
            out[f"{base}running_var"] = torch.ones_like(mod.running_var)
        elif isinstance(mod, SparseConvWeight):
            shape = tuple(mod.weight.shape)       # (kz, ky, kx, Cin, Cout)
            std = (2.0 / int(np.prod(shape[:4]))) ** 0.5
            out[f"{base}weight"] = trunc_normal(shape, gen) * std
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            out[f"{base}weight"] = torch.ones_like(mod.weight)
            out[f"{base}bias"] = torch.zeros_like(mod.bias)
            out[f"{base}running_mean"] = torch.zeros_like(mod.running_mean)
            out[f"{base}running_var"] = torch.ones_like(mod.running_var)
            out[f"{base}num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                              nn.Linear)):
            shape = tuple(mod.weight.shape)
            # flax counts fan_in as the kernel's input channels times its
            # taps: torch's dim 1 for a Conv2d / Linear, dim 0 for a
            # ConvTranspose2d
            cin = shape[0] if isinstance(mod, nn.ConvTranspose2d) else shape[1]
            fan_in = cin * int(np.prod(shape[2:]))
            std = (1.0 / fan_in) ** 0.5 / TRUNC_NORMAL_STD
            out[f"{base}weight"] = trunc_normal(shape, gen) * std
            if mod.bias is not None:
                head = mod_name.rsplit(".", 1)[-1]
                out[f"{base}bias"] = torch.full(
                    mod.bias.shape, INIT_BIAS.get(head, 0.0))
    return out


def load_flax_init(model: nn.Module, seed: int) -> None:
    """Load :func:`flax_init_state_dict` into ``model`` with
    ``strict=True``."""
    model.load_state_dict(flax_init_state_dict(model, seed), strict=True)
