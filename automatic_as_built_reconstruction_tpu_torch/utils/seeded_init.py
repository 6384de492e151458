"""Weights and BatchNorm statistics from a seed, for serving a config that
has no checkpoint.

A framework's fresh initialisation gives identity BatchNorms and
near-constant class scores, which exercise neither the masked BatchNorm
nor the score threshold.  Here every tensor is drawn with numpy from one
seed: He-normal conv and linear weights, BatchNorm scale 1 + N(0, 0.1),
bias and running mean N(0, 0.1), running variance U(0.5, 1.5), class
logits spread around a negative bias so that scores lie on both sides of
a detection threshold, and small box residuals so that boxes stay near
their anchors.  The same seed gives the same state on any device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models.middle import MaskedBatchNorm, SparseConvWeight

# a sparse conv's output row sums about this share of its K taps (the rest
# find no neighbour), so its weights are drawn that much wider
SPARSE_TAP_DENSITY = 0.5
HEAD_GAIN = {"conv_cls": 3.0, "conv_box": 0.2}
CLS_LOGIT_BIAS = -2.0


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
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
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
