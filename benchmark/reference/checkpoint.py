"""A trained checkpoint in the flax layout (a pickle of ``{"params",
"batch_stats"}`` nested dicts of numpy arrays) -> the lineage-named
weights of :mod:`.network`, for the pillar detector.

Layouts: a flax ``Dense`` kernel is (in, out); a ``Conv`` kernel (kh, kw,
in, out); a ``ConvTranspose`` kernel (kh, kw, in, out) applied without
flipping, so that ``out[y * s + r] = x[y] . K[k - 1 - r]`` where PyTorch's
transposed convolution gives ``x[y] . W[r]``: the taps are flipped.
"""
from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Dict

import numpy as np
import torch


def _numbered(tree: dict, prefix: str):
    keys = [k for k in tree if re.fullmatch(rf"{prefix}_\d+", k)]
    return sorted(keys, key=lambda k: int(k.rsplit("_", 1)[1]))


def load_flax_pillars(path, device) -> Dict[str, torch.Tensor]:
    with open(Path(path), "rb") as f:
        tree = pickle.load(f)
    params, stats = tree["params"], tree["batch_stats"]
    out: Dict[str, np.ndarray] = {}

    def bn(name, p, s):
        out[f"{name}.weight"] = p["scale"]
        out[f"{name}.bias"] = p["bias"]
        out[f"{name}.running_mean"] = s["mean"]
        out[f"{name}.running_var"] = s["var"]

    pfn_p, pfn_s = params["PillarFeatureNet_0"], stats["PillarFeatureNet_0"]
    for i, layer in enumerate(_numbered(pfn_p, "PFNLayer")):
        base = f"voxel_feature_extractor.pfn_layers.{i}"
        out[f"{base}.linear.weight"] = pfn_p[layer]["Dense_0"]["kernel"].T
        bn(f"{base}.norm", pfn_p[layer]["BatchNorm_0"],
           pfn_s[layer]["BatchNorm_0"])
    rp, rs = params["RPN_0"], stats["RPN_0"]
    for i, blk in enumerate(_numbered(rp, "ConvBlock")):
        for j, conv in enumerate(_numbered(rp[blk], "Conv")):
            out[f"rpn.blocks.{i}.{3 * j + 1}.weight"] = (
                rp[blk][conv]["kernel"].transpose(3, 2, 0, 1))
            bn(f"rpn.blocks.{i}.{3 * j + 2}", rp[blk][f"BatchNorm_{j}"],
               rs[blk][f"BatchNorm_{j}"])
    for i, up in enumerate(_numbered(rp, "Upsample")):
        k = rp[up]["ConvTranspose_0"]["kernel"]
        out[f"rpn.deblocks.{i}.0.weight"] = (
            k[::-1, ::-1].transpose(2, 3, 0, 1))
        bn(f"rpn.deblocks.{i}.1", rp[up]["BatchNorm_0"], rs[up]["BatchNorm_0"])
    for head in ("conv_cls", "conv_box", "conv_dir_cls"):
        out[f"rpn.{head}.weight"] = rp[head]["kernel"].transpose(3, 2, 0, 1)
        out[f"rpn.{head}.bias"] = rp[head]["bias"]
    return {k: torch.as_tensor(np.asarray(v, np.float32).copy(order="C"),
                               device=device) for k, v in out.items()}
