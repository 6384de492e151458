"""JAX-package variables -> the port's ``state_dict``.

The JAX package's variables (``{"params": ..., "batch_stats": ...}``:
nested dicts of arrays, as ``model.init`` returns them and as the repo's
checkpoint pickles hold them) map to the lineage-named torch tensors the
port's modules carry — the port's own copy of the mapping in the JAX
package's ``utils/weight_import.py::to_torch_state_dict`` (:276), for the
pillar VFE, the sparse middle and the RPN (``SimpleVoxel`` has no
variables):

==============================  =======================================
flax                            torch
==============================  =======================================
Conv ``(kh, kw, I, O)``         Conv2d ``(O, I, kh, kw)`` — transpose(3,2,0,1)
ConvTranspose ``(kh, kw, I, O)``  ConvTranspose2d ``(I, O, kh, kw)`` —
                                flip((0, 1)) then transpose(2,3,0,1)
Dense ``(I, O)``                Linear ``(O, I)`` — ``.T``
BatchNorm scale/bias + mean/var weight/bias + running_mean/running_var
sparse conv ``(K, I, O)``       spconv 1.x ``(kz, ky, kx, I, O)`` — reshape
==============================  =======================================
"""
from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn


# tap count -> (kz, ky, kx): every kernel the lineage middles use
_KERNEL_OF_TAPS = {27: (3, 3, 3), 3: (3, 1, 1), 1: (1, 1, 1)}


def _natkey(name: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def _children(tree: Dict[str, Any], pattern: str) -> List[str]:
    rx = re.compile(pattern)
    return sorted((k for k in tree if rx.fullmatch(k)), key=_natkey)


def to_torch_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Variables of a ``VoxelNet`` -> lineage-named numpy arrays in
    torch layouts (the keys ``to_torch_state_dict`` of the JAX package
    emits for the same tree)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}

    def bn(base: str, p: Dict[str, Any], st: Dict[str, Any]) -> None:
        out[f"{base}.weight"] = np.asarray(p["scale"])
        out[f"{base}.bias"] = np.asarray(p["bias"])
        out[f"{base}.running_mean"] = np.asarray(st["mean"])
        out[f"{base}.running_var"] = np.asarray(st["var"])

    def conv(base: str, p: Dict[str, Any], with_bias: bool = False) -> None:
        out[f"{base}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
        if with_bias:
            out[f"{base}.bias"] = np.asarray(p["bias"])

    unknown = [k for k in params if not re.fullmatch(
        r"(PillarFeatureNet|RPN|PointPillarsScatter|SparseMiddle)_\d+", k)]
    if unknown:
        raise NotImplementedError(
            f"variables hold {unknown}: only the pillar VFE, the sparse "
            f"middle and the RPN are ported")
    for scope in _children(params, r"PillarFeatureNet_\d+"):
        for i, layer in enumerate(_children(params[scope], r"PFNLayer_\d+")):
            base = f"voxel_feature_extractor.pfn_layers.{i}"
            p = params[scope][layer]
            out[f"{base}.linear.weight"] = np.asarray(
                p["Dense_0"]["kernel"]).T
            bn(f"{base}.norm", p["BatchNorm_0"],
               stats[scope][layer]["BatchNorm_0"])
    for scope in _children(params, r"SparseMiddle_\d+"):
        # lineage Sequential, block by block, submanifold convs before the
        # strided one: conv n at index 3n, its BN at 3n + 1
        names = sorted(
            (k for k in params[scope]
             if re.fullmatch(r"b\d+_(subm\d+|down)_w", k)),
            key=lambda n: (_natkey(n)[1], "subm" not in n, _natkey(n)))
        for n, name in enumerate(names):
            w = np.asarray(params[scope][name])
            K, cin, cout = w.shape
            kernel = _KERNEL_OF_TAPS.get(K, (K, 1, 1))
            base = "middle_feature_extractor.middle_conv"
            out[f"{base}.{3 * n}.weight"] = w.reshape(*kernel, cin, cout)
            bn(f"{base}.{3 * n + 1}", params[scope][name[:-2] + "_bn"],
               stats[scope][name[:-2] + "_bn"])
    for scope in _children(params, r"RPN_\d+"):
        rp, rs = params[scope], stats[scope]
        for i, blk in enumerate(_children(rp, r"ConvBlock_\d+")):
            # lineage Sequential: [ZeroPad2d, Conv, BN, ReLU] + n * (Conv,
            # BN, ReLU) -> conv j = 1, 4, 7, ...; its BN j + 1
            for n, c in enumerate(_children(rp[blk], r"Conv_\d+")):
                j = 1 + 3 * n
                conv(f"rpn.blocks.{i}.{j}", rp[blk][c])
                bn(f"rpn.blocks.{i}.{j + 1}", rp[blk][f"BatchNorm_{n}"],
                   rs[blk][f"BatchNorm_{n}"])
        for i, up in enumerate(_children(rp, r"Upsample_\d+")):
            w = np.asarray(rp[up]["ConvTranspose_0"]["kernel"])
            out[f"rpn.deblocks.{i}.0.weight"] = np.flip(
                w, (0, 1)).transpose(2, 3, 0, 1)
            bn(f"rpn.deblocks.{i}.1", rp[up]["BatchNorm_0"],
               rs[up]["BatchNorm_0"])
        for head in ("conv_cls", "conv_box", "conv_dir_cls"):
            conv(f"rpn.{head}", rp[head], with_bias=True)
        if "conv_quality" in rp:
            raise NotImplementedError("the yaw-quality head is not ported")
    return out


def load_variables(model: nn.Module, variables: Dict[str, Any]) -> None:
    """Load JAX-package variables into ``model`` with ``strict=True``.

    BatchNorm's ``num_batches_tracked`` counters (torch-only, unused in
    eval) are set to 0."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
          for k, v in to_torch_state_dict(variables).items()}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            sd[f"{name}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    model.load_state_dict(sd, strict=True)
