"""Weights in and out of the port: JAX-package variables and lineage
torch checkpoints -> the port's ``state_dict``.

The JAX package's variables (``{"params": ..., "batch_stats": ...}``:
nested dicts of arrays, as ``model.init`` returns them and as the repo's
checkpoint pickles hold them) map to the lineage-named torch tensors the
port's modules carry — the port's own copy of the mapping in the JAX
package's ``utils/weight_import.py::to_torch_state_dict`` (:276), for the
pillar VFE, the VoxelNet VFEs (``vfe{i}`` from 1 and the trailing
``linear`` / ``norm``), the sparse middle and the RPN (a fractional
upsample's plain conv included; ``SimpleVoxel`` has no variables).  That
mapping has no slot for ``DenseMiddle`` or the yaw-quality head's
``conv_quality``, and neither has the port's; :func:`load_variables`
carries them into the port's own names besides (:func:`port_only_state`):

==============================  =======================================
flax                            torch
==============================  =======================================
Conv ``(kh, kw, I, O)``         Conv2d ``(O, I, kh, kw)`` — transpose(3,2,0,1)
ConvTranspose ``(kh, kw, I, O)``  ConvTranspose2d ``(I, O, kh, kw)`` —
                                flip((0, 1)) then transpose(2,3,0,1)
Conv ``(kd, kh, kw, I, O)``     Conv3d ``(O, I, kd, kh, kw)`` —
                                transpose(4,3,0,1,2) (port-only)
Dense ``(I, O)``                Linear ``(O, I)`` — ``.T``
BatchNorm scale/bias + mean/var weight/bias + running_mean/running_var
sparse conv ``(K, I, O)``       spconv 1.x ``(kz, ky, kx, I, O)`` — reshape
==============================  =======================================

A lineage ``second.pytorch`` checkpoint needs less: the port's modules
carry the lineage names and layouts (``rpn.blocks.{i}.{j}``,
``middle_feature_extractor.middle_conv.{n}``,
``voxel_feature_extractor.pfn_layers.{i}``, ...), so
:func:`from_torch_state_dict` (the port's copy of the JAX package's
``from_torch_state_dict``, :208) checks the keys and shapes against the
model's own and converts only a spconv 2.x weight ``(O, kz, ky, kx, I)``
to the 1.x layout the port holds (:func:`import_spconv`, the
counterpart of ``_import_spconv`` :194).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from ..models.middle import DenseMiddle


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

    unknown = [k for k in params if not re.fullmatch(_SCOPES, k)]
    if unknown:
        raise ValueError(f"variables hold {unknown}: not a VoxelNet's")

    def linear(base: str, p: Dict[str, Any]) -> None:
        out[f"{base}.weight"] = np.asarray(p["kernel"]).T

    for scope in _children(params, r"PillarFeatureNet_\d+"):
        for i, layer in enumerate(_children(params[scope], r"PFNLayer_\d+")):
            base = f"voxel_feature_extractor.pfn_layers.{i}"
            p = params[scope][layer]
            linear(f"{base}.linear", p["Dense_0"])
            bn(f"{base}.norm", p["BatchNorm_0"],
               stats[scope][layer]["BatchNorm_0"])
    for scope in _children(params, r"VoxelFeatureExtractor(V2)?_\d+"):
        vp, vs = params[scope], stats[scope]
        for i, layer in enumerate(_children(vp, r"VFELayer_\d+")):
            base = f"voxel_feature_extractor.vfe{i + 1}"
            linear(f"{base}.linear", vp[layer]["Dense_0"])
            bn(f"{base}.norm", vp[layer]["BatchNorm_0"],
               vs[layer]["BatchNorm_0"])
        if "Dense_0" in vp:               # the trailing Linear + BN
            linear("voxel_feature_extractor.linear", vp["Dense_0"])
        if "BatchNorm_0" in vp:
            bn("voxel_feature_extractor.norm", vp["BatchNorm_0"],
               vs["BatchNorm_0"])
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
            if "ConvTranspose_0" in rp[up]:
                w = np.asarray(rp[up]["ConvTranspose_0"]["kernel"])
                out[f"rpn.deblocks.{i}.0.weight"] = np.flip(
                    w, (0, 1)).transpose(2, 3, 0, 1)
            else:                         # fractional stride: a plain conv
                conv(f"rpn.deblocks.{i}.0", rp[up]["Conv_0"])
            bn(f"rpn.deblocks.{i}.1", rp[up]["BatchNorm_0"],
               rs[up]["BatchNorm_0"])
        for head in ("conv_cls", "conv_box", "conv_dir_cls"):
            if head in rp:
                conv(f"rpn.{head}", rp[head], with_bias=True)
    return out


_SCOPES = (r"(PillarFeatureNet|VoxelFeatureExtractor|VoxelFeatureExtractorV2"
           r"|SimpleVoxel|SimpleVoxelRadius|RPN|PointPillarsScatter"
           r"|SparseMiddle|DenseMiddle)_\d+")


def port_only_state(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The variables the lineage mapping has no slot for, under the port's
    own names: ``DenseMiddle``'s convolutions (flax ``Conv_i``
    ``(kd, kh, kw, I, O)`` -> ``middle_feature_extractor.middle_conv.{3i}``
    ``(O, I, kd, kh, kw)``) and BatchNorms (``BatchNorm_i`` ->
    ``middle_conv.{3i + 1}``), and the RPN's ``conv_quality``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    for scope in _children(params, r"DenseMiddle_\d+"):
        base = "middle_feature_extractor.middle_conv"
        for i, c in enumerate(_children(params[scope], r"Conv_\d+")):
            out[f"{base}.{3 * i}.weight"] = np.asarray(
                params[scope][c]["kernel"]).transpose(4, 3, 0, 1, 2)
            p = params[scope][f"BatchNorm_{i}"]
            st = stats[scope][f"BatchNorm_{i}"]
            out[f"{base}.{3 * i + 1}.weight"] = np.asarray(p["scale"])
            out[f"{base}.{3 * i + 1}.bias"] = np.asarray(p["bias"])
            out[f"{base}.{3 * i + 1}.running_mean"] = np.asarray(st["mean"])
            out[f"{base}.{3 * i + 1}.running_var"] = np.asarray(st["var"])
    for scope in _children(params, r"RPN_\d+"):
        if "conv_quality" in params[scope]:
            p = params[scope]["conv_quality"]
            out["rpn.conv_quality.weight"] = np.asarray(
                p["kernel"]).transpose(3, 2, 0, 1)
            out["rpn.conv_quality.bias"] = np.asarray(p["bias"])
    return out


def load_variables(model: nn.Module, variables: Dict[str, Any]) -> None:
    """Load JAX-package variables into ``model`` with ``strict=True``: the
    lineage mapping and :func:`port_only_state`.

    BatchNorm's ``num_batches_tracked`` counters (torch-only, unused in
    eval) are set to 0."""
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
          for k, v in {**to_torch_state_dict(variables),
                       **port_only_state(variables)}.items()}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            sd[f"{name}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
    model.load_state_dict(sd, strict=True)


def import_spconv(w, kernel: Sequence[int], cin: int,
                  cout: int) -> np.ndarray:
    """A lineage sparse-conv weight -> spconv 1.x ``(kz, ky, kx, cin,
    cout)``, the layout of ``models/middle.py::SparseConvWeight``: a 1.x
    weight ``(k, k, k, cin, cout)`` as it is (its taps refactored to
    ``kernel``), a 2.x weight ``(cout, k, k, k, cin)`` transposed.  Raises
    ``ValueError`` on any other shape."""
    w = _to_np(w)
    kernel = tuple(int(k) for k in kernel)
    K = int(np.prod(kernel))
    if w.ndim != 5:
        raise ValueError(f"spconv weight must be 5D, got {w.shape}")
    if int(np.prod(w.shape[:3])) == K and w.shape[3:] == (cin, cout):
        return w.reshape(*kernel, cin, cout)              # spconv 1.x
    if (w.shape[0] == cout and int(np.prod(w.shape[1:4])) == K
            and w.shape[4] == cin):                       # spconv 2.x
        return w.transpose(1, 2, 3, 4, 0).reshape(*kernel, cin, cout)
    raise ValueError(
        f"spconv weight {w.shape} matches neither (k,k,k,{cin},{cout}) "
        f"nor ({cout},k,k,k,{cin}) with prod(k)={K}")


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        t = t.numpy()
    return np.asarray(t)


def from_torch_state_dict(state_dict: Dict[str, Any], model: nn.Module,
                          strict: bool = True) -> nn.Module:
    """Map a lineage torch ``state_dict`` (torch tensors or numpy arrays)
    onto a built port ``VoxelNet`` and load it (``strict=True``); returns
    the model.

    The expected keys are the model's own (BatchNorm weight, bias,
    running_mean and running_var, Conv2d, ConvTranspose2d, Linear, spconv,
    the head biases), as the JAX package's ``_build_spec`` (:102) fixes
    them; BatchNorm's ``num_batches_tracked`` counters keep the model's
    values, and extra keys (lineage-only counters, keys of no slot) are
    ignored.  The tensors the JAX mapping has no slot for (a
    ``DenseMiddle``'s, ``conv_quality``'s) keep the model's values, as
    the JAX import keeps the variables' there.  Each converted shape is
    checked against the module's tensor (``ValueError`` naming the key).
    ``strict``: raise ``KeyError`` on missing keys, naming the first four
    and the first four unmatched torch keys; ``strict=False`` keeps the
    model's values for them.
    """
    sd = {k: _to_np(v) for k, v in state_dict.items()}
    new = model.state_dict()
    no_slot = tuple(f"{name}." for name, mod in model.named_modules()
                    if isinstance(mod, DenseMiddle)
                    or name.endswith("rpn.conv_quality"))
    used, missing = set(), []
    for key, cur in new.items():
        if key.endswith(".num_batches_tracked") or key.startswith(no_slot):
            continue
        if key not in sd:
            missing.append(key)
            continue
        used.add(key)
        w = sd[key]
        if cur.dim() == 5:                 # SparseConvWeight
            w = import_spconv(w, cur.shape[:3], cur.shape[3], cur.shape[4])
        if tuple(w.shape) != tuple(cur.shape):
            raise ValueError(f"{key}: converted shape {tuple(w.shape)} != "
                             f"expected {tuple(cur.shape)}")
        new[key] = torch.from_numpy(np.array(w, order="C")).to(cur.dtype)
    if strict and missing:
        extra = sorted(set(sd) - used)
        raise KeyError(
            f"state_dict missing {len(missing)} expected keys "
            f"(first: {missing[:4]}); unmatched torch keys: {extra[:4]}")
    model.load_state_dict(new, strict=True)
    return model


def load_torch_checkpoint(path, model: nn.Module,
                          strict: bool = True) -> nn.Module:
    """``torch.load`` a lineage ``.tckpt`` / ``.pt`` file (a state_dict,
    or ``{"state_dict": ...}``) and import it into ``model``
    (:func:`from_torch_state_dict`)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return from_torch_state_dict(obj, model, strict=strict)
