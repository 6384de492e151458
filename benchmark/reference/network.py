"""The detector's forward pass in plain PyTorch, in float32, in eval mode:
voxel encoder, middle, RPN and heads.

Weights come as one ``{name: tensor}`` dict in the lineage (second.pytorch)
layout: ``voxel_feature_extractor.pfn_layers.{i}.{linear,norm}``,
``middle_feature_extractor.middle_conv.{3n}`` (a sparse conv's weight
``(kz, ky, kx, Cin, Cout)``) and ``.{3n+1}`` (its BatchNorm),
``rpn.blocks.{i}.{j}``, ``rpn.deblocks.{i}.{0,1}``, ``rpn.conv_{cls,box,
dir_cls}``.  :func:`param_specs` lists them for a model description (the
``model`` object of a configuration file under ``benchmark/configs``).

- Pillar encoder (PointPillars, Lang et al. 2019): each point decorated
  with its offset from the pillar's mean and from the pillar's centre,
  one linear layer, BatchNorm, ReLU, the max over the pillar's points,
  then the pillars written into a [B, C, H, W] canvas.
- Mean encoder (SECOND, Yan et al. 2018): the mean of a voxel's points.
- Sparse middle: per block ``n_subm`` submanifold 3-D convolutions
  (outputs at the input sites) and one strided sparse convolution
  (outputs wherever the receptive field holds an input site; the first
  ``site_cap`` output sites in key order ``(y * W + x) * D + z`` when a
  cap is set), each followed by BatchNorm on the active sites and ReLU.
  The last block's sites go to a dense [B, H, W, D * C] map, channel
  ``d * C + c``.  Each tap is found by a sorted-key search.
- RPN: per block a strided 3x3 convolution and ``layer_nums`` more, each
  with BatchNorm and ReLU, an upsampling transposed convolution per
  block, the upsampled maps concatenated, 1x1 heads.

BatchNorm's epsilon is 1e-3 throughout.  ``tf32=True`` lets the
convolutions and products run in TF32 (the lower-precision control).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .voxelize import grid_size

BN_EPS = 1e-3
INT64_MAX = 2**62


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products with TF32 off (``tf32=False``) or on."""
    b = torch.backends
    old = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = old


# ----------------------------------------------------------------- specs

def _bn(name: str, c: int, specs: list, counted: bool = True) -> None:
    specs += [(f"{name}.weight", (c,), "bn_weight"),
              (f"{name}.bias", (c,), "bn_bias"),
              (f"{name}.running_mean", (c,), "bn_mean"),
              (f"{name}.running_var", (c,), "bn_var")]
    if counted:
        specs.append((f"{name}.num_batches_tracked", (), "count"))


def middle_blocks(model: dict) -> List[dict]:
    """The sparse middle's blocks with their grids: n_subm, subm_cout,
    cout, kernel, stride, pad, grid (D, H, W) in, out_grid, site_cap."""
    mid = model["middle"]
    gx, gy, gz = grid_size(model["voxel"]["pc_range"],
                           model["voxel"]["voxel_size"])
    grid = (int(gz) + int(mid.get("z_pad", 0)), int(gy), int(gx))
    out = []
    caps = mid.get("site_caps") or [None] * len(mid["blocks"])
    for (n_subm, subm_cout, cout, k, s, p), cap in zip(mid["blocks"], caps):
        og = tuple((g + 2 * pp - kk) // ss + 1
                   for g, pp, kk, ss in zip(grid, p, k, s))
        out.append(dict(n_subm=n_subm, subm_cout=subm_cout, cout=cout,
                        kernel=tuple(k), stride=tuple(s), pad=tuple(p),
                        grid=grid, out_grid=og, site_cap=cap))
        grid = og
    return out


def rpn_input_channels(model: dict) -> int:
    if model["middle"]["kind"] == "sparse":
        blocks = middle_blocks(model)
        return blocks[-1]["cout"] * blocks[-1]["out_grid"][0]
    return model["vfe"]["num_filters"][-1]


def param_specs(model: dict) -> List[Tuple[str, tuple, str]]:
    """[(name, shape, kind)] of every weight and statistic the model
    needs; kind is one of conv, convt, linear, sparse, head_cls, head_box,
    head, bias_cls, bias, bn_weight, bn_bias, bn_mean, bn_var, count."""
    specs: list = []
    vfe, head, rpn = model["vfe"], model["head"], model["rpn"]
    if vfe["kind"] == "pillar":
        cin = vfe["num_input_features"] + 5
        for i, units in enumerate(vfe["num_filters"]):
            base = f"voxel_feature_extractor.pfn_layers.{i}"
            specs.append((f"{base}.linear.weight", (units, cin), "linear"))
            _bn(f"{base}.norm", units, specs)
            cin = 2 * units
    if model["middle"]["kind"] == "sparse":
        cin, n = vfe["num_input_features"], 0
        for blk in middle_blocks(model):
            layers = ([((3, 3, 3), blk["subm_cout"])] * blk["n_subm"]
                      + [(blk["kernel"], blk["cout"])])
            for kernel, cout in layers:
                base = f"middle_feature_extractor.middle_conv.{3 * n}"
                specs.append((f"{base}.weight", (*kernel, cin, cout),
                              "sparse"))
                _bn(f"middle_feature_extractor.middle_conv.{3 * n + 1}",
                    cout, specs, counted=False)
                cin, n = cout, n + 1
    cin = rpn_input_channels(model)
    for i, (layers, f) in enumerate(zip(rpn["layer_nums"],
                                        rpn["num_filters"])):
        for j in range(layers + 1):
            specs.append((f"rpn.blocks.{i}.{3 * j + 1}.weight",
                          (f, cin if j == 0 else f, 3, 3), "conv"))
            _bn(f"rpn.blocks.{i}.{3 * j + 2}", f, specs)
        s, up = rpn["upsample_strides"][i], rpn["num_upsample_filters"][i]
        if s < 1:
            raise NotImplementedError("a fractional upsample stride")
        s = int(round(s))
        specs.append((f"rpn.deblocks.{i}.0.weight", (f, up, s, s), "convt"))
        _bn(f"rpn.deblocks.{i}.1", up, specs)
        cin = f
    ch = sum(rpn["num_upsample_filters"][:len(rpn["layer_nums"])])
    a = num_anchors_per_loc(model)
    for name, c, kind in (("conv_cls", a * head["num_class"], "head_cls"),
                          ("conv_box", a * head["box_code_size"],
                           "head_box"),
                          ("conv_dir_cls", a * head["num_direction_bins"],
                           "head")):
        specs.append((f"rpn.{name}.weight", (c, ch, 1, 1), kind))
        specs.append((f"rpn.{name}.bias", (c,),
                      "bias_cls" if name == "conv_cls" else "bias"))
    return specs


def num_anchors_per_loc(model: dict) -> int:
    return sum(len(a["rotations"]) for a in model["anchors"])


# ---------------------------------------------------------------- layers

def batch_norm(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
               channel_dim: int = 1) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    mean = w[f"{name}.running_mean"].view(shape)
    var = w[f"{name}.running_var"].view(shape)
    scale = w[f"{name}.weight"].view(shape) / torch.sqrt(var + BN_EPS)
    return (x - mean) * scale + w[f"{name}.bias"].view(shape)


def pillar_features(voxels, num_points, coords, model, w) -> torch.Tensor:
    """[B, V, T, C] -> [B, V, F]: decorations, linear, BN, ReLU, max."""
    vfe = model["vfe"]
    vx, vy = (float(np.float32(v)) for v in model["voxel"]["voxel_size"][:2])
    x0, y0 = (float(np.float32(v)) for v in model["voxel"]["pc_range"][:2])
    T = voxels.shape[2]
    mask = (torch.arange(T, device=voxels.device)[None, None, :]
            < num_points[..., None]).float()[..., None]        # [B,V,T,1]
    n = torch.clamp(num_points, min=1).float()[..., None, None]
    mean = (voxels[..., :3] * mask).sum(2, keepdim=True) / n
    cx = coords[..., 2].float() * vx + (x0 + vx / 2)
    cy = coords[..., 1].float() * vy + (y0 + vy / 2)
    x = torch.cat([voxels[..., :vfe["num_input_features"]],
                   voxels[..., :3] - mean,
                   (voxels[..., 0] - cx[..., None])[..., None],
                   (voxels[..., 1] - cy[..., None])[..., None]], -1) * mask
    for i, _ in enumerate(vfe["num_filters"]):
        base = f"voxel_feature_extractor.pfn_layers.{i}"
        y = x @ w[f"{base}.linear.weight"].t()
        y = torch.relu(batch_norm(y, w, f"{base}.norm", channel_dim=-1))
        y = y * mask
        top = y.max(dim=2, keepdim=True).values
        x = torch.cat([y, top.expand_as(y)], -1)
    return top[:, :, 0, :]


def pillar_canvas(features, coords, model) -> torch.Tensor:
    """[B, V, F] pillars -> [B, F, H, W] canvas, zeros where none."""
    gx, gy, _ = (int(g) for g in grid_size(model["voxel"]["pc_range"],
                                           model["voxel"]["voxel_size"]))
    B, V, Fc = features.shape
    canvas = torch.zeros((B, Fc, gy, gx), dtype=features.dtype,
                         device=features.device)
    for b in range(B):
        ok = coords[b, :, 0] >= 0
        c = coords[b][ok].long()
        canvas[b, :, c[:, 1], c[:, 2]] = features[b][ok].t()
    return canvas


def mean_features(voxels, num_points, model) -> torch.Tensor:
    """[B, V, T, C] -> [B, V, C']: the mean of each voxel's points."""
    c = model["vfe"]["num_input_features"]
    T = voxels.shape[2]
    mask = (torch.arange(T, device=voxels.device)[None, None, :]
            < num_points[..., None]).float()[..., None]
    return ((voxels[..., :c] * mask).sum(2)
            / torch.clamp(num_points, min=1).float()[..., None])


def _keys(c: torch.Tensor, grid) -> torch.Tensor:
    """(z, y, x) int64 [N, 3] -> keys (y * W + x) * D + z; outside the
    grid INT64_MAX."""
    D, H, W = grid
    inside = ((c >= 0) & (c < torch.tensor(grid, device=c.device))).all(1)
    key = (c[:, 1] * W + c[:, 2]) * D + c[:, 0]
    return torch.where(inside, key, torch.full_like(key, INT64_MAX))


def _lookup(sorted_keys, order, q):
    """Row of each query key among ``sorted_keys`` (-1 where none)."""
    if len(sorted_keys) == 0:
        return torch.full_like(q, -1)
    pos = torch.searchsorted(sorted_keys, q).clamp(max=len(sorted_keys) - 1)
    return torch.where(sorted_keys[pos] == q, order[pos],
                       torch.full_like(q, -1))


def _tap_rows(in_coords, in_grid, out_coords, kernel, stride, pad,
              centred: bool):
    """Per tap t, the input row at ``o * stride + t - pad`` of each output
    site o (taps centred for a submanifold conv), -1 where none."""
    dev = in_coords.device
    skeys, order = torch.sort(_keys(in_coords, in_grid))
    kz, ky, kx = kernel
    taps = torch.stack(torch.meshgrid(
        torch.arange(kz), torch.arange(ky), torch.arange(kx),
        indexing="ij"), -1).reshape(-1, 3).to(dev)
    off = taps - torch.tensor([kz // 2, ky // 2, kx // 2] if centred
                              else list(pad), device=dev)
    st = torch.tensor(stride, device=dev)
    for t in range(len(taps)):
        yield t, _lookup(skeys, order,
                         _keys(out_coords * st + off[t], in_grid))


def _hits(in_coords, in_grid, out_coords, kernel, stride, pad,
          centred) -> int:
    return sum(int((row >= 0).sum()) for _, row in _tap_rows(
        in_coords, in_grid, out_coords, kernel, stride, pad, centred))


def _join(feats, in_coords, in_grid, out_coords, weight, kernel, stride,
          pad, centred: bool):
    """out[o] = sum over taps t of feats[input row of tap t] @ W[t]."""
    w = weight.reshape(-1, weight.shape[-2], weight.shape[-1])
    out = torch.zeros((len(out_coords), w.shape[-1]), dtype=feats.dtype,
                      device=feats.device)
    for t, row in _tap_rows(in_coords, in_grid, out_coords, kernel, stride,
                            pad, centred):
        hit = row >= 0
        out[hit] += feats[row[hit]] @ w[t]
    return out


def _strided_sites(coords, blk) -> torch.Tensor:
    """Output sites of a strided sparse conv, ascending key, capped."""
    s = torch.tensor(blk["stride"], device=coords.device)
    p = torch.tensor(blk["pad"], device=coords.device)
    kz, ky, kx = blk["kernel"]
    taps = torch.stack(torch.meshgrid(
        torch.arange(kz), torch.arange(ky), torch.arange(kx),
        indexing="ij"), -1).reshape(-1, 3).to(coords.device)
    cand = coords[None] + p - taps[:, None]                  # [T, N, 3]
    ok = (cand % s == 0).all(-1)
    o = torch.div(cand[ok], s, rounding_mode="floor")
    keys = torch.unique(_keys(o, blk["out_grid"]))
    keys = keys[keys != INT64_MAX]
    if blk["site_cap"] is not None:
        keys = keys[:int(blk["site_cap"])]
    D, H, W = blk["out_grid"]
    return torch.stack([keys % D, keys // (W * D), (keys // D) % W], 1)


def sparse_middle(features, coords, model, w) -> torch.Tensor:
    """[B, V, C] voxel features + (z, y, x) coords -> [B, D*C, H, W]."""
    blocks = middle_blocks(model)
    B = features.shape[0]
    last = blocks[-1]
    D, H, W = last["out_grid"]
    bev = torch.zeros((B, H, W, D, last["cout"]), dtype=features.dtype,
                      device=features.device)
    for b in range(B):
        ok = coords[b, :, 0] >= 0
        x, c = features[b][ok], coords[b][ok].long()
        n = 0
        for blk in blocks:
            for _ in range(blk["n_subm"]):
                name = f"middle_feature_extractor.middle_conv.{3 * n}"
                y = _join(x, c, blk["grid"], c, w[f"{name}.weight"],
                          (3, 3, 3), (1, 1, 1), (1, 1, 1), True)
                x = torch.relu(batch_norm(
                    y, w, f"middle_feature_extractor.middle_conv."
                          f"{3 * n + 1}"))
                n += 1
            oc = _strided_sites(c, blk)
            name = f"middle_feature_extractor.middle_conv.{3 * n}"
            y = _join(x, c, blk["grid"], oc, w[f"{name}.weight"],
                      blk["kernel"], blk["stride"], blk["pad"], False)
            x = torch.relu(batch_norm(
                y, w, f"middle_feature_extractor.middle_conv.{3 * n + 1}"))
            c, n = oc, n + 1
        bev[b, c[:, 1], c[:, 2], c[:, 0]] = x
    return bev.reshape(B, H, W, D * last["cout"]).permute(0, 3, 1, 2)


def sparse_hits(coords, model) -> List[Tuple[int, int, int]]:
    """(hits, Cin, Cout) of each sparse convolution, summed over the
    scans of ``coords`` [B, V, 3]."""
    totals: List[list] = []
    for b in range(coords.shape[0]):
        c = coords[b][coords[b, :, 0] >= 0].long()
        n, cin = 0, model["vfe"]["num_input_features"]
        for blk in middle_blocks(model):
            oc = _strided_sites(c, blk)
            layers = ([(c, (3, 3, 3), (1, 1, 1), (1, 1, 1), True,
                        blk["subm_cout"])] * blk["n_subm"]
                      + [(oc, blk["kernel"], blk["stride"], blk["pad"],
                          False, blk["cout"])])
            for out_c, kernel, stride, pad, centred, cout in layers:
                h = _hits(c, blk["grid"], out_c, kernel, stride, pad,
                          centred)
                if len(totals) <= n:
                    totals.append([0, cin, cout])
                totals[n][0] += h
                cin, n = cout, n + 1
            c = oc
    return [tuple(t) for t in totals]


def rpn_heads(x, model, w) -> Dict[str, torch.Tensor]:
    """[B, C, H, W] -> {box_preds, cls_preds, dir_cls_preds} NCHW."""
    rpn = model["rpn"]
    ups = []
    for i, (layers, stride) in enumerate(zip(rpn["layer_nums"],
                                             rpn["layer_strides"])):
        for j in range(layers + 1):
            x = F.conv2d(x, w[f"rpn.blocks.{i}.{3 * j + 1}.weight"],
                         stride=stride if j == 0 else 1, padding=1)
            x = torch.relu(batch_norm(x, w, f"rpn.blocks.{i}.{3 * j + 2}"))
        s = int(round(rpn["upsample_strides"][i]))
        u = F.conv_transpose2d(x, w[f"rpn.deblocks.{i}.0.weight"], stride=s)
        ups.append(torch.relu(batch_norm(u, w, f"rpn.deblocks.{i}.1")))
    x = torch.cat(ups, 1)
    return {k: F.conv2d(x, w[f"rpn.{n}.weight"], w[f"rpn.{n}.bias"])
            for k, n in (("box_preds", "conv_box"), ("cls_preds", "conv_cls"),
                         ("dir_cls_preds", "conv_dir_cls"))}


def heads(vox, model, w, *, tf32: bool = False) -> Dict[str, torch.Tensor]:
    """Voxels (voxelize.Voxels) -> the network's head maps."""
    with precision(tf32), torch.no_grad():
        if model["vfe"]["kind"] == "pillar":
            f = pillar_features(vox.voxels, vox.num_points, vox.coords,
                                model, w)
        else:
            f = mean_features(vox.voxels, vox.num_points, model)
        if model["middle"]["kind"] == "sparse":
            x = sparse_middle(f, vox.coords, model, w)
        else:
            x = pillar_canvas(f, vox.coords, model)
        return rpn_heads(x, model, w)
