"""Batched on-device serving: voxelize -> network -> decode + NMS.

The port of the JAX package's ``parallel/inference.py::PodInference`` in
hard-voxelization mode on one device (no mesh).  A request is a padded
point buffer ``[B, P, C]`` plus ``num_valid [B]``; the answer is a numpy
dict with the keys and shapes of the JAX ``PodInference.__call__``.
Dynamic voxelization and multi-device meshes wait for later slices.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..builder import (config_io, second_builder, target_assigner_builder,
                       voxel_builder)
from ..device import resolve_device
from ..models import voxelnet as voxelnet_mod
from ..ops.voxelize import voxelize
from ..utils.seeded_init import load_seeded
from ..utils.weight_import import load_variables


class PodInference:
    """Serve a built VoxelNet (pillar or SECOND sparse middle) on one
    device, batch by batch."""

    def __init__(self, model: voxelnet_mod.VoxelNet,
                 model_cfg: voxelnet_mod.VoxelNetConfig,
                 anchors: np.ndarray, *, device="cuda",
                 max_voxels: int = 20000, max_points_per_voxel: int = 32):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model_cfg
        self.anchors = torch.as_tensor(np.asarray(anchors, np.float32),
                                       device=self.device)      # [A, 7]
        self.max_voxels = int(max_voxels)
        self.max_points_per_voxel = int(max_points_per_voxel)

    @torch.no_grad()
    def __call__(self, points: np.ndarray,
                 num_valid: np.ndarray) -> Dict[str, np.ndarray]:
        """points [B, P, C] padded, num_valid [B] -> detection dict
        (host numpy, padded, with a validity mask)."""
        cfg = self.cfg
        pts = torch.as_tensor(np.asarray(points, np.float32),
                              device=self.device)
        nv = torch.as_tensor(np.asarray(num_valid, np.int32),
                             device=self.device)
        vox = voxelize(pts, nv, voxel_size=cfg.voxel_size,
                       pc_range=cfg.pc_range, grid_size=cfg.grid_size,
                       max_points=self.max_points_per_voxel,
                       max_voxels=self.max_voxels)
        preds = self.model(vox.voxels, vox.num_points, vox.coords)
        anchors = self.anchors[None].expand(pts.shape[0],
                                            *self.anchors.shape)
        out = voxelnet_mod.predict(preds, anchors, cfg)
        return {k: v.cpu().numpy() for k, v in out.items()}

    @staticmethod
    def detections_list(out: Dict[str, np.ndarray]):
        """Split a padded output dict into per-scan detection dicts."""
        dets = []
        for b in range(out["box3d_lidar"].shape[0]):
            v = out["valid"][b]
            dets.append({
                "box3d_lidar": out["box3d_lidar"][b][v],
                "scores": out["scores"][b][v],
                "label_preds": out["label_preds"][b][v],
            })
        return dets


def detections_mismatch(got: Dict[str, np.ndarray],
                        ref: Dict[str, np.ndarray], num_class: int,
                        box_atol: float = 1e-3,
                        score_atol: float = 1e-4) -> Optional[str]:
    """Compare two padded detection dicts as sets per (scan, class):
    equal counts, and each detection of ``got`` matched to its own
    detection of ``ref`` with boxes within ``box_atol`` and scores within
    ``score_atol``.  Returns None when they agree, else what differs."""
    for k in ref:
        if got[k].shape != ref[k].shape:
            return f"{k}: shape {got[k].shape} != {ref[k].shape}"
    for b in range(ref["valid"].shape[0]):
        for c in range(num_class):
            sel_g = got["valid"][b] & (got["label_preds"][b] == c)
            sel_r = ref["valid"][b] & (ref["label_preds"][b] == c)
            if sel_g.sum() != sel_r.sum():
                return (f"scan {b} class {c}: {sel_g.sum()} vs "
                        f"{sel_r.sum()} detections")
            boxes_r = ref["box3d_lidar"][b][sel_r]
            scores_r = ref["scores"][b][sel_r]
            used = np.zeros(len(boxes_r), bool)
            for box, score in zip(got["box3d_lidar"][b][sel_g],
                                  got["scores"][b][sel_g]):
                ok = (~used
                      & (np.abs(boxes_r - box).max(-1) <= box_atol)
                      & (np.abs(scores_r - score) <= score_atol))
                if not ok.any():
                    return f"scan {b} class {c}: no match for {box} {score}"
                used[np.flatnonzero(ok)[0]] = True
    return None


def build_from_config(config_path):
    """Config file -> (VoxelNet, VoxelNetConfig, anchors [A, 7] float32)."""
    m = config_io.load_config(config_path)["model"]["second"]
    grid = voxel_builder.build(m["voxel_generator"])
    assigner = target_assigner_builder.build(m["target_assigner"],
                                             m.get("box_coder", {}))
    model, cfg, fmap = second_builder.build(m, grid, assigner)
    anchors = assigner.generate_anchors(fmap)["anchors"].reshape(-1, 7)
    return model, cfg, anchors.astype(np.float32)


def load_checkpoint_variables(path) -> dict:
    """A checkpoint pickle of the JAX package (``{"params",
    "batch_stats"}`` as nested dicts of numpy arrays, e.g.
    ``artifacts/asbuilt_r2_step8000.pkl``) -> that dict."""
    with open(Path(path), "rb") as f:
        variables = pickle.load(f)
    if not isinstance(variables, dict) or "params" not in variables:
        raise ValueError(f"{path}: not a params/batch_stats checkpoint")
    return variables


def pod_inference_from_checkpoint(config_path, checkpoint_pkl, *,
                                  device="cuda", max_voxels: int = 20000,
                                  max_points_per_voxel: int = 32,
                                  seed: int = 0) -> PodInference:
    """Build a :class:`PodInference` straight from a config file and a
    checkpoint pickle — the one-call serving entry point.  With
    ``checkpoint_pkl=None`` it warns and serves random weights and
    BatchNorm statistics drawn from ``seed`` (as the JAX entry point
    serves fresh weights when it finds no checkpoint)."""
    dev = resolve_device(device)
    model, cfg, anchors = build_from_config(config_path)
    if checkpoint_pkl is None:
        print(f"WARNING: no checkpoint; serving random weights from seed "
              f"{seed}")
        load_seeded(model, seed)
    else:
        load_variables(model, load_checkpoint_variables(checkpoint_pkl))
    return PodInference(model, cfg, anchors, device=dev,
                        max_voxels=max_voxels,
                        max_points_per_voxel=max_points_per_voxel)
