"""Batched on-device serving: voxelize -> network -> decode + NMS.

The port of the JAX package's ``parallel/inference.py::PodInference`` on
one device (no mesh), in its ``"hard"`` and ``"dynamic"`` voxelization
modes and a third, ``"fused_mean"``, that runs the fused voxelize+mean
kernel as the input stage.  A request is a padded point buffer
``[B, P, C]`` plus ``num_valid [B]``; the answer is a numpy dict with the
keys and shapes of the JAX ``PodInference.__call__``.  The network runs
in fp32 with TF32 off whatever the process's global flags
(``device.fp32_math``).  Multi-device meshes wait for a later slice.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..builder import (config_io, second_builder, target_assigner_builder,
                       voxel_builder)
from ..device import fp32_math, resolve_device
from ..models import voxelnet as voxelnet_mod
from ..ops.voxel_mean import fused_voxelize_mean
from ..ops.voxelize import dynamic_voxelize, voxelize
from ..utils.seeded_init import load_seeded
from ..utils.weight_import import load_variables


VOXELIZATIONS = ("hard", "dynamic", "fused_mean")


class PodInference:
    """Serve a built VoxelNet (pillar or SECOND sparse middle) on one
    device, batch by batch."""

    def __init__(self, model: voxelnet_mod.VoxelNet,
                 model_cfg: voxelnet_mod.VoxelNetConfig,
                 anchors: np.ndarray, *, device="cuda",
                 max_voxels: int = 20000, max_points_per_voxel: int = 32,
                 voxelization: str = "hard"):
        """voxelization: ``"hard"`` (FCFS caps, any VFE), ``"dynamic"``
        (cap-free per-voxel means) or ``"fused_mean"`` (the hard
        voxelization's capped means from the fused kernel: the answers of
        ``"hard"``).  The last two feed the model one mean point per voxel
        and so pair with the ``SimpleVoxel`` VFE only, which is the
        identity at T = 1."""
        if voxelization not in VOXELIZATIONS:
            raise ValueError(f"voxelization {voxelization!r}: want one of "
                             f"{VOXELIZATIONS}")
        if voxelization != "hard" and model_cfg.vfe_name != "SimpleVoxel":
            raise ValueError(
                f"voxelization {voxelization!r} hands the model per-voxel "
                f"means: it needs the SimpleVoxel VFE, not "
                f"{model_cfg.vfe_name}")
        self.voxelization = voxelization
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
        pts, nv = self._device_inputs(points, num_valid)
        with fp32_math():
            preds = self.model(*self.voxelize(pts, nv))
            anchors = self.anchors[None].expand(pts.shape[0],
                                                *self.anchors.shape)
            out = voxelnet_mod.predict(preds, anchors, self.cfg)
        return {k: v.cpu().numpy() for k, v in out.items()}

    @torch.no_grad()
    def heads(self, points, num_valid) -> Dict[str, torch.Tensor]:
        """The network's raw prediction maps (device tensors) for one
        request, computed as :meth:`__call__` computes them."""
        pts, nv = self._device_inputs(points, num_valid)
        with fp32_math():
            return self.model(*self.voxelize(pts, nv))

    def _device_inputs(self, points, num_valid):
        return (torch.as_tensor(np.asarray(points, np.float32),
                                device=self.device),
                torch.as_tensor(np.asarray(num_valid, np.int32),
                                device=self.device))

    def voxelize(self, pts: torch.Tensor, nv: torch.Tensor):
        """The input stage: device points -> the model's (voxels
        [B, V, T, C], num_points [B, V], coords [B, V, 3])."""
        cfg = self.cfg
        geo = dict(voxel_size=cfg.voxel_size, pc_range=cfg.pc_range,
                   grid_size=cfg.grid_size, max_voxels=self.max_voxels)
        if self.voxelization == "hard":
            vox = voxelize(pts, nv, max_points=self.max_points_per_voxel,
                           first_appearance=False, **geo)
            return vox.voxels, vox.num_points, vox.coords
        if self.voxelization == "dynamic":
            # the sparse middle searches its site keys, which is fast only
            # when they ascend
            vox = dynamic_voxelize(pts, nv, key_order=True, **geo)
        else:
            vox = fused_voxelize_mean(
                pts, nv, max_points=self.max_points_per_voxel,
                first_appearance=False, **geo)
        # one mean point per voxel: SimpleVoxel divides it by exactly 1
        return (vox.features[:, :, None, :], vox.num_points.clamp(max=1),
                vox.coords)

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
                                  seed: int = 0,
                                  voxelization: str = "hard"
                                  ) -> PodInference:
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
                        max_points_per_voxel=max_points_per_voxel,
                        voxelization=voxelization)
