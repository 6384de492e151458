"""``evaluate()`` — the second inference entry point.

The port of the JAX package's ``train/train.py``: ``Bundle`` (everything
built from one config file), ``make_predict_fn`` and ``evaluate`` (the
eval split through the host reader, the network and ``predict`` on the
device, point-evidence refinement for the configured classes, then the
dataset's AP).  The network runs in fp32 with TF32 off whatever the
process's global flags (``device.fp32_math``).  ``train()`` and the
checkpoint directory lookup come with the training slice.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..builder import (config_io, input_reader_builder, second_builder,
                       target_assigner_builder, voxel_builder)
from ..core import point_refine
from ..data import batching
from ..device import fp32_math, resolve_device
from ..models import voxelnet as voxelnet_mod
from ..parallel.inference import load_checkpoint_variables
from ..utils.seeded_init import load_seeded
from ..utils.weight_import import load_variables


class Bundle:
    """Everything built from one config file."""

    def __init__(self, config_path):
        self.config = config_io.load_config(config_path)
        m = self.config["model"]["second"]
        self.model_proto = m
        if self.config.get("train_config", {}).get(
                "enable_mixed_precision", False):
            raise NotImplementedError(
                "enable_mixed_precision (bfloat16 compute) is not ported")
        self.voxel_generator = voxel_builder.build(m["voxel_generator"])
        self.target_assigner = target_assigner_builder.build(
            m["target_assigner"], m.get("box_coder", {}))
        self.model, self.model_cfg, self.feature_map_size = (
            second_builder.build(m, self.voxel_generator,
                                 self.target_assigner))

    def input_reader(self, training: bool, seed: int = 0):
        """-> (PrepDataset, BatchLoader) of the eval reader.  No host
        rulebooks: the sparse middle joins keys inside its kernel or
        builds its rulebooks on the device."""
        if training:
            raise NotImplementedError("the training reader is not ported "
                                      "yet")
        return input_reader_builder.build(
            self.config["eval_input_reader"], training,
            self.voxel_generator, self.target_assigner,
            self.feature_map_size, seed=seed)


def make_predict_fn(bundle: Bundle):
    """-> ``predict_fn(example)``: device example dict -> padded detection
    dict (device tensors)."""
    model, cfg = bundle.model, bundle.model_cfg

    @torch.no_grad()
    @fp32_math()
    def predict_fn(example):
        preds = model(example["voxels"], example["num_points"],
                      example["coordinates"])
        return voxelnet_mod.predict(preds, example["anchors"], cfg,
                                    anchors_mask=example.get("anchors_mask"))

    return predict_fn


@torch.no_grad()
@fp32_math()
def stage_times_ms(bundle: Bundle, example, repeats: int = 3
                   ) -> Dict[str, float]:
    """Time of the four stages (vfe, middle, rpn, predict) on one device
    batch, each synchronised, the mean of ``repeats`` runs after one
    warm-up, in fp32 as :func:`make_predict_fn` runs them."""
    model, cfg = bundle.model, bundle.model_cfg
    sync = (torch.cuda.synchronize if example["voxels"].is_cuda
            else (lambda: None))
    total = dict.fromkeys(("vfe", "middle", "rpn", "predict"), 0.0)
    for r in range(repeats + 1):
        sync()
        t = [time.perf_counter()]

        def lap():
            sync()
            t.append(time.perf_counter())

        feats = model.voxel_feature_extractor(
            example["voxels"], example["num_points"], example["coordinates"])
        lap()
        spatial = model.middle_feature_extractor(feats,
                                                 example["coordinates"])
        lap()
        preds = model.rpn(spatial)
        lap()
        voxelnet_mod.predict(preds, example["anchors"], cfg,
                             anchors_mask=example.get("anchors_mask"))
        lap()
        if r:       # the first run warms up
            for k, a, b in zip(total, t, t[1:]):
                total[k] += (b - a) * 1e3 / repeats
    return total


def evaluate(config_path, checkpoint=None, *, bundle: Optional[Bundle] = None,
             variables: Optional[dict] = None, output_dir=None,
             measure_time: bool = False, device="cuda",
             num_devices: Optional[int] = None, seed: int = 0) -> dict:
    """Run the eval split through predict + the dataset's own evaluation.

    ``checkpoint``: a pickle of the JAX package's ``{"params",
    "batch_stats"}`` tree; ``variables``: that tree itself.  With neither
    it warns and evaluates weights drawn from ``seed``.  ``measure_time``
    prints per-batch wall time of host prep + feed, device network +
    predict, and host convert, and the four-stage split of one batch.
    """
    if num_devices and num_devices > 1:
        raise NotImplementedError("multi-device evaluation is not ported")
    dev = resolve_device(device)
    bundle = bundle or Bundle(config_path)
    prep_ds, loader = bundle.input_reader(training=False)
    if variables is None and checkpoint is not None:
        variables = load_checkpoint_variables(checkpoint)
    if variables is not None:
        load_variables(bundle.model, variables)
    else:
        print(f"WARNING: no checkpoint; evaluating random weights from seed "
              f"{seed}")
        load_seeded(bundle.model, seed)
    bundle.model.to(dev).eval()
    predict_fn = make_predict_fn(bundle)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    timers = {"host_feed": 0.0, "device": 0.0, "convert": 0.0}
    detections = []
    nb = 0
    example = None
    t0 = time.perf_counter()
    for batch in loader:
        example = {k: torch.as_tensor(v, device=dev)
                   for k, v in batching.device_example(batch).items()}
        sync()
        t1 = time.perf_counter()
        out = {k: v.cpu().numpy() for k, v in predict_fn(example).items()}
        t2 = time.perf_counter()
        for b in range(out["box3d_lidar"].shape[0]):
            valid = out["valid"][b]
            detections.append({
                "box3d_lidar": out["box3d_lidar"][b][valid],
                "scores": out["scores"][b][valid],
                "label_preds": out["label_preds"][b][valid],
                "metadata": batch["metadata"][b],
            })
        t3 = time.perf_counter()
        timers["host_feed"] += t1 - t0
        timers["device"] += t2 - t1
        timers["convert"] += t3 - t2
        nb += 1
        t0 = time.perf_counter()
    if measure_time and nb:
        for k, v in timers.items():
            print(f"[measure_time] {k}: {v / nb * 1e3:.1f} ms/batch (the "
                  f"first batch includes warm-up)")
        for name, ms in stage_times_ms(bundle, example).items():
            print(f"[measure_time] stage {name}: {ms:.1f} ms/batch")
    dataset = prep_ds.dataset
    n = min(len(detections), len(dataset))
    refine_cls = bundle.model_cfg.yaw_point_refine_classes
    if refine_cls:
        # post-NMS point-evidence pose refinement (host-side).  Detections
        # are in dataset order (sequential eval loader): the same
        # assumption dataset.evaluation makes below.
        for i in range(n):
            pts = np.asarray(dataset.get_sensor_data(i)["lidar"]["points"])
            detections[i] = point_refine.refine_detections(
                detections[i], pts, classes=refine_cls,
                recenter=bundle.model_cfg.yaw_point_refine_recenter,
                trim_length=bundle.model_cfg.yaw_point_refine_trim)
    return dataset.evaluation(detections[:n], output_dir=output_dir)
