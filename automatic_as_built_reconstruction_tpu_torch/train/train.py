"""``train()`` and ``evaluate()`` — the runtime entry points.

The port of the JAX package's ``train/train.py``: ``Bundle`` (everything
built from one config file), ``init_state`` (flax-default weights from a
seed, the AdamW of the config and its schedule), ``make_train_step``
(forward in train mode, ``compute_loss``, backward, the reference's
global-norm clip at 10, one AdamW update at the schedule's step count),
``clip_by_global_norm``, ``MetricsLogger`` (``log.txt``, ``metrics.jsonl``,
TensorBoard where it imports), ``train`` (the training reader, resume
from ``<model_dir>/checkpoints``, display windows with precision /
recall, time-based and per-eval checkpoints, a forced checkpoint at the
end) and ``evaluate`` (the eval split through the host reader, the
network and ``predict`` on the device, point-evidence refinement for the
configured classes, then the dataset's AP: ``BuildingDataset``'s lidar
AP, or ``KittiDataset``'s KITTI protocol table) from a model directory
of the port's checkpoints, a checkpoint pickle of the JAX package, or
seeded weights.  Pillar and SECOND configs train alike; SECOND's sparse
middle trains in key-match mode through the joins' backward kernels,
reports ``mid_capacity_saturated`` and aborts as the reference does when
its site caps keep truncating.  The network runs in fp32 with TF32 off whatever the process's
global flags (``device.fp32_math``).  Multi-device training, the
reference's ``profile_steps`` trace and mixed precision are not ported.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..builder import (config_io, input_reader_builder, optimizer_builder,
                       second_builder, target_assigner_builder,
                       voxel_builder)
from ..core import point_refine
from ..data import batching
from ..device import fp32_math, resolve_device
from ..models import voxelnet as voxelnet_mod
from ..parallel.inference import load_checkpoint_variables
from ..utils.progress import StageTimers
from ..utils.seeded_init import load_flax_init, load_seeded
from ..utils.weight_import import load_variables
from . import checkpoint as ckpt_mod
from . import metrics as metrics_mod

# the reference's global-norm clip of every training step
CLIP_NORM = 10.0


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
        """-> (PrepDataset, BatchLoader) of the training or eval reader.
        No host rulebooks: the sparse middle joins keys inside its kernel
        or builds its rulebooks on the device."""
        return input_reader_builder.build(
            self.config["train_input_reader" if training
                        else "eval_input_reader"], training,
            self.voxel_generator, self.target_assigner,
            self.feature_map_size, seed=seed)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer
    over its parameters, the learning-rate schedule and the number of
    updates done.  The train step updates it in place."""

    model: voxelnet_mod.VoxelNet
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def init_state(bundle: Bundle, rng_seed: int = 0,
               total_steps: Optional[int] = None,
               device="cuda") -> TrainState:
    """``bundle.model`` with flax-default weights drawn from ``rng_seed``
    (``utils/seeded_init.py::load_flax_init``), on ``device``, in train
    mode, with the config's optimizer over ``total_steps`` (the config's
    ``train_config.steps`` if None)."""
    model = bundle.model
    load_flax_init(model, rng_seed)
    model.to(resolve_device(device)).train()
    if total_steps is None:
        total_steps = int(bundle.config.get("train_config", {}).get(
            "steps", 0)) or 100000
    opt, schedule = optimizer_builder.build(
        bundle.config.get("train_config", {}).get("optimizer", {}),
        total_steps, model.parameters())
    return TrainState(model, opt, schedule)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax's
    ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """The reference's clip: every gradient times ``min(1, max_norm /
    max(norm, 1e-6))`` (not ``torch.nn.utils.clip_grad_norm_``, which
    divides by ``norm + 1e-6``).  No host sync."""
    scale = torch.clamp(max_norm / torch.clamp_min(global_norm(grads), 1e-6),
                        max=1.0)
    return [g * scale for g in grads]


def to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    """The device subset of a host batch (``batching.device_example``) as
    tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in batching.device_example(batch).items()}


def make_train_step(bundle: Bundle):
    """-> ``train_step(state, example) -> metrics``: one update of
    ``state`` in place (forward in train mode, ``compute_loss``,
    backward, the global-norm clip, AdamW at learning rate
    ``schedule(state.step)``), in fp32 with TF32 off.  ``metrics`` holds
    device tensors (no host sync): the loss terms, ``grad_norm`` (of the
    clipped gradients), ``num_pos``, for the sparse middle
    ``mid_capacity_saturated``, and the precision / recall counts under
    ``pr``."""
    cfg = bundle.model_cfg

    def train_step(state: TrainState, example: Dict[str, torch.Tensor]):
        model = state.model.train()
        params = list(model.parameters())
        with fp32_math(), torch.enable_grad():
            preds = model(example["voxels"], example["num_points"],
                          example["coordinates"])
            loss, metrics = voxelnet_mod.compute_loss(preds, example, cfg)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        # sparse-middle capacity telemetry: per strided block, the scans
        # whose active sites filled its static capacity
        sat = getattr(model.middle_feature_extractor, "capacity_saturated",
                      None)
        if sat:
            metrics["mid_capacity_saturated"] = sum(sat.values())
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        grads = clip_by_global_norm(grads, CLIP_NORM)
        for p, g in zip(params, grads):
            p.grad = g
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        flat = voxelnet_mod.flatten_preds(preds, cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        metrics["num_pos"] = (example["labels"] > 0).sum()
        metrics["pr"] = metrics_mod.precision_recall_counts(
            flat["cls_preds"].detach(), example["labels"])
        return metrics

    return train_step


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


class MetricsLogger:
    """``log.txt`` + ``metrics.jsonl`` + TensorBoard scalars under
    ``<model_dir>/summary`` (where ``torch.utils.tensorboard`` imports)."""

    def __init__(self, model_dir: pathlib.Path):
        model_dir.mkdir(parents=True, exist_ok=True)
        self._log = open(model_dir / "log.txt", "a")
        self._jsonl = open(model_dir / "metrics.jsonl", "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass   # TensorBoard optional; the jsonl is always written
        else:
            self._tb = SummaryWriter(log_dir=str(model_dir / "summary"))

    def log(self, step: int, metrics: Dict[str, float], prefix="train"):
        metrics = {k: float(v) for k, v in metrics.items()}
        line = (f"step={step} " +
                " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())))
        print(f"[{prefix}] {line}", flush=True)
        self._log.write(f"[{prefix}] {line}\n")
        self._log.flush()
        self._jsonl.write(json.dumps(
            {"step": step, "prefix": prefix, **metrics}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)
            self._tb.flush()

    def text(self, s: str):
        print(s, flush=True)
        self._log.write(s + "\n")
        self._log.flush()

    def close(self):
        self._log.close()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class CapacitySaturationError(RuntimeError):
    """Sparse-middle static capacities are truncating active sites: the
    training would converge to garbage without saying so."""


def train(config_path, model_dir, *, resume: bool = True,
          max_steps: Optional[int] = None, display_step: int = 50,
          seed: int = 0, num_devices: Optional[int] = None,
          saturation_abort_windows: int = 3, device="cuda") -> TrainState:
    """Train ``config_path`` into ``model_dir`` with checkpoint / resume and
    in-loop evaluation, as the JAX package's ``train`` does.

    ``max_steps`` (the config's ``train_config.steps`` if None) is also
    the length of the learning-rate cycle.  ``resume`` continues from the
    latest checkpoint in ``<model_dir>/checkpoints`` (its weights,
    BatchNorm statistics, optimizer moments and step); ``resume=False``
    deletes them and starts again.  Every ``display_step`` steps it logs
    the window's mean loss terms, ``grad_norm``, ``num_pos``, steps/s and
    the host-prep / feed / step milliseconds of a batch (the step's
    launch: nothing synchronises the device), and the precision / recall
    of the class head.  ``saturation_abort_windows``:
    raise :class:`CapacitySaturationError` when ``mid_capacity_saturated``
    stays above 0 that many display windows in a row (0 disables; no
    pillar model reports it).  -> the final :class:`TrainState`.
    """
    if num_devices and num_devices > 1:
        raise NotImplementedError("multi-device training is not ported")
    dev = resolve_device(device)
    model_dir = pathlib.Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    bundle = Bundle(config_path)
    # the config as given (the port's config reader has no writer); a run
    # may be resumed from that copy itself
    saved = model_dir / "pipeline.config"
    if not (saved.exists() and saved.samefile(config_path)):
        shutil.copyfile(config_path, saved)
    logger = MetricsLogger(model_dir)
    train_cfg = bundle.config.get("train_config", {})

    _, loader = bundle.input_reader(training=True, seed=seed)
    total_steps = max_steps or int(train_cfg.get("steps", 0)) or 1000
    state = init_state(bundle, rng_seed=seed, total_steps=total_steps,
                       device=dev)
    if not resume:
        shutil.rmtree(model_dir / "checkpoints", ignore_errors=True)
    mgr = ckpt_mod.CheckpointManager(model_dir)
    if resume and mgr.restore(state) is not None:
        logger.text(f"resumed from checkpoint at step {state.step}")

    train_step = make_train_step(bundle)
    save_secs = int(train_cfg.get("save_checkpoints_secs", 0)) or 1800
    steps_per_eval = int(train_cfg.get("steps_per_eval", 0))

    last_save = time.time()
    window: Dict[str, list] = {}
    pr = metrics_mod.PrecisionRecall()
    timers = StageTimers()
    t_window = time.time()
    sat_windows = 0
    batches = iter(loader)
    try:
        while state.step < total_steps:
            with timers.time("host_prep"):
                batch = next(batches)
            with timers.time("feed"):
                example = to_device(batch, dev)
            with timers.time("step"):
                metrics = train_step(state, example)
            # metrics stay device tensors until the window ends: reading
            # one would sync every step
            window.setdefault("pr", []).append(metrics.pop("pr"))
            for k, v in metrics.items():
                window.setdefault(k, []).append(v)
            step = state.step
            if step % display_step == 0:
                for counts in window.pop("pr"):
                    pr.update({k: v.cpu().numpy() for k, v in counts.items()})
                avg = {k: float(torch.stack(v).double().mean())
                       for k, v in window.items()}
                avg["steps_per_sec"] = (
                    display_step / max(time.time() - t_window, 1e-9))
                avg.update({f"{k}_ms": v
                            for k, v in timers.means_ms().items()})
                logger.log(step, avg)
                logger.text(f"[train] step={step} {pr.summary()}")
                pr.clear()
                window.clear()
                timers.clear()
                t_window = time.time()
                if avg.get("mid_capacity_saturated", 0.0) > 0:
                    sat_windows += 1
                    logger.text(
                        f"WARNING: mid_capacity_saturated="
                        f"{avg['mid_capacity_saturated']:.1f}: the sparse "
                        f"middle is truncating active sites "
                        f"({sat_windows}/{saturation_abort_windows} "
                        f"consecutive windows before abort)")
                    if (saturation_abort_windows
                            and sat_windows >= saturation_abort_windows):
                        mgr.save(step, state, force=True)
                        raise CapacitySaturationError(
                            f"mid_capacity_saturated > 0 for {sat_windows} "
                            f"consecutive display windows: the sparse "
                            f"middle's static out_site_caps are too small "
                            f"and active sites are being dropped")
                else:
                    sat_windows = 0
            if time.time() - last_save > save_secs:
                mgr.save(step, state)
                last_save = time.time()
            if steps_per_eval and step % steps_per_eval == 0:
                mgr.save(step, state)
                result = evaluate(config_path, bundle=bundle, state=state,
                                  device=dev)
                logger.log(step, {k: v for k, v in result.items()
                                  if isinstance(v, (int, float))},
                           prefix="eval")
    finally:
        batches.close()         # stops the loader's producer and its pool
        try:
            mgr.save(state.step, state, force=True)
        except ckpt_mod.StepAlreadyExistsError as e:   # a no-op run
            logger.text(f"final checkpoint save skipped: {e}")
        logger.text(f"training finished at step {state.step}")
        logger.close()
    return state


def evaluate(config_path, checkpoint=None, *, ckpt_step: Optional[int] = None,
             bundle: Optional[Bundle] = None,
             state: Optional[TrainState] = None,
             variables: Optional[dict] = None, output_dir=None,
             measure_time: bool = False, device="cuda",
             num_devices: Optional[int] = None, seed: int = 0) -> dict:
    """Run the eval split through predict + the dataset's own evaluation.

    ``checkpoint``: a model directory of :func:`train` (its checkpoint at
    ``ckpt_step``, the latest if None; with none there it warns and
    evaluates the initial weights of ``seed``, as the JAX package
    evaluates a fresh init), or a pickle of the JAX package's
    ``{"params", "batch_stats"}`` tree; ``variables``: that tree itself;
    ``state``: a :class:`TrainState` whose model is ``bundle.model`` (the
    in-loop evaluation).  With none of them it warns and evaluates
    weights drawn from ``seed`` (``utils/seeded_init.py::load_seeded``).
    ``measure_time`` prints per-batch wall time of host prep + feed,
    device network + predict, and host convert, and the four-stage split
    of one batch.
    """
    if num_devices and num_devices > 1:
        raise NotImplementedError("multi-device evaluation is not ported")
    dev = resolve_device(device)
    bundle = bundle or Bundle(config_path)
    prep_ds, loader = bundle.input_reader(training=False)
    model = bundle.model
    if state is not None:
        if state.model is not model:
            raise ValueError("state.model is not bundle.model")
    elif variables is not None:
        load_variables(model, variables)
    elif checkpoint is not None and pathlib.Path(checkpoint).is_dir():
        model.to(dev)
        step = ckpt_mod.CheckpointManager(checkpoint).restore_model(
            model, ckpt_step)
        if step is None:
            print(f"WARNING: no checkpoint in {checkpoint}; evaluating the "
                  f"initial weights of seed {seed}")
            load_flax_init(model, seed)
        else:
            print(f"evaluating checkpoint at step {step}")
    elif checkpoint is not None:
        load_variables(model, load_checkpoint_variables(checkpoint))
    else:
        print(f"WARNING: no checkpoint; evaluating random weights from seed "
              f"{seed}")
        load_seeded(model, seed)
    model.to(dev).eval()
    predict_fn = make_predict_fn(bundle)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    timers = {"host_feed": 0.0, "device": 0.0, "convert": 0.0}
    detections = []
    nb = 0
    example = None
    t0 = time.perf_counter()
    for batch in loader:
        example = to_device(batch, dev)
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
