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
seeded weights; ``import_torch_weights`` writes a lineage torch
checkpoint into a model directory at step 0.  Pillar and SECOND configs train alike; SECOND's sparse
middle trains in key-match mode through the joins' backward kernels, or,
where the config does not set ``use_keymatch_sparse_gemm``, on rulebooks
that the input pipeline builds on the host (``ops/rulebook_host.py``:
``people.fhd``, ``car.lite``, ``car.fhd.mixed``), which travel to the
device with the batch; it reports ``mid_capacity_saturated`` and aborts as
the reference does when its site caps keep truncating.
``enable_mixed_precision`` runs the sparse middle and the RPN in bfloat16
(``car.fhd.mixed``), as the reference's ``Bundle`` does.  The float32
arithmetic runs with TF32 off whatever the process's global flags, and
the training step on cuDNN's deterministic algorithms, so that two runs
from one seed and one batch stream give the same parameters
(``device.fp32_math``).  ``num_devices > 1`` trains and evaluates data
parallel over ranks of ``torch.distributed`` (``parallel/mesh.py``):
each rank takes its rows of every global batch, which rank 0 reads;
the BatchNorms take the global batch's statistics, the loss is
normalised by the global batch and the gradients are summed over the
ranks before the clip, so that a step equals the one-process step on
the joined batch.  ``profile_steps = N`` traces N steps after two
warm-up steps with ``torch.profiler`` (host and device activities; rank 0
alone) into a Chrome / Perfetto trace under ``<model_dir>/profile``.
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
from ..ops import rulebook_host
from ..parallel import launch
from ..parallel import mesh as mesh_mod
from ..parallel.inference import load_checkpoint_variables
from ..parallel.mesh import Mesh
from ..utils.progress import StageTimers
from ..utils.seeded_init import load_flax_init, load_seeded
from ..utils.weight_import import load_torch_checkpoint, load_variables
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
        self.voxel_generator = voxel_builder.build(m["voxel_generator"])
        self.target_assigner = target_assigner_builder.build(
            m["target_assigner"], m.get("box_coder", {}))
        self.model, self.model_cfg, self.feature_map_size = (
            second_builder.build(m, self.voxel_generator,
                                 self.target_assigner))
        # enable_mixed_precision: bfloat16 compute, the model rebuilt
        self.model, self.model_cfg = second_builder.mixed_precision(
            self.config, self.model, self.model_cfg)

    def middle_plan(self, training: bool):
        """The block plan of the host-built rulebooks of the training or
        eval reader, or None: key-match mode joins keys inside its kernel
        and needs none, and dense-tail blocks run as masked dense convs
        (the plan stops before them)."""
        reader_cfg = self.config["train_input_reader" if training
                                 else "eval_input_reader"]
        cfg = self.model_cfg
        if cfg.sparse_keymatch and cfg.sparse_use_pallas_gemm:
            return None
        v_cap = int(reader_cfg.get("preprocess", {}).get(
            "max_number_of_voxels", 0)) or 12000
        plan = voxelnet_mod.middle_plan(cfg, v_cap)
        tail = cfg.sparse_dense_tail_blocks
        if plan is not None and tail > 0:
            plan = plan[:max(len(plan) - tail, 0)] or None
        return plan

    def input_reader(self, training: bool, seed: int = 0):
        """-> (PrepDataset, BatchLoader) of the training or eval reader,
        with the host-built rulebooks of :meth:`middle_plan` in every
        example where it gives a plan (with ``static_shape_buckets``, each
        bucket's plan from the model's capacity policy: its
        ``sparse_capacity_shrink`` and the ``sparse_out_caps`` of the
        plan's blocks)."""
        plan = self.middle_plan(training)
        out_caps = self.model_cfg.sparse_out_caps
        if plan is not None and out_caps is not None:
            out_caps = out_caps[:len(plan)] or None
        return input_reader_builder.build(
            self.config["train_input_reader" if training
                        else "eval_input_reader"], training,
            self.voxel_generator, self.target_assigner,
            self.feature_map_size, seed=seed, middle_plan=plan,
            capacity_shrink=self.model_cfg.sparse_capacity_shrink,
            out_caps=out_caps)


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


def middle_rulebooks(example: Dict[str, torch.Tensor],
                     cfg: voxelnet_mod.VoxelNetConfig):
    """The host-built rulebooks (``rb*`` keys) of a device example as the
    sparse middle's per-block pairs, or None where it has none.  The block
    count comes from the keys present: with ``sparse_dense_tail_blocks``
    the pipeline builds books for the leading sparse blocks only."""
    _, flat = rulebook_host.split_example(example)
    if not flat:
        return None
    n = sum(1 for k in flat if k.endswith("_out_valid"))
    return rulebook_host.unflatten(
        flat, min(n, voxelnet_mod.num_middle_blocks(cfg)))


def forward(model: voxelnet_mod.VoxelNet, example: Dict[str, torch.Tensor],
            cfg: voxelnet_mod.VoxelNetConfig):
    """The network on a device example, with its host-built rulebooks
    where it carries them."""
    return model(example["voxels"], example["num_points"],
                 example["coordinates"],
                 middle_rulebooks=middle_rulebooks(example, cfg))


def loss_and_grads(model: voxelnet_mod.VoxelNet,
                   example: Dict[str, torch.Tensor],
                   cfg: voxelnet_mod.VoxelNetConfig,
                   mesh: Optional[Mesh] = None) -> tuple:
    """Forward in train mode, ``compute_loss`` and backward, in fp32 with
    TF32 off.  With ``mesh`` the example is this rank's rows of the global
    batch: the loss is normalised by the global batch size, the model's
    BatchNorms must take global statistics
    (``voxelnet.set_batch_norm_group``), and the gradients are summed over
    the ranks in one flattened all-reduce, so that every rank holds the
    gradients of the joined batch.  -> (preds, loss terms of this rank's
    rows, gradients in ``model.parameters()`` order).  cuDNN runs its
    deterministic algorithms, so that a step's gradients are the same
    bits run after run."""
    params = list(model.parameters())
    batch = (None if mesh is None
             else example["labels"].shape[0] * mesh.size)
    with fp32_math(deterministic=True), torch.enable_grad():
        preds = forward(model, example, cfg)
        loss, metrics = voxelnet_mod.compute_loss(preds, example, cfg,
                                                  batch_size=batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    if mesh is not None:
        grads = mesh_mod.all_reduce_sum(grads, mesh)
    return preds, metrics, grads


def make_train_step(bundle: Bundle, mesh: Optional[Mesh] = None):
    """-> ``train_step(state, example) -> metrics``: one update of
    ``state`` in place (forward in train mode, ``compute_loss``,
    backward, the global-norm clip, AdamW at learning rate
    ``schedule(state.step)``), in fp32 with TF32 off.  ``metrics`` holds
    device tensors (no host sync): the loss terms, ``grad_norm`` (of the
    clipped gradients), ``num_pos``, for the sparse middle
    ``mid_capacity_saturated``, and the precision / recall counts under
    ``pr``.

    With ``mesh`` the step is data parallel:
    ``example`` is this rank's rows of the global batch, the BatchNorms of
    ``bundle.model`` take their statistics over the ranks, the gradients
    are summed over them before the clip (:func:`loss_and_grads`) and the
    metrics are summed too, so that every rank makes the same update and
    reads the metrics of the whole batch."""
    cfg = bundle.model_cfg
    voxelnet_mod.set_batch_norm_group(
        bundle.model, None if mesh is None else mesh.group)

    def train_step(state: TrainState, example: Dict[str, torch.Tensor]):
        model = state.model.train()
        params = list(model.parameters())
        preds, metrics, grads = loss_and_grads(model, example, cfg, mesh)
        # sparse-middle capacity telemetry: per strided block, the scans
        # whose active sites filled its static capacity
        sat = getattr(model.middle_feature_extractor, "capacity_saturated",
                      None)
        if sat:
            metrics["mid_capacity_saturated"] = sum(sat.values())
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
        if mesh is not None:
            metrics = _sum_metrics(metrics, mesh)
        return metrics

    return train_step


def _sum_metrics(metrics: dict, mesh: Mesh) -> dict:
    """The loss terms, counts and precision / recall counts of every rank's
    rows summed over the ranks (``grad_norm`` is already global), in one
    float64 all-reduce."""
    grad_norm, pr = metrics.pop("grad_norm"), metrics.pop("pr")
    parts = [*metrics.values(), *pr.values()]
    sums = [s.to(p.dtype) for s, p in zip(
        mesh_mod.all_reduce_sum([p.double() for p in parts], mesh), parts)]
    out = dict(zip(metrics, sums[:len(metrics)]))
    out.update(grad_norm=grad_norm, pr=dict(zip(pr, sums[len(metrics):])))
    return out


def make_predict_fn(bundle: Bundle):
    """-> ``predict_fn(example)``: device example dict -> padded detection
    dict (device tensors)."""
    model, cfg = bundle.model, bundle.model_cfg

    @torch.no_grad()
    @fp32_math()
    def predict_fn(example):
        preds = forward(model, example, cfg)
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
        books = middle_rulebooks(example, cfg)
        spatial = (model.middle_feature_extractor(feats,
                                                  example["coordinates"])
                   if books is None else model.middle_feature_extractor(
                       feats, example["coordinates"], rulebooks=books))
        lap()
        preds = model.rpn_heads(spatial)
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


class _Silent:
    """The logger of a rank other than 0: it writes nothing."""

    def log(self, *args, **kwargs):
        pass

    def text(self, s: str):
        pass

    def close(self):
        pass


def dp_mesh(num_devices: Optional[int], devices, device) -> Optional[Mesh]:
    """This rank's mesh for ``num_devices > 1`` inside a process group
    (spawned, or started by torchrun), else None."""
    if not num_devices or num_devices <= 1:
        return None
    return mesh_mod.data_parallel_mesh(num_devices, devices, device=device)


def check_batch_divides(config_path, num_devices: Optional[int],
                        reader: str = "train_input_reader") -> None:
    """The reference's refusal of a batch the ranks cannot share evenly."""
    if num_devices and num_devices > 1:
        config = config_io.load_config(config_path)
        bs = int(config[reader].get("batch_size", 0)) or 1
        if bs % num_devices:
            raise ValueError(f"batch_size {bs} not divisible by "
                             f"num_devices {num_devices}")


def train(config_path, model_dir, *, resume: bool = True,
          max_steps: Optional[int] = None, display_step: int = 50,
          seed: int = 0, num_devices: Optional[int] = None,
          saturation_abort_windows: int = 3, profile_steps: int = 0,
          device="cuda", devices=None) -> TrainState:
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
    of the class head; at the end, the run's batches by voxel capacity
    (the buckets of ``static_shape_buckets``), a ``metrics.jsonl`` line
    of prefix ``batches_by_voxel_capacity``.  ``saturation_abort_windows``:
    raise :class:`CapacitySaturationError` when ``mid_capacity_saturated``
    stays above 0 that many display windows in a row (0 disables; no
    pillar model reports it).  ``profile_steps``: trace that many steps
    after the first two of this run with ``torch.profiler`` (CPU and, on a
    card, CUDA activities) and write the trace, which Chrome and Perfetto
    read, to ``<model_dir>/profile/steps_<a>-<b>.trace.json``; the steps
    outside it run as they do without.  -> the final :class:`TrainState`.

    ``num_devices > 1`` trains data parallel over that many ranks, rank
    ``r`` on ``devices[r]`` (default: the first cards for ``device="cuda"``,
    the CPU for ``device="cpu"``; ranks may share a device).  The global
    batch (``train_input_reader.batch_size``) must divide by
    ``num_devices``; rank 0 reads every batch and sends each rank its
    rows, writes the logs and the checkpoints, and every rank restores.
    Inside a process group (torchrun) each rank runs this in place and
    returns its state; from one process it starts the ranks itself and
    returns rank 0's final state, restored from the forced last
    checkpoint onto ``devices[0]``.
    """
    check_batch_divides(config_path, num_devices)
    if num_devices and num_devices > 1 and not launch.in_process_group():
        devs = mesh_mod.rank_devices(num_devices, devices, device)
        launch.spawn(_train_rank, num_devices, devs, args=(
            config_path, model_dir, dict(
                resume=resume, max_steps=max_steps,
                display_step=display_step, seed=seed,
                saturation_abort_windows=saturation_abort_windows,
                profile_steps=profile_steps)))
        bundle = Bundle(config_path)
        state = init_state(bundle, rng_seed=seed,
                           total_steps=_total_steps(bundle, max_steps),
                           device=devs[0])
        ckpt_mod.CheckpointManager(model_dir).restore(state)
        return state
    mesh = dp_mesh(num_devices, devices, device)
    return _train(config_path, model_dir, mesh=mesh, resume=resume,
                  max_steps=max_steps, display_step=display_step, seed=seed,
                  saturation_abort_windows=saturation_abort_windows,
                  profile_steps=profile_steps, device=device)


class _StepTrace:
    """``torch.profiler`` over the training steps ``[first, first + n)``:
    started before step ``first``, stopped after the last of them (the
    device synchronised once there) and written as a Chrome trace into
    ``out_dir``."""

    def __init__(self, out_dir: pathlib.Path, first: int, n: int, dev,
                 logger):
        self.out_dir, self.first, self.last = out_dir, first, first + n
        self.dev, self.logger = dev, logger
        self.prof = None

    def before(self, step: int) -> None:
        if step == self.first:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()

    def after(self, step: int) -> None:
        if step == self.last:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        prof, self.prof = self.prof, None
        prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"steps_{self.first}-{self.last}.trace.json"
        prof.export_chrome_trace(str(path))
        self.logger.text(f"profile trace written to {path}")


def _total_steps(bundle: Bundle, max_steps: Optional[int]) -> int:
    return (max_steps or int(bundle.config.get("train_config", {}).get(
        "steps", 0)) or 1000)


def _train_rank(mesh: Mesh, config_path, model_dir, kwargs: dict):
    """One spawned rank of :func:`train`."""
    _train(config_path, model_dir, mesh=mesh, device=mesh.device, **kwargs)


def _train(config_path, model_dir, *, mesh: Optional[Mesh], resume: bool,
           max_steps: Optional[int], display_step: int, seed: int,
           saturation_abort_windows: int, profile_steps: int = 0,
           device) -> TrainState:
    """The training loop of :func:`train`, on one rank of ``mesh`` or
    alone."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    main = mesh is None or mesh.is_main
    model_dir = pathlib.Path(model_dir)
    bundle = Bundle(config_path)
    train_cfg = bundle.config.get("train_config", {})
    if main:
        model_dir.mkdir(parents=True, exist_ok=True)
        # the config as given (the port's config reader has no writer); a
        # run may be resumed from that copy itself
        saved = model_dir / "pipeline.config"
        if not (saved.exists() and saved.samefile(config_path)):
            shutil.copyfile(config_path, saved)
        logger = MetricsLogger(model_dir)
        _, loader = bundle.input_reader(training=True, seed=seed)
        batches = iter(loader)
        if mesh is not None:
            logger.text(f"data-parallel training over {mesh.size} ranks "
                        f"({mesh.backend})")
        if not resume:
            shutil.rmtree(model_dir / "checkpoints", ignore_errors=True)
    else:
        logger, batches = _Silent(), None

    total_steps = _total_steps(bundle, max_steps)
    state = init_state(bundle, rng_seed=seed, total_steps=total_steps,
                       device=dev)
    mgr = ckpt_mod.CheckpointManager(model_dir)
    start = mgr.latest_step() if resume else None
    if mesh is not None:     # every rank restores the step rank 0 found
        start = mesh_mod.broadcast_object(start, mesh)
    if start is not None:
        mgr.restore(state, start)
        logger.text(f"resumed from checkpoint at step {state.step}")
    if mesh is not None:
        mesh_mod.replicate(state.model, mesh)

    train_step = make_train_step(bundle, mesh=mesh)
    save_secs = int(train_cfg.get("save_checkpoints_secs", 0)) or 1800
    steps_per_eval = int(train_cfg.get("steps_per_eval", 0))

    last_save = time.time()
    window: Dict[str, list] = {}
    pr = metrics_mod.PrecisionRecall()
    timers = StageTimers()
    t_window = time.time()
    sat_windows = 0
    # batches by voxel capacity: one entry without static_shape_buckets
    capacities: Dict[int, int] = {}
    # rank 0 traces steps [start + 2, start + 2 + profile_steps)
    trace = _StepTrace(model_dir / "profile", state.step + 2, profile_steps,
                       dev, logger) if main and profile_steps else None
    try:
        while state.step < total_steps:
            if trace is not None:
                trace.before(state.step)
            with timers.time("host_prep"):
                batch = next(batches) if main else None
                if mesh is not None:    # each rank's rows of rank 0's batch
                    batch = mesh_mod.scatter_batch(
                        batching.device_example(batch) if main else None,
                        mesh)
            with timers.time("feed"):
                example = to_device(batch, dev)
            v = int(example["voxels"].shape[1])
            capacities[v] = capacities.get(v, 0) + 1
            with timers.time("step"):
                metrics = train_step(state, example)
            if trace is not None:
                trace.after(state.step)
            # metrics stay device tensors until the window ends: reading
            # one would sync every step
            window.setdefault("pr", []).append(metrics.pop("pr"))
            for k, v in metrics.items():
                window.setdefault(k, []).append(v)
            step = state.step
            if step % display_step == 0:
                for counts in window.pop("pr"):
                    pr.update({k: v.cpu().numpy() for k, v in counts.items()})
                # summed over the ranks: the same on every rank, so that
                # all of them take the abort below together
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
                        if main:
                            mgr.save(step, state, force=True)
                        raise CapacitySaturationError(
                            f"mid_capacity_saturated > 0 for {sat_windows} "
                            f"consecutive display windows: the sparse "
                            f"middle's static out_site_caps are too small "
                            f"and active sites are being dropped")
                else:
                    sat_windows = 0
            # rank 0 alone writes: its clock decides nothing the others
            # wait for
            if main and time.time() - last_save > save_secs:
                mgr.save(step, state)
                last_save = time.time()
            if steps_per_eval and step % steps_per_eval == 0:
                if main:
                    mgr.save(step, state)
                result = evaluate(config_path, bundle=bundle, state=state,
                                  device=dev, mesh=mesh)
                logger.log(step, {k: v for k, v in result.items()
                                  if isinstance(v, (int, float))},
                           prefix="eval")
    finally:
        if trace is not None:
            trace.stop()        # a run shorter than the trace: what it has
        if main:
            batches.close()     # stops the loader's producer and its pool
            try:
                mgr.save(state.step, state, force=True)
            except ckpt_mod.StepAlreadyExistsError as e:   # a no-op run
                logger.text(f"final checkpoint save skipped: {e}")
            logger.log(state.step, {str(v): n for v, n in
                                    sorted(capacities.items())},
                       prefix="batches_by_voxel_capacity")
            logger.text(f"training finished at step {state.step}")
            logger.close()
    return state


def evaluate(config_path, checkpoint=None, *, ckpt_step: Optional[int] = None,
             bundle: Optional[Bundle] = None,
             state: Optional[TrainState] = None,
             variables: Optional[dict] = None, output_dir=None,
             measure_time: bool = False, device="cuda",
             num_devices: Optional[int] = None, seed: int = 0,
             devices=None, mesh: Optional[Mesh] = None) -> dict:
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

    ``num_devices > 1`` (or the ``mesh`` of a data-parallel training)
    predicts each eval batch over the ranks, as :func:`train` trains (the
    eval batch size must divide; a short last batch leaves the first ranks
    fewer rows): rank 0 reads the batch and sends each rank its rows,
    gathers the detections, refines them and computes the AP, which every
    rank returns.  From one process it starts the ranks itself (``bundle``
    and ``state`` then cannot be given).
    """
    if mesh is None:
        check_batch_divides(config_path, num_devices, "eval_input_reader")
    if (mesh is None and num_devices and num_devices > 1
            and not launch.in_process_group()):
        if bundle is not None or state is not None:
            raise ValueError("bundle / state live in this process: evaluate "
                             "them with the mesh of their own ranks")
        devs = mesh_mod.rank_devices(num_devices, devices, device)
        return launch.spawn(_evaluate_rank, num_devices, devs, args=(
            config_path, checkpoint, dict(
                ckpt_step=ckpt_step, variables=variables,
                output_dir=output_dir, measure_time=measure_time,
                seed=seed)))
    if mesh is None:
        mesh = dp_mesh(num_devices, devices, device)
    return _evaluate(config_path, checkpoint, ckpt_step=ckpt_step,
                     bundle=bundle, state=state, variables=variables,
                     output_dir=output_dir, measure_time=measure_time,
                     device=mesh.device if mesh is not None else device,
                     seed=seed, mesh=mesh)


def _evaluate_rank(mesh: Mesh, config_path, checkpoint, kwargs: dict):
    """One spawned rank of :func:`evaluate`."""
    return _evaluate(config_path, checkpoint, device=mesh.device, mesh=mesh,
                     **kwargs)


def _evaluate(config_path, checkpoint=None, *, ckpt_step=None, bundle=None,
              state=None, variables=None, output_dir=None,
              measure_time=False, device="cuda", seed=0,
              mesh: Optional[Mesh] = None) -> dict:
    """:func:`evaluate` on one rank of ``mesh``, or alone."""
    dev = resolve_device(device)
    main = mesh is None or mesh.is_main
    bundle = bundle or Bundle(config_path)
    prep_ds, loader = (bundle.input_reader(training=False) if main
                       else (None, None))
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
    if mesh is not None and state is None:
        mesh_mod.replicate(model, mesh)
    predict_fn = make_predict_fn(bundle)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    timers = {"host_feed": 0.0, "device": 0.0, "convert": 0.0}
    detections = []
    nb = 0
    example = None
    batches = iter(loader) if main else None
    t0 = time.perf_counter()
    while True:
        batch = next(batches, None) if main else None
        rows = batch
        if mesh is not None:    # each rank's rows of rank 0's batch
            rows = mesh_mod.scatter_batch(
                None if batch is None else batching.device_example(batch),
                mesh)
        if rows is None:
            break
        out = None
        if len(rows["voxels"]):
            example = to_device(rows, dev)
            sync()
            t1 = time.perf_counter()
            out = {k: v.cpu().numpy()
                   for k, v in predict_fn(example).items()}
        else:                   # a short last batch left this rank none
            t1 = time.perf_counter()
        if mesh is not None:
            out = mesh_mod.gather_objects(out, mesh)
            out = mesh_mod.concat_rows(out) if main else None
        t2 = time.perf_counter()
        if main:
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
    if measure_time and nb and main:
        for k, v in timers.items():
            print(f"[measure_time] {k}: {v / nb * 1e3:.1f} ms/batch (the "
                  f"first batch includes warm-up)")
        for name, ms in stage_times_ms(bundle, example).items():
            print(f"[measure_time] stage {name}: {ms:.1f} ms/batch")
    result = None
    if main:
        result = _score(bundle, prep_ds.dataset, detections, output_dir)
    if mesh is not None:
        result = mesh_mod.broadcast_object(result, mesh)
    return result


def import_torch_weights(config_path, model_dir, torch_ckpt, *,
                         strict: bool = True) -> TrainState:
    """Convert a lineage torch checkpoint (``voxelnet-*.tckpt`` / ``.pt``
    state_dict) into this trainer's checkpoint at step 0 under
    ``model_dir``, with ``pipeline.config`` beside it: the port of the JAX
    package's ``train/train.py::import_torch_weights`` (:586).

    Afterwards ``evaluate(config_path, model_dir)`` serves the imported
    weights and ``train(..., resume=True)`` fine-tunes from them, with
    step 0's optimizer state as :func:`init_state` makes it.  Nothing
    runs a network: the state is built and written on the host."""
    model_dir = pathlib.Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    saved = model_dir / "pipeline.config"
    if not (saved.exists() and saved.samefile(config_path)):
        shutil.copyfile(config_path, saved)
    state = init_state(Bundle(config_path), device="cpu")
    load_torch_checkpoint(torch_ckpt, state.model, strict=strict)
    ckpt_mod.CheckpointManager(model_dir).save(0, state, force=True)
    return state


def _score(bundle: Bundle, dataset, detections: list, output_dir) -> dict:
    """Point refinement of the configured classes, then the dataset's AP."""
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
