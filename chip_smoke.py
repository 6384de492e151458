"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the toolchain (torch, CUDA, nvcc, triton, the card);
2. builds every kernel in ``automatic_as_built_reconstruction_tpu_torch/
   csrc/`` with nvcc (one process per source, all at once), prints what
   ptxas reports (registers, shared memory, spills), and checks with
   ``cuobjdump -sass`` that every sparse-GEMM kernel multiplies in TF32 on
   the tensor cores and fills shared memory by cp.async;
3. serves the as-built pillar detector (``asbuilt_pillars.config`` at full
   width, trained ``artifacts/asbuilt_r2_step8000.pkl``) through
   ``pod_inference_from_checkpoint``: four requests of two synthetic
   scans each (scenes 0-7), served twice over after a warm-up, with
   the kernels' launch counters set to 0 just before and read just
   after; reports the latency's median and range and the scans/s;
   checks the detections against the port's own CPU run and against the
   detection counts the JAX package gives on scans 0 and 1.  The process
   keeps PyTorch's default flags (TF32 on for cuDNN): the entry points
   run fp32 with TF32 off inside their calls, and the run checks that they
   leave the flags as they found them;
4. serves SECOND (``car.fhd.serving.config`` at full width: 1408 x 1600 x
   40 voxels, the SpMiddleFHD stack, RPN 128, 70 400 anchors; weights and
   BatchNorm statistics drawn from a seed, there being no trained
   checkpoint) the same way: four requests of two 18 000-point scans
   each (scenes 1000-1007), twice over after a warm-up, in the config's
   key-match mode, and once over with ``sparse_keymatch=False`` (the
   gather-GEMM mode on device-built rulebooks), once over with
   ``voxelization="fused_mean"`` (the fused voxelize+mean's key route as
   the input stage; the detections must equal the hard mode's) and once
   over
   with ``voxelization="dynamic"`` (against the port's own CPU run),
   counters read for each; checks head outputs and detections against
   the port's own CPU run, the modes against each other, the launch
   counts against the plan, and prints each block's
   ``capacity_saturated``;
5. runs ``evaluate`` on the 32 synthetic val scenes of
   ``asbuilt_pillars.config`` with the trained checkpoint (host reader,
   network and ``predict`` on the card, point refinement, AP) and holds
   every AP to the value the JAX package's ``evaluate`` gives;
6. trains ``asbuilt_pillars.config`` at full width through ``train()``
   (60 steps of a one-cycle run from seeded weights, B = 2, into a
   temporary model directory; grad on in its own scope), the counters set
   to 0 just before and read just after (K1's scatter and its backward,
   the gather kernel, once a step each); reports steps/s, the loss of
   each 10-step window, the host prep of a batch against the device step
   (CUDA events on one batch) and a profile of one step (busy share, top
   kernels, events); checks that the loss is finite and its last window
   below its first, that the network ran with TF32 off, and that one step
   on the card matches the port's CPU step from the same weights and
   batch (loss terms, every gradient, the parameters after the update and
   the BatchNorm statistics; every PFN gradient nonzero); runs
   ``evaluate`` on the port's own checkpoint (AP printed, not held); and
   restarts with a larger ``max_steps``, which must resume at the saved
   step;
6b. trains SECOND (``car.fhd.config`` at full width: B = 6, 17 000
   voxels, the SpMiddleFHD stack in key-match mode, RPN 128, 70 400
   anchors, the gt-database sampler and the augmentation, three loader
   threads) through ``train()`` for 40 steps on a synthetic KITTI clone
   that the port's generator writes into a temporary directory (48
   training and 12 validation frames from seed 0, with the offline prep:
   infos, reduced clouds, the gt database); where the plan's own site
   caps raise ``CapacitySaturationError`` it says so and takes the caps
   the reference measured for this config.  The counters are set to 0
   just before and read just after: the forward join and its backward
   (dW every join, the rulebook's inverse and dfeatures every join but
   the first) once a join a step, as the plan says.  It reports steps/s
   of each window, host prep of a batch on one thread against the device
   step (events) and, at the end, a profile of one step; checks the loss
   (finite, the last window below the first), one step at B = 2 in
   float32 on the kernels against float64 on the plain versions on the
   card (loss terms, every gradient, the parameters after the update, the
   BatchNorm statistics), records one step's backward calls for the
   kernel phase, runs ``evaluate`` on the validation frames (the KITTI
   table printed, not held; the detections of two frames against the
   port's CPU run, as sets), holds the KITTI protocol on the validation
   ground truth given as detections (precision 1 at every threshold it
   samples) and restarts with a larger ``max_steps``, which must resume;
7. holds each kernel against its plain PyTorch version on the card, on
   the inputs the main paths gave it (for the pillar scatter also with
   the rows shuffled, and its backward on the training step's canvas
   gradient, shuffled and with negative ids, timed against its bound and
   the scatter timed against zeros + ``index_copy_`` in alternation, 30
   turns each; the sparse joins' backward kernels at every join of a
   SECOND training step, against the plain backward, with their device
   time and bound; for the rotated IoU the pillar and SECOND inputs, a
   1000 x 1000 set with degenerate boxes and one of nearly touching pairs,
   each with the outputs equal bit for bit and the share of the pairs
   each of its rejection tests takes; for the two sparse GEMMs every join
   of a request,
   each with its device time, bound and tile occupancy, the four call
   forms of the key-match function, and unsorted keys; for the fused
   voxelize+mean both routes on the served request, a pillar-sized scan, a
   truncating voxel cap, T = 1, an empty scan, NaN and on-face points and
   more slots than points, the key route's two kernels against their plain
   mirrors and the table kernel bit for bit, and at both served shapes the
   device time and device events of the function, its kernels, the sort
   and the table route);
   times kernel, plain version and library call with CUDA events (median
   and range) and with torch.profiler (device time of the kernels,
   memsets and copies a call launches, the ``ms`` it reports), L2 flushed
   before each call; checks the flat pillar VFE path against the padded
   one on a served request, and that it gives the same bits twice;
8. times an empty kernel (one block, and the grids of K1 and K5) as the
   launch floor beside those two;
9. prints a ``{"kernels": [...]}`` line (``launches`` is the sum over the
   eight main paths, ``launches_by_path`` each path's own count; K1's
   entry carries its backward's ``backward_*`` numbers, the two sparse
   GEMMs' entries those of the joins' shared backward), the card's
   name and power limit as ``nvidia-smi`` reports them, and last
   ``{"ok": true, "device": ...}``.

Exits non-zero, with no result lines, when CUDA is unavailable or any
phase fails.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import functools
import json
import math
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from automatic_as_built_reconstruction_tpu_torch.data import (
    batching, synth_kitti)
from automatic_as_built_reconstruction_tpu_torch.data.building import (
    generate_building_scene, pad_batch)
from automatic_as_built_reconstruction_tpu_torch.data.kitti_like import (
    make_scene)
from automatic_as_built_reconstruction_tpu_torch.device import fp32_math
from automatic_as_built_reconstruction_tpu_torch.models import (
    middle, pointpillars, voxelnet as voxelnet_mod)
from automatic_as_built_reconstruction_tpu_torch.models.voxelnet import (
    VoxelNet, middle_plan, predict)
from automatic_as_built_reconstruction_tpu_torch.ops import (
    _build, nms, pillar_scatter, rotated_iou, sparse_gather_gemm, voxel_mean)
from automatic_as_built_reconstruction_tpu_torch.ops.voxelize import (
    slot_table, voxelize, voxelize_flat)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    PodInference, inference, pod_inference_from_checkpoint)
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    detections_mismatch)
from automatic_as_built_reconstruction_tpu_torch.utils import (
    eval as eval_mod)
from automatic_as_built_reconstruction_tpu_torch.train import (
    checkpoint as ckpt_mod, train as train_mod)
from automatic_as_built_reconstruction_tpu_torch.train.train import evaluate

ROOT = Path(__file__).resolve().parent
CONFIG = (ROOT / "automatic_as_built_reconstruction_tpu_torch" / "configs"
          / "building" / "asbuilt_pillars.config")
CHECKPOINT = ROOT / "artifacts" / "asbuilt_r2_step8000.pkl"
MAX_VOXELS, MAX_POINTS = 25600, 24
REQUESTS = [(0, 1), (2, 3), (4, 5), (6, 7)]      # scene seeds, B = 2 each
ROUNDS = 2                                       # times each is served
# detections per class (wall, column, door) of the JAX package's
# PodInference on scenes 0 and 1 (tests/test_torch_serving.py)
JAX_COUNTS_SCENES_0_1 = [[34, 1, 6], [35, 6, 10]]
BOX_ATOL, SCORE_ATOL = 1e-3, 1e-4
IOU_ATOL = 1e-5
# what the JAX package's evaluate() gives on the 32 val scenes with the
# same config and checkpoint (CPU run of tests/test_torch_eval.py::
# test_evaluate_all_val_scenes_ap_matches_reference, which prints them)
JAX_EVAL_AP = {
    "wall.bev.ap": 0.842663, "wall.bev.num_gt": 1063,
    "wall.3d.ap": 0.842663, "wall.3d.num_gt": 1063,
    "column.bev.ap": 0.962588, "column.bev.num_gt": 71,
    "column.3d.ap": 0.962588, "column.3d.num_gt": 71,
    "door.bev.ap": 0.925938, "door.bev.num_gt": 115,
    "door.3d.ap": 0.925938, "door.3d.num_gt": 115,
    "mAP.bev": 0.910396, "mAP.3d": 0.910396}
EVAL_AP_ATOL = 1e-3
# fused voxelize+mean kernel vs its plain version: the kernel adds a
# voxel's points in arrival order, torch.sum in its own
MEAN_TOL = dict(rtol=1e-6, atol=1e-6)
K5_TRUNCATING_CAP = 2000     # a voxel cap far below a scan's occupied cells
# flat vs padded pillar VFE: the flat path adds a pillar's points one after
# another, torch.sum on the padded path in its own order, so the mean
# differs by an ulp of a 16 m coordinate (2e-6); the cluster offsets
# (centimetres) carry that as 1e-4 relative, and the trained PFN weights
# and BN scales amplify it.  The CPU test (tests/test_torch_models.py,
# random weights of a tiny config) holds the two at FLAT_CPU_TOL; the
# difference here is logged against it
FLAT_TOL = dict(rtol=1e-3, atol=1e-3)
FLAT_CPU_TOL = dict(rtol=1e-5, atol=1e-5)
# SECOND: car.fhd.serving.config, its voxel caps, seeded state
SECOND_CONFIG = (ROOT / "automatic_as_built_reconstruction_tpu_torch"
                 / "configs" / "second" / "car" / "car.fhd.serving.config")
SECOND_MAX_VOXELS, SECOND_MAX_POINTS, SECOND_SEED = 17000, 5, 0
SECOND_REQUESTS = [(1000, 1001), (1002, 1003), (1004, 1005), (1006, 1007)]
# GPU vs CPU head outputs: 14 sparse / dense conv + BN layers and the
# RPN's 6, fp32-accurate sums in another order on each side (3xTF32 tap by
# tap on the tensor cores in the kernels and cuDNN on the card; one
# matmul and oneDNN on the CPU)
HEAD_TOL = dict(rtol=5e-4, atol=5e-4)
# kernel vs plain on the card: up to 27 x 64 products, 3xTF32 (as accurate
# as fp32: tests/test_torch_sparse_gemm.py) summed tap by tap on the
# tensor cores, against one fp32 cuBLAS dot, on values of order 1
GEMM_ATOL = 1e-4
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores, and the dense TF32 tensor-core rate over the
# three products of a 3xTF32 split (the sparse GEMMs' fp32-exact route)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_3X_PER_S = 495e12 / 3
L2_FLUSH_BYTES = 64 << 20        # > the H100's 50 MB L2
# pillar training: steps of the one-cycle run from seeded weights, its
# display window (the loss check compares the first and last windows),
# and the steps the restart adds
TRAIN_STEPS, TRAIN_DISPLAY, TRAIN_RESUME_STEPS = 60, 10, 5
# one training step on the card against the port's CPU step from the same
# weights and batch (train_step_mismatch says how each is held): loss
# terms; gradients against a float64 step (the floor of the card's worst
# error, as a share of a tensor's max |g|); the float64 steps of the two
# devices; parameters after the update
# and BatchNorm statistics, where an element whose gradient is near zero
# (|g| < TRAIN_G_NOISE * max|g|) or differs between the devices by more
# than TRAIN_G_AGREE of itself may take another Adam step (about
# lr * g / |g|)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_ATOL_SHARE = 1e-3
TRAIN_F64_RTOL = 1e-9
TRAIN_PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
TRAIN_G_NOISE, TRAIN_G_AGREE = 1e-3, 1e-3
K1_TURNS = 30                    # K1 against index_copy_, in alternation
# the sparse joins' backward kernels against their plain version on the
# same rulebook: rtol, and atol as a share of the gradient's max |g|.  A
# dW entry is an fp32 sum over the hit rows of a tap (up to ~1.5e5 of them
# at B = 6), which the kernel adds in passes of 128 rows and the plain
# einsum in cuBLAS's blocks: the plain version alone is ~2e-5 of max |g|
# from float64 at the largest join (both sides' float64 errors are logged
# there)
JOIN_GRAD_TOL = 1e-4
# SECOND training: car.fhd.config on a synthetic KITTI clone of the port's
# generator (frames from seed 0; the reference's rehearsal writes 400 and
# 100), 40 steps of its 99 040 in 10-step windows, the steps a restart
# adds; the site caps the reference measured for this config on its clone
# (tools/kitti_rehearsal.py:155), taken only where the plan's own caps
# raise CapacitySaturationError; the batch of the float32 / float64 step
SECOND_TRAIN_CONFIG = (ROOT / "automatic_as_built_reconstruction_tpu_torch"
                       / "configs" / "second" / "car" / "car.fhd.config")
SYNTH_TRAIN, SYNTH_VAL = 48, 12
SECOND_TRAIN_STEPS, SECOND_DISPLAY, SECOND_RESUME_STEPS = 40, 10, 2
MEASURED_SITE_CAPS = (49280, 51968, 29696, 28800)
SECOND_STEP_B = 2
# the card's float32 SECOND step against the float64 step of the plain
# versions on the card: a tensor's gradient within SECOND_GRAD_SHARE of
# its max |g|, the median tensor within SECOND_GRAD_MEDIAN_SHARE.  Set
# from this step's own sound runs on an H100 80GB HBM3 at 700 W (worst
# 6.4e-4, median 2.1e-5 of max |g|, PERF.md), about 8x and 10x above
# them: float32 rounding moves single ReLU inputs across zero in the
# RPN's last blocks, which moves their gradients by a share of max |g|.
# The same step with TF32 on (the lower-precision control) is printed
# beside it; the kernels themselves are held per join below
SECOND_GRAD_SHARE, SECOND_GRAD_MEDIAN_SHARE = 5e-3, 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60)
        return (out.stdout + out.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def toolchain() -> str:
    """Print the toolchain; return nvidia-smi's 'name, power.limit'."""
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    nvcc = run([_build.nvcc_path(), "--version"])
    log("nvcc: " + nvcc.splitlines()[-1] if nvcc else "nvcc: ?")
    try:
        import triton
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import: {e}")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"device_count {torch.cuda.device_count()}")
    return smi


# an empty kernel: its device time is the least a launch of that grid
# takes on this card, the floor beside K1 and K5
EMPTY_KERNEL_SRC = r'''
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return (int)cudaGetLastError();
}
'''


def build_kernels() -> Path:
    """Build every kernel and the empty one, all nvcc processes started
    together.  -> the empty kernel's library."""
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "empty_kernel.cu"
    src.write_text(EMPTY_KERNEL_SRC)
    empty = _build.BUILD_DIR / "libempty_kernel.so"
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(empty), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    result = _build.build_all()
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise _build.KernelBuildError(f"empty kernel: {out}")
    per_source = ", ".join(f"{name} {r['seconds']:.1f} s"
                           for name, r in result.items())
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall ({per_source})")
    for name, r in result.items():
        for line in r["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                log(f"  ptxas {name}: {line.strip()}")
    check_sparse_gemm_sass()
    return empty


def launch_floor(lib: Path, card: str, grids: dict) -> dict:
    """Device time (torch.profiler, as ``device_time``) and event times of
    the empty kernel: one block of 32 threads, and each grid of ``grids``
    ({name: (blocks, threads)}).  -> {"one block" or name: device ms}."""
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    floors = {}
    for what, (blocks, threads) in {"one block": (1, 32), **grids}.items():
        def call():
            _build.check(fn(blocks, threads,
                            torch.cuda.current_stream().cuda_stream),
                         "empty_launch")
        ms, _ = device_ms(call)
        ev = cuda_ms(call)
        floors[what] = ms
        log(f"launch floor [{card}]: empty kernel, {blocks} x {threads} "
            f"threads ({what}): device "
            f"{'not measured' if ms is None else f'{ms:.5f} ms'} "
            f"(torch.profiler), events {fmt_range(ev)}")
    return floors


def check_sparse_gemm_sass() -> None:
    """Every instantiation of the two sparse-GEMM kernels multiplies on the
    tensor cores in TF32 (HMMA ... TF32) and fills shared memory with
    cp.async (LDGSTS): ``cuobjdump -sass`` of the built library."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = run([str(cuobjdump), "-sass",
                str(_build.lib_path("sparse_gather_gemm"))])
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        if "gemm_kernel" not in name:
            continue
        lines = body.splitlines()
        counts[name.strip()] = {
            "hmma_tf32": sum("HMMA" in x and "TF32" in x for x in lines),
            "ldgsts": sum("LDGSTS" in x for x in lines)}
    log(f"sparse GEMM SASS (cuobjdump -sass): {json.dumps(counts)}")
    opcodes = sorted({x.split()[1] for x in sass.splitlines()
                      if "HMMA" in x and len(x.split()) > 1})
    log(f"  HMMA opcodes: {opcodes}")
    bad = [n for n, c in counts.items() if not (c["hmma_tf32"]
                                                and c["ldgsts"])]
    if len(counts) != 10 or bad:
        raise AssertionError(f"sparse GEMM kernels without TF32 HMMA or "
                             f"LDGSTS: {bad or counts}")


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> list:
    """[median, min, max] ms per call, CUDA events around each call
    (host launch overhead included), L2 flushed before each (a serving
    call finds its inputs cold at worst)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return [float(np.median(times)), min(times), max(times)]


def fmt_range(t: list) -> str:
    return f"{t[0]:.4f} ms (range {t[1]:.4f}-{t[2]:.4f})"


def device_profile(fn, iters: int = 20):
    """Device time per call summed over the kernels, memsets and copies
    ``fn`` launches (torch.profiler / CUPTI, one profiling window), L2
    flushed before each call by a 64 MB ``bitwise_not`` (left out): the
    card's own time without the host's launch overhead.  Returns (ms,
    {name: ms}, device events a call), or (None, {}, 0) when the profiler
    saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    src = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            torch.bitwise_not(src, out=dst)
            fn()
        torch.cuda.synchronize()
    per_kernel, n = {}, 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "bitwise_not" not in e.name):
            n += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3 / iters)
    if not per_kernel:
        return None, {}, 0
    return sum(per_kernel.values()), per_kernel, n / iters


def device_ms(fn, iters: int = 20):
    """:func:`device_profile` without the event count: (ms, {name: ms})."""
    return device_profile(fn, iters)[:2]


def fmt_kernels(per_kernel: dict) -> str:
    return "; ".join(f"{name[:60]} {ms:.4f} ms"
                     for name, ms in sorted(per_kernel.items(),
                                            key=lambda kv: -kv[1]))


@contextlib.contextmanager
def substituted(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def recording(module, name: str, calls: list):
    """Record the arguments of every call to ``module.name``."""
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    # the wrapper shares the function's attributes: a kernel wrapper that
    # counts its launches through its own module-level name still counts
    # them on itself
    rec.__dict__ = orig.__dict__
    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

# the port's kernel wrappers (K1 is two: the scatter and, in training, its
# backward, the gather; the sparse joins' backward is three: the rulebook
# inverse, dfeatures through the gather-GEMM kernel, the dW reduction; K5
# is three: its key route's key kernel and segment-and-mean kernel, and
# the first-appearance route's table kernel), and where the main paths
# look each kernel or function up
KERNELS = {"pillar_scatter": pillar_scatter.scatter_sorted_to_canvas,
           "pillar_gather": pillar_scatter.pillar_gather,
           "rotated_iou": rotated_iou.rotate_iou_matrix,
           "keymatch_gemm": sparse_gather_gemm.keymatch_gemm,
           "gather_gemm": sparse_gather_gemm.gather_gemm,
           "rulebook_inverse": sparse_gather_gemm.rulebook_inverse,
           "join_grad_features": sparse_gather_gemm.join_grad_features,
           "join_grad_weights": sparse_gather_gemm.join_grad_weights,
           "voxel_keys": voxel_mean.point_keys,
           "voxel_mean": voxel_mean.segment_mean,
           "voxel_mean_table": voxel_mean.mean_from_table}
CALL_SITES = {"pillar_scatter": (pointpillars, "scatter_sorted_to_canvas"),
              "pillar_gather": (pillar_scatter, "pillar_gather"),
              "rotated_iou": (nms, "rotate_iou_matrix"),
              "keymatch_gemm": (middle, "keymatch_gemm"),
              "gather_gemm": (middle, "gather_gemm"),
              "join_grad_features": (sparse_gather_gemm,
                                     "join_grad_features"),
              "join_grad_weights": (sparse_gather_gemm, "join_grad_weights"),
              "voxel_mean": (inference, "fused_voxelize_mean")}


def drive(what: str, card: str, pod, requests, rounds: int, expect: dict):
    """One main path: a warm-up request (cuDNN plans, allocator; it
    records every kernel wrapper's arguments), then every request
    ``rounds`` times over with all launch counters set to 0 just before
    and read just after.  ``expect`` maps a kernel of this path to its
    exact count (None: at least one a request); every other kernel must
    count 0.  -> (outputs, latencies ms, launches, recorded calls)."""
    calls = {name: [] for name in KERNELS}
    with contextlib.ExitStack() as stack:
        for name, (module, attr) in CALL_SITES.items():
            stack.enter_context(recording(module, attr, calls[name]))
        pod(*requests[0])
    torch.cuda.synchronize()

    for fn in KERNELS.values():
        fn.launches = 0
    outs, lat = [], []
    t_all = time.perf_counter()
    for _ in range(rounds):
        for pts, nv in requests:
            t = time.perf_counter()
            outs.append(pod(pts, nv))    # returns host numpy: synchronised
            lat.append((time.perf_counter() - t) * 1e3)
    total_s = time.perf_counter() - t_all
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    log(f"{what}: launches on the main path {launches} over {len(outs)} "
        f"requests")
    for name, n in launches.items():
        want = expect.get(name, 0)
        if (n < len(outs)) if want is None else (n != want):
            raise AssertionError(
                f"{what}: kernel {name} launched {n} times on the main "
                f"path, expected "
                f"{'at least one a request' if want is None else want}")
    n_scans = sum(len(nv) for _, nv in requests) * rounds
    log(f"{what} [{card}]: {len(outs)} requests (B=2), latency ms median "
        f"{np.median(lat):.3f}, mean {np.mean(lat):.3f}, range "
        f"{min(lat):.3f}-{max(lat):.3f}; {n_scans / total_s:.2f} scans/s "
        f"over {n_scans} scans; all ms {[round(x, 3) for x in lat]}")
    splits = [stage_split_ms(pod, *r) for r in requests]
    log(f"{what} [{card}]: stage split ms (each B=2 request once, "
        f"synchronised per stage) " + json.dumps(
            {k: [round(sp[k], 3) for sp in splits] for k in splits[0]}))
    return outs, lat, launches, calls


def check_outputs(what: str, outs, pod) -> None:
    """Shapes and finite boxes of every request's output."""
    C = pod.cfg.num_class
    for out in outs:
        if out["box3d_lidar"].shape != (2, C * pod.cfg.nms_post_max_size, 7):
            raise AssertionError(f"{what}: bad output shape "
                                 f"{out['box3d_lidar'].shape}")
        if not np.isfinite(out["box3d_lidar"][out["valid"]]).all():
            raise AssertionError(f"{what}: non-finite boxes")


def stage_split_ms(pod, points, num_valid) -> dict:
    """Host clock per stage, synchronised after each (one request)."""
    cfg = pod.cfg
    pts = torch.as_tensor(points, device=pod.device)
    nv = torch.as_tensor(num_valid, device=pod.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), fp32_math():
        vox = pod.voxelize(pts, nv)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        preds = pod.model(*vox)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        anchors = pod.anchors[None].expand(pts.shape[0], *pod.anchors.shape)
        predict(preds, anchors, cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    return {"voxelize": (t1 - t0) * 1e3, "network": (t2 - t1) * 1e3,
            "decode_nms": (t3 - t2) * 1e3}


def profile_call(what: str, call, card: str, latency_ms: float) -> dict:
    """One ``call()`` under torch.profiler: device busy time, its share of
    the profiled wall time and of the unprofiled latency, and the kernels
    that take it.  -> {"wall_ms", "busy_ms", "busy_share", "events",
    "top"}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
    busy = sum(per_kernel.values())
    top = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10])
    log(f"{what} [{card}]: profiled call: wall {wall_ms:.3f} ms, device "
        f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} % of the profiled "
        f"wall, idle {100 - 100 * busy / wall_ms:.1f} %; "
        f"{100 * busy / latency_ms:.1f} % of the unprofiled median "
        f"latency {latency_ms:.3f} ms), {n} device events; top: "
        f"{fmt_kernels(top)}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy_share": busy / wall_ms,
            "events": n, "top": top}


def serve(card: str):
    """The pillar path.  -> (pod, requests, median latency ms, launches,
    recorded K1 call, recorded K2 call)."""
    flags = tf32_flags()
    log(f"serving: the process's own flags, as a caller has them: "
        f"torch.backends.cudnn.allow_tf32 = {flags[0]}, "
        f"torch.backends.cuda.matmul.allow_tf32 = {flags[1]}; the entry "
        f"points run fp32 with TF32 off inside their calls")
    t0 = time.perf_counter()
    pod = pod_inference_from_checkpoint(
        CONFIG, CHECKPOINT, device="cuda", max_voxels=MAX_VOXELS,
        max_points_per_voxel=MAX_POINTS)
    requests = [pad_batch([generate_building_scene(s) for s in seeds])
                for seeds in REQUESTS]
    log(f"serving: model + {len(requests)} requests ready in "
        f"{time.perf_counter() - t0:.1f} s; points per scan "
        f"{[r[1].tolist() for r in requests]}")
    outs, lat, launches, calls = drive(
        "serving", card, pod, requests, ROUNDS,
        {"pillar_scatter": len(requests) * ROUNDS, "rotated_iou": None})

    # correctness: shapes, finite, JAX counts, the port's CPU run
    C = pod.cfg.num_class
    check_outputs("serving", outs, pod)
    counts = [np.bincount(d["label_preds"], minlength=C).tolist()
              for d in pod.detections_list(outs[0])]
    log(f"serving: detections per class on scenes 0, 1: {counts}")
    if counts != JAX_COUNTS_SCENES_0_1:
        raise AssertionError(f"counts {counts} != JAX package's "
                             f"{JAX_COUNTS_SCENES_0_1}")
    cpu = pod_inference_from_checkpoint(
        CONFIG, CHECKPOINT, device="cpu", max_voxels=MAX_VOXELS,
        max_points_per_voxel=MAX_POINTS)
    cpu_outs = [cpu(*req) for req in requests]
    for i, out in enumerate(outs):
        diff = detections_mismatch(out, cpu_outs[i % len(requests)], C,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"request {i}, GPU vs CPU: {diff}")
    if tf32_flags() != flags:
        raise AssertionError(f"serving changed the caller's TF32 flags "
                             f"{flags} to {tf32_flags()}")
    check_network_flags("serving", pod, requests[0])
    n_det = int(sum(o["valid"].sum() for o in outs[:len(requests)]))
    log(f"serving: GPU detections match the port's CPU run on all "
        f"{len(outs)} requests (boxes atol {BOX_ATOL}, scores atol "
        f"{SCORE_ATOL}); {n_det} detections per round")
    return (pod, requests, float(np.median(lat)), launches,
            calls["pillar_scatter"][0], calls["rotated_iou"][0])


# --------------------------------------------------------------------------
# SECOND serving
# --------------------------------------------------------------------------

def head_outputs(pod, request) -> dict:
    """The network's raw prediction maps for one request, on the host."""
    return {k: v.float().cpu() for k, v in pod.heads(*request).items()}


def tf32_flags() -> tuple:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def flags_in_modules():
    """-> the set of :func:`tf32_flags` that any module's forward saw
    at its start inside the block."""
    seen = set()
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda *_: seen.add(tf32_flags()))
    try:
        yield seen
    finally:
        handle.remove()


@contextlib.contextmanager
def tf32_on():
    """TF32 on for cuDNN convolutions and cuBLAS matmuls inside the
    block; the flags restored after."""
    before = tf32_flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def check_network_flags(what: str, pod, request) -> None:
    """Inside ``heads()`` and ``__call__`` every module of the network
    runs with TF32 off, whatever the process's flags."""
    with flags_in_modules() as seen:
        pod.heads(*request)
        pod(*request)
    if seen != {(False, False)}:
        raise AssertionError(f"{what}: the network ran with TF32 flags "
                             f"{sorted(seen)}")
    log(f"{what}: every module of the network saw cuDNN and matmul TF32 "
        f"off inside heads() and __call__ (the process's flags "
        f"{tf32_flags()})")


def heads_mismatch(got: dict, ref: dict):
    """-> ({head: max abs difference}, first head outside HEAD_TOL)."""
    err = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
    bad = [k for k in ref if not torch.allclose(got[k], ref[k], **HEAD_TOL)]
    return err, (bad[0] if bad else None)


def serve_second(card: str):
    """The SECOND path in both sparse-conv modes and, in key-match mode,
    with the fused voxelize+mean and the dynamic input stage.  -> dict
    with the pods, the requests, the median latency, launches and
    recorded kernel calls of each mode."""
    t0 = time.perf_counter()
    kw = dict(max_voxels=SECOND_MAX_VOXELS,
              max_points_per_voxel=SECOND_MAX_POINTS)
    pod = pod_inference_from_checkpoint(SECOND_CONFIG, None, device="cuda",
                                        seed=SECOND_SEED, **kw)
    cfg = pod.cfg
    if not (cfg.sparse_keymatch and cfg.sparse_use_pallas_gemm):
        raise AssertionError("car.fhd.serving.config is not in key-match "
                             "mode")
    # the gather-GEMM mode: the same weights, rulebooks built on device
    gg_cfg = dataclasses.replace(cfg, sparse_keymatch=False)
    gg_model = VoxelNet(gg_cfg)
    gg_model.load_state_dict(pod.model.state_dict(), strict=True)
    gg = PodInference(gg_model, gg_cfg, pod.anchors.cpu().numpy(),
                      device="cuda", **kw)
    # the other two input stages: the same model object
    fused = PodInference(pod.model, cfg, pod.anchors.cpu().numpy(),
                         device="cuda", voxelization="fused_mean", **kw)
    dyn = PodInference(pod.model, cfg, pod.anchors.cpu().numpy(),
                       device="cuda", voxelization="dynamic", **kw)
    requests = [pad_batch([make_scene(s) for s in seeds])
                for seeds in SECOND_REQUESTS]
    plan = middle_plan(cfg, SECOND_MAX_VOXELS)
    n_sparse = len(plan) - cfg.sparse_dense_tail_blocks
    joins = sum(b.n_subm + 1 for b in plan[:n_sparse])
    log(f"second: grid {cfg.grid_size}, plan "
        f"{[(b.grid, b.in_cap, b.out_cap) for b in plan]}, "
        f"{n_sparse} sparse blocks with {joins} joins a request (the batch "
        f"is the launch grid's second axis) + "
        f"{cfg.sparse_dense_tail_blocks} dense; {pod.anchors.shape[0]} "
        f"anchors; models + {len(requests)} requests ready in "
        f"{time.perf_counter() - t0:.1f} s")

    result = {"pod": pod, "gg": gg, "fused": fused, "dyn": dyn,
              "requests": requests}
    n = len(requests)
    outs, lat, result["km_launches"], result["km_calls"] = drive(
        "second key-match", card, pod, requests, ROUNDS,
        {"keymatch_gemm": joins * n * ROUNDS, "rotated_iou": None})
    gg_outs, gg_lat, result["gg_launches"], result["gg_calls"] = drive(
        "second gather-GEMM", card, gg, requests, 1,
        {"gather_gemm": joins * n, "rotated_iou": None})
    fm_outs, fm_lat, result["fm_launches"], result["fm_calls"] = drive(
        "second fused_mean", card, fused, requests, 1,
        {"keymatch_gemm": joins * n, "rotated_iou": None, "voxel_keys": n,
         "voxel_mean": n})
    dyn_outs, dyn_lat, result["dyn_launches"], _ = drive(
        "second dynamic", card, dyn, requests, 1,
        {"keymatch_gemm": joins * n, "rotated_iou": None})
    result["latency_ms"] = float(np.median(lat))
    result["gg_latency_ms"] = float(np.median(gg_lat))
    result["fm_latency_ms"] = float(np.median(fm_lat))
    result["dyn_latency_ms"] = float(np.median(dyn_lat))
    check_outputs("second", outs + gg_outs + fm_outs + dyn_outs, pod)
    sat = {mode: {k: int(v) for k, v in p.model.middle_feature_extractor
                  .capacity_saturated.items()}
           for mode, p in (("key-match", pod), ("gather-GEMM", gg))}
    log(f"second: capacity_saturated per block (scans of the last request "
        f"that filled the block's site capacity) {sat}")
    if any(v for d in sat.values() for v in d.values()):
        log("second: WARNING: a block's site capacity saturated: sites "
            "beyond it were truncated in key order")
    log(f"second: detections per scan, first round: "
        f"{[o['valid'].sum(-1).tolist() for o in outs[:n]]}")

    # the two modes against each other
    heads_km = head_outputs(pod, requests[0])
    err, bad = heads_mismatch(head_outputs(gg, requests[0]), heads_km)
    log(f"second: gather-GEMM vs key-match head outputs, max abs diff {err}")
    if bad is not None:
        raise AssertionError(f"second: modes disagree on {bad}: {err}")
    for i in range(n):
        diff = detections_mismatch(gg_outs[i], outs[i], cfg.num_class,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"second request {i}, gather-GEMM vs "
                                 f"key-match: {diff}")

    # the fused input stage against the hard one: K5's contract says equal
    err, bad = heads_mismatch(head_outputs(fused, requests[0]), heads_km)
    log(f"second: fused_mean vs hard head outputs, max abs diff {err}")
    if bad is not None:
        raise AssertionError(f"second: fused_mean differs on {bad}: {err}")
    for i in range(n):
        diff = detections_mismatch(fm_outs[i], outs[i], cfg.num_class,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"second request {i}, fused_mean vs hard: "
                                 f"{diff}")
    worst = max(float(np.abs(fm_outs[i][k].astype(np.float64)
                             - outs[i][k]).max())
                for i in range(n) for k in ("box3d_lidar", "scores"))
    log(f"second: fused_mean detections equal the hard mode's on all {n} "
        f"requests (as sets, boxes atol {BOX_ATOL}, scores atol "
        f"{SCORE_ATOL}); row by row the largest difference is {worst:.3g}")

    # against the port's own CPU run (the plain versions, oneDNN)
    t0 = time.perf_counter()
    cpu = pod_inference_from_checkpoint(SECOND_CONFIG, None, device="cpu",
                                        seed=SECOND_SEED, **kw)
    heads_cpu = head_outputs(cpu, requests[0])
    err, bad = heads_mismatch(heads_km, heads_cpu)
    log(f"second: GPU vs CPU head outputs, max abs diff {err}; std "
        f"{ {k: round(float(v.std()), 4) for k, v in heads_cpu.items()} }; "
        f"tolerance {HEAD_TOL}")
    if bad is not None:
        raise AssertionError(f"second: GPU vs CPU head {bad} differs: {err}")
    check_network_flags("second fused_mean", fused, requests[0])
    # control: the same heads with TF32 on (the network called outside
    # the entry points), to show whether HEAD_TOL tells TF32 from fp32
    with tf32_on():
        tf32 = {k: v.float().cpu()
                for k, v in pod.model(*pod.voxelize(
                    *pod._device_inputs(*requests[0]))).items()}
    err_tf32, bad_tf32 = heads_mismatch(tf32, heads_cpu)
    log(f"second: control, GPU heads with TF32 on vs CPU: max abs diff "
        f"{err_tf32}; "
        f"{'outside' if bad_tf32 is not None else 'within'} {HEAD_TOL}")
    cpu_outs = [cpu(*req) for req in requests]
    for i, out in enumerate(outs):
        diff = detections_mismatch(out, cpu_outs[i % n], cfg.num_class,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"second request {i}, GPU vs CPU: {diff}")
    log(f"second: GPU detections match the port's CPU run on all "
        f"{len(outs)} requests (boxes atol {BOX_ATOL}, scores atol "
        f"{SCORE_ATOL}); CPU run {time.perf_counter() - t0:.1f} s")
    # the dynamic mode against its own CPU run (two requests: a CPU
    # request takes about ten seconds)
    t0 = time.perf_counter()
    cpu_dyn = PodInference(cpu.model, cpu.cfg, cpu.anchors.numpy(),
                           device="cpu", voxelization="dynamic", **kw)
    for i, req in enumerate(requests[:2]):
        diff = detections_mismatch(dyn_outs[i], cpu_dyn(*req), cfg.num_class,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"second dynamic request {i}, GPU vs CPU: "
                                 f"{diff}")
    log(f"second: dynamic-mode GPU detections match the port's CPU run on "
        f"2 requests; detections per scan {dyn_outs[0]['valid'].sum(-1)} "
        f"(hard: {outs[0]['valid'].sum(-1)}); CPU run "
        f"{time.perf_counter() - t0:.1f} s")
    return result


# --------------------------------------------------------------------------
# kernels vs plain versions
# --------------------------------------------------------------------------

def k1_in_turns(kernel, library) -> dict:
    """K1 and its library yardstick timed in alternation (kernel, library,
    library, kernel, ...), K1_TURNS of each, CUDA events around each call
    with L2 flushed before it.  -> {"kernel": [median, min, max],
    "library": [...]}."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for fn in (kernel, library, kernel, library):
        fn()
    times = {"kernel": [], "library": []}
    order = ("kernel", "library", "library", "kernel")
    for i in range(2 * K1_TURNS):
        name = order[i % 4]
        fn = kernel if name == "kernel" else library
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end))
    return {k: [float(np.median(v)), min(v), max(v)]
            for k, v in times.items()}


def phase_k1(call, gather_call, launches: int, gather_launches: int,
             card: str):
    """-> (kernels-line entry with event times, {key: fn} to time on the
    device).  The backward (the gather kernel) on the canvas gradient and
    ids training gave it."""
    (feats, lin, hw), _ = call
    B, V, C = feats.shape
    got = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    ref = pillar_scatter.scatter_sorted_to_canvas_plain(feats, lin, hw)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("pillar_scatter kernel != plain version")
    # the same rows shuffled: unique ids in any order give the same canvas
    perm = torch.randperm(V, device=feats.device,
                          generator=torch.Generator(feats.device)
                          .manual_seed(0))
    shuffled = pillar_scatter.scatter_sorted_to_canvas(
        feats[:, perm].contiguous(), lin[:, perm].contiguous(), hw)
    torch.cuda.synchronize()
    if not (torch.equal(shuffled, ref) and torch.equal(
            shuffled, pillar_scatter.scatter_sorted_to_canvas_plain(
                feats[:, perm], lin[:, perm], hw))):
        raise AssertionError("pillar_scatter with shuffled rows != sorted")
    descents = int((lin[:, perm][:, 1:] < lin[:, perm][:, :-1]).sum())
    log(f"K1 pillar_scatter [{card}]: rows shuffled ({descents} descents in "
        f"the ids): kernel == plain == the sorted call's canvas exactly")
    ok = (lin >= 0) & (lin < hw)
    rows = int(ok.sum())
    # library yardstick: one index_copy_ into the zeroed flat canvas
    flat_idx = (torch.arange(B, device=lin.device)[:, None] * hw
                + lin.long())[ok]
    src = feats[ok]

    def library():
        canvas = torch.zeros((B * hw, C), dtype=feats.dtype,
                             device=feats.device)
        canvas.index_copy_(0, flat_idx, src)
        return canvas

    if not torch.equal(library().view(B, hw, C), ref):
        raise AssertionError("index_copy_ yardstick != plain version")

    # the backward on the training step's canvas gradient and ids, and on
    # the same with the rows shuffled and dropped ids in between
    (dcanvas, glin), _ = gather_call
    gB, ghw, gC = dcanvas.shape
    gV = glin.shape[1]
    gok = (glin >= 0) & (glin < ghw)
    bad_ids = torch.where(torch.arange(gV, device=glin.device) % 7 == 0,
                          -1 - torch.arange(gV, device=glin.device) % 3,
                          glin)
    gperm = torch.randperm(gV, device=glin.device,
                           generator=torch.Generator(glin.device)
                           .manual_seed(1))
    for what, ids in (("training", glin),
                      ("rows shuffled", glin[:, gperm].contiguous()),
                      ("negative ids", bad_ids.int().contiguous())):
        g = pillar_scatter.pillar_gather(dcanvas, ids)
        r = pillar_scatter.pillar_gather_plain(dcanvas, ids)
        torch.cuda.synchronize()
        if not torch.equal(g, r):
            raise AssertionError(f"pillar_gather kernel != plain ({what})")
    grows = int(gok.sum())
    log(f"K1 pillar_gather [{card}]: B={gB} V={gV} C={gC} hw={ghw}, "
        f"{grows} valid rows: kernel == plain exactly on the training "
        f"call, with the rows shuffled and with negative ids")

    fns = {"ms": lambda: pillar_scatter.scatter_sorted_to_canvas(
               feats, lin, hw),
           "plain_ms": lambda: pillar_scatter.scatter_sorted_to_canvas_plain(
               feats, lin, hw),
           "library_ms": library,
           "backward_ms": lambda: pillar_scatter.pillar_gather(dcanvas,
                                                              glin),
           "backward_plain_ms": lambda: pillar_scatter.pillar_gather_plain(
               dcanvas, glin)}
    ev = {k: cuda_ms(fn) for k, fn in fns.items()}
    turns = k1_in_turns(fns["ms"], library)
    # bytes this data needs: the occupied rows' features, every id, the
    # whole canvas written once
    nbytes = rows * C * 4 + B * V * 4 + B * hw * C * 4
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    # the backward: the valid rows' cells read, every id, every row written
    gbytes = grows * gC * 4 + gB * gV * 4 + gB * gV * gC * 4
    gbound_ms = gbytes / PEAK_BYTES_PER_S * 1e3
    log(f"K1 pillar_scatter [{card}]: B={B} V={V} C={C} hw={hw}, "
        f"{rows} occupied rows; kernel == plain exactly; events: kernel "
        f"{fmt_range(ev['ms'])}, plain {fmt_range(ev['plain_ms'])}, "
        f"index_copy_ {fmt_range(ev['library_ms'])}; bound "
        f"{bound_ms:.5f} ms ({nbytes} bytes)")
    log(f"K1 pillar_scatter [{card}]: in alternation, {K1_TURNS} turns "
        f"each: kernel {fmt_range(turns['kernel'])}, zeros + index_copy_ "
        f"{fmt_range(turns['library'])}")
    log(f"K1 pillar_gather [{card}]: events: kernel "
        f"{fmt_range(ev['backward_ms'])}, plain "
        f"{fmt_range(ev['backward_plain_ms'])}; bound {gbound_ms:.5f} ms "
        f"({gbytes} bytes); no single PyTorch call zeroes the dropped rows, "
        f"so no library time")
    entry = {"name": "pillar_scatter", "route": "cuda",
             "source": "automatic_as_built_reconstruction_tpu_torch/csrc/"
                       "pillar_scatter.cu",
             "replaces": "automatic_as_built_reconstruction_tpu/ops/pallas/"
                         "pillar_scatter.py:61",
             "launches": launches, "max_abs_err": 0.0,
             "bound_ms": bound_ms, "bound_by": "bytes",
             "in_turns_event_ms": turns,
             # as csrc/pillar_scatter.cu launches it
             "grid": [-(-B * V * (C // 4) // 256), 256],
             "backward_kernel": "pillar_gather_kernel",
             "backward_launches": gather_launches,
             "backward_max_abs_err": 0.0,
             "backward_bound_ms": gbound_ms, "backward_bound_by": "bytes",
             "backward_library_ms": None}
    return entry, fns, ev


def iou_cases(R: int, K: int, seed: int = 0) -> np.ndarray:
    """[R, K, 5] float32 building-scale boxes plus degenerate ones:
    coincident, zero-area pad boxes, thin boxes crossed at 90 degrees."""
    rng = np.random.default_rng(seed)
    b = np.concatenate([rng.uniform(0, 16, (R, K, 2)),
                        rng.uniform(0.05, 3.0, (R, K, 2)),
                        rng.uniform(-np.pi, np.pi, (R, K, 1))], -1)
    b[:, 1] = b[:, 0]
    b[:, 2] = [1e6, 1e6, 0.0, 0.0, 0.0]
    b[:, 3] = [5.0, 5.0, 0.0, 0.0, 0.3]
    b[:, 4] = [5.0, 5.0, 0.07, 0.95, 0.0]
    b[:, 5] = [5.0, 5.0, 0.07, 0.95, math.pi / 2]
    return b.astype(np.float32)


def near_touching_cases(R: int, K: int, seed: int = 0) -> np.ndarray:
    """[R, K, 5] float32 boxes in pairs (2i, 2i + 1) that nearly touch,
    for the rotated IoU's rejection test (its IoU matrix with itself):
    bounding circles (1 +- 1e-4)(r_a + r_b) apart; thin axis-aligned walls
    edge to edge (gaps 0, +-1e-6, +-1e-4 m, at 0 and 90 degrees); gaps of
    (1 +- 1e-2) times the kernel's rejection margin; a third of each kind
    1e3 m from the origin; and in every row a coincident pair, zero-area
    boxes, the 1e6 m pad box and a 1e6 m wide box."""
    rng = np.random.default_rng(seed)
    b = np.zeros((R, K, 5))
    gaps = (0.0, 1e-6, -1e-6, 1e-4, -1e-4)
    for r in range(R):
        for i in range(K // 2):
            kind, j = i % 4, i // 4
            origin = rng.uniform(0, 16, 2) + (1e3 if j % 3 == 2 else 0.0)
            sign = 1 if j % 2 else -1
            a = np.concatenate([origin, rng.uniform(0.05, 3.0, 2),
                                rng.uniform(-np.pi, np.pi, 1)])
            q = np.concatenate([origin, rng.uniform(0.05, 3.0, 2),
                                rng.uniform(-np.pi, np.pi, 1)])
            if kind == 0:               # circles (1 +- 1e-4)(r_a + r_b) apart
                ra, rq = (0.5 * np.hypot(v[2], v[3]) for v in (a, q))
                d = (ra + rq) * (1 + sign * 1e-4)
                phi = rng.uniform(-np.pi, np.pi)
                q[:2] = a[:2] + d * np.array([np.cos(phi), np.sin(phi)])
            elif kind in (1, 2):        # walls edge to edge
                yaw = 0.0 if j // 2 % 2 else math.pi / 2
                thick, long_ = rng.uniform(0.05, 0.3), rng.uniform(2, 8)
                axis = np.array([np.cos(yaw), np.sin(yaw)])
                gap = gaps[j % len(gaps)]
                if kind == 2:           # the kernel's own margin, +-1 %
                    mag = (abs(origin).sum() + abs(origin + thick * axis).sum()
                           + np.hypot(thick, long_))
                    gap = (1 + sign * 1e-2) * (
                        rotated_iou.REJECT_TOL_REL * mag
                        + 2 * rotated_iou.REJECT_TOL_MIN)
                a = np.array([*origin, thick, long_, yaw])
                q = np.array([*(origin + (thick + gap) * axis), thick, long_,
                              yaw])
            b[r, 2 * i], b[r, 2 * i + 1] = a, q
        b[r, 0] = b[r, 1]               # coincident
        b[r, 2] = [1e6, 1e6, 0.0, 0.0, 0.0]
        b[r, 3] = [*b[r, 4, :2], 0.0, 2.0, 0.4]
        b[r, 5] = [*b[r, 4, :2], 1.5, 0.0, 0.0]
        b[r, 6] = [3.0, 4.0, 1e6, 1e6, 0.2]
    return b.astype(np.float32)


def iou_mismatch(a, q, criteria=(-1, 0, 1)):
    """The kernel against the plain version on ``a`` x ``q`` under each
    criterion -> (max abs error, outputs equal bit for bit, outputs).
    IoU over the union against a zero-area B is 0/0 (rounding noise on
    both sides, see tests/test_torch_ops.py): those columns are held to
    the other criteria only."""
    zero_area_b = (q[..., 2] * q[..., 3] == 0)[:, None, :]
    worst, equal, total = 0.0, 0, 0
    for criterion in criteria:
        got = rotated_iou.rotate_iou_matrix(a, q, criterion)
        ref = rotated_iou.rotate_iou_matrix_plain(a, q, criterion)
        torch.cuda.synchronize()
        held = (~zero_area_b if criterion == -1
                else torch.ones_like(zero_area_b)).expand_as(got)
        err = float((got - ref).abs()[held].max())
        if not (err <= IOU_ATOL and torch.isfinite(got[held]).all()):
            raise AssertionError(f"rotated_iou {tuple(a.shape)} x "
                                 f"{tuple(q.shape)} criterion {criterion}: "
                                 f"max abs err {err} > {IOU_ATOL}")
        worst = max(worst, err)
        equal += int((got.view(torch.int32) == ref.view(torch.int32)).sum())
        total += got.numel()
    return worst, equal, total


def reject_share(a, q) -> dict:
    """Shares of the pairs that the kernel's bounding circles reject, that
    its separating axes reject of the rest, and that it clips (the plain
    mirror of its test, ``rotated_iou.reject_stages``)."""
    circles, axes = rotated_iou.reject_stages(a, q)
    n = circles.numel()
    return {"circles": int(circles.sum()) / n,
            "axes": int((axes & ~circles).sum()) / n,
            "clipped": int((~(circles | axes)).sum()) / n}


def iou_bound_ms(a, q):
    """-> (bound ms, ops ms, bytes ms, fp32 flops) of the IoU matrix of
    ``a`` x ``q``: the arithmetic these boxes need, or the bytes."""
    R, N, K = a.shape[0], a.shape[1], q.shape[1]
    flops = rotated_iou.clip_flops(a, q)
    ops_ms = flops / PEAK_FP32_PER_S * 1e3
    bytes_ms = (R * (N + K) * 5 * 4 + R * N * K * 4) / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms, flops


def phase_k2(call, second_call, launches: int, card: str):
    """The rotated IoU on the pillar and SECOND serving runs' own inputs,
    the degenerate set and the near-touching set: kernel vs plain, the
    share of the pairs each rejection stage takes, device times.  -> (kernels-
    line entry with event times, {key: fn} to time on the device)."""
    (a, q), _ = call
    (sa, sq), _ = second_call
    degenerate = torch.as_tensor(iou_cases(6, 1000), device="cuda")
    near = torch.as_tensor(near_touching_cases(6, 1000), device="cuda")
    sets = {"pillar serving": (a, q, (-1,)),
            "second key-match": (sa, sq, (-1,)),
            "degenerate set": (degenerate, degenerate, (-1, 0, 1)),
            "near-touching set": (near, near, (-1, 0, 1))}
    worst, shares, bit_equal, set_ms = 0.0, {}, {}, {}
    for what, (x, y, criteria) in sets.items():
        err, equal, total = iou_mismatch(x, y, criteria)
        worst = max(worst, err)
        shares[what] = reject_share(x, y)
        bit_equal[what] = [equal, total]
        bound, _, _, flops = iou_bound_ms(x, y)
        pairs = x.shape[0] * x.shape[1] * y.shape[1]
        dev, _ = device_ms(lambda: rotated_iou.rotate_iou_matrix(x, y))
        set_ms[what] = dev
        log(f"K2 rotated_iou [{card}]: {what} R={x.shape[0]} N={x.shape[1]} "
            f"K={y.shape[1]}, criteria {list(criteria)}: kernel vs plain max "
            f"abs err {err:.3g}, {equal} of {total} outputs equal bit for "
            f"bit; rejected by the circles "
            f"{shares[what]['circles']:.4f}, by the axes "
            f"{shares[what]['axes']:.4f}, clipped "
            f"{shares[what]['clipped']:.4f}; device "
            f"{'not measured' if dev is None else f'{dev:.5f} ms'}, bound "
            f"{bound:.5f} ms, {flops / pairs:.2f} needed flops a "
            f"pair")
    # with criterion 0 a zero-area B keeps all of A: IoU 1.0 (the pad box
    # of iou_cases, against every A with an area near the origin)
    got = rotated_iou.rotate_iou_matrix(degenerate, degenerate, 0)[:, :, 2]
    some_a = ((degenerate[..., 2] * degenerate[..., 3] > 0)
              & (degenerate[..., :2].abs().amax(-1) < 100))
    low = float(got[some_a].min())
    log(f"K2 rotated_iou [{card}]: criterion 0 against the zero-area pad box: "
        f"IoU {low:.7f} at the least over {int(some_a.sum())} boxes A")
    if not low > 0.99:
        raise AssertionError(f"zero-area B under criterion 0 gave {low}")

    R, N, K = a.shape[0], a.shape[1], q.shape[1]
    fns = {"ms": lambda: rotated_iou.rotate_iou_matrix(a, q),
           "plain_ms": lambda: rotated_iou.rotate_iou_matrix_plain(a, q)}
    ev = {"ms": cuda_ms(fns["ms"]),
          "plain_ms": cuda_ms(fns["plain_ms"], iters=10)}
    bound_ms, ops_ms, bytes_ms, flops = iou_bound_ms(a, q)
    log(f"K2 rotated_iou [{card}]: main-path input R={R} N={N} K={K}: "
        f"events: kernel {fmt_range(ev['ms'])}, plain "
        f"{fmt_range(ev['plain_ms'])}; bound {bound_ms:.5f} ms (ops "
        f"{ops_ms:.5f}: {flops} fp32 flops, {flops / (R * N * K):.2f} a pair;"
        f" bytes {bytes_ms:.5f})")
    entry = {"name": "rotated_iou", "route": "cuda",
             "source": "automatic_as_built_reconstruction_tpu_torch/csrc/"
                       "rotated_iou.cu",
             "replaces": "automatic_as_built_reconstruction_tpu/ops/pallas/"
                         "rotated_iou_pallas.py:158",
             "launches": launches, "max_abs_err": worst,
             "bound_ms": bound_ms,
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "library_ms": None, "reject_share": shares,
             "bit_equal": bit_equal, "ms_by_input": set_ms}
    return entry, fns, ev


def join_shape(call) -> str:
    (feats, _, table, w, *_), _ = call
    return (f"B={feats.shape[0]} N={feats.shape[1]} R={table.shape[-1]} "
            f"K={w.shape[0]} Cin={w.shape[1]} Cout={w.shape[2]}")


def phase_sparse_gemm(name: str, calls: list, launches: int, card: str):
    """``keymatch_gemm`` or ``gather_gemm`` against its plain version on
    every join the serving run's warm-up request gave it; each join's
    device time, bound and tile occupancy.  -> (kernels-line entry with
    event times, {key: fn} to time on the device)."""
    keymatch = name == "keymatch_gemm"
    kernel = KERNELS[name]
    plain = (sparse_gather_gemm.keymatch_gemm_plain if keymatch
             else sparse_gather_gemm.gather_gemm_plain)

    def operands(call):
        """(feats, keys or idx, query keys or found, weights)."""
        return call[0][:4]

    def work(call) -> int:
        feats, _, table, w = operands(call)
        return feats.shape[0] * table.shape[-1] * w.numel()

    def check(call):
        """-> (max abs difference, largest reference value)."""
        got = kernel(*call[0])
        ref = plain(*operands(call))
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not (err <= GEMM_ATOL and torch.isfinite(got).all()):
            raise AssertionError(f"{name} {join_shape(call)}: kernel vs "
                                 f"plain max abs err {err} > {GEMM_ATOL}")
        return err, float(ref.abs().max())

    def need(call) -> dict:
        """What the join needs (hits of its taps, bytes, flops), its
        bounds at the 3xTF32 and the fp32 SIMT rate, its tile occupancy."""
        feats, a, b, w = operands(call)
        B, R, Cout = feats.shape[0], b.shape[-1], w.shape[2]
        found = (sparse_gather_gemm.keymatch_found(a, b) if keymatch
                 else b)
        hits, pairs, occupancy = sparse_gather_gemm.tile_occupancy(found)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (feats, a, b, w)) + B * R * Cout * 4
        flops = 2 * hits * w.shape[1] * Cout
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_TF32_3X_PER_S * 1e3
        simt_ms = flops / PEAK_FP32_PER_S * 1e3
        return {"hits": hits, "pairs": pairs, "occupancy": occupancy,
                "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
                "ops_ms": ops_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_fp32_simt_ms": max(simt_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}

    largest = max(calls, key=work)
    smallest = next(c for c in calls
                    if tuple(operands(c)[3].shape) == (27, 16, 16))
    worst = 0.0
    per_join = []
    for call in calls:          # every join of the request
        err, scale = check(call)
        worst = max(worst, err)
        n = need(call)
        ms, _ = device_ms(lambda: kernel(*call[0]))
        per_join.append(ms)
        log(f"{name} [{card}]: {join_shape(call)}: kernel vs plain max abs "
            f"err {err:.3g} (values up to {scale:.3g}); device "
            f"{'not measured' if ms is None else f'{ms:.5f} ms'}; bound "
            f"{n['bound_ms']:.5f} ms ({n['bound_by']}; fp32 SIMT "
            f"{n['bound_fp32_simt_ms']:.5f}); {n['hits']} hits, "
            f"{n['pairs']} non-empty (tile, tap) pairs, tile occupancy "
            f"{n['occupancy']:.4f}")
    occupancy = [need(c)["occupancy"] for c in calls]
    per_request = (None if None in per_join else sum(per_join))
    log(f"{name} [{card}]: device time of the {len(calls)} joins of one "
        f"request: {per_join}, summed "
        f"{'not measured' if per_request is None else f'{per_request:.5f}'}"
        f" ms")

    if keymatch:
        # the four call forms of the JAX function give one result, and
        # unsorted keys the same as sorted ones
        feats, in_keys, q_keys, w = operands(smallest)
        base = kernel(feats, in_keys, q_keys, w)
        perm = torch.as_tensor(sparse_gather_gemm.group_perm((3, 3, 3)),
                               device=feats.device)
        forms = {
            "per-tap windows": kernel(feats, in_keys, q_keys, w, None, 256,
                                      768, False),
            "shared window": kernel(feats, in_keys, q_keys, w, None, 256,
                                    768, True),
            "subwindow": kernel(feats, in_keys, q_keys, w, None, 256, 768,
                                True, 384),
            "grouped taps": kernel(feats, in_keys, q_keys[:, perm], w[perm],
                                   None, 256, 768, True, 384, 3)}
        n = 4096
        shuffle = torch.randperm(n, device=feats.device,
                                 generator=torch.Generator(
                                     feats.device).manual_seed(0))
        sub = (feats[0, :n], in_keys[0, :n], q_keys[0, :, :n])
        forms["unsorted keys (4096 rows)"] = kernel(
            sub[0][shuffle], sub[1][shuffle], sub[2], w)
        torch.cuda.synchronize()
        for form, out in forms.items():
            ref = (kernel(*sub, w) if form.startswith("unsorted") else base)
            err = float((out - ref).abs().max())
            log(f"{name} [{card}]: form '{form}' vs the default call: max "
                f"abs diff {err:.3g}")
            # only the grouped form sums the taps in another order
            if err > (GEMM_ATOL if form == "grouped taps" else 0.0):
                raise AssertionError(f"{name}: form {form} differs by {err}")
        err = float((forms["unsorted keys (4096 rows)"]
                     - plain(sub[0][shuffle], sub[1][shuffle], sub[2], w))
                    .abs().max())
        if not err <= GEMM_ATOL:
            raise AssertionError(f"{name}: unsorted keys vs plain: {err}")

    fns = {"ms": lambda: kernel(*largest[0]),
           "plain_ms": lambda: plain(*operands(largest))}
    ev = {"ms": cuda_ms(fns["ms"], iters=20),
          "plain_ms": cuda_ms(fns["plain_ms"], iters=5, warmup=1)}
    big = need(largest)
    taps = operands(largest)[2].numel()
    log(f"{name} [{card}]: largest join {join_shape(largest)}: {big['hits']} "
        f"hits of {taps} (tap, row) pairs ({100 * big['hits'] / taps:.1f} %), "
        f"tile occupancy {big['occupancy']:.4f}; events: kernel "
        f"{fmt_range(ev['ms'])}, plain {fmt_range(ev['plain_ms'])}; bound "
        f"{big['bound_ms']:.5f} ms (ops at the 3xTF32 rate "
        f"{big['ops_ms']:.5f}: {big['flops']} needed flops; bytes "
        f"{big['bytes_ms']:.5f}: {big['bytes']}); at the fp32 SIMT rate "
        f"{big['bound_fp32_simt_ms']:.5f}")
    s_ev = cuda_ms(lambda: kernel(*smallest[0]), iters=20)
    log(f"{name} [{card}]: smallest join {join_shape(smallest)}: events: "
        f"kernel {fmt_range(s_ev)}")
    line = {"keymatch_gemm": 1098, "gather_gemm": 331}[name]
    entry = {"name": name, "route": "cuda",
             "source": "automatic_as_built_reconstruction_tpu_torch/csrc/"
                       "sparse_gather_gemm.cu",
             "replaces": "automatic_as_built_reconstruction_tpu/ops/pallas/"
                         f"sparse_gather_gemm.py:{line}",
             "launches": launches, "max_abs_err": worst,
             "shape": join_shape(largest), "hits": big["hits"],
             "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
             "bound_fp32_simt_ms": big["bound_fp32_simt_ms"],
             "per_join_ms": per_join, "per_request_ms": per_request,
             "per_join_shape": [join_shape(c) for c in calls],
             "tile_occupancy": occupancy, "library_ms": None}
    return entry, fns, ev


def k5_cases(requests, pillar_request, pillar_cfg, cfg) -> list:
    """[(what, points, num_valid, kwargs)] of the K5 checks: the served
    request, a pillar-sized scan (also with T = 64), a voxel cap below
    the occupied cells, T = 1, an empty scan, NaN and on-face points,
    more slots than points, four pillar-sized scans (more segment blocks
    than the card holds at once)."""
    def geo(c):
        return dict(voxel_size=c.voxel_size, pc_range=c.pc_range,
                    grid_size=c.grid_size)

    pts = torch.as_tensor(requests[0][0], device="cuda")
    nv = torch.as_tensor(requests[0][1], device="cuda")
    V, T = SECOND_MAX_VOXELS, SECOND_MAX_POINTS
    served = dict(max_points=T, max_voxels=V, **geo(cfg))
    # NaN rows (an all-NaN point lands in cell 0, first there) and points
    # on cell faces ((p - r0) / vs a whole number), in the served request
    odd = pts.clone()
    g = torch.Generator(device="cuda").manual_seed(5)
    odd[:, 0, :3] = math.nan
    odd[:, 1:40, 0] = math.nan
    odd[:, 40:50, 1] = math.inf
    lo = torch.tensor(cfg.pc_range[:3], device="cuda")
    vs = torch.tensor(cfg.voxel_size, device="cuda")
    cells = torch.floor(torch.rand(2, 2000, 3, device="cuda", generator=g)
                        * torch.tensor(cfg.grid_size, device="cuda") / 4)
    odd[:, 50:2050, :3] = lo + cells * vs
    return [
        ("served request", pts, nv, served),
        ("pillar-sized scan", torch.as_tensor(pillar_request[0],
                                              device="cuda"),
         torch.as_tensor(pillar_request[1], device="cuda"),
         dict(max_points=MAX_POINTS, max_voxels=MAX_VOXELS,
              **geo(pillar_cfg))),
        ("pillar-sized scan, T = 64 (runs past a tile's halo)",
         torch.as_tensor(pillar_request[0], device="cuda"),
         torch.as_tensor(pillar_request[1], device="cuda"),
         dict(max_points=64, max_voxels=MAX_VOXELS, **geo(pillar_cfg))),
        ("voxel cap below the occupied cells", pts, nv,
         served | {"max_voxels": K5_TRUNCATING_CAP}),
        ("T = 1", pts, nv, served | {"max_points": 1}),
        ("empty scan", pts, torch.zeros_like(nv), served),
        ("NaN, inf and on-face points", odd, nv, served),
        ("more slots than points (P = 3001, V = 4096)",
         pts[:, :3001].contiguous(), torch.tensor([3001, 2000],
                                                  dtype=nv.dtype,
                                                  device="cuda"),
         served | {"max_voxels": 4096}),
        # 4 x 175 blocks of 512 threads: more than the 132 SMs x 4 the
        # H100 can hold at once, whatever the registers
        ("four pillar-sized scans (B = 4: more segment blocks than fit the "
         "card at once)", torch.as_tensor(np.concatenate(
             [pillar_request[0]] * 2), device="cuda"),
         torch.as_tensor(np.concatenate(
             [pillar_request[1], pillar_request[1] // 2]), device="cuda"),
         dict(max_points=MAX_POINTS, max_voxels=MAX_VOXELS,
              **geo(pillar_cfg)))]


def same_floats(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a[~nan], b[~nan]))


def check_k5(what, pts, nv, kw, card) -> float:
    """Both routes of ``fused_voxelize_mean`` against the plain function,
    and the key route's two kernels against their plain mirrors and the
    table kernel.  -> the largest feature difference to the plain
    function."""
    worst = 0.0
    for fa in (False, True):
        got = voxel_mean.fused_voxelize_mean(pts, nv, first_appearance=fa,
                                             **kw)
        ref = voxel_mean.fused_voxelize_mean_plain(pts, nv,
                                                   first_appearance=fa, **kw)
        torch.cuda.synchronize()
        for name in ("coords", "num_points", "num_voxels"):
            if not torch.equal(getattr(got, name), getattr(ref, name)):
                raise AssertionError(f"voxel_mean {what}, first_appearance="
                                     f"{fa}: {name} differ")
        fin = torch.isfinite(ref.features)
        err = float((got.features - ref.features).abs()[fin].max()
                    if fin.any() else 0.0)
        if not (torch.allclose(got.features, ref.features, equal_nan=True,
                               **MEAN_TOL)
                and bool((got.features[got.num_points == 0] == 0).all())):
            raise AssertionError(f"voxel_mean {what}: features differ by "
                                 f"{err} (tolerance {MEAN_TOL})")
        worst = max(worst, err)
        log(f"K5 voxel_mean [{card}]: {what}, first_appearance={fa}: "
            f"B={pts.shape[0]} P={pts.shape[1]} V={kw['max_voxels']} "
            f"T={kw['max_points']}, voxels {got.num_voxels.tolist()}, most "
            f"points in one {int(got.num_points.max())}, "
            f"{int(torch.isnan(got.features).any(-1).sum())} NaN voxels: "
            f"integers equal the plain function's, features max abs diff "
            f"{err:.3g}")
        if not fa:
            key_route = got
    geo = {k: kw[k] for k in ("voxel_size", "pc_range", "grid_size")}
    seg_kw = {k: kw[k] for k in ("grid_size", "max_points", "max_voxels")}
    keys = voxel_mean.point_keys(pts, nv, **geo)
    if not torch.equal(keys, voxel_mean.point_keys_plain(pts, nv, **geo)):
        raise AssertionError(f"voxel_mean {what}: keys != plain keys")
    srt = torch.sort(keys, dim=1).values
    plain = voxel_mean.segment_mean_plain(pts, srt, **seg_kw)
    cell, tab = slot_table(pts, nv, max_voxels=kw["max_voxels"],
                           first_appearance=False, **geo)
    table = voxel_mean.mean_from_table(pts, cell, tab, kw["max_points"])
    seg = voxel_mean.segment_mean(pts, srt, **seg_kw)
    for other, name in ((plain, "its plain mirror"),
                        (key_route, "the function's key route"),
                        (table, "the table route")):
        if not (all(torch.equal(getattr(seg, k), getattr(other, k))
                    for k in ("coords", "num_points", "num_voxels"))
                and same_floats(seg.features, other.features)):
            raise AssertionError(f"voxel_mean {what}: segment kernel != "
                                 f"{name}")
    log(f"K5 voxel_mean [{card}]: {what}: key kernel == plain keys; "
        f"segment kernel == its plain mirror == the table route, bit for "
        f"bit")
    return worst


def k5_bound(B, P, C, V) -> tuple:
    """-> (bytes, ms) the key route needs without the sort: every point
    row and num_valid read once, the packed values written and read
    once, features, coords, counts and num_voxels written once."""
    nbytes = B * P * 4 * C + B * 4 + 2 * B * P * 8 + B * V * (4 * C + 16) \
        + B * 4
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def k5_times(pts, nv, kw) -> dict:
    """Device times (torch.profiler, L2 flushed) and device events a call
    of the key route, its kernels, the sort, the table route and the
    first-appearance route on one request."""
    fused = dict(first_appearance=False, **kw)
    ms, per, events = device_profile(
        lambda: voxel_mean.fused_voxelize_mean(pts, nv, **fused))

    def kernel_ms(prefix):
        return sum(v for k, v in per.items() if k.startswith(prefix))

    keys = voxel_mean.point_keys(pts, nv, voxel_size=kw["voxel_size"],
                                 pc_range=kw["pc_range"],
                                 grid_size=kw["grid_size"])
    sort_ms, _, sort_events = device_profile(
        lambda: torch.sort(keys, dim=1))
    cut = {k: kw[k] for k in ("voxel_size", "pc_range", "grid_size",
                              "max_voxels")}

    def table_route():
        cell, tab = slot_table(pts, nv, first_appearance=False, **cut)
        return voxel_mean.mean_from_table(pts, cell, tab, kw["max_points"])

    table_ms, table_per, table_events = device_profile(table_route)
    fa_ms, _, fa_events = device_profile(
        lambda: voxel_mean.fused_voxelize_mean(pts, nv, first_appearance=True,
                                               **kw))
    return {"function_ms": ms, "function_launches": events,
            "keys_ms": kernel_ms("point_keys_kernel"),
            "segment_ms": kernel_ms("segment_mean_kernel"),
            "sort_ms": sort_ms, "sort_launches": sort_events,
            "table_route_ms": table_ms, "table_route_launches": table_events,
            "table_kernel_ms": sum(v for k, v in table_per.items()
                                   if k.startswith("voxel_mean_kernel")),
            "first_appearance_ms": fa_ms,
            "first_appearance_launches": fa_events,
            "function_kernels": fmt_kernels(per)}


def phase_k5(call, requests, pillar_request, pillar_cfg, cfg,
             launches: dict, card: str):
    """The fused voxelize+mean: both routes and the key route's kernels
    against their plain versions on every case; device times of the key
    route, its two kernels, the sort and the table route at both served
    shapes.  ``call`` is the recorded
    ``fused_voxelize_mean`` call of the serving run.  -> (kernels-line
    entry with event times, {key: fn} to time on the device)."""
    cases = k5_cases(requests, pillar_request, pillar_cfg, cfg)
    worst = 0.0
    for what, pts, nv, kw in cases:
        worst = max(worst, check_k5(what, pts, nv, kw, card))
        if what.startswith("voxel cap"):
            got = voxel_mean.fused_voxelize_mean(pts, nv, **kw)
            if got.num_voxels.tolist() != [K5_TRUNCATING_CAP] * 2:
                raise AssertionError("voxel cap did not truncate")
        if what == "empty scan":
            got = voxel_mean.fused_voxelize_mean(pts, nv, **kw)
            if int(got.num_voxels.sum()) != 0:
                raise AssertionError("empty scan gave voxels")
    if launches["voxel_keys"] != launches["voxel_mean"]:
        raise AssertionError(f"key and segment kernels launched "
                             f"{launches['voxel_keys']} / "
                             f"{launches['voxel_mean']} times")

    # the served call as the fused_mean path made it, and the pillar-sized
    # scan: the key route against the table route
    (spts, snv), skw = call
    skw = {k: v for k, v in skw.items() if k != "first_appearance"}
    shapes = {"served SECOND request": (spts, snv, skw),
              "pillar-sized scan": cases[1][1:]}
    times = {}
    for what, (pts, nv, kw) in shapes.items():
        t = times[what] = k5_times(pts, nv, kw)
        B, P, C = pts.shape
        t["needed_bytes"], t["bound_ms"] = k5_bound(B, P, C,
                                                    kw["max_voxels"])
        log(f"K5 voxel_mean [{card}]: {what} B={B} P={P} C={C} "
            f"V={kw['max_voxels']} T={kw['max_points']}: function (key "
            f"route) {t['function_ms']:.5f} ms device, "
            f"{t['function_launches']:.0f} device events a call "
            f"[{t['function_kernels']}]; key kernel {t['keys_ms']:.5f}, "
            f"segment kernel {t['segment_ms']:.5f}, torch.sort alone "
            f"{t['sort_ms']:.5f} ({t['sort_launches']:.0f} events); table "
            f"route (slot_table + table kernel) "
            f"{t['table_route_ms']:.5f} ({t['table_route_launches']:.0f} "
            f"events, its kernel {t['table_kernel_ms']:.5f}); "
            f"first_appearance=True {t['first_appearance_ms']:.5f} "
            f"({t['first_appearance_launches']:.0f} events); bound without "
            f"the sort {t['bound_ms']:.5f} ms ({t['needed_bytes']} bytes)")
    served = times["served SECOND request"]
    B, P, C = spts.shape
    plain_kw = {k: skw[k] for k in ("grid_size", "max_points", "max_voxels")}
    geo = {k: skw[k] for k in ("voxel_size", "pc_range", "grid_size")}
    srt = torch.sort(voxel_mean.point_keys(spts, snv, **geo), dim=1).values
    out = voxel_mean.FusedVoxelMeanResult(
        torch.empty((B, skw["max_voxels"], C), device="cuda"),
        *(torch.empty(shape, dtype=torch.int32, device="cuda")
          for shape in ((B, skw["max_voxels"], 3), (B, skw["max_voxels"]),
                        (B,))))
    state = torch.empty((B, voxel_mean.scan_words(P)), dtype=torch.int32,
                        device="cuda")

    def two_kernels():
        """The function without its sort, as the function calls them."""
        voxel_mean.point_keys(spts, snv, fill=out, tile_state=state, **geo)
        voxel_mean.segment_mean(spts, srt, outputs=out, tile_state=state,
                                **plain_kw)

    def two_plain():
        voxel_mean.point_keys_plain(spts, snv, **geo)
        voxel_mean.segment_mean_plain(spts, srt, **plain_kw)

    fns = {"ms": two_kernels, "plain_ms": two_plain}
    ev = {k: cuda_ms(fn) for k, fn in fns.items()}
    ev["function"] = cuda_ms(lambda: voxel_mean.fused_voxelize_mean(
        spts, snv, first_appearance=False, **skw))
    log(f"K5 voxel_mean [{card}]: served request, events: key + segment "
        f"kernels {fmt_range(ev['ms'])}, their plain mirrors "
        f"{fmt_range(ev['plain_ms'])}, the function "
        f"{fmt_range(ev['function'])}")
    entry = {"name": "voxel_mean", "route": "cuda",
             "source": "automatic_as_built_reconstruction_tpu_torch/csrc/"
                       "voxel_mean.cu",
             "replaces": "automatic_as_built_reconstruction_tpu/ops/pallas/"
                         "voxel_mean.py:80",
             "launches": launches["voxel_mean"],
             "keys_launches": launches["voxel_keys"],
             "table_route_launches_on_paths": launches["voxel_mean_table"],
             "max_abs_err": worst,
             "bound_ms": served["bound_ms"], "bound_by": "bytes",
             "bound_counts": "the key route without the sort",
             "library_ms": None,
             "keys_ms": served["keys_ms"],
             "segment_ms": served["segment_ms"],
             "sort_ms": served["sort_ms"],
             "function_ms": served["function_ms"],
             "function_launches": served["function_launches"],
             "function_event_ms": ev["function"],
             "by_shape": times,
             # the segment kernel's grid, as csrc/voxel_mean.cu launches it
             "grid": [-(-P // voxel_mean.SEGMENT_TILE) * B,
                      voxel_mean.SEGMENT_TILE]}
    return entry, fns, ev


def check_flat_pfn(pod, request, card: str) -> None:
    """The flat pillar path (voxelize_flat -> point-major PFN -> scatter
    kernel) against the padded one on one served request: the canvas and
    the head outputs, the flat path's equal bit for bit over two runs."""
    cfg = pod.cfg
    pts = torch.as_tensor(request[0], device="cuda")
    nv = torch.as_tensor(request[1], device="cuda")
    kw = dict(voxel_size=cfg.voxel_size, pc_range=cfg.pc_range,
              grid_size=cfg.grid_size, max_points=pod.max_points_per_voxel,
              max_voxels=pod.max_voxels, first_appearance=False)
    flat = voxelize_flat(pts, nv, **kw)
    vox = voxelize(pts, nv, **kw)
    with fp32_math():
        runs = [pod.model(None, flat.num_points, flat.coords,
                          flat_points=flat.points, flat_slot=flat.slot,
                          return_stages=True) for _ in range(2)]
        preds_p, st_p = pod.model(vox.voxels, vox.num_points, vox.coords,
                                  return_stages=True)
    torch.cuda.synchronize()
    (preds_f, st_f), (preds_f2, st_f2) = runs
    if not (torch.equal(st_f["spatial_features"], st_f2["spatial_features"])
            and all(torch.equal(preds_f[k], preds_f2[k]) for k in preds_f)):
        raise AssertionError("flat PFN: two runs differ")
    pairs = [("canvas", st_f["spatial_features"], st_p["spatial_features"])]
    pairs += [(k, preds_f[k], preds_p[k]) for k in preds_p]
    errs = {name: float((a - b).abs().max()) for name, a, b in pairs}
    within_cpu = {name: bool(torch.allclose(a, b, **FLAT_CPU_TOL))
                  for name, a, b in pairs}
    over = int((vox.num_points == pod.max_points_per_voxel).sum())
    log(f"flat PFN [{card}]: flat vs padded path on one request "
        f"({int(flat.num_voxels.sum())} pillars, {over} at the point cap, "
        f"{int((flat.slot == pod.max_voxels).sum())} dump rows): the flat "
        f"path equal bit for bit over two runs; max abs diff {errs}, canvas "
        f"values up to {float(st_p['spatial_features'].abs().max()):.3g}; "
        f"within the CPU test's {FLAT_CPU_TOL}: {within_cpu} (held to "
        f"{FLAT_TOL})")
    for name, a, b in pairs:
        if not torch.allclose(a, b, **FLAT_TOL):
            raise AssertionError(f"flat vs padded {name}: max abs diff "
                                 f"{errs[name]} (tolerance {FLAT_TOL})")


def run_evaluate(card: str) -> dict:
    """``evaluate`` on the 32 val scenes with the trained checkpoint.
    -> launches of each kernel during it."""
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with flags_in_modules() as seen:
        result = evaluate(CONFIG, CHECKPOINT, device="cuda",
                          measure_time=True)
    wall = time.perf_counter() - t0
    if seen != {(False, False)}:
        raise AssertionError(f"evaluate: the network ran with TF32 flags "
                             f"{sorted(seen)}")
    launches = {name: fn.launches for name, fn in KERNELS.items()}
    log(f"evaluate [{card}]: 32 val scenes in {wall:.1f} s (host reader, "
        f"refinement and AP included; every module saw TF32 off); "
        f"launches {launches}")
    log("evaluate AP: " + json.dumps(result))
    if sorted(result) != sorted(JAX_EVAL_AP):
        raise AssertionError(f"evaluate: keys {sorted(result)}")
    worst = 0.0
    for k, want in JAX_EVAL_AP.items():
        if k.endswith("num_gt"):
            if result[k] != want:
                raise AssertionError(f"evaluate: {k} {result[k]} != {want}")
        else:
            worst = max(worst, abs(result[k] - want))
            if not abs(result[k] - want) <= EVAL_AP_ATOL:
                raise AssertionError(
                    f"evaluate: {k} = {result[k]} but the JAX package gives "
                    f"{want} (tolerance {EVAL_AP_ATOL})")
    log(f"evaluate [{card}]: every AP within {EVAL_AP_ATOL} of the JAX "
        f"package's (largest difference {worst:.3g}), every num_gt equal")
    # 16 batches of two scans and the stage timer's 4 runs of one batch
    want = dict.fromkeys(KERNELS, 0) | {"pillar_scatter": 20,
                                        "rotated_iou": 20}
    if launches != want:
        raise AssertionError(f"evaluate launched {launches}, expected "
                             f"{want}")
    return launches


# --------------------------------------------------------------------------
# pillar training
# --------------------------------------------------------------------------

def step_grads(bundle, state, example, math=fp32_math) -> tuple:
    """Loss terms and gradients of one forward in train mode under the
    float flags of ``math``, the model's state (BatchNorm statistics
    included) put back after.  -> ({term: float}, {param name: grad on
    the host})."""
    model = state.model.train()
    saved = copy.deepcopy(model.state_dict())
    names, params = zip(*model.named_parameters())
    with math(), torch.enable_grad():
        preds = model(example["voxels"], example["num_points"],
                      example["coordinates"])
        loss, terms = voxelnet_mod.compute_loss(preds, example,
                                                bundle.model_cfg)
        grads = torch.autograd.grad(loss, params)
    model.load_state_dict(saved)
    return ({k: float(v.detach()) for k, v in terms.items()},
            {n: g.detach().cpu() for n, g in zip(names, grads)})


def device_step(config, batch, dev: str, steps: int,
                dtype=torch.float32, update: bool = False,
                math=fp32_math) -> dict:
    """From the seeded weights of ``train()`` (seed 0) on ``dev``: the loss
    terms and gradients of ``batch`` (under ``math``'s float flags), and,
    in float32 (or with ``update``), the state after one
    ``make_train_step`` (on the host) and the learning rate it took.  In
    float64 the model and batch are cast and the kernels must be their
    plain versions (the kernels are fp32)."""
    bundle = train_mod.Bundle(config)
    state = train_mod.init_state(bundle, rng_seed=0, total_steps=steps,
                                 device=dev)
    example = train_mod.to_device(batch, dev)
    if dtype != torch.float32:
        state.model.to(dtype)
        example = {k: v.to(dtype) if v.is_floating_point() else v
                   for k, v in example.items()}
    terms, grads = step_grads(bundle, state, example, math)
    out = {"terms": terms, "grads": grads}
    if dtype == torch.float32 or update:
        train_mod.make_train_step(bundle)(state, example)
        out["state"] = {k: v.cpu() for k, v in
                        state.model.state_dict().items()}
        out["lr"] = state.schedule(0)
    return out


def train_step_mismatch(config, batch, steps: int) -> tuple:
    """One training step of ``config`` on the card and on the CPU from the
    same seeded weights and the same batch.  -> (summary dict, first
    mismatch or None).

    Loss terms: TRAIN_LOSS_RTOL.  Gradients: at full width a float32
    gradient of this network at its initial weights is itself off its
    float64 value by up to ~14 % of the tensor's max |g| in the deepest
    RPN blocks, in other tensors on each device and batch, so the two
    float32 steps cannot agree to rounding.  Each side is held to a
    float64 step instead: the float64 steps on the card and on the CPU
    (the same code, the plain scatter) agree to TRAIN_F64_RTOL, and the
    card's worst float32 error against it (over the tensors, as a share
    of each tensor's max |g|) is at most twice the CPU's worst plus
    TRAIN_GRAD_ATOL_SHARE.  Every PFN gradient is nonzero on the card.
    After the AdamW update (the same map on both devices, held to optax
    on the CPU) the parameters agree to TRAIN_PARAM_TOL where the two
    float32 gradients agree to TRAIN_G_AGREE and |g| >= TRAIN_G_NOISE *
    max|g|; elsewhere Adam's first step (about lr * g / |g|) may differ,
    bounded by 2 * lr; BatchNorm statistics to TRAIN_PARAM_TOL."""
    c32 = device_step(config, batch, "cpu", steps)
    g32 = device_step(config, batch, "cuda", steps)
    plain = pillar_scatter.scatter_sorted_to_canvas_plain
    with substituted(pointpillars, "scatter_sorted_to_canvas", plain):
        c64 = device_step(config, batch, "cpu", steps, torch.float64)
        g64 = device_step(config, batch, "cuda", steps, torch.float64)
    ct, gt = c32["terms"], g32["terms"]
    summary = {"loss_cpu": ct["loss"], "loss_cuda": gt["loss"],
               "terms_rel_err": {k: abs(gt[k] - ct[k]) / abs(ct[k])
                                 for k in ct}}
    bad = None
    for k in ct:
        if not abs(gt[k] - ct[k]) <= TRAIN_LOSS_RTOL * abs(ct[k]):
            bad = bad or f"loss term {k}: card {gt[k]} vs CPU {ct[k]}"
    gg = g32["grads"]
    pfn = [n for n in gg if n.startswith("voxel_feature_extractor")]
    summary["pfn_grad_min_abs_max"] = min(float(gg[n].abs().max())
                                          for n in pfn)
    per_tensor, f64_err = {}, 0.0
    for n, truth in c64["grads"].items():
        scale = float(truth.abs().max())
        if not bool(gg[n].abs().max() > 0):
            bad = bad or f"gradient of {n} is zero on the card"
        d64 = float((g64["grads"][n] - truth).abs().max()) / scale
        f64_err = max(f64_err, d64)
        if not d64 <= TRAIN_F64_RTOL:
            bad = bad or f"float64 gradient of {n}: card vs CPU {d64}"
        per_tensor[n] = (
            float((gg[n].double() - truth).abs().max()) / scale,
            float((c32["grads"][n].double() - truth).abs().max()) / scale)
    worst_card = max(e[0] for e in per_tensor.values())
    worst_cpu = max(e[1] for e in per_tensor.values())
    if not worst_card <= 2 * worst_cpu + TRAIN_GRAD_ATOL_SHARE:
        bad = bad or (f"float32 gradients: the card's worst error "
                      f"{worst_card:.3g} of a tensor's max|g| against "
                      f"float64, the CPU's {worst_cpu:.3g}")
    excused = 0
    lr = c32["lr"]
    for n, want in c32["state"].items():
        got = g32["state"][n]
        if not want.is_floating_point():
            if not torch.equal(got, want):
                bad = bad or f"{n}: {got} vs {want}"
            continue
        close = torch.isclose(got, want, **TRAIN_PARAM_TOL)
        if n in gg:
            gc = c32["grads"][n]
            noise = (((gg[n] - gc).abs() > TRAIN_G_AGREE * gc.abs())
                     | (gc.abs() < TRAIN_G_NOISE * gc.abs().max()))
            excused += int((noise & ~close).sum())
            close |= noise & ((got - want).abs() <= 2 * lr * 1.01)
        if not bool(close.all()):
            bad = bad or f"{n} after the update: max abs diff " \
                         f"{float((got - want).abs().max())}"
    summary["f64_card_vs_cpu_max_rel"] = f64_err
    summary["f32_vs_f64_worst"] = {"card": worst_card, "cpu": worst_cpu}
    summary["f32_vs_f64_by_tensor"] = {
        n: {"card": e[0], "cpu": e[1]}
        for n, e in sorted(per_tensor.items(),
                           key=lambda kv: -max(kv[1]))[:4]}
    summary["excused_params"] = excused
    return summary, bad


def train_pillars(card: str, config=CONFIG, steps: int = TRAIN_STEPS,
                  display: int = TRAIN_DISPLAY,
                  resume_steps: int = TRAIN_RESUME_STEPS) -> dict:
    """The pillar training path: ``train()`` on ``config`` from seeded
    weights into a temporary model directory, with every kernel counter
    set to 0 just before and read just after; the loss check; the device
    step timed on one batch (``main`` profiles one more at its end); one
    step on the card against the port's CPU step; ``evaluate`` on the
    port's own checkpoint; a restart that resumes.  Grad on in its own
    scope.  -> {"launches", "calls", "report", "step": one more training
    step on the timed batch, for the profile}."""
    report = {}
    with torch.enable_grad(), tempfile.TemporaryDirectory() as tmp:
        model_dir = Path(tmp) / "pillars"
        calls = {"pillar_scatter": [], "pillar_gather": []}
        for fn in KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            seen = stack.enter_context(flags_in_modules())
            for name in calls:
                module, attr = CALL_SITES[name]
                stack.enter_context(recording(module, attr, calls[name]))
            state = train_mod.train(config, model_dir, max_steps=steps,
                                    display_step=display, device="cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in KERNELS.items()}
        log(f"pillar training [{card}]: {steps} steps of train() in "
            f"{wall:.2f} s wall (Bundle, reader, seeded init and the final "
            f"checkpoint included): {steps / wall:.3f} steps/s; launches "
            f"{launches}")
        want = dict.fromkeys(KERNELS, 0) | {"pillar_scatter": steps,
                                            "pillar_gather": steps}
        if launches != want or state.step != steps:
            raise AssertionError(f"pillar training launched {launches} in "
                                 f"{state.step} steps, expected {want}")
        if seen != {(False, False)}:
            raise AssertionError(f"pillar training: the network ran with "
                                 f"TF32 flags {sorted(seen)}")
        windows = [json.loads(line) for line in
                   (model_dir / "metrics.jsonl").read_text().splitlines()]
        windows = [w for w in windows if w["prefix"] == "train"]
        keys = ("loss", "loss_cls", "loss_loc", "loss_dir", "grad_norm",
                "num_pos", "steps_per_sec", "host_prep_ms", "feed_ms",
                "step_ms")
        for w in windows:
            log(f"pillar training [{card}]: window to step {w['step']}: "
                + json.dumps({k: round(w[k], 5) for k in keys}))
        first, last = windows[0]["loss"], windows[-1]["loss"]
        if not all(math.isfinite(w["loss"]) for w in windows):
            raise AssertionError("pillar training: a loss is not finite")
        if not last < first:
            raise AssertionError(f"pillar training: mean loss of the last "
                                 f"{display} steps {last} is not below the "
                                 f"first {display} steps' {first}")
        host_prep = float(np.median([w["host_prep_ms"] for w in windows]))
        report.update(steps=steps, wall_s=wall, steps_per_sec=steps / wall,
                      window_steps_per_sec=[w["steps_per_sec"]
                                            for w in windows],
                      loss_first_window=first, loss_last_window=last,
                      host_prep_ms=host_prep,
                      step_launch_ms=float(np.median(
                          [w["step_ms"] for w in windows])))
        log(f"pillar training [{card}]: mean loss of steps 1-{display} "
            f"{first:.5f} -> steps {steps - display + 1}-{steps} {last:.5f}"
            f" (falls); host prep of a batch (median of the windows) "
            f"{host_prep:.2f} ms")

        # the device step on one batch: CUDA events (synchronised); main()
        # profiles one more at the end, with the serving paths (the
        # profiler's tracing slows the launches after it)
        bundle = train_mod.Bundle(config)
        _, loader = bundle.input_reader(training=True, seed=1)
        batch = next(iter(loader))
        example = train_mod.to_device(batch, "cuda")
        step_fn = train_mod.make_train_step(bundle)
        ev = cuda_ms(lambda: step_fn(state, example), iters=10, warmup=2)
        report.update(device_step_ms=ev,
                      host_prep_share=host_prep / (host_prep + ev[0]))
        log(f"pillar training [{card}]: device step (B=2, synchronised, "
            f"events) {fmt_range(ev)}; host prep {host_prep:.2f} ms a "
            f"batch = {100 * report['host_prep_share']:.1f} % of host prep "
            f"+ device step")

        summary, bad = train_step_mismatch(config, batch, steps)
        log(f"pillar training [{card}]: one step on the card vs the port's "
            f"CPU step (same seeded weights and batch): "
            + json.dumps(summary))
        if bad is not None:
            raise AssertionError(f"train step, card vs CPU: {bad}")

        for fn in KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = evaluate(config, model_dir, device="cuda")
        log(f"pillar training [{card}]: evaluate on the port's checkpoint "
            f"(step {steps}) in {time.perf_counter() - t0:.1f} s, launches "
            f"{ {n: fn.launches for n, fn in KERNELS.items()} }; AP (not "
            f"held: {steps} steps from seeded weights): "
            + json.dumps(result))
        report["evaluate_ap"] = result

        state2 = train_mod.train(config, model_dir,
                                 max_steps=steps + resume_steps,
                                 display_step=resume_steps, device="cuda")
        text = (model_dir / "log.txt").read_text()
        if (state2.step != steps + resume_steps
                or f"resumed from checkpoint at step {steps}" not in text):
            raise AssertionError(f"restart: step {state2.step}, log "
                                 f"{text[-300:]}")
        log(f"pillar training [{card}]: a restart with max_steps "
            f"{steps + resume_steps} resumed at step {steps} and ended at "
            f"{state2.step}")
    return {"launches": launches, "calls": calls, "report": report,
            "step": lambda: step_fn(state, example)}


# --------------------------------------------------------------------------
# SECOND training
# --------------------------------------------------------------------------

def second_train_config(tmp: Path, root: Path, caps=None) -> Path:
    """car.fhd.config with its data paths under ``root``, as
    tools/kitti_rehearsal.py:69-73 rewrites them, and, where given, the
    middle's ``out_site_caps``; nothing else changes."""
    text = SECOND_TRAIN_CONFIG.read_text().replace('"data/kitti',
                                                   f'"{root}')
    if caps:
        old = "      downsample_factor: 8\n"
        if text.count(old) != 1:
            raise AssertionError("car.fhd.config: no single "
                                 "downsample_factor line")
        text = text.replace(old, old + "      out_site_caps: ["
                            + ", ".join(map(str, caps)) + "]\n")
    path = tmp / ("car.fhd.caps.config" if caps else "car.fhd.config")
    path.write_text(text)
    return path


def plain_keymatch(features, in_keys, q_keys, weights, *args):
    """The key-match join's plain version in the middle's call form
    (differentiable by autograd, any float type)."""
    return sparse_gather_gemm.keymatch_gemm_plain(features, in_keys, q_keys,
                                                  weights)


def second_step_mismatch(config, batch, steps: int) -> tuple:
    """One SECOND training step on the card from the seeded weights of
    ``train()``: float32 on the kernels against float64 on the plain
    versions, both on the card.  -> (summary, first mismatch or None).
    Loss terms TRAIN_LOSS_RTOL; each gradient within SECOND_GRAD_SHARE of
    its tensor's max |g| and the median tensor within
    SECOND_GRAD_MEDIAN_SHARE; every gradient nonzero; the parameters
    after the update and the BatchNorm statistics as
    train_step_mismatch holds them.  The summary also gives the same
    shares of the float32 step with TF32 on (the control: a step of lower
    precision, which the limits should not pass)."""
    g32 = device_step(config, batch, "cuda", steps)
    with substituted(middle, "keymatch_gemm", plain_keymatch):
        g64 = device_step(config, batch, "cuda", steps, torch.float64,
                          update=True)
    control = device_step(config, batch, "cuda", steps, math=tf32_on)
    t32, t64 = g32["terms"], g64["terms"]
    summary = {"loss_f32": t32["loss"], "loss_f64": t64["loss"],
               "terms_rel_err": {k: abs(t32[k] - t64[k]) / abs(t64[k])
                                 for k in t64}}
    bad = None
    for k in t64:
        if not abs(t32[k] - t64[k]) <= TRAIN_LOSS_RTOL * abs(t64[k]):
            bad = bad or f"loss term {k}: float32 {t32[k]} vs {t64[k]}"

    def shares(grads: dict) -> dict:
        """Each tensor's max error against float64, a share of max |g|."""
        out = {}
        for n, truth in g64["grads"].items():
            scale = float(truth.abs().max())
            if scale > 0:
                out[n] = (float((grads[n].double() - truth).abs().max())
                          / scale)
        return out

    for n, truth in g64["grads"].items():
        if not (truth.abs().max() > 0 and g32["grads"][n].abs().max() > 0):
            bad = bad or f"gradient of {n} is zero"
    share = shares(g32["grads"])
    worst = max(share.values())
    median = float(np.median(list(share.values())))
    if not (worst <= SECOND_GRAD_SHARE
            and median <= SECOND_GRAD_MEDIAN_SHARE):
        bad = bad or (f"float32 gradients against float64: worst "
                      f"{worst:.3g}, median {median:.3g} of max |g|")
    tf32 = list(shares(control["grads"]).values())
    c_worst, c_median = max(tf32), float(np.median(tf32))
    summary.update(control_tf32_grad_share_worst=c_worst,
                   control_tf32_grad_share_median=c_median,
                   control_tf32_within_limits=(
                       c_worst <= SECOND_GRAD_SHARE
                       and c_median <= SECOND_GRAD_MEDIAN_SHARE))
    excused, lr = 0, g32["lr"]
    for n, want in g64["state"].items():
        got = g32["state"][n]
        if not want.is_floating_point():
            if not torch.equal(got, want):
                bad = bad or f"{n}: {got} vs {want}"
            continue
        got, want = got.double(), want.double()
        close = torch.isclose(got, want, **TRAIN_PARAM_TOL)
        if n in g64["grads"]:
            g, truth = g32["grads"][n].double(), g64["grads"][n]
            noise = (((g - truth).abs() > TRAIN_G_AGREE * truth.abs())
                     | (truth.abs() < TRAIN_G_NOISE * truth.abs().max()))
            excused += int((noise & ~close).sum())
            close |= noise & ((got - want).abs() <= 2 * lr * 1.01)
        if not bool(close.all()):
            bad = bad or (f"{n} after the update: max abs diff "
                          f"{float((got - want).abs().max())}")
    summary.update(grad_share_worst=worst, grad_share_median=median,
                   grad_share_top={n: share[n] for n in sorted(
                       share, key=share.get, reverse=True)[:4]},
                   excused_params=excused)
    return summary, bad


def join_bound(feats, idx, found, dout, dfeatures: bool = True) -> dict:
    """What the backward of one join needs, from its own hits.  Each half
    does the needed flops 2 * hits * Cin * Cout, bounded at the 3xTF32
    rate as K3/K4 are (the fp32 SIMT rate beside it for dW, whose kernel
    runs there), and moves each of its inputs once and its output once:
    dW reads the features, dout and the rulebook and writes dW; dfeatures
    reads dout, the rulebook and W and writes dfeatures.  A half's bound
    is the larger of its two times; the backward's is their sum (dW alone
    where the input needs no gradient)."""
    Cin, Cout = feats.shape[-1], dout.shape[-1]
    hits = int(found.sum())
    book = idx.numel() * idx.element_size() + found.numel()
    w_bytes = idx.shape[-2] * Cin * Cout * 4
    flops = 2 * hits * Cin * Cout
    ops_ms = flops / PEAK_TF32_3X_PER_S * 1e3
    out = {"hits": hits, "flops": flops}
    for half, nbytes in (("dw", feats.numel() * 4 + dout.numel() * 4 + book
                          + w_bytes),
                         ("dfeatures", dout.numel() * 4 + book + w_bytes
                          + feats.numel() * 4)):
        if half == "dfeatures" and not dfeatures:
            out.update(dfeatures_bytes=0, dfeatures_bound_ms=0.0)
            continue
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        out.update({f"{half}_bytes": nbytes,
                    f"{half}_bound_ms": max(ops_ms, bytes_ms),
                    f"{half}_bound_by": ("operations" if ops_ms >= bytes_ms
                                         else "bytes")})
    out["dw_bound_fp32_simt_ms"] = max(flops / PEAK_FP32_PER_S * 1e3,
                                       out["dw_bytes"] / PEAK_BYTES_PER_S
                                       * 1e3)
    out["bound_ms"] = out["dw_bound_ms"] + out["dfeatures_bound_ms"]
    larger = ("dw" if out["dw_bound_ms"] >= out["dfeatures_bound_ms"]
              else "dfeatures")
    out["bound_by"] = out[f"{larger}_bound_by"]
    return out


@torch.no_grad()
def phase_join_backward(wcalls: list, fcalls: list, card: str) -> tuple:
    """The backward kernels against the plain backward at every join of
    one training step (B = 6): dW (``join_grad_weights``) and dfeatures
    (``join_grad_features``: the rulebook's inverse and the gather
    kernel), rtol and atol JOIN_GRAD_TOL of max |g|; each join's device
    time and bound.  -> (the kernels line's backward fields, {key: fn} and
    event times for the largest join)."""
    sgg = sparse_gather_gemm
    by_rulebook = {id(c[0][1]): c for c in fcalls}
    worst, per_join, bounds = 0.0, [], []
    for (feats, idx, found, dout), _ in wcalls:
        got = sgg.join_grad_weights(feats, idx, found, dout)
        ref = sgg.grad_weights_plain(feats, idx, found, dout)
        checks = [("dW", got, ref)]
        fcall = by_rulebook.get(id(idx))
        if fcall is not None:
            (fdout, fidx, ffound, w, N), _ = fcall
            checks.append(("dfeatures",
                           sgg.join_grad_features(fdout, fidx, ffound, w, N),
                           sgg.grad_features_plain(fdout, fidx, ffound, w,
                                                   N)))
        torch.cuda.synchronize()
        what = (f"B={feats.shape[0]} N={feats.shape[1]} R={idx.shape[-1]} "
                f"K={idx.shape[-2]} Cin={feats.shape[-1]} "
                f"Cout={dout.shape[-1]}")
        errs = {}
        for name, g, r in checks:
            scale = float(r.abs().max())
            err = float((g - r).abs().max())
            errs[name] = err / scale if scale else err
            close = torch.isclose(g, r, rtol=JOIN_GRAD_TOL,
                                  atol=JOIN_GRAD_TOL * scale)
            if not (scale > 0 and bool(close.all())):
                raise AssertionError(f"join backward {what}: {name} kernel "
                                     f"vs plain: max abs err {err} (max "
                                     f"|g| {scale})")
            worst = max(worst, errs[name])

        def kernels():
            sgg.join_grad_weights(feats, idx, found, dout)
            if fcall is not None:
                sgg.join_grad_features(fdout, fidx, ffound, w, N)

        ms, _ = device_ms(kernels)
        # the voxel means need no gradient: no dfeatures at the first join
        b = join_bound(feats, idx, found, dout, fcall is not None)
        per_join.append(ms)
        bounds.append(b["bound_ms"])
        log(f"join backward [{card}]: {what}: dW"
            f"{' + dfeatures' if fcall is not None else ''} kernel vs plain "
            f"max err {json.dumps(errs)} of max |g|; device "
            f"{'not measured' if ms is None else f'{ms:.5f} ms'}; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} (dW "
            f"{b['dw_bound_ms']:.5f} by {b['dw_bound_by']}, at the SIMT "
            f"rate {b['dw_bound_fp32_simt_ms']:.5f}; dfeatures "
            f"{b['dfeatures_bound_ms']:.5f}; {b['hits']} hits, "
            f"{b['flops']} needed flops, {b['dw_bytes']} bytes a half)")
    largest = max(wcalls, key=lambda c: int(c[0][2].sum())
                  * c[0][0].shape[-1] * c[0][3].shape[-1])
    feats, idx, found, dout = largest[0]
    (fdout, fidx, ffound, w, N), _ = by_rulebook[id(idx)]
    b = join_bound(feats, idx, found, dout)
    # which side is nearer float64, at the largest join
    f64 = {"dW": sgg.grad_weights_plain(feats.double(), idx, found,
                                        dout.double()),
           "dfeatures": sgg.grad_features_plain(fdout.double(), fidx, ffound,
                                                w.double(), N)}
    f32 = {"dW": (sgg.join_grad_weights(feats, idx, found, dout),
                  sgg.grad_weights_plain(feats, idx, found, dout)),
           "dfeatures": (sgg.join_grad_features(fdout, fidx, ffound, w, N),
                         sgg.grad_features_plain(fdout, fidx, ffound, w, N))}
    vs64 = {k: {side: float((g.double() - f64[k]).abs().max()
                            / f64[k].abs().max())
                for side, g in zip(("kernel", "plain"), f32[k])}
            for k in f64}
    del f64, f32
    log(f"join backward [{card}]: largest join, max error against float64 "
        f"as a share of max |g|: {json.dumps(vs64)}")
    fns = {"backward_ms": lambda: (
               sgg.join_grad_weights(feats, idx, found, dout),
               sgg.join_grad_features(fdout, fidx, ffound, w, N)),
           "backward_plain_ms": lambda: (
               sgg.grad_weights_plain(feats, idx, found, dout),
               sgg.grad_features_plain(fdout, fidx, ffound, w, N)),
           "backward_dw_ms": lambda: sgg.join_grad_weights(
               feats, idx, found, dout),
           "backward_dfeatures_ms": lambda: sgg.join_grad_features(
               fdout, fidx, ffound, w, N)}
    ev = {k: cuda_ms(fn, iters=10, warmup=2) for k, fn in fns.items()}
    shape = (f"B={feats.shape[0]} N={feats.shape[1]} R={idx.shape[-1]} "
             f"K={idx.shape[-2]} Cin={feats.shape[-1]} Cout={dout.shape[-1]}")
    log(f"join backward [{card}]: largest join {shape}: events "
        + "; ".join(f"{k[:-3]} {fmt_range(v)}" for k, v in ev.items())
        + f"; bound {b['bound_ms']:.5f} ms; {len(wcalls)} joins, "
        f"{len(fcalls)} with dfeatures; per join device ms {per_join}")
    fields = {"backward_kernel": "rulebook_inverse_kernel + "
                                 "gather_gemm_kernel (dfeatures), "
                                 "tap_grad_partial_kernel + "
                                 "tap_grad_sum_kernel (dW)",
              "backward_source": "automatic_as_built_reconstruction_tpu_"
                                 "torch/csrc/sparse_join_grad.cu",
              "backward_shape": shape,
              "backward_max_err_of_max_g": worst,
              "backward_vs_float64": vs64,
              "backward_bound_ms": b["bound_ms"],
              "backward_bound_by": b["bound_by"],
              "backward_dw_bound_ms": b["dw_bound_ms"],
              "backward_dw_bound_by": b["dw_bound_by"],
              "backward_dw_bound_fp32_simt_ms": b["dw_bound_fp32_simt_ms"],
              "backward_dfeatures_bound_ms": b["dfeatures_bound_ms"],
              "backward_dfeatures_bound_by": b["dfeatures_bound_by"],
              "backward_per_join_ms": per_join,
              "backward_per_join_bound_ms": bounds,
              "backward_library_ms": None}
    return fields, fns, ev


def perfect_eval(val_info_path: Path, card: str) -> dict:
    """The KITTI protocol with the validation ground truth as detections
    (distinct scores): every threshold the protocol samples has precision
    1 and the last recall 1, so AP is 100 wherever the ground truth fills
    the 41 recall slots (at least ~40 objects of the difficulty) and
    100 * (slots filled) / 41 otherwise.  -> the AP table."""
    import pickle

    with open(val_info_path, "rb") as f:
        gt = [i["annos"] for i in pickle.load(f)]
    dt, s = [], 1.0
    for a in gt:
        keep = a["name"] != "DontCare"
        d = {k: a[k][keep] for k in ("name", "truncated", "occluded",
                                     "alpha", "bbox", "dimensions",
                                     "location", "rotation_y")}
        d["score"] = s - 1e-3 * np.arange(int(keep.sum()))
        s -= 1e-3 * int(keep.sum())
        dt.append(d)
    result = eval_mod.get_official_eval_result(gt, dt, ["Car"])
    for metric, mname in ((0, "bbox"), (1, "bev"), (2, "3d")):
        for diff, dname in enumerate(eval_mod.DIFFICULTY_NAMES):
            r = eval_mod.eval_class(gt, dt, "Car", diff, metric,
                                    eval_mod.OVERLAPS["Car"][metric])
            T = len(r["thresholds"])
            if r["num_valid_gt"] == 0:
                continue
            filled = len(range(0, min(T, 41), 4))
            ap = result[f"Car.{mname}.{dname}"]
            if not ((r["precision"][:T] == 1).all()
                    and r["recall"][T - 1] == 1.0
                    and abs(ap - 100.0 * filled / 11) < 1e-9):
                raise AssertionError(
                    f"perfect detections: Car {mname} {dname}: AP {ap}, "
                    f"{T} thresholds, precision {r['precision'][:T]}, "
                    f"recall {r['recall'][:T]}")
            log(f"perfect detections [{card}]: Car {mname} {dname}: "
                f"{r['num_valid_gt']} objects, {T} thresholds, precision 1 "
                f"at each, AP {ap:.4f}"
                f"{' (100: every recall slot filled)' if T == 41 else ''}")
    log(f"perfect detections [{card}]: KITTI table\n" + result["result_str"])
    return result


def train_second(card: str) -> dict:
    """The SECOND training path: a synthetic KITTI clone (the port's
    generator and offline prep) in a temporary directory; ``train()`` on
    car.fhd.config at full width (B = 6, the sampler, the augmentation,
    the loader's three workers) with every kernel counter set to 0 just
    before and read just after; the loss check; host prep against the
    device step; one training step's backward calls recorded for the
    kernel phase; one step at B = 2, float32 on the kernels against
    float64 on the plain versions; ``evaluate`` on the 12 validation
    frames (the KITTI table; two frames' detections against the port's
    CPU run); perfect detections; a restart that resumes.  -> {"launches",
    "report", "wcalls", "fcalls", "step": one more step, for the
    profile}."""
    report = {}
    sgg = sparse_gather_gemm
    with torch.enable_grad(), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "kitti"
        t0 = time.perf_counter()
        n_labels = synth_kitti.write_clone(root, SYNTH_TRAIN, SYNTH_VAL,
                                           seed=0)
        log(f"second training [{card}]: synthetic KITTI clone, "
            f"{SYNTH_TRAIN} + {SYNTH_VAL} frames ({n_labels} labels), "
            f"infos, reduced clouds and gt database in "
            f"{time.perf_counter() - t0:.1f} s")
        config = second_train_config(tmp, root)
        bundle = train_mod.Bundle(config)
        cfg = bundle.model_cfg
        if not (cfg.sparse_keymatch and cfg.sparse_use_pallas_gemm
                and cfg.sparse_dense_tail_blocks == 0):
            raise AssertionError("car.fhd.config is not in key-match mode")
        plan = middle_plan(cfg, 17000)
        joins = sum(b.n_subm + 1 for b in plan)
        log(f"second training [{card}]: plan caps "
            f"{[b.out_cap for b in plan]}, {joins} joins a step")
        model_dir = tmp / "second"

        def run_train(config, **kw):
            for fn in KERNELS.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with flags_in_modules() as seen:
                state = train_mod.train(config, model_dir,
                                        max_steps=SECOND_TRAIN_STEPS,
                                        display_step=SECOND_DISPLAY,
                                        device="cuda", **kw)
                torch.cuda.synchronize()
            return state, time.perf_counter() - t0, seen

        try:
            state, wall, seen = run_train(config)
            report["site_caps"] = "plan"
        except train_mod.CapacitySaturationError as e:
            log(f"second training [{card}]: the plan's site caps raised "
                f"CapacitySaturationError ({e}); substituting the caps the "
                f"reference measured for car.fhd.config "
                f"(tools/kitti_rehearsal.py:155): {MEASURED_SITE_CAPS}")
            config = second_train_config(tmp, root, MEASURED_SITE_CAPS)
            state, wall, seen = run_train(config, resume=False)
            report["site_caps"] = list(MEASURED_SITE_CAPS)
        steps = SECOND_TRAIN_STEPS
        launches = {name: fn.launches for name, fn in KERNELS.items()}
        log(f"second training [{card}]: {steps} steps of train() in "
            f"{wall:.2f} s wall (Bundle, reader, seeded init and the final "
            f"checkpoint included): {steps / wall:.3f} steps/s; launches "
            f"{launches}")
        want = dict.fromkeys(KERNELS, 0) | {
            "keymatch_gemm": joins * steps, "join_grad_weights": joins * steps,
            "join_grad_features": (joins - 1) * steps,
            "rulebook_inverse": (joins - 1) * steps}
        if launches != want or state.step != steps:
            raise AssertionError(f"second training launched {launches} in "
                                 f"{state.step} steps, expected {want}")
        if seen != {(False, False)}:
            raise AssertionError(f"second training: the network ran with "
                                 f"TF32 flags {sorted(seen)}")
        windows = [json.loads(line) for line in
                   (model_dir / "metrics.jsonl").read_text().splitlines()]
        windows = [w for w in windows if w["prefix"] == "train"]
        keys = ("loss", "loss_cls", "loss_loc", "loss_dir", "grad_norm",
                "num_pos", "mid_capacity_saturated", "steps_per_sec",
                "host_prep_ms", "feed_ms", "step_ms")
        for w in windows:
            log(f"second training [{card}]: window to step {w['step']}: "
                + json.dumps({k: round(w[k], 5) for k in keys}))
        first, last = windows[0]["loss"], windows[-1]["loss"]
        if not all(math.isfinite(w["loss"]) for w in windows):
            raise AssertionError("second training: a loss is not finite")
        if not last < first:
            raise AssertionError(f"second training: mean loss of the last "
                                 f"window {last} is not below the first's "
                                 f"{first}")
        wait = float(np.median([w["host_prep_ms"] for w in windows]))

        # host prep of one batch on one thread against the device step
        prep_ds, loader = bundle.input_reader(training=True, seed=1)
        stream = loader._index_stream()
        t_prep = []
        examples = []
        reader = bundle.config["train_input_reader"]
        for _ in range(reader["batch_size"]):
            t0 = time.perf_counter()
            examples.append(prep_ds.example(*next(stream)))
            t_prep.append((time.perf_counter() - t0) * 1e3)
        prep_batch = float(np.sum(t_prep))
        example = train_mod.to_device(batching.merge_batch(examples), "cuda")
        step_fn = train_mod.make_train_step(train_mod.Bundle(config))
        ev = cuda_ms(lambda: step_fn(state, example), iters=5, warmup=1)
        report.update(steps=steps, wall_s=wall, steps_per_sec=steps / wall,
                      window_steps_per_sec=[w["steps_per_sec"]
                                            for w in windows],
                      loss_windows=[w["loss"] for w in windows],
                      loader_wait_ms=wait, prep_ms_one_thread=prep_batch,
                      device_step_ms=ev,
                      host_prep_share=prep_batch / (prep_batch + ev[0]))
        log(f"second training [{card}]: mean loss {first:.5f} (steps 1-"
            f"{SECOND_DISPLAY}) -> {last:.5f} (steps {steps - SECOND_DISPLAY
            + 1}-{steps}); the loader's wait a batch (median of the windows, "
            f"{reader['num_workers']} workers) {wait:.2f} ms; prep of one "
            f"batch of {len(examples)} on one thread "
            f"{prep_batch:.1f} ms (examples {[round(t, 1) for t in t_prep]}); "
            f"device step (B={len(examples)}, synchronised, events) "
            f"{fmt_range(ev)}: host prep on one thread is "
            f"{100 * report['host_prep_share']:.1f} % of prep + device step")

        # one step's backward calls, for the kernel phase
        wcalls, fcalls = [], []
        with recording(sgg, "join_grad_weights", wcalls), \
                recording(sgg, "join_grad_features", fcalls):
            step_fn(state, example)
        torch.cuda.synchronize()
        if (len(wcalls), len(fcalls)) != (joins, joins - 1):
            raise AssertionError(f"one step recorded {len(wcalls)} dW and "
                                 f"{len(fcalls)} dfeatures calls, expected "
                                 f"{joins} and {joins - 1}")
        if sgg.rulebook_collisions("cuda"):
            raise AssertionError("a join's rulebook is not a convolution's: "
                                 f"{sgg.rulebook_collisions('cuda')} "
                                 f"collisions")

        # one step at B = 2: float32 on the kernels, float64 plain
        pair = batching.merge_batch(examples[:SECOND_STEP_B])
        summary, bad = second_step_mismatch(config, pair, steps)
        log(f"second training [{card}]: one step (B={SECOND_STEP_B}) float32 "
            f"on the kernels vs float64 on the plain versions, both on the "
            f"card: " + json.dumps(summary))
        if bad is not None:
            raise AssertionError(f"second train step, float32 vs float64: "
                                 f"{bad}")
        report["f32_vs_f64"] = summary

        # evaluate on the validation frames; two frames against the CPU
        for fn in KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = evaluate(config, model_dir, device="cuda")
        ev_launches = {n: fn.launches for n, fn in KERNELS.items()}
        batches = -(-SYNTH_VAL // bundle.config["eval_input_reader"][
            "batch_size"])
        want = dict.fromkeys(KERNELS, 0) | {"keymatch_gemm": joins * batches,
                                            "rotated_iou": batches}
        if ev_launches != want:
            raise AssertionError(f"second evaluate launched {ev_launches}, "
                                 f"expected {want}")
        log(f"second training [{card}]: evaluate on the {SYNTH_VAL} "
            f"validation frames (checkpoint at step {steps}) in "
            f"{time.perf_counter() - t0:.1f} s, launches {ev_launches}; "
            f"KITTI table (not held):\n" + result["result_str"])
        report["evaluate_ap"] = {k: v for k, v in result.items()
                                 if k != "result_str"}
        # validation frames 0 and 1 through the checkpoint on the CPU and
        # on the card: the heads, and the detections at the config's score
        # threshold and, as 40 steps score few boxes above it, at the
        # middle of the widest gap among the CPU's 64 highest scores
        eb = train_mod.Bundle(config)
        vds, _ = eb.input_reader(training=False)
        val = batching.merge_batch([vds.example(i, i) for i in range(2)])
        heads, dets, thresholds = {}, {}, [cfg.nms_score_threshold]
        for dev in ("cpu", "cuda"):
            eb.model.to(dev)
            ckpt_mod.CheckpointManager(model_dir).restore_model(eb.model)
            ex = train_mod.to_device(val, dev)
            with torch.no_grad(), fp32_math():
                preds = eb.model.eval()(ex["voxels"], ex["num_points"],
                                        ex["coordinates"])
                if dev == "cpu":
                    top = torch.sigmoid(preds["cls_preds"]).flatten().topk(
                        64).values.double()
                    i = int((top[:-1] - top[1:]).argmax())
                    thresholds.append(float(top[i] + top[i + 1]) / 2)
                for thr in thresholds:
                    out = predict(preds, ex["anchors"], dataclasses.replace(
                        cfg, nms_score_threshold=thr))
                    dets[dev, thr] = {k: v.cpu().numpy()
                                      for k, v in out.items()}
            heads[dev] = {k: v.float().cpu() for k, v in preds.items()}
        err, bad_head = heads_mismatch(heads["cuda"], heads["cpu"])
        if bad_head is not None:
            raise AssertionError(f"second evaluate: head {bad_head} card vs "
                                 f"CPU {err}, tolerance {HEAD_TOL}")
        counts = {}
        for thr in thresholds:
            diff = detections_mismatch(dets["cuda", thr], dets["cpu", thr],
                                       cfg.num_class)
            if diff is not None:
                raise AssertionError(f"second evaluate: card vs CPU "
                                     f"detections (score >= {thr}) on two "
                                     f"validation frames: {diff}")
            counts[thr] = int(dets["cpu", thr]["valid"].sum())
        log(f"second training [{card}]: validation frames 0 and 1: heads "
            f"card vs CPU max abs diff {err} (within {HEAD_TOL}); "
            f"detections equal the CPU run's as sets ({counts} boxes by "
            f"score threshold)")
        report["perfect_ap"] = {k: v for k, v in perfect_eval(
            root / "kitti_infos_val.pkl", card).items() if k != "result_str"}

        state2 = train_mod.train(config, model_dir,
                                 max_steps=steps + SECOND_RESUME_STEPS,
                                 display_step=SECOND_RESUME_STEPS,
                                 device="cuda")
        text = (model_dir / "log.txt").read_text()
        if (state2.step != steps + SECOND_RESUME_STEPS
                or f"resumed from checkpoint at step {steps}" not in text):
            raise AssertionError(f"second restart: step {state2.step}, log "
                                 f"{text[-300:]}")
        log(f"second training [{card}]: a restart with max_steps "
            f"{steps + SECOND_RESUME_STEPS} resumed at step {steps} and "
            f"ended at {state2.step}")
    return {"launches": launches, "report": report, "wcalls": wcalls,
            "fcalls": fcalls, "step": lambda: step_fn(state, example)}


def device_time(what: str, card: str, fn):
    ms, per_kernel = device_ms(fn)
    log(f"{what} [{card}]: device time per call "
        f"{'not measured' if ms is None else f'{ms:.5f} ms'} "
        f"(torch.profiler, L2 flushed): {fmt_kernels(per_kernel)}")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)    # serving: the kernels have no backward
    try:
        card = smi = toolchain()
        empty_kernel = build_kernels()
        pod, requests, latency_ms, launches, k1_call, k2_call = serve(card)
        second = serve_second(card)
        ev_launches = run_evaluate(card)
        training = train_pillars(card)
        second_training = train_second(card)
        km, gg = second["km_launches"], second["gg_launches"]
        fm, dyn = second["fm_launches"], second["dyn_launches"]
        per_path = {"pillar serving": launches, "evaluate": ev_launches,
                    "second key-match": km, "second gather-GEMM": gg,
                    "second fused_mean": fm, "second dynamic": dyn,
                    "pillar training": training["launches"],
                    "second training": second_training["launches"]}
        total = {name: sum(p[name] for p in per_path.values())
                 for name in KERNELS}
        log(f"launches by path: {json.dumps(per_path)}; summed {total}")
        check_flat_pfn(pod, requests[0], card)
        k5 = phase_k5(second["fm_calls"]["voxel_mean"][0],
                      second["requests"], requests[0], pod.cfg,
                      second["pod"].cfg, total, card)
        phases = [phase_k1(k1_call, training["calls"]["pillar_gather"][0],
                           total["pillar_scatter"], total["pillar_gather"],
                           card),
                  phase_k2(k2_call, second["km_calls"]["rotated_iou"][0],
                           total["rotated_iou"], card),
                  phase_sparse_gemm("keymatch_gemm",
                                    second["km_calls"]["keymatch_gemm"],
                                    total["keymatch_gemm"], card),
                  phase_sparse_gemm("gather_gemm",
                                    second["gg_calls"]["gather_gemm"],
                                    total["gather_gemm"], card),
                  k5]
        # the joins' backward, shared by the two families: its numbers go
        # into both entries
        bw_fields, bw_fns, bw_ev = phase_join_backward(
            second_training["wcalls"], second_training["fcalls"], card)
        del second_training["wcalls"], second_training["fcalls"]
        bw_counters = ["rulebook_inverse", "join_grad_features",
                       "join_grad_weights"]
        for entry, fns, ev in phases[2:4]:
            entry.update(bw_fields, backward_counters=bw_counters,
                         backward_launches={c: total[c]
                                            for c in bw_counters})
            fns.update(bw_fns)
            ev.update(bw_ev)
        phases[0][0]["backward_counters"] = ["pillar_gather"]
        # last: the profiler's tracing slows later launches down.  Each
        # time in the kernels line is device time, with the event times
        # (median, min, max) beside it under *_event_ms.
        kernels = []
        for entry, fns, ev in phases:
            measured = True
            for key, fn in fns.items():
                dev = device_time(f"{entry['name']} {key}", card, fn)
                measured &= dev is not None
                entry[key] = ev[key][0] if dev is None else dev
                entry["event_ms" if key == "ms"
                      else key[:-3] + "_event_ms"] = ev[key]
            entry["launches_by_path"] = {
                path: n[entry["name"]] for path, n in per_path.items()}
            if "backward_counters" in entry:
                counters = entry.pop("backward_counters")
                entry["backward_launches_by_path"] = {
                    path: {c: n[c] for c in counters} if len(counters) > 1
                    else n[counters[0]] for path, n in per_path.items()}
            entry["ms_from"] = ("torch.profiler device time" if measured
                                else "cuda events (median)")
            kernels.append(entry)
        launch_bound = [e for e in kernels
                        if e["name"] in ("pillar_scatter", "voxel_mean")]
        floors = launch_floor(empty_kernel, card, {
            e["name"]: e["grid"] for e in launch_bound})
        for e in launch_bound:
            e["floor_ms"] = floors["one block"]
            e["grid_floor_ms"] = floors[e["name"]]
        with torch.enable_grad():
            profile_call("pillar training step", training["step"], card,
                         training["report"]["device_step_ms"][0])
            profile_call("second training step", second_training["step"],
                         card,
                         second_training["report"]["device_step_ms"][0])
        profile_call("serving", lambda: pod(*requests[2]), card, latency_ms)
        for what, key, lat in (("second key-match", "pod", "latency_ms"),
                               ("second gather-GEMM", "gg", "gg_latency_ms"),
                               ("second fused_mean", "fused",
                                "fm_latency_ms"),
                               ("second dynamic", "dyn", "dyn_latency_ms")):
            profile_call(what, functools.partial(second[key],
                                                 *second["requests"][2]),
                         card, second[lat])
    except Exception:  # noqa: BLE001 - any phase failing fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
