"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the toolchain (torch, CUDA, nvcc, triton, the card);
2. builds every kernel in ``automatic_as_built_reconstruction_tpu_torch/
   csrc/`` with nvcc (one process per source, all at once), prints what
   ptxas reports (registers, shared memory, spills), and checks with
   ``cuobjdump -sass`` that every sparse-GEMM kernel and both backward
   GEMM kernels of the joins multiply in TF32 on the tensor cores and fill
   shared memory by cp.async, and that the backward has no float atomic;
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
   counters read for each; checks head outputs and the detections of the
   first SECOND_CPU_REQUESTS requests against the port's own CPU run, the
   modes against each other, the launch
   counts against the plan, and prints each block's
   ``capacity_saturated``;
4b. export: each of the pillar path (K1, K2), SECOND key-match (K4g,
   K2), key-match with ``fused_mean`` (K5, K4g, K2) and the gather-GEMM
   mode (K3s, K2) exported through ``utils/serving_export.py`` on the
   card, saved to bytes, loaded in this process and called on the
   path's requests (padded to one point count): its detections equal the
   eager pod's, its launch counters (set to 0 just before, read just
   after) equal the eager pod's with every kernel of the path launched,
   the caller's TF32 flags unchanged; prints each artifact's size, the
   export and load times and the request latency of artifact and eager
   pod in turns;
5. runs ``evaluate`` on the 32 synthetic val scenes of
   ``asbuilt_pillars.config`` with the trained checkpoint (host reader,
   network and ``predict`` on the card, point refinement, AP) and holds
   every AP to the value the JAX package's ``evaluate`` gives;
5b. asbuilt: a model directory whose latest checkpoint holds the trained
   checkpoint's weights at step 8000 (the port's weight import and
   ``train/checkpoint.py``); ``cli export_asbuilt --scene 0 --svg`` in a
   child process (K1 and K2 once each, TF32 off), whose JSON and SVG must
   be ``build_asbuilt_model`` / ``render_svg`` of the detections that
   ``viewer.server._make_predictor(..., device="cuda")`` gives here, and
   those equal the port's CPU detections as sets; then the viewer's
   ``Handler`` on 127.0.0.1 in a thread with that predictor: ``/``,
   ``/api/info``, ``/api/scene``, ``/api/detect`` twice (the second from
   its cache) and a bad index (500), the counters set to 0 just before
   and read just after (K1 and K2 once each); each step's wall time;
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
   ``evaluate`` on the port's own checkpoint over the first
   TRAIN_EVAL_SCENES val scenes (AP printed, not held); and
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
   (the key-match rulebook, the hits and dW every join, the rulebook's
   inverse and dfeatures every join but the first) once a join a step,
   as the plan says.  It reports steps/s
   of each window, host prep of a batch on one thread against the device
   step (events) and, at the end, a profile of one step; checks the loss
   (finite, the last window below the first), one step at B = 2 in
   float32 on the kernels against float64 on the plain versions on the
   card (loss terms, every gradient, the parameters after the update, the
   BatchNorm statistics), records one step's backward calls for the
   kernel phase, runs ``evaluate`` on the validation frames (the KITTI
   table printed, not held; two frames' heads against a float64 forward
   of the checkpoint within F32_HEAD_SHARE of their max |x|, a TF32
   control outside it; their detections against the float64 forward's,
   as sets within BOX_ATOL + F32_BOX_RTOL of each value, the TF32
   control's outside that or DETECTION_CONTROL_RATIO times farther, the
   CPU's distance printed), holds the KITTI
   protocol on the validation
   ground truth given as detections (precision 1 at every threshold it
   samples) and restarts with a larger ``max_steps``, which must resume;
6c. KITTI PointPillars and multi-class KITTI, on synthetic KITTI clones
   of 48 + 12 frames from seed 0 written into a temporary directory:
   ``pointpillars/car/xyres_16.config`` at full width (432 x 496 pillars,
   PFN 64, RPNV2 with upsample strides 1/2/4, 107 136 anchors, the anchor
   mask) trains for 60 steps through the port's command line, each verb a
   child process (``python -m automatic_as_built_reconstruction_tpu_torch
   .cli kitti_data_prep``, ``train --profile_steps 2``, whose trace must
   name K1's ``pillar_rows_kernel`` and ``pillar_gather_kernel``,
   ``evaluate``: B = 2, the buckets
   4000 / 8000 / 12 000, the sampler and the augmentation; an exit hook
   writes the child's launch counts and the TF32 flags its modules ran
   under, which must be off): the loss falls, at least two
   buckets occur (their histogram printed), the anchor mask drops
   anchors, the KITTI table is printed, one step's float32 on the card is
   held to float64 as in 6; the same config serves four requests of
   eight validation frames (B = 8, the trainer's seed-0 initial weights)
   twice over, detections against the port's CPU run;
   ``pointpillars/all/xyres_16.config`` (321 408 anchors) trains 30 steps
   on the multi-class clone and prints its three-class table, a step held
   as in 6; ``second/all.fhd.config`` (B = 6, key-match, the three sample
   groups) trains 20 steps with the plan's site caps (the caps
   tools/run_multiclass_r5.sh:19 measured where a window saturates),
   every join's backward kernels of one step against the plain backward,
   one step at B = 2 held to float64 as in 6b, and prints its table;
6d. the host-rulebook and bfloat16 SECOND configs on the same clones,
   each trained 20 steps through ``train()`` at full width (B = 6, three
   loader threads, the plan's own site caps, ``mid_capacity_saturated``
   printed by window, the loss falls; the loader's wait against one
   thread's prep of a batch, the native rulebook build of it apart, and
   the device step): ``second/people.fhd.config`` (Pedestrian and
   Cyclist sampler groups; the plain joins on the rulebooks the input
   pipeline builds on the host; one step at B = 2 in float32 held to
   float64 on the card at car.fhd's limits; ``evaluate``'s table),
   ``second/car/car.lite.config`` (the host rulebooks of a training batch
   against the device merge builders, integer for integer; ``evaluate``)
   and ``second/car/car.fhd.mixed.config`` (bfloat16 middle and RPN; the
   gather join's bfloat16 kernel forward and the float32 backward
   kernels, once a join a step), which then serves four B = 2 requests
   through ``pod_inference_from_checkpoint`` (seeded weights, rulebooks
   built on the device): the heads on the kernels against the same
   network on the plain versions, within CONTROL_MARGIN times the
   distance of a control (the plain versions with every join's taps
   reversed, another float32 sum order) from them, the bf16-vs-float32
   distance printed beside; the RPN's share of a request's device time
   beside car.fhd's float32 one;
6e. bfloat16 pillars: ``asbuilt_pillars.config`` with
   ``enable_mixed_precision`` (the PFN, K1 and the RPN in bf16) serves
   the trained checkpoint (four B = 2 requests twice over; latency and
   each stage's device time beside float32's; the heads held against the
   plain K1 with the control of the RPN convolutions' input channels
   reversed), runs ``evaluate`` on the 32 val scenes (AP printed beside
   JAX_EVAL_AP, num_gt equal) and trains MIXED_PILLAR_STEPS steps (the
   loss falls); and bfloat16 key-match SECOND: car.fhd.config with the
   flag trains 20 steps at B = 6 on the car clone (K4 in bf16 forward,
   the float32 backward kernels; the loss falls; one step's joins
   recorded) and evaluates, and car.fhd.serving.config with the flag
   serves four B = 2 requests, heads held against the plain joins with
   the taps-reversed control;
6e'. voxelnet, on the car clone: car.voxelnet.config (the VoxelNet
   paper's VFE and the dense middle on K1's D x H x W canvas, its
   gradient K1's gather) trains VOXELNET_STEPS steps at B = 2 through
   ``train()`` (counters set to 0 just before and read just after: K1
   and its gather once a step; the loss falls), its device step timed
   with cuDNN's deterministic algorithms and without, in turns, with the
   peak memory; serves four B = 2 validation requests (K1 and K2 each;
   the first request's heads and detections held to the port's CPU run)
   and one request of VOXELNET_VARIANT (nearest NMS, the yaw-quality
   head, softmax scores: K1 only), held the same way;
6f. multi_device: data parallelism over two ranks that share the card
   (``devices=["cuda:0", "cuda:0"]``, gloo; the ranks are child
   processes, and a rank's exception or a collective's timeout fails the
   phase): one spawn of ranks (``parallel/launch.py``) for (b) one
   car.fhd step at B = 6 (three scans a rank; the first batch of the sequential
   loader, seed 0, so that it is the same batch every run) against the
   one-process step (the loss, the middle's running statistics, the gradients
   within CONTROL_MARGIN x the distance of the same step on the batch's rows
   reordered; the one-process step's gradients the same bits when computed
   again), (c) ``evaluate(num_devices=2)`` over the 32 val scenes
   (detections equal one device's as sets, each AP within DP_AP_ATOL),
   (d) sharded serving of the pillar and car.fhd.serving requests (equal
   to the unsharded pods), (e) ``make_sharded_mean_canvas`` of a 2 M-point
   building floor (counts equal the one-device oracle's, means within
   rtol 1e-5), each rank's kernel counts read per sub-phase and no plain
   version called; then (a) ``train(num_devices=2)``, which starts its own
   ranks, against ``train()`` (one step: the loss within 1e-5, the
   parameters within rtol 2e-4 / atol 2e-5 but where the float32
   gradients disagree; three steps: ``train()`` again equal to
   ``train()`` bit for bit, the DP run within CONTROL_MARGIN x the
   distance of ``train()`` on the rows reversed, the part of it that the
   reduction order explains), each rank's counts from an exit hook; the
   training steps' device ms per rank beside one process's;
7. holds each kernel against its plain PyTorch version on the card, on
   the inputs the main paths gave it (for the pillar scatter also with
   the rows shuffled and on a canvas whose memory held NaN, one call's
   device kernels profiled (one, no fill, also inside a profiled pillar
   request), and its backward on the training step's canvas gradient,
   shuffled, with negative ids and on memory that held NaN, timed against
   its bound and
   the scatter timed against zeros + ``index_copy_`` in alternation, 30
   turns each; the sparse joins' backward kernels at every join of a
   SECOND training step, against the plain backward (and the key-match
   rulebook against ``_merge_lookup``), with their device time and
   bound, and at the largest join dW, dfeatures, their steps and the
   rulebook lookup in turns beside the bound and the per-tap floor; for
   the rotated IoU the pillar and SECOND inputs, a 1000 x 1000 set with
   degenerate boxes and one of nearly touching pairs, each with the
   outputs equal bit for bit and the share of the pairs each of its
   rejection tests takes; for the two sparse GEMMs every join
   of a request,
   each with its device time in turns with the plain version (CUDA
   events behind a GPU sleep, L2 flushed: one method for every join),
   bound and tile occupancy, the four call forms of the key-match
   function, and unsorted keys; the two joins' bfloat16 forms on every
   join of a car.fhd.mixed / bf16 car.fhd.serving request (and, for the
   key-match form, of a bf16 car.fhd training step), within 1e-4 of the
   join's max |out|, bound at the bf16 tensor-core rate; K1 on bfloat16
   rows (forward and backward, bit for bit, at the served shape and at
   the KITTI B = 8 shape, against zeros + ``index_copy_`` in bf16); for
   the
   fused
   voxelize+mean both routes on the served request, a pillar-sized scan, a
   truncating voxel cap, T = 1, an empty scan, NaN and on-face points and
   more slots than points, the key route's two kernels against their plain
   mirrors and the table kernel bit for bit, and at both served shapes the
   device time and device events of the function, its kernels, the sort
   and the table route);
   times kernel, plain version and library call with CUDA events (median
   and range), and in turns with each other behind a GPU sleep (the
   ``ms`` it reports: the card's work without the host's launch gaps), L2
   flushed before each call; checks the flat pillar VFE path against the padded
   one on a served request, and that it gives the same bits twice;
8. times an empty kernel (one block, and the grids of K1, from its
   wrapper's launch plan, and of K5) as the launch floor beside those
   two;
9. prints a ``{"kernels": [...]}`` line (``launches`` is the sum over the
   main paths, ``launches_by_path`` each path's own count; K1's entry
   carries its backward's ``backward_*`` numbers and has a second entry,
   ``pillar_scatter@kitti``, at the KITTI request's shape with the KITTI
   paths' launches, and ``pillar_scatter@bf16`` on bfloat16 rows with
   the bf16 pillar paths' launches and its KITTI-shape numbers under
   ``kitti``, and ``pillar_scatter@voxelnet`` at the dense VoxelNet
   canvas's shape (the rows route) with its gather and the voxelnet
   paths' launches; the sparse GEMMs' entries carry those of the joins'
   shared backward; ``gather_gemm_bf16`` and ``keymatch_gemm_bf16`` are the two
   joins' bfloat16 forms), the card's name and power limit as
   ``nvidia-smi`` reports them, and last ``{"ok": true, "device": ...}``.

Exits non-zero, with no result lines, when CUDA is unavailable or any
phase fails.
"""
from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import datetime
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from automatic_as_built_reconstruction_tpu_torch.builder import (
    input_reader_builder)
from automatic_as_built_reconstruction_tpu_torch.data import (
    batching, building, kitti_dataset, synth_kitti)
from automatic_as_built_reconstruction_tpu_torch.data.building import (
    generate_building_scene, pad_batch)
from automatic_as_built_reconstruction_tpu_torch.data.kitti_like import (
    make_scene)
from automatic_as_built_reconstruction_tpu_torch.device import fp32_math
from automatic_as_built_reconstruction_tpu_torch.models import (
    middle, pointpillars, rpn, voxelnet as voxelnet_mod)
from automatic_as_built_reconstruction_tpu_torch.models.voxelnet import (
    VoxelNet, middle_plan, predict)
from automatic_as_built_reconstruction_tpu_torch.ops import (
    _build, nms, pillar_scatter, rotated_iou, rulebook_host, sparse_conv,
    sparse_gather_gemm, voxel_mean)
from automatic_as_built_reconstruction_tpu_torch.ops.voxelize import (
    slot_table, voxelize, voxelize_flat)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    PodInference, inference, launch, pod_inference_from_checkpoint,
    sharded_voxelize)
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    mesh as mesh_mod)
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    build_from_config, detections_mismatch)
from automatic_as_built_reconstruction_tpu_torch.utils import (
    asbuilt_export, eval as eval_mod, serving_export, weight_import)
from automatic_as_built_reconstruction_tpu_torch.viewer import (
    server as viewer_server)
from automatic_as_built_reconstruction_tpu_torch.train import (
    checkpoint as ckpt_mod, train as train_mod)
from automatic_as_built_reconstruction_tpu_torch.train.train import evaluate
from automatic_as_built_reconstruction_tpu_torch.utils.seeded_init import (
    load_flax_init, load_seeded)

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
# the SECOND requests whose key-match detections are held against the
# port's CPU run, both rounds of each (a CPU request takes 8-17 s on the
# card machine's host; the other requests are held to the hard mode by
# fused_mean and to the eager pod by the export)
SECOND_CPU_REQUESTS = 2
# GPU vs CPU head outputs: 14 sparse / dense conv + BN layers and the
# RPN's 6, fp32-accurate sums in another order on each side (3xTF32 tap by
# tap on the tensor cores in the kernels and cuDNN on the card; one
# matmul and oneDNN on the CPU)
HEAD_TOL = dict(rtol=5e-4, atol=5e-4)
# the heads of the 40-step car.fhd checkpoint on the card against a
# float64 forward of it, as a share of each head's max |x|.  40 steps move
# the BatchNorm running statistics a third of the way (momentum 0.01), so
# in eval the RPN's activations reach ~1e4 and the heads 1e3-6e3; there
# float32 rounding alone reaches HEAD_TOL's atol at the small elements
# (head_drift.py, nine checkpoints, H100 80GB HBM3 at 700 W: the CPU's
# float32 heads used up to 0.54 of HEAD_TOL against float64, the card's
# up to 0.74, card against CPU up to 0.80; that check failed on 3 of about
# 12 runs).  Against max |x| the card's float32 lay at most 1.27e-6 from
# float64, the CPU's at most 7.7e-7; the control, the card's heads with
# TF32 on in the RPN, must lie outside the limit on every run
F32_HEAD_SHARE = 1e-5
# the detections ``predict`` decodes from those heads against the ones it
# decodes from the float64 forward, as sets: every box value within
# BOX_ATOL + F32_BOX_RTOL * |value|, scores within SCORE_ATOL.  An
# untrained box head's exp() gives boxes of thousands of metres (4117.8 m
# in one run of this check, 1.9e14 m in one of head_drift.py's), where
# BOX_ATOL alone is a few float32 ulps and no float32 forward keeps it.
# head_drift.py, eight checkpoints on an H100 80GB HBM3 at 700 W: the
# card's float32 detections needed at most 2.28e-5 of a value beyond
# BOX_ATOL (the CPU's 1.72e-5), so F32_BOX_RTOL is about 9x that.  The
# TF32 control's lay 1.3e-4 to 6.7e-3 from float64 (box values), the
# card's 0 to 1.5e-5: where the control's boxes stay inside BOX_ATOL
# (three checkpoints of four), it must lie at least
# DETECTION_CONTROL_RATIO times farther from float64 than the card's
F32_BOX_RTOL = 2e-4
DETECTION_CONTROL_RATIO = 10
# the boxes the second score threshold of that check keeps: from the 8th
# to the 32nd by score (chip_smoke.score_thresholds)
DETECTION_RANKS = (8, 32)
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
PEAK_BF16_PER_S = 989e12         # dense bf16 tensor-core rate
L2_FLUSH_BYTES = 64 << 20        # > the H100's 50 MB L2
# pillar training: steps of the one-cycle run from seeded weights, its
# display window (the loss check compares the first and last windows),
# and the steps the restart adds
TRAIN_STEPS, TRAIN_DISPLAY, TRAIN_RESUME_STEPS = 60, 10, 5
# the val scenes that evaluate the 60-step checkpoint (its AP is printed,
# not held; the untrained head's huge boxes make the point refinement take
# 3-9 s a scene: 105-279 s for all 32, 44.5 s for 8, 13.3-28.1 s for 4 on
# an H100 80GB HBM3 at 700 W)
TRAIN_EVAL_SCENES = 2
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
# kernels against their library call or plain version, in alternation:
# calls of each, and the GPU sleep before each call (about 1 ms at the
# H100's clocks: longer than the host takes to queue a call's launches)
K1_TURNS = 30
IN_TURNS_SLEEP_CYCLES = 2_000_000
# the sparse joins' device time, in turns with their plain versions: calls
# of each at the largest join of a request (its kernels-line time) and at
# every other join
SPARSE_TURNS, JOIN_TURNS = 20, 5
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
# KITTI PointPillars (pointpillars/car/xyres_16.config, full width: 432 x
# 496 pillars of 0.16 m, PFN 64, RPNV2 64/128/256 with upsample strides
# 1/2/4, 107 136 anchors, the anchor mask) and the multi-class configs,
# on synthetic KITTI clones of SYNTH_TRAIN + SYNTH_VAL frames: serving at
# B = 8 (PP_REQUESTS requests of eight validation frames, ROUNDS times
# over, seeded weights) and training through the command line (buckets
# PP_BUCKETS, B = 2) for PP_TRAIN_STEPS steps in PP_DISPLAY-step windows;
# pointpillars/all/xyres_16.config (321 408 anchors) for PP_ALL_STEPS
# steps; second/all.fhd.config (B = 6, key-match) for ALL_FHD_STEPS steps
# in ALL_FHD_DISPLAY-step windows, with the site caps that
# tools/run_multiclass_r5.sh:19 measured where the plan's saturate
CONFIGS = ROOT / "automatic_as_built_reconstruction_tpu_torch" / "configs"
PP_CONFIG = CONFIGS / "pointpillars" / "car" / "xyres_16.config"
PP_ALL_CONFIG = CONFIGS / "pointpillars" / "all" / "xyres_16.config"
ALL_FHD_CONFIG = CONFIGS / "second" / "all.fhd.config"
PP_MAX_VOXELS, PP_MAX_POINTS, PP_SERVE_B, PP_REQUESTS = 12000, 100, 8, 4
PP_BUCKETS = (4000, 8000, 12000)
PP_TRAIN_STEPS, PP_DISPLAY, PP_ALL_STEPS = 60, 10, 30
ALL_FHD_STEPS, ALL_FHD_DISPLAY = 20, 5
MULTICLASS_SITE_CAPS = (52352, 53888, 30464, 29184)
CLI_TIMEOUT_S = 600
# host-rulebook SECOND (people.fhd on the multi-class clone, car.lite on
# the car clone: the plain joins on rulebooks the input pipeline builds)
# and bfloat16 SECOND (car.fhd.mixed: host rulebooks, the gather join's
# bfloat16 kernel), each trained HOST_RB_STEPS steps in HOST_RB_DISPLAY-
# step windows with the plan's own site caps.  A bf16 join kernel is held
# to its plain version (the bf16 inputs upcast, one float32 matmul) within
# BF16_GEMM_RTOL of the join's max |out|: the products are exact in
# float32, the two differ in the order of their float32 sums only.  A bf16
# network's heads on the kernels are held against the same network on the
# plain versions within CONTROL_MARGIN x the distance of a control from
# the plain versions on the same request: the plain versions again with
# another float32 sum order (the joins' taps reversed; for the pillar
# path, whose one kernel copies rows exactly, the RPN convolutions' input
# channels reversed).  A float32 sum order moves the bf16 rounding of
# values next to a rounding boundary and every later layer rounds again,
# so two bf16 runs that differ in sum order alone lie about as far apart
# as bf16 lies from float32 (car.fhd.mixed on an H100 80GB HBM3 at 700 W:
# the control 0.57-1.05 of that distance, the kernels 0.49-1.02, PERF.md);
# the control measures that spread on each request, and a kernel may
# spread it no further than half as much again.  The joins themselves are
# held at BF16_GEMM_RTOL
PEOPLE_CONFIG = CONFIGS / "second" / "people.fhd.config"
LITE_CONFIG = CONFIGS / "second" / "car" / "car.lite.config"
MIXED_CONFIG = CONFIGS / "second" / "car" / "car.fhd.mixed.config"
HOST_RB_STEPS, HOST_RB_DISPLAY = 20, 5
# bfloat16 pillars (asbuilt_pillars.config with enable_mixed_precision):
# the steps of its training run, in TRAIN_DISPLAY-step windows
MIXED_PILLAR_STEPS = 30
BF16_GEMM_RTOL = 1e-4
CONTROL_MARGIN = 1.5
# the VoxelNet family (car.voxelnet.config at full width: 352 x 400 x 10
# voxels of 35 points, the paper's VFE, DenseMiddle on K1's dense canvas,
# 70 400 anchors) on the car clone of the KITTI phases: VOXELNET_STEPS
# steps of train() at B = VOXELNET_B in VOXELNET_DISPLAY-step windows, its
# device step with cuDNN's deterministic algorithms and without, in
# turns; VOXELNET_REQUESTS requests of B = VOXELNET_B validation frames
# served from weights drawn from VOXELNET_SEED, the first held to the
# port's CPU run; one request of VOXELNET_VARIANT (nearest NMS, the
# yaw-quality head, softmax scores), held the same way
VOXELNET_CONFIG = (ROOT / "automatic_as_built_reconstruction_tpu_torch"
                   / "configs" / "second" / "car" / "car.voxelnet.config")
VOXELNET_B, VOXELNET_STEPS, VOXELNET_DISPLAY = 2, 12, 4
VOXELNET_REQUESTS, VOXELNET_SEED = 4, 0
VOXELNET_MAX_VOXELS, VOXELNET_MAX_POINTS = 20000, 35
VOXELNET_VARIANT = dict(use_rotate_nms=False, use_yaw_quality_head=True,
                        encode_background_as_zeros=False)
VOXELNET_STEP_TURNS = 3
# data parallelism (the multi_device phase): DP_RANKS ranks time-share the
# one card over gloo (NCCL refuses two ranks on one device).  Pillar
# training: one step of train(num_devices=2) against train(), parameters
# and BatchNorm statistics within DP_PARAM_TOL (the JAX package's own DP
# test, tests/test_parallel.py:55) where the element's two float32
# gradients agree to TRAIN_G_AGREE and |g| >= TRAIN_G_NOISE * max|g| (as
# train_step_mismatch holds them; elsewhere Adam may step the other way,
# at most 2 * lr), the loss within DP_LOSS_RTOL;
# then DP_TRAIN_STEPS steps, the parameters held within CONTROL_MARGIN x
# two controls' distance from train() (on an H100 80GB HBM3 at 700 W two
# train() runs of 3 steps already differ in 2.6 M of 4.8 M elements
# beyond DP_PARAM_TOL and by 1.7e-4 in the third step's loss, PERF.md).
# SECOND: one car.fhd step at B = 6 (three scans a rank) against the
# one-process step: the loss within DP_LOSS_RTOL, the middle's running
# statistics within DP_STATS_SHARE of each tensor's max |x|, the
# gradients within CONTROL_MARGIN x two controls' distance (the same
# step with the batch's rows reordered moves the median tensor by 3e-3
# of its max |g|, above SECOND_GRAD_MEDIAN_SHARE).  evaluate:
# every AP within DP_AP_ATOL of one device's.  The sharded mean canvas of
# a DP_CANVAS_POINTS-point building floor (synthetic scans side by
# side) against the one-device oracle at
# tests/test_parallel.py:137's tolerances
DP_RANKS = 2
DP_DEVICES = ["cuda:0"] * DP_RANKS
DP_TRAIN_STEPS = 3
DP_PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
DP_LOSS_RTOL = 1e-5
DP_STATS_SHARE = 1e-4
DP_AP_ATOL = 1e-4
DP_CANVAS_POINTS, DP_CANVAS_COLUMNS = 2_000_000, 8
DP_CANVAS_TOL = dict(rtol=1e-5, atol=1e-6)
DP_TIMEOUT = datetime.timedelta(minutes=5)
# the plain versions a kernel wrapper falls back to on a CPU tensor: a
# rank on the card must call none of them
PLAIN_VERSIONS = [
    (pillar_scatter, "scatter_sorted_to_canvas_plain"),
    (pillar_scatter, "pillar_gather_plain"),
    (rotated_iou, "rotate_iou_matrix_plain"),
    (sparse_gather_gemm, "gather_gemm_plain"),
    (sparse_gather_gemm, "keymatch_gemm_plain"),
    (sparse_gather_gemm, "keymatch_rulebook_plain"),
    (sparse_gather_gemm, "rulebook_hits_plain"),
    (sparse_gather_gemm, "rulebook_inverse_plain"),
    (sparse_gather_gemm, "grad_features_plain"),
    (sparse_gather_gemm, "grad_weights_plain")]


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
# takes on this card, the floor beside K1 and K5; and the L2 flush of
# device_profile, a kernel of its own name so that a trace tells its
# launches from the measured function's
EMPTY_KERNEL_SRC = r'''
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return (int)cudaGetLastError();
}
__global__ void l2_flush_kernel(uint4* p, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint4 v = p[i];
    v.x = ~v.x; v.y = ~v.y; v.z = ~v.z; v.w = ~v.w;
    p[i] = v;
  }
}
extern "C" int l2_flush_launch(void* p, long long n, cudaStream_t stream) {
  l2_flush_kernel<<<1056, 256, 0, stream>>>((uint4*)p, n);
  return (int)cudaGetLastError();
}
'''
FLUSH_KERNEL = "l2_flush_kernel"
_FLUSH = []           # the flush's launch function, once built


def start_empty_kernel_build():
    """nvcc on EMPTY_KERNEL_SRC, started.  -> (the process, the library
    it writes)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "empty_kernel.cu"
    src.write_text(EMPTY_KERNEL_SRC)
    lib = _build.BUILD_DIR / "libempty_kernel.so"
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def finish_empty_kernel_build(proc, lib: Path) -> Path:
    """Wait for :func:`start_empty_kernel_build` and load the flush."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise _build.KernelBuildError(f"empty kernel: {out}")
    flush = ctypes.CDLL(str(lib)).l2_flush_launch
    flush.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    flush.restype = ctypes.c_int
    _FLUSH[:] = [flush]
    return lib


def l2_flush(buf: torch.Tensor) -> None:
    """Read and write every byte of ``buf`` (L2_FLUSH_BYTES, more than
    the L2 holds) with :data:`FLUSH_KERNEL`, built at first use where
    :func:`build_kernels` has not built it."""
    if not _FLUSH:
        finish_empty_kernel_build(*start_empty_kernel_build())
    _build.check(_FLUSH[0](buf.data_ptr(), buf.numel() // 16,
                           torch.cuda.current_stream().cuda_stream),
                 "l2_flush_launch")


def build_kernels() -> Path:
    """Build every kernel and the empty one, all nvcc processes started
    together.  -> the empty kernel's library."""
    t0 = time.perf_counter()
    proc, lib = start_empty_kernel_build()
    result = _build.build_all()
    empty = finish_empty_kernel_build(proc, lib)
    per_source = ", ".join(f"{name} {r['seconds']:.1f} s"
                           for name, r in result.items())
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall ({per_source})")
    for name, r in result.items():
        for line in r["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                log(f"  ptxas {name}: {line.strip()}")
    check_sparse_gemm_sass()
    check_join_grad_sass()
    check_pillar_scatter_sass()
    return empty


def launch_floor(lib: Path, card: str, grids: dict) -> dict:
    """Device time (in turns, as the kernels line takes its times) and
    event times of the empty kernel: one block of 32 threads, and each
    grid of ``grids`` ({name: (blocks, threads)}).  -> {"one block" or
    name: device ms}."""
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    floors = {}
    for what, (blocks, threads) in {"one block": (1, 32), **grids}.items():
        def call():
            _build.check(fn(blocks, threads,
                            torch.cuda.current_stream().cuda_stream),
                         "empty_launch")
        turns = take_turns({what: call})[what]
        ev = cuda_ms(call)
        floors[what] = turns[0]
        log(f"launch floor [{card}]: empty kernel, {blocks} x {threads} "
            f"threads ({what}): in turns {fmt_range(turns)}, events "
            f"{fmt_range(ev)}")
    return floors


def check_sparse_gemm_sass() -> None:
    """Every instantiation of the two float32 sparse-GEMM kernels
    multiplies on the tensor cores in TF32 (HMMA ... TF32) and fills
    shared memory with cp.async (LDGSTS); every one of the two joins'
    bfloat16 forms multiplies with wgmma in bf16 (HGMMA ... BF16), fills
    its stages with cp.async and waits on mbarriers (SYNCS); the library
    has no float atomic (RED or ATOM on F32): ``cuobjdump -sass`` of the
    built library."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = run([str(cuobjdump), "-sass",
                str(_build.lib_path("sparse_gather_gemm"))])
    counts, atomics = {}, []
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        lines = body.splitlines()
        atomics += [x.strip() for x in lines
                    if ("RED" in x or "ATOM" in x) and ".F32" in x]
        if "gemm_kernel" not in name and "gemm_bf16_kernel" not in name:
            continue
        counts[name.strip()] = {
            "hmma_tf32": sum("HMMA" in x and "TF32" in x for x in lines),
            "hgmma_bf16": sum("HGMMA" in x and "BF16" in x for x in lines),
            "ldgsts": sum("LDGSTS" in x for x in lines),
            "syncs": sum("SYNCS" in x for x in lines)}
    log(f"sparse GEMM SASS (cuobjdump -sass): {json.dumps(counts)}")
    opcodes = sorted({x.split()[1] for x in sass.splitlines()
                      if "MMA" in x and len(x.split()) > 1})
    log(f"  MMA opcodes: {opcodes}; float atomics: {atomics or 'none'}")
    bad = [n for n, c in counts.items()
           if not ((c["hgmma_bf16"] and c["syncs"]) if "bf16" in n
                   else c["hmma_tf32"]) or not c["ldgsts"]]
    if len(counts) != 20 or bad or atomics:
        raise AssertionError(f"sparse GEMM kernels without TF32 HMMA, BF16 "
                             f"HGMMA on mbarriers or LDGSTS, or with float "
                             f"atomics: {bad or atomics or counts}")


def check_join_grad_sass() -> None:
    """Every instantiation of the joins' two backward GEMM kernels
    (``tap_grad_mma_kernel``: 12 output tiles; ``grad_features_kernel``:
    5 widths) multiplies on the tensor cores in TF32 and fills shared
    memory with cp.async, and the library has no float atomic (RED or
    ATOM on F32): ``cuobjdump -sass`` of the built library."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = run([str(cuobjdump), "-sass",
                str(_build.lib_path("sparse_join_grad"))])
    counts, atomics = {}, []
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        lines = body.splitlines()
        atomics += [x.strip() for x in lines
                    if ("RED" in x or "ATOM" in x) and ".F32" in x]
        if "tap_grad_mma_kernel" in name or "grad_features_kernel" in name:
            counts[name.strip()] = {
                "hmma_tf32": sum("HMMA" in x and "TF32" in x for x in lines),
                "ldgsts": sum("LDGSTS" in x for x in lines)}
    bad = [n for n, c in counts.items()
           if not (c["hmma_tf32"] and c["ldgsts"])]
    log(f"  join backward SASS: {len(counts)} GEMM kernels, each with TF32 "
        f"HMMA and LDGSTS; float atomics: {atomics or 'none'}")
    if len(counts) != 17 or bad or atomics:
        raise AssertionError(f"join backward kernels without TF32 HMMA or "
                             f"LDGSTS, or with float atomics: "
                             f"{bad or atomics or counts}")


def check_pillar_scatter_sass() -> None:
    """K1's library (its three kernels, the tiles, the rows and the
    gather, each instantiated for rows of 4, 8 and 16 chunks and any other
    width) has no atomic of any type (RED or ATOM) and moves rows in
    16-byte loads and stores (LDG / STG .128): ``cuobjdump -sass`` of the
    built library."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = run([str(cuobjdump), "-sass",
                str(_build.lib_path("pillar_scatter"))])
    counts, atomics = {}, []
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        lines = body.splitlines()
        ops = []
        for x in lines:
            words = x.split("*/")[1].split() if "*/" in x else []
            if words and words[0].startswith("@"):    # a predicate
                words = words[1:]
            if words:
                ops.append(words[0])
        atomics += [op for op in ops if op.startswith(("ATOM", "RED"))]
        counts[name.strip()] = {
            "ldg128": sum(op.startswith("LDG") and ".128" in op
                          for op in ops),
            "stg128": sum(op.startswith("STG") and ".128" in op
                          for op in ops)}
    log(f"  pillar scatter SASS: {json.dumps(counts)}; atomics: "
        f"{atomics or 'none'}")
    bad = [n for n, c in counts.items() if not (c["ldg128"] and c["stg128"])]
    if len(counts) != 12 or bad or atomics:
        raise AssertionError(f"pillar scatter kernels with atomics or "
                             f"without 16-byte loads and stores: "
                             f"{bad or atomics or counts}")


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


def device_profile(fn, iters: int = 20, windows: int = 3):
    """Device time per call summed over the kernels, memsets and copies
    ``fn`` launches (torch.profiler / CUPTI), L2 flushed before each call
    by :func:`l2_flush` (left out): the card's own time without the
    host's launch overhead.  Returns (ms, {name: ms}, device events a
    call), or (None, {}, 0) when the profiler saw no kernel.

    A window's trace can miss records and can hold records of an earlier
    window, which arrive late: late in a full run K4g once read 0.454 ms
    for the 0.73 of every other reading (each of the call's three kernels
    at about 0.61 of its time), windows held 7-19 of their 20 flushes, and
    a window of K1's backward held an earlier window's records of the same
    kernel (twice its time).  So each window keeps only the records that
    start at or after its first flush, ``windows`` windows are taken, and
    each kernel's time a call is its mean duration over every record kept
    times its launches a call, a whole number: the largest count any one
    window keeps over ``iters``, rounded up (a window that lost a record
    of every call's kernel would scale its time down by the share lost).
    The kernels line takes its times in turns (:func:`take_turns`), which
    loses no record.  (The flush was a ``bitwise_not`` before, whose name
    the measured functions' own ``bitwise_not`` kernels shared: they were
    left out of the sums.)"""
    from torch.profiler import ProfilerActivity, profile

    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    durations, most, short = {}, {}, []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                l2_flush(buf)
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        starts = [e.time_range.start for e in device
                  if FLUSH_KERNEL in e.name]
        if not starts:
            short.append(0)
            continue
        first = min(starts)
        counts = {}
        for e in device:
            if e.time_range.start < first or FLUSH_KERNEL in e.name:
                continue
            d = durations.setdefault(e.name, [0.0, 0])
            d[0] += e.time_range.elapsed_us() / 1e3
            d[1] += 1
            counts[e.name] = counts.get(e.name, 0) + 1
        for name, n in counts.items():
            most[name] = max(most.get(name, 0), n)
        if len(starts) < iters:
            short.append(len(starts))
    if short:
        log(f"device_profile: {len(short)} of {windows} windows lost flush "
            f"records (held {short} of {iters})")
    if not durations:
        return None, {}, 0
    per_call = {name: math.ceil(n / iters) for name, n in most.items()}
    per_kernel = {name: total / n * per_call[name]
                  for name, (total, n) in durations.items()}
    return (sum(per_kernel.values()), per_kernel, sum(per_call.values()))


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
# backward, the gather; the sparse joins' backward is four: the hits of
# each tap and the per-tap dW reduction, the rulebook's inverse and the
# dfeatures kernel over the rows each tap hits, and the key-match join's
# backward a fifth before them, its rulebook by the join's key lookup; K5
# is three: its key route's key kernel and segment-and-mean kernel, and
# the first-appearance route's table kernel), and where the main paths
# look each kernel or function up
KERNELS = {"pillar_scatter": pillar_scatter.scatter_sorted_to_canvas,
           "pillar_gather": pillar_scatter.pillar_gather,
           "rotated_iou": rotated_iou.rotate_iou_matrix,
           "keymatch_gemm": sparse_gather_gemm.keymatch_gemm,
           "gather_gemm": sparse_gather_gemm.gather_gemm,
           "gather_gemm_bf16": sparse_gather_gemm.gather_gemm_bf16,
           "keymatch_gemm_bf16": sparse_gather_gemm.keymatch_gemm_bf16,
           "keymatch_rulebook": sparse_gather_gemm.keymatch_rulebook,
           "rulebook_hits": sparse_gather_gemm.rulebook_hits,
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
    B = len(requests[0][1])
    log(f"{what} [{card}]: {len(outs)} requests (B={B}), latency ms median "
        f"{np.median(lat):.3f}, mean {np.mean(lat):.3f}, range "
        f"{min(lat):.3f}-{max(lat):.3f}; {n_scans / total_s:.2f} scans/s "
        f"over {n_scans} scans; all ms {[round(x, 3) for x in lat]}")
    splits = [stage_split_ms(pod, *r) for r in requests]
    log(f"{what} [{card}]: stage split ms (each B={B} request once, "
        f"synchronised per stage) " + json.dumps(
            {k: [round(sp[k], 3) for sp in splits] for k in splits[0]}))
    return outs, lat, launches, calls


def check_outputs(what: str, outs, pod) -> None:
    """Shapes and finite boxes of every request's output."""
    C = pod.cfg.num_class
    for out in outs:
        B = out["valid"].shape[0]
        if out["box3d_lidar"].shape != (B, C * pod.cfg.nms_post_max_size, 7):
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


def k1_in_request(pod, request, card: str) -> list:
    """One pillar request under torch.profiler with K1's call site in a
    ``record_function`` range: the device kernels the profiler links to
    that range and to the operators under it, which must be one, the
    scatter kernel (no fill).  -> their names."""
    from torch.profiler import ProfilerActivity, profile, record_function

    site = pointpillars.scatter_sorted_to_canvas
    tag = "K1 pillar_scatter call"

    def tagged(*args, **kwargs):
        with record_function(tag):
            return site(*args, **kwargs)

    def kernels(e) -> list:
        return [k.name for k in e.kernels] + [
            n for c in e.cpu_children for n in kernels(c)]

    with substituted(pointpillars, "scatter_sorted_to_canvas", tagged), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        pod(*request)
        torch.cuda.synchronize()
    found = [kernels(e) for e in prof.events() if e.name == tag
             and e.device_type == torch.autograd.DeviceType.CPU]
    log(f"serving [{card}]: the device kernels of K1's call in a profiled "
        f"request: {found}")
    if len(found) != 1 or len(found[0]) != 1 or \
            "pillar_scatter_kernel" not in found[0][0]:
        raise AssertionError(f"K1's call in a request launched {found}, not "
                             f"one pillar_scatter_kernel")
    return found[0]


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
# the serving export
# --------------------------------------------------------------------------

# artifact / eager rounds over a path's requests, in turns
EXPORT_TURNS = 4
# the kernels each exported path must launch (its K1, K2, K4g, K5, K3s)
EXPORT_KERNELS = {
    "pillar": ("pillar_scatter", "rotated_iou"),
    "second key-match": ("keymatch_gemm", "rotated_iou"),
    "second fused_mean": ("voxel_keys", "voxel_mean", "keymatch_gemm",
                          "rotated_iou"),
    "second gather-GEMM": ("gather_gemm", "rotated_iou")}


def padded_requests(requests) -> list:
    """The requests padded to one point count, the artifact's static
    shape (zeros past ``num_valid``, which no voxelizer reads)."""
    P = max(pts.shape[1] for pts, _ in requests)
    out = []
    for pts, nv in requests:
        full = np.zeros((pts.shape[0], P, pts.shape[2]), np.float32)
        full[:, :pts.shape[1]] = pts
        out.append((full, nv))
    return out


def export_path(what: str, pod, requests, card: str) -> dict:
    """One served path through ``utils/serving_export.py``: export the
    pod's program on the card, save it to bytes, load it in this process
    and call it on the path's requests (padded to one shape).  Holds: the
    artifact's detections equal the eager pod's (``detections_mismatch``),
    its launch counters (set to 0 just before, read just after) those of
    the eager pod on the same requests with every kernel of
    EXPORT_KERNELS[what] launched, the caller's TF32 flags unchanged.
    Prints the artifact's size, the export and load times, and the
    request latency of the artifact and the eager pod in turns.  -> its
    numbers and launches."""
    reqs = padded_requests(requests)
    B, P, C = reqs[0][0].shape
    flags = tf32_flags()
    t0 = time.perf_counter()
    blob = serving_export.export_serving(pod, B, P, num_features=C)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = serving_export.load_serving(blob)
    load_s = time.perf_counter() - t0
    art(*reqs[0])                         # warm-up of both
    pod(*reqs[0])
    zero_counts()
    want = [pod(*r) for r in reqs]
    eager = launch_counts()
    zero_counts()
    got = [art(*r) for r in reqs]
    launches = launch_counts()
    if tf32_flags() != flags:
        raise AssertionError(f"export {what}: the caller's TF32 flags "
                             f"{flags} became {tf32_flags()}")
    expect_some_launches(f"export {what}", launches, EXPORT_KERNELS[what])
    if launches != eager:
        raise AssertionError(f"export {what}: the artifact launched "
                             f"{launches}, the eager pod {eager}")
    C_cls = pod.cfg.num_class
    for i, (g, w) in enumerate(zip(got, want)):
        diff = detections_mismatch(g, w, C_cls, BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"export {what}, request {i}: {diff}")
    bit_equal = all(np.array_equal(g[k], w[k])
                    for g, w in zip(got, want) for k in w)
    lat = {"artifact": [], "eager": []}
    for turn in range(EXPORT_TURNS):
        order = [("artifact", art), ("eager", pod)]
        for name, fn in (order if turn % 2 == 0 else order[::-1]):
            for r in reqs:
                t = time.perf_counter()
                fn(*r)                    # host numpy: synchronised
                lat[name].append((time.perf_counter() - t) * 1e3)
    ms = {k: [float(np.median(v)), min(v), max(v)] for k, v in lat.items()}
    n_det = int(sum(o["valid"].sum() for o in got))
    log(f"export {what} [{card}]: artifact of {len(blob)} bytes "
        f"(B = {B}, {P} points x {C}), exported in {export_s:.2f} s, "
        f"loaded in {load_s:.2f} s; on {len(reqs)} requests its {n_det} "
        f"detections equal the eager pod's (boxes atol {BOX_ATOL}, scores "
        f"atol {SCORE_ATOL}; bit for bit: {bit_equal}), its launches "
        f"{ {k: v for k, v in launches.items() if v} } the eager pod's, "
        f"TF32 flags left at {flags}; request latency ms in turns "
        f"({EXPORT_TURNS} rounds of {len(reqs)}): artifact "
        f"{fmt_range(ms['artifact'])}, eager {fmt_range(ms['eager'])}")
    return {"bytes": len(blob), "export_s": export_s, "load_s": load_s,
            "latency_ms": ms, "bit_equal": bit_equal, "launches": launches,
            "calls": {"artifact": functools.partial(art, *reqs[-1]),
                      "eager": functools.partial(pod, *reqs[-1])}}


def export_phase(card: str, pod, requests, second: dict) -> dict:
    """The ``export`` phase: :func:`export_path` on the pillar path
    (K1, K2), SECOND key-match (K4g, K2), key-match with ``fused_mean``
    (K5, K4g, K2) and the gather-GEMM mode (K3s, K2).  -> {"launches":
    {path: counts}, "report": {path: numbers}, "calls": {path: the last
    request's artifact and eager calls, for the profiles at the end}}."""
    t0 = time.perf_counter()
    report = {"pillar": export_path("pillar", pod, requests, card)}
    for what, key in (("second key-match", "pod"),
                      ("second fused_mean", "fused"),
                      ("second gather-GEMM", "gg")):
        report[what] = export_path(what, second[key], second["requests"],
                                   card)
    log(f"export [{card}]: {len(report)} paths in "
        f"{time.perf_counter() - t0:.1f} s: " + json.dumps(
            {k: {n: v[n] for n in ("bytes", "export_s", "load_s",
                                   "latency_ms", "bit_equal")}
             for k, v in report.items()}))
    return {"launches": {f"export {k}": v.pop("launches")
                         for k, v in report.items()},
            "calls": {k: v.pop("calls") for k, v in report.items()},
            "report": report}


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


def head_tolerance_used(got: dict, ref: dict) -> dict:
    """{head: the largest |got - ref| / (atol + rtol |ref|) of HEAD_TOL,
    with |ref| there}: a head is outside HEAD_TOL where this exceeds 1."""
    out = {}
    for k in ref:
        share = (got[k] - ref[k]).abs() / (HEAD_TOL["atol"] + HEAD_TOL[
            "rtol"] * ref[k].abs())
        i = int(share.flatten().argmax())
        out[k] = [float(share.flatten()[i]), float(ref[k].flatten()[i])]
    return out


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
    cpu_outs = [cpu(*req) for req in requests[:SECOND_CPU_REQUESTS]]
    held = [i for i in range(len(outs)) if i % n < SECOND_CPU_REQUESTS]
    for i in held:
        diff = detections_mismatch(outs[i], cpu_outs[i % n], cfg.num_class,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"second request {i}, GPU vs CPU: {diff}")
    log(f"second: GPU detections match the port's CPU run on {len(held)} "
        f"of the {len(outs)} requests (the first {SECOND_CPU_REQUESTS} of "
        f"each round; boxes atol {BOX_ATOL}, scores atol {SCORE_ATOL}); "
        f"CPU run {time.perf_counter() - t0:.1f} s")
    # the dynamic mode against its own CPU run (one request: a CPU
    # request takes about ten seconds)
    t0 = time.perf_counter()
    cpu_dyn = PodInference(cpu.model, cpu.cfg, cpu.anchors.numpy(),
                           device="cpu", voxelization="dynamic", **kw)
    for i, req in enumerate(requests[:1]):
        diff = detections_mismatch(dyn_outs[i], cpu_dyn(*req), cfg.num_class,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"second dynamic request {i}, GPU vs CPU: "
                                 f"{diff}")
    log(f"second: dynamic-mode GPU detections match the port's CPU run on "
        f"1 request; detections per scan {dyn_outs[0]['valid'].sum(-1)} "
        f"(hard: {outs[0]['valid'].sum(-1)}); CPU run "
        f"{time.perf_counter() - t0:.1f} s")
    return result


# --------------------------------------------------------------------------
# kernels vs plain versions
# --------------------------------------------------------------------------

def take_turns(fns: dict, turns: int = K1_TURNS) -> dict:
    """Functions of the same inputs timed in alternation (the order of
    ``fns``, then the reverse, over and over), ``turns`` calls of each
    after two warm-up calls of each: CUDA events around each call,
    recorded after an L2 flush and a GPU sleep of IN_TURNS_SLEEP_CYCLES,
    so that the host has queued the call's launches before the first of
    them may start and the events time the card's work, not the host's.
    -> {key: [median, min, max]} in ms."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(2):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for i in range(len(fns) * turns):
        name = order[i % len(order)]
        flush.zero_()
        torch.cuda._sleep(IN_TURNS_SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fns[name]()
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end))
    return {k: [float(np.median(v)), min(v), max(v)]
            for k, v in times.items()}


def in_turns(kernel, other, turns: int = K1_TURNS) -> dict:
    """:func:`take_turns` of two functions (kernel, other, other, kernel,
    ...).  -> {"kernel": [median, min, max], "other": [...]} in ms."""
    return take_turns({"kernel": kernel, "other": other}, turns)


def on_dirty_memory(fn, shape, dtype):
    """``fn()`` right after a tensor of ``shape`` filled with NaN was freed,
    so that the caching allocator hands its block to the ``torch.empty``
    of the same size inside ``fn``: the result, which must lie in that
    block (else the check would not be one)."""
    dirty = torch.full(shape, float("nan"), dtype=dtype, device="cuda")
    ptr = dirty.data_ptr()
    del dirty
    out = fn()
    if out.data_ptr() != ptr:
        raise AssertionError("the dirty block was not reused")
    return out


def k1_call_kernels(call, card: str, what: str) -> dict:
    """The device kernels of one K1 forward call on the recorded inputs
    (torch.profiler): on the tiles route exactly one, the scatter kernel,
    and no fill; on the rows route the fill and the rows kernel."""
    (feats, lin, hw), _ = call
    B, V, C = feats.shape
    route = pillar_scatter.scatter_plan(
        B, V, hw, C * feats.element_size() // 16,
        pillar_scatter.sm_count(feats.device)).route
    _, per_kernel, events = device_profile(
        lambda: pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw))
    log(f"K1 pillar_scatter {what} [{card}]: the {route} route; one call's "
        f"device kernels ({events} a call): {fmt_kernels(per_kernel)}")
    kernel = ("pillar_scatter_kernel" if route == "tiles"
              else "pillar_rows_kernel")
    others = [k for k in per_kernel if kernel not in k]
    if (events != (1 if route == "tiles" else 2)
            or len(others) != (0 if route == "tiles" else 1)):
        raise AssertionError(f"{what}: a K1 call on the {route} route ran "
                             f"{per_kernel}")
    return per_kernel


def k1_forward(call, card: str, what: str) -> tuple:
    """K1's forward on a recorded call: kernel == plain exactly, also with
    the rows shuffled and on a canvas whose memory held NaN; the ``zeros``
    + ``index_copy_`` yardstick equal to both; one call's device kernels
    (one); event times of the three and the kernel against the yardstick
    in turns; the bound in bytes.  -> (entry fields, {key: fn} to time on
    the device, event times)."""
    (feats, lin, hw), _ = call
    B, V, C = feats.shape
    e = feats.element_size()
    got = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    ref = pillar_scatter.scatter_sorted_to_canvas_plain(feats, lin, hw)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"{what}: pillar_scatter kernel != plain "
                             f"version")
    del got
    dirty = on_dirty_memory(
        lambda: pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw),
        (B, hw, C), feats.dtype)
    torch.cuda.synchronize()
    if not torch.equal(dirty, ref):
        raise AssertionError(f"{what}: pillar_scatter on a canvas of NaN "
                             f"!= plain version")
    del dirty
    kernels = k1_call_kernels(call, card, what)
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
        raise AssertionError(f"{what}: pillar_scatter with shuffled rows != "
                             f"sorted")
    descents = int((lin[:, perm][:, 1:] < lin[:, perm][:, :-1]).sum())
    log(f"K1 pillar_scatter {what} [{card}]: rows shuffled ({descents} "
        f"descents in the ids) and on a canvas whose memory held NaN: "
        f"kernel == plain == the sorted call's canvas exactly")
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
        raise AssertionError(f"{what}: index_copy_ yardstick != plain "
                             f"version")
    fns = {"ms": lambda: pillar_scatter.scatter_sorted_to_canvas(
               feats, lin, hw),
           "plain_ms": lambda: pillar_scatter.scatter_sorted_to_canvas_plain(
               feats, lin, hw),
           "library_ms": library}
    ev = {k: cuda_ms(fn) for k, fn in fns.items()}
    plan = pillar_scatter.scatter_plan(B, V, hw, C * e // 16,
                                       pillar_scatter.sm_count(feats.device))
    # bytes this data needs: the occupied rows' features, every id, the
    # whole canvas written once
    nbytes = rows * C * e + B * V * 4 + B * hw * C * e
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"K1 pillar_scatter {what} [{card}]: {feats.dtype}, B={B} V={V} "
        f"C={C} hw={hw}, "
        f"{rows} occupied rows; kernel == plain exactly; events: kernel "
        f"{fmt_range(ev['ms'])}, plain {fmt_range(ev['plain_ms'])}, "
        f"index_copy_ {fmt_range(ev['library_ms'])}; bound "
        f"{bound_ms:.5f} ms ({nbytes} bytes)")
    entry = {"name": "pillar_scatter", "route": "cuda",
             "source": "automatic_as_built_reconstruction_tpu_torch/csrc/"
                       "pillar_scatter.cu",
             "replaces": "automatic_as_built_reconstruction_tpu/ops/pallas/"
                         "pillar_scatter.py:61",
             "shape": f"B={B} V={V} C={C} hw={hw} {feats.dtype}",
             "occupied_rows": rows,
             "max_abs_err": 0.0, "bound_ms": bound_ms, "bound_by": "bytes",
             "bytes": nbytes, "device_kernels": list(kernels),
             # as the wrapper launches it: its plan's route and blocks (a
             # tile of canvas cells each, or a thread a chunk of a row)
             "plan": plan._asdict(),
             "grid": [plan.blocks, pillar_scatter.SCATTER_THREADS
                      if plan.route == "tiles"
                      else pillar_scatter.ROWS_THREADS]}
    return entry, fns, ev


def k1_backward(gather_call, card: str, what: str) -> tuple:
    """K1's backward (the gather kernel) on a recorded call, and on the
    same with the rows shuffled and with dropped ids in between: kernel ==
    plain exactly.  -> (entry fields, {key: fn} to time on the device,
    event times)."""
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
    # the gradient made contiguous before the dirty case, so that the
    # wrapper's one allocation is the output's
    dense = dcanvas.contiguous()
    for case, ids in (("as recorded", glin),
                      ("rows shuffled", glin[:, gperm].contiguous()),
                      ("negative ids", bad_ids.int().contiguous()),
                      ("on memory that held NaN", glin)):
        r = pillar_scatter.pillar_gather_plain(dcanvas, ids)
        if case.startswith("on memory"):
            g = on_dirty_memory(
                lambda: pillar_scatter.pillar_gather(dense, ids),
                (gB, gV, gC), dcanvas.dtype)
        else:
            g = pillar_scatter.pillar_gather(dcanvas, ids)
        torch.cuda.synchronize()
        if not torch.equal(g, r):
            raise AssertionError(f"pillar_gather kernel != plain ({what}, "
                                 f"{case})")
        del g, r
    del dense
    grows = int(gok.sum())
    log(f"K1 pillar_gather {what} [{card}]: {dcanvas.dtype}, B={gB} V={gV} "
        f"C={gC} hw={ghw}, {grows} valid rows: kernel == plain exactly as "
        f"recorded, with the rows shuffled, with negative ids and on "
        f"memory that held NaN")
    fns = {"backward_ms": lambda: pillar_scatter.pillar_gather(dcanvas,
                                                              glin),
           "backward_plain_ms": lambda: pillar_scatter.pillar_gather_plain(
               dcanvas, glin)}
    ev = {k: cuda_ms(fn) for k, fn in fns.items()}
    # the backward: the valid rows' cells read, every id, every row written
    e = dcanvas.element_size()
    gbytes = grows * gC * e + gB * gV * 4 + gB * gV * gC * e
    gbound_ms = gbytes / PEAK_BYTES_PER_S * 1e3
    log(f"K1 pillar_gather {what} [{card}]: events: kernel "
        f"{fmt_range(ev['backward_ms'])}, plain "
        f"{fmt_range(ev['backward_plain_ms'])}; bound {gbound_ms:.5f} ms "
        f"({gbytes} bytes); no single PyTorch call zeroes the dropped rows, "
        f"so no library time")
    fields = {"backward_kernel": "pillar_gather_kernel",
              "backward_shape": f"B={gB} V={gV} C={gC} hw={ghw} "
                                f"{dcanvas.dtype}",
              "backward_grid": [
                  pillar_scatter.gather_plan(gB, gV, gC * e // 16),
                  pillar_scatter.GATHER_THREADS],
              "backward_max_abs_err": 0.0, "backward_bound_ms": gbound_ms,
              "backward_bound_by": "bytes", "backward_library_ms": None}
    return fields, fns, ev


def phase_k1(call, gather_call, launches: int, gather_launches: int,
             card: str):
    """-> (kernels-line entry with event times, {key: fn} to time on the
    device).  The backward (the gather kernel) on the canvas gradient and
    ids training gave it."""
    entry, fns, ev = k1_forward(call, card, "served pillar request")
    fields, bfns, bev = k1_backward(gather_call, card, "training")
    fns.update(bfns)
    ev.update(bev)
    entry.update(fields, launches=launches,
                 backward_launches=gather_launches)
    return entry, fns, ev


def phase_k1_bf16(call, gather_call, kitti_call, per_path: dict,
                  card: str):
    """K1 on bfloat16 rows: forward on the bf16 pillar path's served
    request, backward on its training step's canvas gradient, both with
    their bounds in bytes; the same at the KITTI B = 8 shape (the served
    KITTI request's ids with its features in bfloat16, and a bfloat16
    canvas gradient drawn from a seed for the backward) under ``kitti_*``
    keys.  Its launches are K1's on the bf16 paths (``per_path``)."""
    entry, fns, ev = k1_forward(call, card, "bf16 served pillar request")
    fields, bfns, bev = k1_backward(gather_call, card, "bf16 training")
    fns.update(bfns)
    ev.update(bev)
    entry.update(fields)
    (kfeats, klin, khw), _ = kitti_call
    kfeats = kfeats.bfloat16()
    kentry, kfns, kev = k1_forward(((kfeats, klin, khw), {}), card,
                                   "KITTI request in bf16")
    dcanvas = torch.randn((*kfeats.shape[:1], khw, kfeats.shape[2]),
                          device=kfeats.device,
                          generator=torch.Generator(kfeats.device)
                          .manual_seed(2)).bfloat16()
    kfields, kbfns, kbev = k1_backward(((dcanvas, klin), {}), card,
                                       "KITTI shape in bf16")
    kfns.update(kbfns)
    kev.update(kbev)
    for key, fn in kfns.items():
        fns["kitti_" + key] = fn
        ev["kitti_" + key] = kev[key]
    entry["kitti"] = {k: v for k, v in {**kentry, **kfields}.items()
                      if k not in ("name", "route", "source", "replaces")}
    entry.update(name="pillar_scatter@bf16", counter="pillar_scatter",
                 paths=list(per_path),
                 launches=sum(n["pillar_scatter"] for n in per_path.values()),
                 backward_launches=sum(n["pillar_gather"]
                                       for n in per_path.values()))
    return entry, fns, ev


def phase_k1_kitti(call, per_path: dict, card: str):
    """K1 at the KITTI pillar shape (a served request of
    pointpillars/car/xyres_16.config: B = 8, V = 12 000, the largest
    bucket, 64 channels, a 496 x 432 canvas): its own kernels-line entry,
    whose launches are K1's forward launches on the KITTI paths
    (``per_path``)."""
    entry, fns, ev = k1_forward(call, card, "KITTI request")
    entry.update(name="pillar_scatter@kitti", counter="pillar_scatter",
                 paths=list(per_path),
                 launches=sum(n["pillar_scatter"] for n in per_path.values()))
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
        dev = take_turns({"k": lambda: rotated_iou.rotate_iou_matrix(
            x, y)})["k"][0]
        set_ms[what] = dev
        log(f"K2 rotated_iou [{card}]: {what} R={x.shape[0]} N={x.shape[1]} "
            f"K={y.shape[1]}, criteria {list(criteria)}: kernel vs plain max "
            f"abs err {err:.3g}, {equal} of {total} outputs equal bit for "
            f"bit; rejected by the circles "
            f"{shares[what]['circles']:.4f}, by the axes "
            f"{shares[what]['axes']:.4f}, clipped "
            f"{shares[what]['clipped']:.4f}; device, in turns "
            f"{dev:.5f} ms, bound "
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


def phase_sparse_gemm(name: str, calls: list, launches: int, card: str,
                      step_calls: tuple = ()):
    """``keymatch_gemm`` or ``gather_gemm`` (``*_bf16``: the tile's
    bfloat16 form) against its plain version on every join of a served
    request (``calls``, recorded by its warm-up) and, where given, of a
    training step (``step_calls``); each served join's device time in
    turns with the plain version (:func:`in_turns`: CUDA events behind a
    GPU sleep, L2 flushed), bound and tile occupancy.  -> (kernels-line
    entry with its device and event times, {key: fn} left to time on the
    device)."""
    keymatch = name.startswith("keymatch_gemm")
    bf16 = name.endswith("_bf16")
    # a bf16 form is its join's function on bfloat16 inputs; it counts
    # apart
    kernel = KERNELS[name[:-len("_bf16")] if bf16 else name]
    plain = (sparse_gather_gemm.keymatch_gemm_plain if keymatch
             else sparse_gather_gemm.gather_gemm_plain)

    def operands(call):
        """(feats, keys or idx, query keys or found, weights)."""
        return call[0][:4]

    def work(call) -> int:
        feats, _, table, w = operands(call)
        return feats.shape[0] * table.shape[-1] * w.numel()

    def tolerance(scale: float) -> float:
        return BF16_GEMM_RTOL * scale if bf16 else GEMM_ATOL

    def check(call):
        """-> (max abs difference, largest reference value)."""
        got = kernel(*call[0])
        ref = plain(*operands(call))
        torch.cuda.synchronize()
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        if not (err <= tolerance(scale) and torch.isfinite(got).all()):
            raise AssertionError(f"{name} {join_shape(call)}: kernel vs "
                                 f"plain max abs err {err} > "
                                 f"{tolerance(scale)}")
        return err, scale

    def need(call) -> dict:
        """What the join needs (hits of its taps, bytes, flops), its
        bounds at the 3xTF32 (bf16: the bf16 tensor-core) and the fp32
        SIMT rate, its tile occupancy."""
        feats, a, b, w = operands(call)
        B, R, Cout = feats.shape[0], b.shape[-1], w.shape[2]
        found = (sparse_gather_gemm.keymatch_found(a, b) if keymatch
                 else b)
        hits, pairs, occupancy = sparse_gather_gemm.tile_occupancy(found)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (feats, a, b, w)) + B * R * Cout * 4
        flops = 2 * hits * w.shape[1] * Cout
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = flops / (PEAK_BF16_PER_S if bf16
                          else PEAK_TF32_3X_PER_S) * 1e3
        simt_ms = flops / PEAK_FP32_PER_S * 1e3
        return {"hits": hits, "pairs": pairs, "occupancy": occupancy,
                "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
                "ops_ms": ops_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_fp32_simt_ms": max(simt_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}

    largest = max(range(len(calls)), key=lambda i: work(calls[i]))
    smallest = next(c for c in calls
                    if tuple(operands(c)[3].shape) == (27, 16, 16))
    tiles = {}
    if bf16:
        for c in calls:
            shape = tuple(operands(c)[3].shape)
            tiles[shape] = sparse_gather_gemm.bf16_tile(*shape)
        log(f"{name} [{card}]: the bf16 tile (wgmma, a ring on mbarriers) "
            "at the request's joins: " + "; ".join(
                f"K={k} Cin={i} Cout={o}: {t['rows']} rows a block, "
                f"{t['stages']} stages, {t['smem_bytes']} bytes of shared "
                f"memory, {t['blocks_per_sm']} blocks an SM"
                for (k, i, o), t in tiles.items()))
    worst = 0.0
    per_join, per_join_plain = [], []
    for i, call in enumerate(calls):          # every join of the request
        err, scale = check(call)
        worst = max(worst, err)
        n = need(call)
        turns = in_turns(lambda: kernel(*call[0]),
                         lambda: plain(*operands(call)),
                         SPARSE_TURNS if i == largest else JOIN_TURNS)
        per_join.append(turns["kernel"][0])
        per_join_plain.append(turns["other"][0])
        if i == largest:
            big_turns = turns
        log(f"{name} [{card}]: {join_shape(call)}: kernel vs plain max abs "
            f"err {err:.3g} (values up to {scale:.3g}); device, in turns "
            f"with the plain version: kernel {fmt_range(turns['kernel'])}, "
            f"plain {fmt_range(turns['other'])}; bound "
            f"{n['bound_ms']:.5f} ms ({n['bound_by']}; fp32 SIMT "
            f"{n['bound_fp32_simt_ms']:.5f}); {n['hits']} hits, "
            f"{n['pairs']} non-empty (tile, tap) pairs, tile occupancy "
            f"{n['occupancy']:.4f}")
    step_worst = 0.0
    for call in step_calls:                   # every join of a step
        err, scale = check(call)
        step_worst = max(step_worst, err / scale)
    if step_calls:
        log(f"{name} [{card}]: the {len(step_calls)} joins of a training "
            f"step: every one within {BF16_GEMM_RTOL if bf16 else GEMM_ATOL}"
            f"{' of its max |out|' if bf16 else ''} of its plain version "
            f"(worst {step_worst:.3g} of its max |out|)")
    occupancy = [need(c)["occupancy"] for c in calls]
    per_request = sum(per_join)
    log(f"{name} [{card}]: device time of the {len(calls)} joins of one "
        f"request, in turns with the plain version: {per_join}, summed "
        f"{per_request:.5f} ms")

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
        n = min(4096, feats.shape[1])
        shuffle = torch.randperm(n, device=feats.device,
                                 generator=torch.Generator(
                                     feats.device).manual_seed(0))
        sub = (feats[0, :n], in_keys[0, :n], q_keys[0, :, :n])
        forms[f"unsorted keys ({n} rows)"] = kernel(
            sub[0][shuffle], sub[1][shuffle], sub[2], w)
        torch.cuda.synchronize()
        scale = float(base.abs().max())
        for form, out in forms.items():
            ref = (kernel(*sub, w) if form.startswith("unsorted") else base)
            err = float((out - ref).abs().max())
            log(f"{name} [{card}]: form '{form}' vs the default call: max "
                f"abs diff {err:.3g}")
            # only the grouped form sums the taps in another order
            if err > (tolerance(scale) if form == "grouped taps" else 0.0):
                raise AssertionError(f"{name}: form {form} differs by {err}")
        ref = plain(sub[0][shuffle], sub[1][shuffle], sub[2], w)
        err = float((forms[f"unsorted keys ({n} rows)"] - ref).abs().max())
        if not err <= tolerance(float(ref.abs().max())):
            raise AssertionError(f"{name}: unsorted keys vs plain: {err}")

    big_call = calls[largest]
    ev = {"ms": cuda_ms(lambda: kernel(*big_call[0]), iters=20),
          "plain_ms": cuda_ms(lambda: plain(*operands(big_call)), iters=5,
                              warmup=1)}
    big = need(big_call)
    taps = operands(big_call)[2].numel()
    log(f"{name} [{card}]: largest join {join_shape(big_call)}: "
        f"{big['hits']} hits of {taps} (tap, row) pairs "
        f"({100 * big['hits'] / taps:.1f} %), tile occupancy "
        f"{big['occupancy']:.4f}; device, in turns ({SPARSE_TURNS} calls "
        f"each): kernel {fmt_range(big_turns['kernel'])}, plain "
        f"{fmt_range(big_turns['other'])}; events around the call, host "
        f"included: kernel {fmt_range(ev['ms'])}, plain "
        f"{fmt_range(ev['plain_ms'])}; bound {big['bound_ms']:.5f} ms (ops "
        f"at the {'bf16' if bf16 else '3xTF32'} rate "
        f"{big['ops_ms']:.5f}: {big['flops']} needed flops; bytes "
        f"{big['bytes_ms']:.5f}: {big['bytes']}); at the fp32 SIMT rate "
        f"{big['bound_fp32_simt_ms']:.5f}")
    s_ev = cuda_ms(lambda: kernel(*smallest[0]), iters=20)
    log(f"{name} [{card}]: smallest join {join_shape(smallest)}: events: "
        f"kernel {fmt_range(s_ev)}")
    # the bf16 gather form replaces the shared-window kernel K3s that
    # car.fhd.mixed's gather joins reach
    line = {"keymatch_gemm": 1098, "gather_gemm": 331,
            "gather_gemm_bf16": 146, "keymatch_gemm_bf16": 1098}[name]
    entry = {"name": name, "route": "cuda",
             "source": "automatic_as_built_reconstruction_tpu_torch/csrc/"
                       "sparse_gather_gemm.cu",
             "replaces": "automatic_as_built_reconstruction_tpu/ops/pallas/"
                         f"sparse_gather_gemm.py:{line}",
             "launches": launches, "max_abs_err": worst,
             "shape": join_shape(big_call), "hits": big["hits"],
             "ms": big_turns["kernel"][0],
             "plain_ms": big_turns["other"][0],
             "in_turns_ms": {"kernel": big_turns["kernel"],
                             "plain": big_turns["other"]},
             "event_ms": ev["ms"], "plain_event_ms": ev["plain_ms"],
             "ms_from": "in turns with the plain version: CUDA events "
                        "behind a GPU sleep, L2 flushed",
             "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
             "bound_fp32_simt_ms": big["bound_fp32_simt_ms"],
             "per_join_ms": per_join, "per_join_plain_ms": per_join_plain,
             "per_request_ms": per_request,
             "per_join_shape": [join_shape(c) for c in calls],
             "tile_occupancy": occupancy, "library_ms": None}
    if bf16:
        entry["tile"] = tiles[tuple(operands(big_call)[3].shape)]
    if step_calls:
        entry["step_joins_worst_rel_err"] = step_worst
    return entry, {}, {}


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


def run_evaluate(card: str) -> tuple:
    """``evaluate`` on the 32 val scenes with the trained checkpoint.
    -> (launches of each kernel during it, {"result", "detections"}: the
    AP and the detections it was computed on)."""
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    calls = []
    with flags_in_modules() as seen, recording(
            building.BuildingDataset, "evaluation", calls):
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
    # the detections the AP was computed on: the multi_device phase's
    # reference
    return launches, {"result": result, "detections": calls[0][0][1]}


# --------------------------------------------------------------------------
# the as-built tail: export_asbuilt and the viewer
# --------------------------------------------------------------------------

ASBUILT_SCENE = 0        # the eval split's scene that both paths detect on
ASBUILT_STEP = 8000      # CHECKPOINT's training step


def asbuilt_model_dir(model_dir: Path) -> None:
    """A model directory of ``train``'s layout whose latest checkpoint
    holds CHECKPOINT's weights at ASBUILT_STEP (the port's weight import
    and ``train/checkpoint.py``)."""
    state = train_mod.init_state(train_mod.Bundle(CONFIG), device="cpu")
    weight_import.load_variables(
        state.model, inference.load_checkpoint_variables(CHECKPOINT))
    state.step = ASBUILT_STEP
    ckpt_mod.CheckpointManager(model_dir).save(ASBUILT_STEP, state,
                                               force=True)


def http_get(url: str) -> tuple:
    """-> (status, body) of a GET, an HTTP error's too."""
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def rounded(dets: dict) -> dict:
    """``run.raw``'s detections as the viewer's ``run`` gives them."""
    return {"boxes": np.round(dets["box3d_lidar"], 3),
            "scores": np.round(dets["scores"], 3),
            "labels": dets["label_preds"]}


def one_scan(dets: dict) -> dict:
    """One scan's detections -> the padded dict of detections_mismatch."""
    return {"box3d_lidar": dets["box3d_lidar"][None],
            "scores": dets["scores"][None],
            "label_preds": dets["label_preds"][None],
            "valid": np.ones((1, len(dets["scores"])), bool)}


def asbuilt(card: str) -> dict:
    """The as-built tail on the trained checkpoint at full width: ``cli
    export_asbuilt`` of eval scene ASBUILT_SCENE in a child process (K1
    and K2 once each, TF32 off), whose JSON must be ``build_asbuilt_model``
    of the detections that ``viewer.server._make_predictor(...,
    device="cuda")`` gives in this process, and those equal the port's CPU
    detections as sets (boxes within BOX_ATOL, scores within SCORE_ATOL,
    unrounded); then the viewer's ``Handler`` on 127.0.0.1 in a thread,
    with that predictor on the card: every endpoint, ``/api/detect`` twice
    (the second from its cache) equal to the predictor's detections, a bad
    index answered 500, the counters set to 0 just before the requests and
    read just after (K1 and K2 once each).  -> {"launches"}."""
    what = "asbuilt"
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        model_dir = tmp / "asbuilt_model"
        asbuilt_model_dir(model_dir)
        walls["model directory"] = time.perf_counter() - t0
        out_json, out_svg = tmp / "asbuilt.json", tmp / "asbuilt.svg"
        t0 = time.perf_counter()
        out, export_launches = cli(
            ["export_asbuilt", "--config_path", CONFIG, "--model_dir",
             model_dir, "--scene", ASBUILT_SCENE, "--output", out_json,
             "--svg", out_svg], what, card, tmp)
        walls["cli export_asbuilt"] = time.perf_counter() - t0
        expect_launches(f"{what}: export_asbuilt", export_launches,
                        {"pillar_scatter": 1, "rotated_iou": 1})
        log(f"{what} [{card}]: {out.strip().splitlines()[-1]}")

        t0 = time.perf_counter()
        dataset, run = viewer_server._make_predictor(CONFIG, model_dir,
                                                     device="cuda")
        walls["predictor on the card"] = time.perf_counter() - t0
        saved = dict(viewer_server._STATE)
        viewer_server._STATE.update(dataset=dataset,
                                    classes=dataset._class_names,
                                    predict=run)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), viewer_server.Handler)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            zero_counts()
            t0 = time.perf_counter()
            got = {path: http_get(url + path) for path in (
                "/", "/api/info", f"/api/scene?idx={ASBUILT_SCENE}",
                f"/api/detect?idx={ASBUILT_SCENE}")}
            t1 = time.perf_counter()
            again = http_get(url + f"/api/detect?idx={ASBUILT_SCENE}")
            walls["viewer: /api/detect again (cached)"] = (
                time.perf_counter() - t1)
            bad = http_get(url + "/api/scene?idx=nope")
            walls["viewer: five GETs and a bad one"] = (
                time.perf_counter() - t0)
            viewer_launches = launch_counts()
        finally:
            httpd.shutdown()
            thread.join()
            viewer_server._STATE.clear()
            viewer_server._STATE.update(saved)
        expect_launches(f"{what}: viewer", viewer_launches,
                        {"pillar_scatter": 1, "rotated_iou": 1})
        for path, (status, body) in got.items():
            if status != 200:
                raise AssertionError(f"{what}: viewer GET {path} answered "
                                     f"{status}: {body[:300]!r}")
        index = (Path(viewer_server.__file__).parent / "index.html")
        if got["/"][1] != index.read_bytes():
            raise AssertionError(f"{what}: GET / is not viewer/index.html")
        info = json.loads(got["/api/info"][1])
        if info != {"num_scenes": len(dataset),
                    "classes": list(building.CLASSES), "has_model": True}:
            raise AssertionError(f"{what}: /api/info {info}")
        scene = json.loads(got[f"/api/scene?idx={ASBUILT_SCENE}"][1])
        if not 1000 < len(scene["points"]) <= 60000:
            raise AssertionError(f"{what}: /api/scene gave "
                                 f"{len(scene['points'])} points")
        if bad[0] != 500 or b"error" not in bad[1]:
            raise AssertionError(f"{what}: a bad index answered {bad}")
        detect = got[f"/api/detect?idx={ASBUILT_SCENE}"][1]
        if again != (200, detect):
            raise AssertionError(f"{what}: /api/detect changed on its "
                                 f"second call")

        # the predictor's detections again, outside the counted requests
        t0 = time.perf_counter()
        card_dets = run.raw(ASBUILT_SCENE)
        walls["predictor: scene on the card"] = time.perf_counter() - t0
        view = rounded(card_dets)
        if json.loads(detect) != json.loads(json.dumps(
                view, default=viewer_server._jsonable)):
            raise AssertionError(f"{what}: /api/detect differs from the "
                                 f"predictor's detections")
        model = asbuilt_export.build_asbuilt_model(
            {"box3d_lidar": view["boxes"], "scores": view["scores"],
             "label_preds": view["labels"]}, dataset._class_names)
        if out_json.read_text() != json.dumps(model, indent=1):
            raise AssertionError(f"{what}: the JSON export_asbuilt wrote is "
                                 f"not build_asbuilt_model of the card's "
                                 f"detections")
        if out_svg.read_text() != asbuilt_export.render_svg(model):
            raise AssertionError(f"{what}: the SVG is not render_svg of "
                                 f"the model")
        t0 = time.perf_counter()
        _, cpu_run = viewer_server._make_predictor(CONFIG, model_dir,
                                                   device="cpu")
        cpu_dets = cpu_run.raw(ASBUILT_SCENE)
        walls["predictor: scene on the CPU"] = time.perf_counter() - t0
        diff = detections_mismatch(one_scan(card_dets), one_scan(cpu_dets),
                                   len(building.CLASSES), BOX_ATOL,
                                   SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"{what}: card vs CPU detections: {diff}")
    log(f"{what} [{card}]: stats {json.dumps(model['stats'])}; "
        f"{len(card_dets['scores'])} detections equal the port's CPU "
        f"detections as sets (boxes atol {BOX_ATOL}, scores atol "
        f"{SCORE_ATOL}); the JSON and SVG equal build_asbuilt_model and "
        f"render_svg of the card's detections; every endpoint answered, a "
        f"bad index 500; viewer launches {viewer_launches}")
    log(f"{what} [{card}]: wall s " + json.dumps(
        {k: round(v, 3) for k, v in walls.items()}))
    return {"launches": {"asbuilt export": export_launches,
                         "asbuilt viewer": viewer_launches}}


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
        preds = train_mod.forward(model, example, bundle.model_cfg)
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
        windows = training_windows(model_dir, "pillar training", card)
        first, last = windows[0]["loss"], windows[-1]["loss"]
        host_prep = float(np.median([w["host_prep_ms"] for w in windows]))
        report.update(steps=steps, wall_s=wall, steps_per_sec=steps / wall,
                      window_steps_per_sec=[w["steps_per_sec"]
                                            for w in windows],
                      loss_first_window=first, loss_last_window=last,
                      host_prep_ms=host_prep,
                      step_launch_ms=float(np.median(
                          [w["step_ms"] for w in windows])))
        log(f"pillar training [{card}]: host prep of a batch (median of the "
            f"windows) {host_prep:.2f} ms")

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
        with substituted(input_reader_builder, "_build_dataset",
                         lambda ds, names, training: building.BuildingDataset(
                             class_names=names,
                             num_synthetic=TRAIN_EVAL_SCENES,
                             synthetic_seed=7)):
            result = evaluate(config, model_dir, device="cuda")
        log(f"pillar training [{card}]: evaluate on the port's checkpoint "
            f"(step {steps}, the first {TRAIN_EVAL_SCENES} val scenes) in "
            f"{time.perf_counter() - t0:.1f} s, launches "
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

def kitti_config(src: Path, tmp: Path, root: Path, caps=None) -> Path:
    """The config ``src`` with its data paths under ``root``, as
    tools/kitti_rehearsal.py:69-73 rewrites them, and, where given, the
    sparse middle's ``out_site_caps``; nothing else changes.  Written
    into ``tmp``."""
    text = src.read_text().replace('"data/kitti', f'"{root}')
    if caps:
        old = "      downsample_factor: 8\n"
        if text.count(old) != 1:
            raise AssertionError(f"{src.name}: no single downsample_factor "
                                 f"line")
        text = text.replace(old, old + "      out_site_caps: ["
                            + ", ".join(map(str, caps)) + "]\n")
    path = tmp / (src.stem + (".caps" if caps else "") + ".config")
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
    where the input needs no gradient).  Beside it, the floor of the
    kernels' per-tap design, which reads a gathered row once per hit:
    dW hits * (Cin + Cout) * 4 bytes, dfeatures the dout rows of the hits
    and the dfeatures written."""
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
    out["dw_floor_ms"] = hits * (Cin + Cout) * 4 / PEAK_BYTES_PER_S * 1e3
    out["dfeatures_floor_ms"] = ((hits * Cout + feats.numel()) * 4
                                 / PEAK_BYTES_PER_S * 1e3
                                 if dfeatures else 0.0)
    out["bound_ms"] = out["dw_bound_ms"] + out["dfeatures_bound_ms"]
    larger = ("dw" if out["dw_bound_ms"] >= out["dfeatures_bound_ms"]
              else "dfeatures")
    out["bound_by"] = out[f"{larger}_bound_by"]
    return out


def check_join(wcall, fcall) -> tuple:
    """One join's backward kernels against the plain backward: dW and,
    where the join's input needs a gradient, dfeatures, rtol and atol
    JOIN_GRAD_TOL of max |g|.  -> (the join's shape, {half: max error as
    a share of max |g|})."""
    sgg = sparse_gather_gemm
    (feats, idx, found, dout), _ = wcall
    checks = [("dW", sgg.join_grad_weights(feats, idx, found, dout),
               sgg.grad_weights_plain(feats, idx, found, dout))]
    if fcall is not None:
        (fdout, fidx, ffound, w, N), _ = fcall
        checks.append(("dfeatures",
                       sgg.join_grad_features(fdout, fidx, ffound, w, N),
                       sgg.grad_features_plain(fdout, fidx, ffound, w, N)))
    torch.cuda.synchronize()
    what = (f"B={feats.shape[0]} N={feats.shape[1]} R={idx.shape[-1]} "
            f"K={idx.shape[-2]} Cin={feats.shape[-1]} Cout={dout.shape[-1]}")
    errs = {}
    for name, g, r in checks:
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        errs[name] = err / scale if scale else err
        close = torch.isclose(g, r, rtol=JOIN_GRAD_TOL,
                              atol=JOIN_GRAD_TOL * scale)
        if not (scale > 0 and bool(close.all())):
            raise AssertionError(f"join backward {what}: {name} kernel vs "
                                 f"plain: max abs err {err} (max |g| "
                                 f"{scale})")
    return what, errs


@torch.no_grad()
def phase_join_backward(wcalls: list, fcalls: list, mcalls: list,
                        card: str) -> tuple:
    """The backward kernels against the plain backward at every join of
    one training step (B = 6): dW (``join_grad_weights``: the hits of each
    tap, the per-tap reduction GEMM) and dfeatures (``join_grad_features``:
    the rulebook's inverse, the kernel over the rows each tap hits), rtol
    and atol JOIN_GRAD_TOL of max |g|, and the rulebook that the key-match
    backward looks up first (``keymatch_rulebook``, recorded in
    ``mcalls`` join by join as ``wcalls``) equal to its plain version
    (``_merge_lookup``); each join's device time and bound.  At the
    largest join each half, its steps and the rulebook lookup against its
    plain version in turns, with the bounds and the per-tap floor.  -> (the
    kernels line's backward fields, {key: fn} and event times for the
    largest join)."""
    sgg = sparse_gather_gemm
    by_rulebook = {id(c[0][1]): c for c in fcalls}
    worst, per_join, bounds = 0.0, [], []
    for wcall, mcall in zip(wcalls, mcalls):
        (feats, idx, found, dout), _ = wcall
        (in_keys, q_keys), _ = mcall
        ref_idx, ref_found = sgg.keymatch_rulebook_plain(in_keys, q_keys)
        if not (torch.equal(found, ref_found) and torch.equal(
                idx[found], ref_idx[found])):
            raise AssertionError("keymatch_rulebook kernel != plain "
                                 "version, or the recorded lookups do not "
                                 "pair with the recorded joins")
        fcall = by_rulebook.get(id(idx))
        what, errs = check_join(wcall, fcall)
        worst = max(worst, *errs.values())
        if fcall is not None:
            (fdout, fidx, ffound, w, N), _ = fcall

        def kernels():
            sgg.join_grad_weights(feats, idx, found, dout)
            if fcall is not None:
                sgg.join_grad_features(fdout, fidx, ffound, w, N)

        ms = take_turns({"kernels": kernels}, JOIN_TURNS)["kernels"][0]
        # the voxel means need no gradient: no dfeatures at the first join
        b = join_bound(feats, idx, found, dout, fcall is not None)
        per_join.append(ms)
        bounds.append(b["bound_ms"])
        log(f"join backward [{card}]: {what}: dW"
            f"{' + dfeatures' if fcall is not None else ''} kernel vs plain "
            f"max err {json.dumps(errs)} of max |g|; device, in turns "
            f"{ms:.5f} ms; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} (dW "
            f"{b['dw_bound_ms']:.5f} by {b['dw_bound_by']}, at the SIMT "
            f"rate {b['dw_bound_fp32_simt_ms']:.5f}; dfeatures "
            f"{b['dfeatures_bound_ms']:.5f}; {b['hits']} hits, "
            f"{b['flops']} needed flops, {b['dw_bytes']} bytes a half); "
            f"per-tap floor dW {b['dw_floor_ms']:.5f}, dfeatures "
            f"{b['dfeatures_floor_ms']:.5f}")
    at = max(range(len(wcalls)), key=lambda i: int(wcalls[i][0][2].sum())
             * wcalls[i][0][0].shape[-1] * wcalls[i][0][3].shape[-1])
    feats, idx, found, dout = wcalls[at][0]
    (fdout, fidx, ffound, w, N), _ = by_rulebook[id(idx)]
    (in_keys, q_keys), _ = mcalls[at]
    b = join_bound(feats, idx, found, dout)
    # the rulebook lookup reads the keys and query keys once and writes
    # idx and found once
    book_bytes = (in_keys.numel() + q_keys.numel()) * 4 + idx.numel() * 5
    book_bound = book_bytes / PEAK_BYTES_PER_S * 1e3
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
    # each half and its steps in turns: dW = the hits + the reduction,
    # dfeatures = the inverse + the kernel over the hit rows; the rulebook
    # lookup of the key-match backward and its plain version beside them
    halves = take_turns({
        "dw": lambda: sgg.join_grad_weights(feats, idx, found, dout),
        "dfeatures": lambda: sgg.join_grad_features(fdout, fidx, ffound, w,
                                                    N),
        "hits": lambda: sgg.rulebook_hits(idx, found, N),
        "inverse": lambda: sgg.rulebook_inverse(fidx, ffound, N),
        "rulebook": lambda: sgg.keymatch_rulebook(in_keys, q_keys),
        "rulebook_plain": lambda: sgg.keymatch_rulebook_plain(in_keys,
                                                              q_keys)})
    fns = {"backward_ms": lambda: (
               sgg.join_grad_weights(feats, idx, found, dout),
               sgg.join_grad_features(fdout, fidx, ffound, w, N)),
           "backward_plain_ms": lambda: (
               sgg.grad_weights_plain(feats, idx, found, dout),
               sgg.grad_features_plain(fdout, fidx, ffound, w, N))}
    ev = {k: cuda_ms(fn, iters=10, warmup=2) for k, fn in fns.items()}
    shape = (f"B={feats.shape[0]} N={feats.shape[1]} R={idx.shape[-1]} "
             f"K={idx.shape[-2]} Cin={feats.shape[-1]} Cout={dout.shape[-1]}")
    log(f"join backward [{card}]: largest join {shape}, {b['hits']} hits: "
        f"in turns dW {fmt_range(halves['dw'])} (bound "
        f"{b['dw_bound_ms']:.5f} by {b['dw_bound_by']}, per-tap floor "
        f"{b['dw_floor_ms']:.5f}), of which the hits "
        f"{fmt_range(halves['hits'])}; dfeatures "
        f"{fmt_range(halves['dfeatures'])} (bound "
        f"{b['dfeatures_bound_ms']:.5f} by {b['dfeatures_bound_by']}, "
        f"per-tap floor {b['dfeatures_floor_ms']:.5f}), of which the inverse "
        f"{fmt_range(halves['inverse'])}; the key-match backward's rulebook "
        f"lookup {fmt_range(halves['rulebook'])} (bound {book_bound:.5f} by "
        f"bytes; plain, _merge_lookup, {fmt_range(halves['rulebook_plain'])})"
        f"; events "
        + "; ".join(f"{k[:-3]} {fmt_range(v)}" for k, v in ev.items())
        + f"; bound {b['bound_ms']:.5f} ms; {len(wcalls)} joins, "
        f"{len(fcalls)} with dfeatures; per join device ms {per_join}")
    fields = {"backward_kernel": "tap_hits_count_kernel + "
                                 "tap_hits_write_kernel + "
                                 "tap_grad_mma_kernel + tap_grad_sum_kernel "
                                 "(dW), rulebook_inverse_kernel + "
                                 "grad_features_kernel (dfeatures); "
                                 "key-match: keymatch_table_kernel + "
                                 "keymatch_rulebook_kernel "
                                 "(csrc/sparse_gather_gemm.cu) first",
              "backward_source": "automatic_as_built_reconstruction_tpu_"
                                 "torch/csrc/sparse_join_grad.cu",
              "backward_shape": shape,
              "backward_hits": b["hits"],
              "backward_max_err_of_max_g": worst,
              "backward_vs_float64": vs64,
              "backward_dw_ms": halves["dw"][0],
              "backward_dfeatures_ms": halves["dfeatures"][0],
              "backward_hits_ms": halves["hits"][0],
              "backward_inverse_ms": halves["inverse"][0],
              "backward_rulebook_ms": halves["rulebook"][0],
              "backward_rulebook_plain_ms": halves["rulebook_plain"][0],
              "backward_rulebook_bound_ms": book_bound,
              "backward_rulebook_bound_by": "bytes",
              "backward_halves_in_turns_ms": halves,
              "backward_bound_ms": b["bound_ms"],
              "backward_bound_by": b["bound_by"],
              "backward_dw_bound_ms": b["dw_bound_ms"],
              "backward_dw_bound_by": b["dw_bound_by"],
              "backward_dw_bound_fp32_simt_ms": b["dw_bound_fp32_simt_ms"],
              "backward_dw_floor_ms": b["dw_floor_ms"],
              "backward_dfeatures_bound_ms": b["dfeatures_bound_ms"],
              "backward_dfeatures_bound_by": b["dfeatures_bound_by"],
              "backward_dfeatures_floor_ms": b["dfeatures_floor_ms"],
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


def score_thresholds(heads64: dict, anchors: torch.Tensor, cfg) -> list:
    """The config's score threshold and, as a checkpoint of a few dozen
    steps scores few boxes above it, one that keeps DETECTION_RANKS[0] to
    DETECTION_RANKS[1] boxes: the middle of the widest gap among the
    scores of the boxes ``predict`` keeps from the float64 heads
    ``heads64`` at a threshold of 0, ranked in that window (greedy NMS
    keeps the same boxes above any threshold, so that many stay, and no
    kept box lies nearer the threshold than half the gap)."""
    dets = decode(heads64, anchors, cfg, 0.0, "cuda")
    scores = np.sort(dets["scores"][dets["valid"]].astype(np.float64))[::-1]
    lo, hi = DETECTION_RANKS
    window = scores[lo - 1:hi] if len(scores) > lo else scores
    if len(window) < 2:
        return [cfg.nms_score_threshold,
                float(window[0]) / 2 if len(window) else 0.5]
    i = int((window[:-1] - window[1:]).argmax())
    return [cfg.nms_score_threshold, float(window[i] + window[i + 1]) / 2]


def decode(heads: dict, anchors: torch.Tensor, cfg, threshold: float,
           device) -> dict:
    """``predict`` on ``heads`` (any float type: it decodes in float32)
    at the score ``threshold``, on ``device``.  -> host numpy dict."""
    out = predict({k: v.to(device) for k, v in heads.items()},
                  anchors.to(device),
                  dataclasses.replace(cfg, nms_score_threshold=threshold))
    return {k: v.cpu().numpy() for k, v in out.items()}


def detection_distance(got: dict, ref: dict, num_class: int) -> dict:
    """How far two padded detection dicts lie apart, matched as sets per
    (scan, class), each detection of ``got`` to the unused one of ``ref``
    that needs the least allowance: {"counts_equal", "box_abs": the largest
    |difference| of a box value, "box_rel": the largest (|difference| -
    BOX_ATOL) / |the reference's value| (the share of the value a match
    needs beyond BOX_ATOL), "score_abs"}."""
    worst = {"counts_equal": True, "box_abs": 0.0, "box_rel": 0.0,
             "score_abs": 0.0}
    for b in range(ref["valid"].shape[0]):
        for c in range(num_class):
            sel_g = got["valid"][b] & (got["label_preds"][b] == c)
            sel_r = ref["valid"][b] & (ref["label_preds"][b] == c)
            if sel_g.sum() != sel_r.sum():
                worst["counts_equal"] = False
                continue
            boxes_r = ref["box3d_lidar"][b][sel_r].astype(np.float64)
            scores_r = ref["scores"][b][sel_r].astype(np.float64)
            used = np.zeros(len(boxes_r), bool)
            for box, score in zip(got["box3d_lidar"][b][sel_g],
                                  got["scores"][b][sel_g]):
                diff = np.abs(boxes_r - box)
                need = (np.maximum(diff - BOX_ATOL, 0.0)
                        / np.maximum(np.abs(boxes_r), 1e-30)).max(-1)
                need[used] = np.inf
                j = int(np.argmin(need))
                used[j] = True
                worst["box_abs"] = max(worst["box_abs"], float(diff[j].max()))
                worst["box_rel"] = max(worst["box_rel"], float(need[j]))
                worst["score_abs"] = max(worst["score_abs"],
                                         abs(float(score) - scores_r[j]))
    return worst


def train_second(card: str) -> dict:
    """The SECOND training path: a synthetic KITTI clone (the port's
    generator and offline prep) in a temporary directory; ``train()`` on
    car.fhd.config at full width (B = 6, the sampler, the augmentation,
    the loader's three workers) with every kernel counter set to 0 just
    before and read just after; the loss check; host prep against the
    device step; one training step's backward calls recorded for the
    kernel phase; one step at B = 2, float32 on the kernels against
    float64 on the plain versions; ``evaluate`` on the 12 validation
    frames (the KITTI table; two frames' heads against float64, their
    detections against the port's CPU run); perfect detections; a
    restart that resumes.  -> {"launches", "report", "wcalls", "fcalls",
    "mcalls": the rulebook lookups of the key-match backward, "step": one
    more step, for the profile}."""
    report = {}
    sgg = sparse_gather_gemm
    with torch.enable_grad(), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "kitti"
        write_clone(root, False, "second training", card)
        config = kitti_config(SECOND_TRAIN_CONFIG, tmp, root)
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
            config = kitti_config(SECOND_TRAIN_CONFIG, tmp, root,
                                  MEASURED_SITE_CAPS)
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
            "rulebook_hits": joins * steps, "keymatch_rulebook": joins * steps,
            "join_grad_features": (joins - 1) * steps,
            "rulebook_inverse": (joins - 1) * steps}
        if launches != want or state.step != steps:
            raise AssertionError(f"second training launched {launches} in "
                                 f"{state.step} steps, expected {want}")
        if seen != {(False, False)}:
            raise AssertionError(f"second training: the network ran with "
                                 f"TF32 flags {sorted(seen)}")
        windows = training_windows(model_dir, "second training", card)
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
        log(f"second training [{card}]: the loader's wait a batch (median "
            f"of the windows, "
            f"{reader['num_workers']} workers) {wait:.2f} ms; prep of one "
            f"batch of {len(examples)} on one thread "
            f"{prep_batch:.1f} ms (examples {[round(t, 1) for t in t_prep]}); "
            f"device step (B={len(examples)}, synchronised, events) "
            f"{fmt_range(ev)}: host prep on one thread is "
            f"{100 * report['host_prep_share']:.1f} % of prep + device step")

        # one step's backward calls, for the kernel phase: the joins'
        # backward kernels and the rulebook that each key-match backward
        # looks up first, join by join in one order
        wcalls, fcalls, mcalls = [], [], []
        with recording(sgg, "join_grad_weights", wcalls), \
                recording(sgg, "join_grad_features", fcalls), \
                recording(sgg, "keymatch_rulebook", mcalls):
            step_fn(state, example)
        torch.cuda.synchronize()
        if (len(wcalls), len(fcalls), len(mcalls)) != (joins, joins - 1,
                                                       joins):
            raise AssertionError(f"one step recorded {len(wcalls)} dW, "
                                 f"{len(fcalls)} dfeatures and "
                                 f"{len(mcalls)} key-lookup calls, expected "
                                 f"{joins}, {joins - 1} and {joins}")
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
        # on the card: the heads, held to a float64 forward of the same
        # checkpoint on the card (the plain key-match join), as a share of
        # each head's max |x| (F32_HEAD_SHARE), with the card's heads under
        # TF32 as the control that must fall outside it; HEAD_TOL's
        # distances are printed beside
        eb = train_mod.Bundle(config)
        vds, _ = eb.input_reader(training=False)
        val = batching.merge_batch([vds.example(i, i) for i in range(2)])
        heads = {}
        for dev in ("cpu", "cuda"):
            eb.model.to(dev)
            ckpt_mod.CheckpointManager(model_dir).restore_model(eb.model)
            ex = train_mod.to_device(val, dev)
            with torch.no_grad(), fp32_math():
                preds = eb.model.eval()(ex["voxels"], ex["num_points"],
                                        ex["coordinates"])
            heads[dev] = {k: v.float().cpu() for k, v in preds.items()}
        f64 = copy.deepcopy(eb.model).double()
        ex = {k: v.double() if v.is_floating_point() else v
              for k, v in train_mod.to_device(val, "cuda").items()}
        with torch.no_grad(), fp32_math(), substituted(
                middle, "keymatch_gemm", plain_keymatch):
            preds = f64.eval()(ex["voxels"], ex["num_points"],
                               ex["coordinates"])
        truth = {k: v.cpu() for k, v in preds.items()}
        del f64, preds
        ex = train_mod.to_device(val, "cuda")
        with torch.no_grad(), tf32_on():
            preds = eb.model.eval()(ex["voxels"], ex["num_points"],
                                    ex["coordinates"])
        control = {k: v.double().cpu() for k, v in preds.items()}
        anchors = ex["anchors"]
        del preds, ex
        card64 = {k: v.double() for k, v in heads["cuda"].items()}
        cpu64 = {k: v.double() for k, v in heads["cpu"].items()}
        shares = {"card": head_share(card64, truth),
                  "cpu": head_share(cpu64, truth),
                  "tf32_control": head_share(control, truth)}
        used = {"card_vs_f64": head_tolerance_used(card64, truth),
                "cpu_vs_f64": head_tolerance_used(cpu64, truth),
                "card_vs_cpu": head_tolerance_used(heads["cuda"],
                                                   heads["cpu"])}
        scale = {k: float(v.abs().max()) for k, v in truth.items()}
        detail = (f"shares of max |x| against float64 {shares} (limit "
                  f"{F32_HEAD_SHARE}; max |x| {scale}); HEAD_TOL "
                  f"{HEAD_TOL} used at the worst element, with the "
                  f"reference's value there: {used}")
        for k in truth:
            if not (torch.isfinite(heads["cuda"][k]).all()
                    and shares["card"][k] <= F32_HEAD_SHARE):
                raise AssertionError(f"second evaluate: head {k} card vs "
                                     f"float64: {detail}")
            if not shares["tf32_control"][k] > F32_HEAD_SHARE:
                raise AssertionError(f"second evaluate: the TF32 control "
                                     f"of head {k} is within the limit: "
                                     f"{detail}")
        # the detections ``predict`` decodes from each side's heads, at the
        # config's score threshold and at one that keeps 8 to 32 of the
        # float64 forward's boxes (score_thresholds): the card's held to
        # the float64 forward's as sets (BOX_ATOL + F32_BOX_RTOL of each
        # value, SCORE_ATOL), the TF32 control's outside that check or
        # DETECTION_CONTROL_RATIO times farther from them than the card's;
        # the CPU's distance printed beside
        sides = {"card": (heads["cuda"], "cuda"), "f64": (truth, "cuda"),
                 "cpu": (heads["cpu"], "cpu"),
                 "tf32_control": (control, "cuda")}
        thresholds = score_thresholds(truth, anchors, cfg)
        distance, counts, control_out = {}, {}, []
        for thr in thresholds:
            dets = {side: decode(h, anchors, cfg, thr, dev)
                    for side, (h, dev) in sides.items()}
            distance[thr] = {f"{a}_vs_{b}": detection_distance(
                dets[a], dets[b], cfg.num_class)
                for a, b in (("card", "f64"), ("cpu", "f64"),
                             ("card", "cpu"), ("tf32_control", "f64"))}
            counts[thr] = int(dets["f64"]["valid"].sum())
            diff = detections_mismatch(dets["card"], dets["f64"],
                                       cfg.num_class, BOX_ATOL, SCORE_ATOL,
                                       box_rtol=F32_BOX_RTOL)
            if diff is not None:
                raise AssertionError(f"second evaluate: card vs float64 "
                                     f"detections (score >= {thr}) on two "
                                     f"validation frames: {diff}; distances "
                                     f"{distance[thr]}")
            control_out.append(detections_mismatch(
                dets["tf32_control"], dets["f64"], cfg.num_class, BOX_ATOL,
                SCORE_ATOL, box_rtol=F32_BOX_RTOL))
        card_abs = max(d["card_vs_f64"]["box_abs"]
                       for d in distance.values())
        control_abs = max(d["tf32_control_vs_f64"]["box_abs"]
                          for d in distance.values())
        outside = any(c is not None for c in control_out)
        if not (outside or control_abs > max(
                DETECTION_CONTROL_RATIO * card_abs, 0.0)):
            raise AssertionError(
                f"second evaluate: the TF32 control's detections pass the "
                f"check and lie {control_abs} from float64 against the "
                f"card's {card_abs} (less than {DETECTION_CONTROL_RATIO}x): "
                f"{distance}")
        log(f"second training [{card}]: validation frames 0 and 1: heads "
            f"on the card within F32_HEAD_SHARE of float64, the TF32 "
            f"control outside: {detail}; detections equal the float64 "
            f"forward's as sets within BOX_ATOL {BOX_ATOL} + F32_BOX_RTOL "
            f"{F32_BOX_RTOL} of each value ({counts} boxes by score "
            f"threshold); the TF32 control's "
            f"{'outside the check' if outside else 'inside the check'} "
            f"({control_out}), its largest box difference {control_abs} "
            f"against the card's {card_abs} "
            f"({control_abs / card_abs if card_abs else float('inf'):.1f}x); "
            f"distances (box_rel: the share of a value a match needs "
            f"beyond BOX_ATOL) {json.dumps(distance)}")
        report["heads_vs_f64"] = {"share_of_max": shares,
                                  "head_tol_used": used}
        report["detections_vs_f64"] = distance
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
            "fcalls": fcalls, "mcalls": mcalls,
            "step": lambda: step_fn(state, example)}


# --------------------------------------------------------------------------
# KITTI PointPillars and multi-class KITTI
# --------------------------------------------------------------------------

def write_clone(root: Path, multiclass: bool, what: str, card: str,
                prep: bool = True) -> None:
    """A synthetic KITTI clone of SYNTH_TRAIN + SYNTH_VAL frames from seed
    0 (the port's generator), with the offline prep where ``prep``."""
    t0 = time.perf_counter()
    n = synth_kitti.write_clone(root, SYNTH_TRAIN, SYNTH_VAL, seed=0,
                                multiclass=multiclass, prep=prep)
    log(f"{what} [{card}]: synthetic KITTI clone"
        f"{' (Car, Pedestrian, Cyclist)' if multiclass else ''}, "
        f"{SYNTH_TRAIN} + {SYNTH_VAL} frames ({n} labels)"
        f"{', infos, reduced clouds and gt database' if prep else ''} in "
        f"{time.perf_counter() - t0:.1f} s")


def training_windows(model_dir: Path, what: str, card: str) -> list:
    """The train windows of ``metrics.jsonl``, logged; the loss finite and
    the last window's below the first's."""
    windows = [json.loads(line) for line in
               (model_dir / "metrics.jsonl").read_text().splitlines()]
    windows = [w for w in windows if w["prefix"] == "train"]
    keys = ("loss", "loss_cls", "loss_loc", "loss_dir", "grad_norm",
            "num_pos", "mid_capacity_saturated", "steps_per_sec",
            "host_prep_ms", "feed_ms", "step_ms")
    for w in windows:
        log(f"{what} [{card}]: window to step {w['step']}: "
            + json.dumps({k: round(w[k], 5) for k in keys if k in w}))
    first, last = windows[0]["loss"], windows[-1]["loss"]
    if not all(math.isfinite(w["loss"]) for w in windows):
        raise AssertionError(f"{what}: a loss is not finite")
    if not last < first:
        raise AssertionError(f"{what}: mean loss of the last window {last} "
                             f"is not below the first's {first}")
    log(f"{what} [{card}]: mean loss {first:.5f} (first window) -> "
        f"{last:.5f} (last window): falls")
    return windows


def capacity_histogram(model_dir: Path) -> dict:
    """The last run's batches by voxel capacity, as ``train()`` writes
    them into ``metrics.jsonl``.  -> {capacity: batches}."""
    lines = [json.loads(line) for line in
             (model_dir / "metrics.jsonl").read_text().splitlines()]
    last = [w for w in lines
            if w["prefix"] == "batches_by_voxel_capacity"][-1]
    return {int(k): int(v) for k, v in last.items()
            if k not in ("step", "prefix")}


def sequential_batches(config: Path, n: int, seed: int = 0) -> list:
    """The first ``n`` batches of ``config``'s training reader as its
    sequential loader draws them (one thread, stream order, a fresh
    reader of ``seed``): the same batches, the gt-database sampler's
    draws included, on every run."""
    prep_ds, loader = train_mod.Bundle(config).input_reader(training=True,
                                                            seed=seed)
    B = loader._batch_size
    stream = loader._index_stream()
    return [batching.merge_batch([prep_ds.example(*next(stream))
                                  for _ in range(B)]) for _ in range(n)]


def kitti_requests(root: Path, n_requests: int, B: int) -> list:
    """``n_requests`` requests of B validation frames of the clone (the
    r-th from frame r on, cyclically), each frame padded to the largest
    frame's point count."""
    ds = kitti_dataset.KittiDataset(root, root / "kitti_infos_val.pkl",
                                    ["Car"])
    frames = [ds.get_sensor_data(i)["lidar"]["points"]
              for i in range(len(ds))]
    P = max(len(f) for f in frames)
    requests = []
    for r in range(n_requests):
        pts = np.zeros((B, P, frames[0].shape[1]), np.float32)
        nv = np.zeros(B, np.int32)
        for b in range(B):
            f = frames[(r + b) % len(frames)]
            pts[b, :len(f)] = f
            nv[b] = len(f)
        requests.append((pts, nv))
    return requests


def kitti_pod(device: str) -> PodInference:
    """pointpillars/car/xyres_16.config at full width for serving (``hard``
    voxelization, 12 000 pillars of 100 points) with the initial weights
    ``train()`` draws from seed 0 (``utils/seeded_init.py::
    load_flax_init``: scores about the focal prior, 0.01-0.25 on these
    scans).  ``load_seeded``'s wider draws saturate the class head at
    this width (logits up to +-98, a tenth of the anchors at a score of
    exactly 1.0), and a checkpoint of a few dozen steps has BatchNorm
    running statistics far from its batches' (heads of +-3000): neither
    ranks its boxes alike on two devices."""
    model, cfg, anchors = build_from_config(PP_CONFIG)
    load_flax_init(model, 0)
    return PodInference(model, cfg, anchors, device=device,
                        max_voxels=PP_MAX_VOXELS,
                        max_points_per_voxel=PP_MAX_POINTS)


def serve_pp_kitti(card: str, root: Path) -> dict:
    """pointpillars/car/xyres_16.config through PodInference at B = 8
    (:func:`kitti_pod`): four requests of eight validation frames, twice
    over after a warm-up, the counters set to 0 just before and read just
    after; detections against the port's CPU run as sets, the heads of
    one request within HEAD_TOL.  -> {"pod", "requests", "latency_ms",
    "launches", "calls"}."""
    t0 = time.perf_counter()
    pod = kitti_pod("cuda")
    requests = kitti_requests(root, PP_REQUESTS, PP_SERVE_B)
    log(f"pp-KITTI serving: grid {pod.cfg.grid_size}, "
        f"{pod.anchors.shape[0]} anchors, model + {len(requests)} requests "
        f"of B={PP_SERVE_B} ready in {time.perf_counter() - t0:.1f} s; "
        f"points per frame {requests[0][1].tolist()} (padded to "
        f"{requests[0][0].shape[1]})")
    outs, lat, launches, calls = drive(
        "pp-KITTI serving", card, pod, requests, ROUNDS,
        {"pillar_scatter": len(requests) * ROUNDS, "rotated_iou": None})
    check_outputs("pp-KITTI serving", outs, pod)
    cpu = kitti_pod("cpu")
    t0 = time.perf_counter()
    cpu_outs = [cpu(*req) for req in requests]
    cpu_s = time.perf_counter() - t0
    C = pod.cfg.num_class
    for i, out in enumerate(outs):
        diff = detections_mismatch(out, cpu_outs[i % len(requests)], C,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"pp-KITTI request {i}, GPU vs CPU: {diff}")
    n_det = [int(o["valid"].sum()) for o in cpu_outs]
    if not min(n_det):
        raise AssertionError(f"pp-KITTI serving: detections a request "
                             f"{n_det}: nothing to compare")
    err, bad = heads_mismatch(head_outputs(pod, requests[0]),
                              head_outputs(cpu, requests[0]))
    if bad is not None:
        raise AssertionError(f"pp-KITTI serving: head {bad} card vs CPU "
                             f"{err}, tolerance {HEAD_TOL}")
    check_network_flags("pp-KITTI serving", pod, requests[0])
    log(f"pp-KITTI serving: GPU detections match the port's CPU run "
        f"({cpu_s:.1f} s for {len(requests)} requests) on all {len(outs)} "
        f"requests as sets (boxes atol {BOX_ATOL}, scores atol "
        f"{SCORE_ATOL}; {n_det} detections a request); heads of request 0 "
        f"card vs CPU max abs diff {err} (within {HEAD_TOL})")
    del cpu
    return {"pod": pod, "requests": requests,
            "latency_ms": float(np.median(lat)), "launches": launches,
            "calls": calls}


# the kernels' launch counters of a child process and the TF32 flags its
# modules ran under: a hook that the child's interpreter loads as
# ``sitecustomize`` (from a directory put first on its PYTHONPATH) records
# the flags at the start of every module's forward, as flags_in_modules
# does, and at exit writes each wrapper's count and the flags seen as
# JSON (to a file of its own where the path holds ``{pid}``: the ranks of
# a data-parallel run, and nothing from their helper processes, which load
# none of the port).  Any other sitecustomize on the path runs first.
COUNTS_HOOK = r"""
import atexit, json, os, sys

import torch

_here = os.path.dirname(os.path.abspath(__file__))
for _p in sys.path:
    _f = os.path.join(_p or ".", "sitecustomize.py")
    if os.path.abspath(_p or ".") != _here and os.path.exists(_f):
        exec(compile(open(_f).read(), _f, "exec"),
             {"__name__": "sitecustomize", "__file__": _f})
        break


_seen = set()
torch.nn.modules.module.register_module_forward_pre_hook(
    lambda *_: _seen.add((torch.backends.cudnn.allow_tf32,
                          torch.backends.cuda.matmul.allow_tf32)))


def _dump_launch_counts():
    counts = {}
    wrappers = json.loads(os.environ["ABR_KERNEL_WRAPPERS"])
    path = os.environ["ABR_LAUNCH_COUNTS"]
    if "{pid}" in path and not any(m in sys.modules
                                   for m, _ in wrappers.values()):
        return          # a helper process of the ranks: none of the port
    for name, (module, attr) in wrappers.items():
        mod = sys.modules.get(module)
        counts[name] = int(getattr(getattr(mod, attr), "launches", 0)
                           if mod is not None else 0)
    with open(path.replace("{pid}", str(os.getpid())), "w") as f:
        json.dump({"launches": counts, "tf32_seen": sorted(_seen)}, f)


atexit.register(_dump_launch_counts)
"""


def cli(args: list, what: str, card: str, tmp: Path) -> tuple:
    """``python -m automatic_as_built_reconstruction_tpu_torch.cli *args``
    in a child process from the checkout, every kernel counter starting
    at 0 there; every module of a network that the child ran saw TF32 off
    (and ``train`` / ``evaluate`` / ``export_asbuilt`` ran one).  -> (its
    standard output, {kernel: launches})."""
    hook = tmp / "counts_hook"
    hook.mkdir(exist_ok=True)
    (hook / "sitecustomize.py").write_text(COUNTS_HOOK)
    counts = tmp / "launch_counts.json"
    counts.unlink(missing_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(hook), str(ROOT)] + ([env["PYTHONPATH"]]
                                  if env.get("PYTHONPATH") else []))
    env["ABR_LAUNCH_COUNTS"] = str(counts)
    env["ABR_KERNEL_WRAPPERS"] = json.dumps(
        {name: (fn.__module__, fn.__name__) for name, fn in KERNELS.items()})
    cmd = [sys.executable, "-m", "automatic_as_built_reconstruction_tpu_torch"
           ".cli", *map(str, args)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{what}: {' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    dumped = json.loads(counts.read_text())
    launches = dumped["launches"]
    seen = {tuple(f) for f in dumped["tf32_seen"]}
    network = args[0] in ("train", "evaluate", "export_asbuilt")
    if not seen <= {(False, False)} or (network and not seen):
        raise AssertionError(f"{what}: cli {args[0]} ran modules with TF32 "
                             f"flags {sorted(seen)}, expected only "
                             f"(False, False)")
    log(f"{what} [{card}]: python -m ...cli {' '.join(map(str, args[:1]))} "
        f"in a child process: {wall:.1f} s wall (start-up included); "
        f"launches {launches}; TF32 flags its modules saw {sorted(seen)}")
    return proc.stdout, launches


def expect_launches(what: str, launches: dict, want: dict) -> None:
    want = dict.fromkeys(KERNELS, 0) | want
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, expected {want}")


def expect_some_launches(what: str, launches: dict, names) -> None:
    zero = [n for n in names if not launches[n] > 0]
    if zero:
        raise AssertionError(f"{what}: kernels {zero} launched no time "
                             f"({launches})")


def step_on_device(config, batch, steps: int, card: str, what: str) -> tuple:
    """One more training step of ``config`` on ``batch`` from seeded
    weights, timed with CUDA events.  -> (event times, the step as a
    callable, for the profile)."""
    bundle = train_mod.Bundle(config)
    state = train_mod.init_state(bundle, rng_seed=0, total_steps=steps,
                                 device="cuda")
    example = train_mod.to_device(batch, "cuda")
    step_fn = train_mod.make_train_step(bundle)
    ev = cuda_ms(lambda: step_fn(state, example), iters=10, warmup=2)
    log(f"{what} [{card}]: device step (B={batch['voxels'].shape[0]}, "
        f"V={batch['voxels'].shape[1]}, synchronised, events) "
        f"{fmt_range(ev)}")
    return ev, lambda: step_fn(state, example)


def hold_f32_step(config, batch, steps: int, card: str, what: str) -> dict:
    """One step on the card against the port's CPU step, each held to a
    float64 step (:func:`train_step_mismatch`)."""
    t0 = time.perf_counter()
    summary, bad = train_step_mismatch(config, batch, steps)
    log(f"{what} [{card}]: one step (B={batch['voxels'].shape[0]}, "
        f"V={batch['voxels'].shape[1]}) on the card vs the port's CPU step, "
        f"float32 against float64 on both, in "
        f"{time.perf_counter() - t0:.1f} s: " + json.dumps(summary))
    if bad is not None:
        raise AssertionError(f"{what} step, card vs CPU: {bad}")
    return summary


# steps of the pp-KITTI training that ``train --profile_steps`` traces,
# and the kernels its trace must name: K1's row copy (the KITTI canvas is
# above the tiles' limit) and its backward
PP_PROFILE_STEPS = 2
PROFILE_KERNELS = ("pillar_rows_kernel", "pillar_gather_kernel")


def check_profile_trace(model_dir: Path, what: str, card: str) -> None:
    """``<model_dir>/profile`` holds one Chrome trace, of steps 2 to
    2 + PP_PROFILE_STEPS, that names every kernel of PROFILE_KERNELS."""
    traces = sorted((model_dir / "profile").glob("*.trace.json"))
    want = f"steps_2-{2 + PP_PROFILE_STEPS}.trace.json"
    if [t.name for t in traces] != [want]:
        raise AssertionError(f"{what}: profile traces {traces}, want "
                             f"{want}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    missing = [k for k in PROFILE_KERNELS
               if not any(k in e.get("name", "") for e in kernels)]
    if missing:
        raise AssertionError(f"{what}: the profile trace names no kernel "
                             f"{missing}")
    counts = {k: sum(k in e["name"] for e in kernels)
              for k in PROFILE_KERNELS}
    log(f"{what} [{card}]: train --profile_steps {PP_PROFILE_STEPS} wrote "
        f"{traces[0].name} ({traces[0].stat().st_size} bytes, "
        f"{len(events)} events, {len(kernels)} device kernels); "
        f"launches in it {counts}")


def train_pp_kitti(card: str, tmp: Path, root: Path) -> dict:
    """KITTI PointPillars training through the port's command line:
    ``kitti_data_prep`` on a fresh clone, ``train`` of
    pointpillars/car/xyres_16.config at full width (B = 2, buckets
    4000 / 8000 / 12 000, the sampler and the augmentation, two loader
    threads) and ``evaluate`` on the validation frames (the KITTI table
    printed, not held), each a child process; the loss falls, at least two
    buckets occur, the anchor mask drops anchors; one step's float32 held
    to float64.  -> {"launches", "report", "step"}."""
    what = "pp-KITTI training"
    write_clone(root, False, what, card, prep=False)
    cli(["kitti_data_prep", "--root_path", root], what, card, tmp)
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_dbinfos_train.pkl"):
        if not (root / name).exists():
            raise AssertionError(f"kitti_data_prep wrote no {name}")
    config = kitti_config(PP_CONFIG, tmp, root)
    model_dir = tmp / "pp_kitti"
    steps = PP_TRAIN_STEPS
    _, train_launches = cli(
        ["train", "--config_path", config, "--model_dir", model_dir,
         "--max_steps", steps, "--display_step", PP_DISPLAY,
         "--profile_steps", PP_PROFILE_STEPS], what, card, tmp)
    expect_launches(what, train_launches, {"pillar_scatter": steps,
                                           "pillar_gather": steps})
    check_profile_trace(model_dir, what, card)
    windows = training_windows(model_dir, what, card)
    hist = capacity_histogram(model_dir)
    log(f"{what} [{card}]: batches by bucket (voxel capacity) over the "
        f"{steps} steps: {hist}")
    if (len(hist) < 2 or sum(hist.values()) != steps
            or not set(hist) <= set(PP_BUCKETS)):
        raise AssertionError(f"{what}: buckets {hist}, want at least two of "
                             f"{PP_BUCKETS} over {steps} batches")
    out, eval_launches = cli(
        ["evaluate", "--config_path", config, "--model_dir", model_dir],
        what, card, tmp)
    batches = -(-SYNTH_VAL // 2)
    expect_launches(f"{what}: evaluate", eval_launches,
                    {"pillar_scatter": batches, "rotated_iou": batches})
    log(f"{what} [{card}]: cli evaluate (checkpoint at step {steps}), KITTI "
        f"table (not held):\n{out}")

    # the anchor mask and the step, on batches of the same reader
    _, loader = train_mod.Bundle(config).input_reader(training=True, seed=1)
    it = iter(loader)
    batches = [next(it) for _ in range(3)]
    it.close()
    masked = [float(1 - b["anchors_mask"].mean()) for b in batches]
    log(f"{what} [{card}]: anchors the mask drops (anchor_area_threshold "
        f"1.0) in three batches: {[round(m, 4) for m in masked]}; voxel "
        f"capacity {[b['voxels'].shape[1] for b in batches]}")
    if not max(masked) > 0:
        raise AssertionError(f"{what}: anchors_mask all true")
    batch = min(batches, key=lambda b: b["voxels"].shape[1])
    ev, step = step_on_device(config, batch, steps, card, what)
    summary = hold_f32_step(config, batch, steps, card, what)
    report = {"steps": steps, "windows": windows, "buckets": hist,
              "anchors_masked": masked, "device_step_ms": ev,
              "f32_vs_f64": summary}
    return {"launches": {"pp-KITTI training": train_launches,
                         "pp-KITTI evaluate": eval_launches},
            "report": report, "step": step}


def train_pp_all(card: str, tmp: Path, root: Path) -> dict:
    """pointpillars/all/xyres_16.config (Car, Pedestrian, Cyclist: 321 408
    anchors) at full width on the multi-class clone: ``train()`` for
    PP_ALL_STEPS steps (counters set to 0 just before and read just
    after), the loss falls, ``evaluate`` prints the three-class table,
    one step's float32 held to float64.  -> {"launches", "report"}."""
    what = "pp-all training"
    config = kitti_config(PP_ALL_CONFIG, tmp, root)
    model_dir = tmp / "pp_all"
    steps = PP_ALL_STEPS
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.enable_grad(), flags_in_modules() as seen:
        train_mod.train(config, model_dir, max_steps=steps,
                        display_step=PP_DISPLAY, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = {n: fn.launches for n, fn in KERNELS.items()}
    expect_launches(what, train_launches, {"pillar_scatter": steps,
                                           "pillar_gather": steps})
    if seen != {(False, False)}:
        raise AssertionError(f"{what}: TF32 flags {sorted(seen)}")
    log(f"{what} [{card}]: {steps} steps of train() in {wall:.2f} s wall; "
        f"launches {train_launches}; batches by voxel capacity "
        f"{capacity_histogram(model_dir)}")
    windows = training_windows(model_dir, what, card)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = evaluate(config, model_dir, device="cuda")
    eval_launches = {n: fn.launches for n, fn in KERNELS.items()}
    batches = -(-SYNTH_VAL // 2)
    expect_launches(f"{what}: evaluate", eval_launches,
                    {"pillar_scatter": batches, "rotated_iou": batches})
    log(f"{what} [{card}]: evaluate on the {SYNTH_VAL} validation frames in "
        f"{time.perf_counter() - t0:.1f} s; three-class KITTI table (not "
        f"held):\n" + result["result_str"])
    for c in ("Car", "Pedestrian", "Cyclist"):
        if f"{c} AP@" not in result["result_str"]:
            raise AssertionError(f"{what}: no {c} rows in the KITTI table")
    _, loader = train_mod.Bundle(config).input_reader(training=True, seed=1)
    it = iter(loader)
    batch = next(it)
    it.close()
    summary = hold_f32_step(config, batch, steps, card, what)
    return {"launches": {"pp-all training": train_launches,
                         "pp-all evaluate": eval_launches},
            "report": {"steps": steps, "wall_s": wall, "windows": windows,
                       "f32_vs_f64": summary,
                       "evaluate_ap": {k: v for k, v in result.items()
                                       if k != "result_str"}}}


def train_all_fhd(card: str, tmp: Path, root: Path) -> dict:
    """second/all.fhd.config at full width (B = 6, key-match mode, the
    three sample groups, three loader threads) on the multi-class clone:
    ``train()`` for ALL_FHD_STEPS steps with the plan's site caps (the
    caps tools/run_multiclass_r5.sh:19 measured where a window saturates),
    the counters set to 0 just before and read just after; the loss
    falls; every join's backward kernels of one step against the plain
    backward; one step at B = 2, float32 on the kernels against float64
    on the plain versions (:func:`second_step_mismatch`); ``evaluate``
    prints the three-class table.  The key-match backward's rulebook
    (``keymatch_rulebook``, a hash table of the keys) of every join of
    that step against its plain version, on keys that do not ascend
    where the config has no ``sort_voxels_by_key``; the largest lookup on
    such keys timed against ``_merge_lookup`` in turns.
    -> {"launches", "report"}."""
    what = "all.fhd training"
    config = kitti_config(ALL_FHD_CONFIG, tmp, root)
    bundle = train_mod.Bundle(config)
    cfg = bundle.model_cfg
    if not (cfg.sparse_keymatch and cfg.sparse_use_pallas_gemm
            and cfg.num_class == 3):
        raise AssertionError("all.fhd.config is not three-class key-match")
    plan = middle_plan(cfg, 17000)
    joins = sum(b.n_subm + 1 for b in plan)
    steps = ALL_FHD_STEPS
    log(f"{what} [{card}]: plan caps {[b.out_cap for b in plan]}, {joins} "
        f"joins a step, {bundle.target_assigner.num_anchors_per_location} "
        f"anchors a cell")

    def run(config, model_dir):
        for fn in KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with torch.enable_grad(), flags_in_modules() as seen:
            state = train_mod.train(config, model_dir, max_steps=steps,
                                    display_step=ALL_FHD_DISPLAY,
                                    saturation_abort_windows=0,
                                    device="cuda")
            torch.cuda.synchronize()
        if seen != {(False, False)}:
            raise AssertionError(f"{what}: TF32 flags {sorted(seen)}")
        return state, time.perf_counter() - t0

    model_dir = tmp / "all_fhd"
    state, wall = run(config, model_dir)
    windows = training_windows(model_dir, what, card)
    saturated = [w["mid_capacity_saturated"] for w in windows]
    log(f"{what} [{card}]: mid_capacity_saturated by window {saturated}")
    caps = "plan"
    if any(saturated):
        caps = list(MULTICLASS_SITE_CAPS)
        log(f"{what} [{card}]: the plan's site caps saturate; substituting "
            f"the caps tools/run_multiclass_r5.sh:19 measured: {caps}")
        config = kitti_config(ALL_FHD_CONFIG, tmp, root, caps)
        model_dir = tmp / "all_fhd_caps"
        state, wall = run(config, model_dir)
        windows = training_windows(model_dir, what, card)
        saturated = [w["mid_capacity_saturated"] for w in windows]
        log(f"{what} [{card}]: with the measured caps, "
            f"mid_capacity_saturated by window {saturated}")
    train_launches = {n: fn.launches for n, fn in KERNELS.items()}
    expect_launches(what, train_launches, {
        "keymatch_gemm": joins * steps, "join_grad_weights": joins * steps,
        "rulebook_hits": joins * steps, "keymatch_rulebook": joins * steps,
        "join_grad_features": (joins - 1) * steps,
        "rulebook_inverse": (joins - 1) * steps})
    log(f"{what} [{card}]: {steps} steps of train() in {wall:.2f} s wall "
        f"({caps} site caps); launches {train_launches}")

    # one step's backward calls, each join's kernels against the plain
    # backward; batches of the sequential stream
    prep_ds, loader = train_mod.Bundle(config).input_reader(training=True,
                                                            seed=1)
    stream = loader._index_stream()
    examples = [prep_ds.example(*next(stream)) for _ in range(6)]
    example = train_mod.to_device(batching.merge_batch(examples), "cuda")
    step_fn = train_mod.make_train_step(train_mod.Bundle(config))
    wcalls, fcalls, mcalls = [], [], []
    sgg = sparse_gather_gemm
    with torch.enable_grad(), recording(sgg, "join_grad_weights", wcalls), \
            recording(sgg, "join_grad_features", fcalls), \
            recording(sgg, "keymatch_rulebook", mcalls):
        step_fn(state, example)
    torch.cuda.synchronize()
    if (len(wcalls), len(fcalls), len(mcalls)) != (joins, joins - 1,
                                                   joins):
        raise AssertionError(f"{what}: one step recorded {len(wcalls)} dW, "
                             f"{len(fcalls)} dfeatures and {len(mcalls)} "
                             f"key-lookup calls")
    by_rulebook = {id(c[0][1]): c for c in fcalls}
    worst, unordered = 0.0, []
    with torch.no_grad():
        for i, (wcall, mcall) in enumerate(zip(wcalls, mcalls)):
            (in_keys, q_keys), _ = mcall
            idx, found = wcall[0][1], wcall[0][2]
            ref_idx, ref_found = sgg.keymatch_rulebook_plain(in_keys, q_keys)
            if not (torch.equal(found, ref_found) and torch.equal(
                    idx[found], ref_idx[found])):
                raise AssertionError(f"{what}: join {i}: keymatch_rulebook "
                                     f"kernel != plain version")
            if not bool(sgg._ascending(in_keys)):
                unordered.append(i)
            _, errs = check_join(wcall, by_rulebook.get(id(wcall[0][1])))
            worst = max(worst, *errs.values())
    log(f"{what} [{card}]: one step's {len(wcalls)} joins: backward kernels "
        f"vs plain within {worst:.3g} of max |g| (tolerance "
        f"{JOIN_GRAD_TOL}); every join's rulebook lookup equal to "
        f"_merge_lookup's; joins whose keys do not ascend: {unordered} of "
        f"{list(range(len(mcalls)))}")
    lookup = {}
    if unordered:
        at = max(unordered, key=lambda i: mcalls[i][0][1].numel())
        (in_keys, q_keys), _ = mcalls[at]
        with torch.no_grad():
            turns = take_turns({
                "rulebook": lambda: sgg.keymatch_rulebook(in_keys, q_keys),
                "rulebook_plain": lambda: sgg.keymatch_rulebook_plain(
                    in_keys, q_keys)})
        # the keys and query keys read once, idx and found written once
        book_bytes = (in_keys.numel() + q_keys.numel()) * 4 + \
            q_keys.numel() * 5
        lookup = {"join": at, "shape": list(q_keys.shape),
                  "n": in_keys.shape[-1], "ms": turns["rulebook"],
                  "plain_ms": turns["rulebook_plain"],
                  "bound_ms": book_bytes / PEAK_BYTES_PER_S * 1e3}
        log(f"{what} [{card}]: the largest rulebook lookup on keys that "
            f"do not ascend, join {at} (q_keys {list(q_keys.shape)}, "
            f"N={in_keys.shape[-1]}), in turns: keymatch_rulebook "
            f"{fmt_range(turns['rulebook'])}; "
            f"plain, _merge_lookup, {fmt_range(turns['rulebook_plain'])}; "
            f"bound {lookup['bound_ms']:.5f} ms by bytes")
    del wcalls, fcalls, mcalls
    ev = cuda_ms(lambda: step_fn(state, example), iters=5, warmup=1)
    log(f"{what} [{card}]: device step (B=6, synchronised, events) "
        f"{fmt_range(ev)}")
    del example

    # one step at B = 2: float32 on the kernels, float64 plain, as the
    # car.fhd phase holds it
    t0 = time.perf_counter()
    summary, bad = second_step_mismatch(
        config, batching.merge_batch(examples[:SECOND_STEP_B]), steps)
    log(f"{what} [{card}]: one step (B={SECOND_STEP_B}) float32 on the "
        f"kernels vs float64 on the plain versions, both on the card, in "
        f"{time.perf_counter() - t0:.1f} s: " + json.dumps(summary))
    if bad is not None:
        raise AssertionError(f"{what} step, float32 vs float64: {bad}")

    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = evaluate(config, model_dir, device="cuda")
    eval_launches = {n: fn.launches for n, fn in KERNELS.items()}
    batches = -(-SYNTH_VAL // 6)
    expect_launches(f"{what}: evaluate", eval_launches,
                    {"keymatch_gemm": joins * batches,
                     "rotated_iou": batches})
    log(f"{what} [{card}]: evaluate on the {SYNTH_VAL} validation frames in "
        f"{time.perf_counter() - t0:.1f} s; three-class KITTI table (not "
        f"held):\n" + result["result_str"])
    return {"launches": {"all.fhd training": train_launches,
                         "all.fhd evaluate": eval_launches},
            "report": {"steps": steps, "wall_s": wall, "windows": windows,
                       "site_caps": caps, "saturated": saturated,
                       "join_backward_worst": worst,
                       "rulebook_unordered_joins": unordered,
                       "rulebook_unordered_lookup": lookup,
                       "device_step_ms": ev,
                       "f32_vs_f64": summary}}


# --------------------------------------------------------------------------
# host-rulebook SECOND (people.fhd, car.lite) and bfloat16 (car.fhd.mixed)
# --------------------------------------------------------------------------

def train_host_rulebook(config: Path, what: str, card: str,
                        kernels_a_step: dict) -> dict:
    """``train()`` for HOST_RB_STEPS steps of a host-rulebook config (the
    counters set to 0 just before and read just after: ``kernels_a_step``
    times the steps), the plan's caps and ``mid_capacity_saturated`` by
    window printed (no caps substituted), the loss falls; the loader's
    wait against one thread's prep of a batch, the native rulebook build
    of it apart, and the device step (events).  -> {"state", "model_dir",
    "launches", "examples", "report"}."""
    bundle = train_mod.Bundle(config)
    plan = bundle.middle_plan(True)
    if plan is None:
        raise AssertionError(f"{what}: no host rulebooks in this config")
    joins = sum(b.n_subm + 1 for b in plan)
    log(f"{what} [{card}]: host rulebooks for {len(plan)} blocks, plan "
        f"caps {[b.out_cap for b in plan]}, {joins} joins a step; compute "
        f"{bundle.model_cfg.compute_dtype}, gather join "
        f"{bundle.model_cfg.sparse_use_pallas_gemm}")
    model_dir = config.parent / (config.stem + "_run")
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.enable_grad(), flags_in_modules() as seen:
        state = train_mod.train(config, model_dir, max_steps=HOST_RB_STEPS,
                                display_step=HOST_RB_DISPLAY,
                                saturation_abort_windows=0, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    expect_launches(what, launches, {k: v * HOST_RB_STEPS
                                     for k, v in kernels_a_step.items()})
    if seen != {(False, False)}:
        raise AssertionError(f"{what}: TF32 flags {sorted(seen)}")
    windows = training_windows(model_dir, what, card)
    saturated = [w["mid_capacity_saturated"] for w in windows]
    log(f"{what} [{card}]: {HOST_RB_STEPS} steps of train() in {wall:.2f} s "
        f"wall; mid_capacity_saturated by window {saturated} (the plan's "
        f"caps, none substituted); launches {launches}")

    # one thread's prep of a batch (the native rulebook build apart)
    # against the loader's wait and the device step
    prep_ds, loader = bundle.input_reader(training=True, seed=1)
    stream = loader._index_stream()
    t_prep, t_books, examples = [], [], []
    for _ in range(bundle.config["train_input_reader"]["batch_size"]):
        t1 = time.perf_counter()
        ex = prep_ds.example(*next(stream))
        t_prep.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        rulebook_host.build_middle_rulebooks(ex["coordinates"], plan)
        t_books.append((time.perf_counter() - t1) * 1e3)
        examples.append(ex)
    batch = batching.merge_batch(examples)
    rb_bytes = sum(v.nbytes for k, v in batch.items() if k.startswith("rb"))
    example = train_mod.to_device(batch, "cuda")
    step_fn = train_mod.make_train_step(train_mod.Bundle(config))
    with torch.enable_grad():
        ev = cuda_ms(lambda: step_fn(state, example), iters=3, warmup=1)
    wait = float(np.median([w["host_prep_ms"] for w in windows]))
    log(f"{what} [{card}]: the loader's wait a batch (median of the "
        f"windows, {bundle.config['train_input_reader']['num_workers']} "
        f"threads) {wait:.2f} ms; one thread's prep of a batch of "
        f"{len(examples)} {sum(t_prep):.1f} ms, of which the native "
        f"rulebook build {sum(t_books):.1f} ms ({rb_bytes} bytes of "
        f"rulebooks a batch to the device); device step (synchronised, "
        f"events) {fmt_range(ev)}")
    report = {"steps": HOST_RB_STEPS, "wall_s": wall, "windows": windows,
              "saturated": saturated, "plan_caps": [b.out_cap for b in plan],
              "loader_wait_ms": wait, "prep_ms_one_thread": sum(t_prep),
              "rulebook_build_ms_one_thread": sum(t_books),
              "rulebook_bytes_a_batch": rb_bytes, "device_step_ms": ev}
    return {"state": state, "model_dir": model_dir, "launches": launches,
            "examples": examples, "report": report, "joins": joins,
            "step": lambda: step_fn(state, example)}


def evaluate_host_rulebook(config: Path, model_dir: Path, what: str,
                           card: str) -> dict:
    """``evaluate`` of the run's checkpoint on the validation frames (host
    rulebooks at the eval reader's caps): K2 once a batch; the KITTI
    table printed, not held.  -> launches."""
    bundle = train_mod.Bundle(config)
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = evaluate(config, model_dir, device="cuda")
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    batches = -(-SYNTH_VAL // bundle.config["eval_input_reader"][
        "batch_size"])
    expect_launches(f"{what}: evaluate", launches, {"rotated_iou": batches})
    log(f"{what} [{card}]: evaluate on the {SYNTH_VAL} validation frames in "
        f"{time.perf_counter() - t0:.1f} s (eval plan caps "
        f"{[b.out_cap for b in bundle.middle_plan(False)]}); KITTI table "
        f"(not held):\n" + result["result_str"])
    return launches


def people_fhd(card: str, tmp: Path, root: Path) -> dict:
    """second/people.fhd.config at full width on the multi-class clone
    (Pedestrian and Cyclist sampler groups, B = 6, three loader threads,
    host rulebooks, the plain joins): train, one step at B = 2 in float32
    held to float64 as car.fhd's is, evaluate."""
    what = "people.fhd"
    config = kitti_config(PEOPLE_CONFIG, tmp, root)
    run = train_host_rulebook(config, what, card, {})
    t0 = time.perf_counter()
    summary, bad = second_step_mismatch(
        config, batching.merge_batch(run["examples"][:SECOND_STEP_B]),
        HOST_RB_STEPS)
    log(f"{what} [{card}]: one step (B={SECOND_STEP_B}) float32 vs float64 "
        f"(the plain joins on the host rulebooks), both on the card, in "
        f"{time.perf_counter() - t0:.1f} s: " + json.dumps(summary))
    if bad is not None:
        raise AssertionError(f"{what} step, float32 vs float64: {bad}")
    run["report"]["f32_vs_f64"] = summary
    ev = evaluate_host_rulebook(config, run["model_dir"], what, card)
    return {"launches": {"people.fhd training": run["launches"],
                         "people.fhd evaluate": ev},
            "report": run["report"], "step": run["step"]}


def check_host_books(examples: list, plan, what: str, card: str) -> None:
    """The host rulebooks of a batch against the port's device merge
    builders (``ops/sparse_conv.py::build_submanifold_rulebook_merge``,
    ``::build_strided_layout_merge``) on the card, block by block: the
    same found taps and the same source row where found, the same output
    sites."""
    ex = train_mod.to_device(batching.merge_batch(examples), "cuda")
    coords = ex["coordinates"]
    valid = coords[..., 0] >= 0
    books = rulebook_host.unflatten(ex, len(plan))
    for bi, (blk, (rb, layout)) in enumerate(zip(plan, books)):
        checks = []
        if blk.n_subm:
            dev = sparse_conv.build_submanifold_rulebook_merge(
                coords, valid, blk.grid, blk.subm_kernel)
            checks.append(("subm", dev.found, dev.gather_idx, rb.found,
                           rb.gather_idx))
        lay = sparse_conv.build_strided_layout_merge(
            coords, valid, blk.grid, blk.kernel, blk.stride, blk.pad,
            blk.out_cap)
        checks.append(("strided", lay.found, lay.gather_idx, layout.found,
                       layout.gather_idx))
        for name, f_dev, i_dev, f_host, i_host in checks:
            if not (torch.equal(f_dev, f_host)
                    and torch.equal(i_dev[f_dev], i_host[f_host])):
                raise AssertionError(f"{what}: block {bi} {name} rulebook: "
                                     f"host != device merge builder")
        if not (torch.equal(lay.out_coords, layout.out_coords)
                and torch.equal(lay.out_valid, layout.out_valid)):
            raise AssertionError(f"{what}: block {bi} output sites: host != "
                                 f"device")
        coords, valid = layout.out_coords, layout.out_valid
    torch.cuda.synchronize()
    log(f"{what} [{card}]: the host rulebooks of a batch of {len(examples)} "
        f"equal the device merge builders' on the card, integer for integer, "
        f"in all {len(plan)} blocks")


def car_lite(card: str, tmp: Path, root: Path) -> dict:
    """second/car/car.lite.config at full width on the car clone (B = 6,
    host rulebooks, the plain joins): train, the host rulebooks of a
    training batch against the device builders, evaluate."""
    what = "car.lite"
    config = kitti_config(LITE_CONFIG, tmp, root)
    run = train_host_rulebook(config, what, card, {})
    check_host_books(run["examples"], train_mod.Bundle(config).middle_plan(
        True), what, card)
    ev = evaluate_host_rulebook(config, run["model_dir"], what, card)
    return {"launches": {"car.lite training": run["launches"],
                         "car.lite evaluate": ev},
            "report": run["report"]}


def plain_gather(features, gather_idx, found, weights, *args):
    """The gather join's plain version in the middle's call form."""
    return sparse_gather_gemm.gather_gemm_plain(features, gather_idx, found,
                                                weights)


def head_share(got: dict, ref: dict) -> dict:
    """{head: max |got - ref| / max |ref|}."""
    return {k: float((got[k] - ref[k]).abs().max() / ref[k].abs().max())
            for k in ref}


# --------------------------------------------------------------------------
# bfloat16: the held head check and its control
# --------------------------------------------------------------------------

def with_mixed_precision(config: Path, tmp: Path) -> Path:
    """A copy of ``config`` in ``tmp`` with ``train_config
    .enable_mixed_precision: true``, the one line a user adds to a shipped
    config to train, evaluate and serve it in bfloat16."""
    text = config.read_text()
    if "enable_mixed_precision" in text or "train_config: {" not in text:
        raise ValueError(f"{config}: no train_config block to set the flag "
                         f"in, or the flag is set already")
    out = tmp / f"{config.stem}.mixed.config"
    out.write_text(text.replace(
        "train_config: {", "train_config: {\n  enable_mixed_precision: true",
        1))
    return out


def plain_gather_reversed(features, gather_idx, found, weights, *args):
    """The control: the gather join's plain version with its taps in
    reverse order, the weights permuted alike (the same function, another
    float32 sum order in its one matmul)."""
    return sparse_gather_gemm.gather_gemm_plain(
        features, gather_idx.flip(-2), found.flip(-2), weights.flip(0))


def plain_keymatch_reversed(features, in_keys, q_keys, weights, *args):
    """The control of the key-match join: its plain version with the taps
    reversed, the weights permuted alike."""
    return sparse_gather_gemm.keymatch_gemm_plain(
        features, in_keys, q_keys.flip(-2), weights.flip(0))


def conv2d_reversed(self, x):
    """The control of the pillar path, whose one kernel (K1) copies rows
    exactly: each RPN convolution with its input channels reversed, its
    kernel's alike (the same function, another float32 sum order in
    cuDNN), in the module's compute type as ``rpn.Conv2d`` computes."""
    dt = self.compute_dtype or x.dtype
    y = self._conv_forward(x.to(dt).flip(1), self.weight.to(dt).flip(1),
                           None)
    return y if self.bias is None else y + self.bias.to(dt).view(1, -1, 1, 1)


def f32_twin(pod, **kw) -> PodInference:
    """The same network and weights as ``pod`` in float32."""
    cfg = dataclasses.replace(pod.cfg, compute_dtype="float32")
    model = VoxelNet(cfg)
    model.load_state_dict(pod.model.state_dict(), strict=True)
    return PodInference(model, cfg, pod.anchors.cpu().numpy(),
                        device=pod.device, **kw)


def hold_bf16_heads(what: str, pod, f32_pod, requests, plain: list,
                    control: list, card: str) -> dict:
    """The bf16 network's heads on the kernels against the same network
    on the plain versions (``plain``: [(module, name, fn)] substituted),
    on each request: within CONTROL_MARGIN x the distance of the control
    (the plain versions with another float32 sum order: ``control``,
    substituted over ``plain``) from the plain versions.  The
    bf16-vs-float32 distance (``f32_pod``) is printed beside, and each
    distance as a share of it.  -> {"kernel_vs_plain", "control_vs_plain",
    "bf16_vs_f32"}: per request, {head: share of max |x|}."""
    report = {"kernel_vs_plain": [], "control_vs_plain": [],
              "bf16_vs_f32": []}
    for i, request in enumerate(requests):
        heads = head_outputs(pod, request)
        with contextlib.ExitStack() as stack:
            for module, name, fn in plain:
                stack.enter_context(substituted(module, name, fn))
            ref = head_outputs(pod, request)
            for module, name, fn in control:
                stack.enter_context(substituted(module, name, fn))
            ctl = head_outputs(pod, request)
        kvp, cvp = head_share(heads, ref), head_share(ctl, ref)
        bvf = head_share(ref, head_outputs(f32_pod, request))
        for key, v in (("kernel_vs_plain", kvp), ("control_vs_plain", cvp),
                       ("bf16_vs_f32", bvf)):
            report[key].append(v)
        log(f"{what} [{card}]: heads of request {i} (share of max |x|): "
            f"kernels vs plain {kvp}; control vs plain {cvp}; bf16 vs "
            f"float32 {bvf}; as shares of bf16 vs float32: kernels "
            f"{ {k: round(kvp[k] / bvf[k], 4) for k in kvp} }, control "
            f"{ {k: round(cvp[k] / bvf[k], 4) for k in cvp} }; held: "
            f"kernels vs plain <= {CONTROL_MARGIN} x control vs plain")
        for k in heads:
            if not (torch.isfinite(heads[k]).all()
                    and kvp[k] <= CONTROL_MARGIN * cvp[k]):
                raise AssertionError(
                    f"{what}: request {i} head {k}: kernels vs plain "
                    f"{kvp[k]}, control vs plain {cvp[k]} (margin "
                    f"{CONTROL_MARGIN})")
    return report


def rpn_share(pod, request, card: str, what: str) -> dict:
    """Device time (torch.profiler) of one request and of its RPN alone
    (the heads of the middle's canvas, in the model's compute dtype)."""
    pts, nv = pod._device_inputs(*request)
    with torch.no_grad(), fp32_math():
        vox = pod.voxelize(pts, nv)
        spatial = pod.model(*vox, return_stages=True)[1]["spatial_features"]

    def rpn():
        with torch.no_grad(), fp32_math():
            pod.model.rpn_heads(spatial)

    total, _ = device_ms(lambda: pod(*request), iters=5)
    rpn_ms, per_kernel = device_ms(rpn, iters=5)
    share = (None if total is None or rpn_ms is None else rpn_ms / total)
    top = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6])
    log(f"{what} [{card}]: device time of one request "
        f"{total} ms, of its RPN ({pod.cfg.compute_dtype}) {rpn_ms} ms: "
        f"share {share}; RPN kernels: {fmt_kernels(top)}")
    return {"request_ms": total, "rpn_ms": rpn_ms, "rpn_share": share}


def car_fhd_mixed(card: str, tmp: Path, root: Path, fp32_pod) -> dict:
    """second/car/car.fhd.mixed.config at full width: ``train()`` in
    bfloat16 on the car clone (B = 6, host rulebooks, the gather join's
    bfloat16 kernel forward, the float32 backward kernels); then four
    B = 2 requests through ``pod_inference_from_checkpoint`` (rulebooks
    built on the device), the heads of the bf16 run on the kernels held
    against the bf16 run on the plain versions with the control
    (:func:`hold_bf16_heads`: the taps reversed), and the RPN's share of
    a request beside car.fhd's float32 one (``fp32_pod``)."""
    what = "car.fhd.mixed"
    config = kitti_config(MIXED_CONFIG, tmp, root)
    bundle = train_mod.Bundle(config)
    plan = bundle.middle_plan(True)
    joins = sum(b.n_subm + 1 for b in plan)
    run = train_host_rulebook(config, what, card, {
        "gather_gemm_bf16": joins, "join_grad_weights": joins,
        "rulebook_hits": joins, "join_grad_features": joins - 1,
        "rulebook_inverse": joins - 1})
    if sparse_gather_gemm.rulebook_collisions("cuda"):
        raise AssertionError(f"{what}: a host rulebook is not a "
                             f"convolution's")

    # serving: four B = 2 requests, the same scans as car.fhd's
    kw = dict(max_voxels=SECOND_MAX_VOXELS,
              max_points_per_voxel=SECOND_MAX_POINTS)
    pod = pod_inference_from_checkpoint(MIXED_CONFIG, None, device="cuda",
                                        seed=SECOND_SEED, **kw)
    cfg = pod.cfg
    if cfg.compute_dtype != "bfloat16" or cfg.sparse_keymatch:
        raise AssertionError(f"{what}: not the bf16 gather-join network")
    requests = [pad_batch([make_scene(s) for s in seeds])
                for seeds in SECOND_REQUESTS]
    splan = middle_plan(cfg, SECOND_MAX_VOXELS)
    sjoins = sum(b.n_subm + 1 for b in splan)
    outs, lat, launches, calls = drive(
        f"{what} serving", card, pod, requests, 1,
        {"gather_gemm_bf16": sjoins * len(requests), "rotated_iou": None})
    check_outputs(what, outs, pod)
    check_network_flags(f"{what} serving", pod, requests[0])
    heads = hold_bf16_heads(
        f"{what} serving", pod, f32_twin(pod, **kw), requests[:2],
        [(middle, "gather_gemm", plain_gather)],
        [(middle, "gather_gemm", plain_gather_reversed)], card)
    shares = {"car.fhd.mixed (bf16)": rpn_share(pod, requests[2], card,
                                                f"{what} serving"),
              "car.fhd (float32)": rpn_share(fp32_pod, requests[2], card,
                                             "second key-match")}
    report = dict(run["report"], latency_ms=float(np.median(lat)),
                  heads=heads, rpn=shares)
    return {"launches": {"car.fhd.mixed training": run["launches"],
                         "car.fhd.mixed serving": launches},
            "calls": calls["gather_gemm"], "report": report,
            "pod": pod, "requests": requests, "step": run["step"]}


def stage_device_ms(pod, request, what: str, card: str) -> dict:
    """Device time (torch.profiler) of each stage of one request: the
    input stage, the network, decode + NMS.  -> {stage: ms}."""
    pts, nv = pod._device_inputs(*request)
    with torch.no_grad(), fp32_math():
        vox = pod.voxelize(pts, nv)
        preds = pod.model(*vox)
    anchors = pod.anchors[None].expand(pts.shape[0], *pod.anchors.shape)
    stages = {"voxelize": lambda: pod.voxelize(pts, nv),
              "network": lambda: pod.model(*vox),
              "decode_nms": lambda: predict(preds, anchors, pod.cfg)}

    def timed(fn):
        def call():
            with torch.no_grad(), fp32_math():
                fn()
        return device_ms(call, iters=10)[0]

    split = {k: timed(fn) for k, fn in stages.items()}
    log(f"{what} [{card}]: device time of each stage of one request "
        f"(torch.profiler): " + json.dumps(split))
    return split


def mixed_pillars(card: str, fp32_pod, fp32_latency_ms: float) -> dict:
    """asbuilt_pillars.config with ``enable_mixed_precision`` at full
    width (the PFN, K1 and the RPN in bfloat16): the trained checkpoint
    served (four B = 2 requests twice over: latency, the device time of
    each stage; the heads held against the plain K1 with the control,
    beside ``fp32_pod``'s float32 heads), ``evaluate`` on the 32 val
    scenes (its AP printed beside the float32 AP the JAX package gives,
    every num_gt equal), and ``train()`` for MIXED_PILLAR_STEPS steps from
    seeded weights (the loss falls; K1 and its backward on bf16 rows once
    a step), each with the counters set to 0 just before and read just
    after.  -> {"launches", "scatter_call", "gather_call", "report",
    "pod", "requests", "step"}."""
    what = "bf16 pillars"
    report = {}
    with torch.enable_grad(), tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        config = with_mixed_precision(CONFIG, tmp)
        pod = pod_inference_from_checkpoint(
            config, CHECKPOINT, device="cuda", max_voxels=MAX_VOXELS,
            max_points_per_voxel=MAX_POINTS)
        if pod.cfg.compute_dtype != "bfloat16":
            raise AssertionError(f"{what}: the flag gave "
                                 f"{pod.cfg.compute_dtype}")
        requests = [pad_batch([generate_building_scene(s) for s in seeds])
                    for seeds in REQUESTS]
        with torch.no_grad():
            outs, lat, serve_launches, calls = drive(
                f"{what} serving", card, pod, requests, ROUNDS,
                {"pillar_scatter": len(requests) * ROUNDS,
                 "rotated_iou": None})
            check_outputs(what, outs, pod)
            check_network_flags(f"{what} serving", pod, requests[0])
            scatter_call = calls["pillar_scatter"][0]
            if scatter_call[0][0].dtype != torch.bfloat16:
                raise AssertionError(f"{what}: K1 took "
                                     f"{scatter_call[0][0].dtype} rows")
            counts = [np.bincount(d["label_preds"],
                                  minlength=pod.cfg.num_class).tolist()
                      for d in pod.detections_list(outs[0])]
            log(f"{what} serving [{card}]: median latency "
                f"{np.median(lat):.3f} ms (float32 {fp32_latency_ms:.3f} "
                f"ms, the same requests earlier in this run); detections "
                f"per class on scenes 0, 1: {counts} (float32, the JAX "
                f"package: {JAX_COUNTS_SCENES_0_1})")
            report.update(latency_ms=float(np.median(lat)),
                          stage_device_ms=stage_device_ms(
                              pod, requests[2], f"{what} serving", card),
                          stage_device_ms_f32=stage_device_ms(
                              fp32_pod, requests[2], "float32 pillars "
                              "serving", card),
                          heads=hold_bf16_heads(
                              f"{what} serving", pod, fp32_pod, requests[:2],
                              [(pointpillars, "scatter_sorted_to_canvas",
                                pillar_scatter
                                .scatter_sorted_to_canvas_plain)],
                              [(rpn.Conv2d, "forward", conv2d_reversed)],
                              card))

            for fn in KERNELS.values():
                fn.launches = 0
            t0 = time.perf_counter()
            result = evaluate(config, CHECKPOINT, device="cuda")
            ev_launches = {n: fn.launches for n, fn in KERNELS.items()}
        expect_launches(f"{what}: evaluate", ev_launches,
                        {"pillar_scatter": 16, "rotated_iou": 16})
        diffs = {k: result[k] - v for k, v in JAX_EVAL_AP.items()
                 if not k.endswith("num_gt")}
        log(f"{what} [{card}]: evaluate on the 32 val scenes in "
            f"{time.perf_counter() - t0:.1f} s; AP " + json.dumps(result))
        log(f"{what} [{card}]: bf16 AP minus the float32 AP the JAX package "
            f"gives (JAX_EVAL_AP; printed, not held): " + json.dumps(diffs))
        if sorted(result) != sorted(JAX_EVAL_AP) or any(
                result[k] != v for k, v in JAX_EVAL_AP.items()
                if k.endswith("num_gt")):
            raise AssertionError(f"{what}: evaluate gave {result}")
        report["evaluate_ap"] = result

        model_dir = tmp / "train"
        tcalls = {"pillar_scatter": [], "pillar_gather": []}
        for fn in KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            seen = stack.enter_context(flags_in_modules())
            for name in tcalls:
                module, attr = CALL_SITES[name]
                stack.enter_context(recording(module, attr, tcalls[name]))
            state = train_mod.train(config, model_dir,
                                    max_steps=MIXED_PILLAR_STEPS,
                                    display_step=TRAIN_DISPLAY, device="cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr_launches = {n: fn.launches for n, fn in KERNELS.items()}
        expect_launches(f"{what} training", tr_launches,
                        {"pillar_scatter": MIXED_PILLAR_STEPS,
                         "pillar_gather": MIXED_PILLAR_STEPS})
        if seen != {(False, False)}:
            raise AssertionError(f"{what} training: TF32 flags "
                                 f"{sorted(seen)}")
        windows = training_windows(model_dir, f"{what} training", card)
        gather_call = tcalls["pillar_gather"][0]
        if gather_call[0][0].dtype != torch.bfloat16:
            raise AssertionError(f"{what}: K1's backward took "
                                 f"{gather_call[0][0].dtype}")
        bundle = train_mod.Bundle(config)
        _, loader = bundle.input_reader(training=True, seed=1)
        example = train_mod.to_device(next(iter(loader)), "cuda")
        step_fn = train_mod.make_train_step(bundle)
        ev = cuda_ms(lambda: step_fn(state, example), iters=10, warmup=2)
        log(f"{what} training [{card}]: {MIXED_PILLAR_STEPS} steps of "
            f"train() in {wall:.2f} s wall; device step (B=2, synchronised, "
            f"events) {fmt_range(ev)}; launches {tr_launches}")
        report.update(train_wall_s=wall, loss_windows=[w["loss"]
                                                       for w in windows],
                      device_step_ms=ev)
    return {"launches": {"bf16 pillar serving": serve_launches,
                         "bf16 pillar evaluate": ev_launches,
                         "bf16 pillar training": tr_launches},
            "scatter_call": scatter_call, "gather_call": gather_call,
            "report": report, "pod": pod, "requests": requests,
            "step": lambda: step_fn(state, example)}


def mixed_keymatch(card: str, tmp: Path, root: Path) -> dict:
    """SECOND key-match in bfloat16 (``enable_mixed_precision`` on
    car.fhd.config and car.fhd.serving.config, at full width): ``train()``
    of car.fhd for HOST_RB_STEPS steps at B = 6 on the car clone (the
    loss falls; K4 in bf16 forward, the float32 backward kernels, once a
    join a step; the device step; one step's joins recorded), its
    ``evaluate`` (the KITTI table printed), then four B = 2 requests of
    car.fhd.serving (seeded weights) with the heads held against the plain
    joins with the control, beside the float32 network.  -> {"launches",
    "calls", "step_calls", "report", "pod", "requests", "step"}."""
    what = "bf16 key-match"
    sgg = sparse_gather_gemm
    config = with_mixed_precision(kitti_config(SECOND_TRAIN_CONFIG, tmp,
                                               root), tmp)
    bundle = train_mod.Bundle(config)
    cfg = bundle.model_cfg
    if not (cfg.compute_dtype == "bfloat16" and cfg.sparse_keymatch
            and cfg.sparse_use_pallas_gemm):
        raise AssertionError(f"{what}: not the bf16 key-match network")
    plan = middle_plan(cfg, 17000)
    joins = sum(b.n_subm + 1 for b in plan)
    model_dir = tmp / "keymatch_bf16"
    with torch.enable_grad():
        for fn in KERNELS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with flags_in_modules() as seen:
            state = train_mod.train(config, model_dir,
                                    max_steps=HOST_RB_STEPS,
                                    display_step=HOST_RB_DISPLAY,
                                    device="cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr_launches = {n: fn.launches for n, fn in KERNELS.items()}
        expect_launches(f"{what} training", tr_launches, {
            k: v * HOST_RB_STEPS for k, v in {
                "keymatch_gemm_bf16": joins, "join_grad_weights": joins,
                "rulebook_hits": joins, "keymatch_rulebook": joins,
                "join_grad_features": joins - 1,
                "rulebook_inverse": joins - 1}.items()})
        if seen != {(False, False)}:
            raise AssertionError(f"{what} training: TF32 flags "
                                 f"{sorted(seen)}")
        windows = training_windows(model_dir, f"{what} training", card)
        _, loader = bundle.input_reader(training=True, seed=1)
        example = train_mod.to_device(next(iter(loader)), "cuda")
        step_fn = train_mod.make_train_step(train_mod.Bundle(config))
        step_calls = []
        with recording(middle, "keymatch_gemm", step_calls):
            step_fn(state, example)
        torch.cuda.synchronize()
        if len(step_calls) != joins:
            raise AssertionError(f"{what}: a step recorded "
                                 f"{len(step_calls)} joins, not {joins}")
        ev = cuda_ms(lambda: step_fn(state, example), iters=5, warmup=1)
        log(f"{what} training [{card}]: {HOST_RB_STEPS} steps of train() "
            f"(B=6) in {wall:.2f} s wall; device step (synchronised, "
            f"events) {fmt_range(ev)}; launches {tr_launches}")
    if sgg.rulebook_collisions("cuda"):
        raise AssertionError(f"{what}: a join's rulebook is not a "
                             f"convolution's")
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = evaluate(config, model_dir, device="cuda")
    ev_launches = {n: fn.launches for n, fn in KERNELS.items()}
    batches = -(-SYNTH_VAL // bundle.config["eval_input_reader"][
        "batch_size"])
    expect_launches(f"{what}: evaluate", ev_launches,
                    {"keymatch_gemm_bf16": joins * batches,
                     "rotated_iou": batches})
    log(f"{what} [{card}]: evaluate on the {SYNTH_VAL} validation frames "
        f"in {time.perf_counter() - t0:.1f} s; KITTI table (not held):\n"
        + result["result_str"])

    kw = dict(max_voxels=SECOND_MAX_VOXELS,
              max_points_per_voxel=SECOND_MAX_POINTS)
    pod = pod_inference_from_checkpoint(
        with_mixed_precision(SECOND_CONFIG, tmp), None, device="cuda",
        seed=SECOND_SEED, **kw)
    requests = [pad_batch([make_scene(s) for s in seeds])
                for seeds in SECOND_REQUESTS]
    splan = middle_plan(pod.cfg, SECOND_MAX_VOXELS)
    sjoins = sum(b.n_subm + 1 for b in splan[:len(splan) - pod.cfg
                                             .sparse_dense_tail_blocks])
    outs, lat, serve_launches, calls = drive(
        f"{what} serving", card, pod, requests, 1,
        {"keymatch_gemm_bf16": sjoins * len(requests), "rotated_iou": None})
    check_outputs(what, outs, pod)
    check_network_flags(f"{what} serving", pod, requests[0])
    heads = hold_bf16_heads(
        f"{what} serving", pod, f32_twin(pod, **kw), requests,
        [(middle, "keymatch_gemm", plain_keymatch)],
        [(middle, "keymatch_gemm", plain_keymatch_reversed)], card)
    total, _ = device_ms(lambda: pod(*requests[2]), iters=5)
    log(f"{what} serving [{card}]: median latency {np.median(lat):.3f} ms; "
        f"device time of one request {total} ms (torch.profiler)")
    report = {"train_wall_s": wall, "loss_windows": [w["loss"]
                                                     for w in windows],
              "device_step_ms": ev, "latency_ms": float(np.median(lat)),
              "request_device_ms": total, "heads": heads}
    return {"launches": {"bf16 key-match training": tr_launches,
                         "bf16 key-match evaluate": ev_launches,
                         "bf16 key-match serving": serve_launches},
            "calls": calls["keymatch_gemm"], "step_calls": step_calls,
            "report": report, "pod": pod, "requests": requests,
            "step": lambda: step_fn(state, example)}


def host_rulebook_phases(card: str, tmp: Path, car: Path, mc: Path,
                         fp32_pod) -> dict:
    """The three configs of this path, on the clones of the KITTI phases."""
    out = {}
    for name, fn, root in (("people", people_fhd, mc),
                           ("lite", car_lite, car)):
        (tmp / name).mkdir()
        out[name] = fn(card, tmp / name, root)
    (tmp / "mixed").mkdir()
    out["mixed"] = car_fhd_mixed(card, tmp / "mixed", car, fp32_pod)
    return out


def kitti_phases(card: str, fp32_pod) -> dict:
    """The KITTI phases in one temporary directory: on the car clone
    pointpillars/car trains through the command line and serves B = 8
    requests; on the multi-class clone pointpillars/all and all.fhd
    train; then the host-rulebook and bfloat16 SECOND configs
    (:func:`host_rulebook_phases`; ``fp32_pod``: car.fhd's float32
    serving pod, for the RPN's share beside bfloat16's) and bfloat16
    key-match SECOND on the car clone (:func:`mixed_keymatch`); the
    VoxelNet family on the car clone (:func:`voxelnet`).  ->
    {"serve", "pp", "pp_all", "all_fhd", "host", "mixed_km", "voxelnet"}."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        car, mc = tmp / "kitti", tmp / "kitti_mc"
        pp = train_pp_kitti(card, tmp, car)
        serve = serve_pp_kitti(card, car)
        vx = voxelnet(card, tmp, car)
        write_clone(mc, True, "multi-class KITTI", card)
        (tmp / "all").mkdir()
        pp_all = train_pp_all(card, tmp / "all", mc)
        all_fhd = train_all_fhd(card, tmp / "all", mc)
        host = host_rulebook_phases(card, tmp, car, mc, fp32_pod)
        (tmp / "keymatch_bf16").mkdir()
        mixed_km = mixed_keymatch(card, tmp / "keymatch_bf16", car)
    return {"serve": serve, "pp": pp, "pp_all": pp_all, "all_fhd": all_fhd,
            "host": host, "mixed_km": mixed_km, "voxelnet": vx}


def time_entries(phases, per_path, card: str) -> list:
    """Device time of every kernels-line entry: all of its functions (the
    kernel, its plain version, the library call; its backward and its
    other shapes under prefixed keys) in turns with each other
    (:func:`take_turns`), the events around each call without the sleep
    (``ev``) beside them under *_event_ms; launches by path.  -> the
    entries."""
    kernels = []
    for entry, fns, ev in phases:
        turns = take_turns(fns) if fns else {}
        for key, t in turns.items():
            entry[key] = t[0]
            entry["event_ms" if key == "ms"
                  else key[:-3] + "_event_ms"] = ev[key]
        entry.setdefault("in_turns_ms", {}).update(turns)
        if turns:
            log(f"{entry['name']} [{card}]: in turns, {K1_TURNS} calls of "
                f"each: " + "; ".join(f"{key} {fmt_range(t)}"
                                      for key, t in turns.items()))
        counter = entry.get("counter", entry["name"])
        entry["launches_by_path"] = {
            path: per_path[path][counter]
            for path in entry.pop("paths", per_path)}
        if "backward_counters" in entry:
            counters = entry.pop("backward_counters")
            entry["backward_launches_by_path"] = {
                path: {c: n[c] for c in counters} if len(counters) > 1
                else n[counters[0]] for path, n in per_path.items()}
        entry.setdefault("ms_from", "in turns with its plain version and "
                         "library call: CUDA events behind a GPU sleep, L2 "
                         "flushed")
        kernels.append(entry)
    return kernels


def kitti_launches(kitti: dict) -> dict:
    """Launches by path of the KITTI phases."""
    return {"pp-KITTI serving": kitti["serve"]["launches"],
            **kitti["pp"]["launches"], **kitti["pp_all"]["launches"],
            **kitti["all_fhd"]["launches"],
            **{path: n for phase in kitti["host"].values()
               for path, n in phase["launches"].items()},
            **kitti["mixed_km"]["launches"], **kitti["voxelnet"]["launches"]}


def profile_kitti(kitti: dict, card: str) -> None:
    serve = kitti["serve"]
    with torch.enable_grad():
        profile_call("pp-KITTI training step", kitti["pp"]["step"], card,
                     kitti["pp"]["report"]["device_step_ms"][0])
    profile_call("pp-KITTI serving (B=8)",
                 functools.partial(serve["pod"], *serve["requests"][2]),
                 card, serve["latency_ms"])
    host = kitti["host"]
    mixed = host["mixed"]
    with torch.enable_grad():
        for what, phase in (("people.fhd training step", host["people"]),
                            ("car.fhd.mixed training step", mixed)):
            profile_call(what, phase["step"], card,
                         phase["report"]["device_step_ms"][0])
    profile_call("car.fhd.mixed serving (bf16)",
                 functools.partial(mixed["pod"], *mixed["requests"][2]),
                 card, mixed["report"]["latency_ms"])
    km = kitti["mixed_km"]
    with torch.enable_grad():
        profile_call("bf16 key-match training step (car.fhd)", km["step"],
                     card, km["report"]["device_step_ms"][0])
    profile_call("bf16 key-match serving (car.fhd.serving)",
                 functools.partial(km["pod"], *km["requests"][2]), card,
                 km["report"]["latency_ms"])
    vx = kitti["voxelnet"]
    profile_call("voxelnet serving (car.voxelnet, B=2)",
                 functools.partial(vx["pod"], *vx["requests"][2]), card,
                 float(np.median(vx["latency_ms"])))


# --------------------------------------------------------------------------
# the VoxelNet family: the paper's VFE and the dense middle on K1
# --------------------------------------------------------------------------

def voxelnet_config(tmp: Path, root: Path) -> Path:
    """car.voxelnet.config on the clone at ``root``, both readers at B =
    VOXELNET_B; nothing else changes."""
    path = kitti_config(VOXELNET_CONFIG, tmp, root)
    text = path.read_text()
    if text.count("batch_size: 6") != 2:
        raise AssertionError("car.voxelnet.config: want two readers at B = 6")
    path.write_text(text.replace("batch_size: 6",
                                 f"batch_size: {VOXELNET_B}"))
    return path


def voxelnet_pod(config: Path, device: str, **variant) -> PodInference:
    """car.voxelnet.config (with ``variant``'s fields) at full width for
    serving, hard voxelization, weights drawn from VOXELNET_SEED."""
    model, cfg, anchors = build_from_config(config)
    if variant:
        cfg = dataclasses.replace(cfg, **variant)
        model = VoxelNet(cfg)
    load_seeded(model, VOXELNET_SEED)
    return PodInference(model, cfg, anchors, device=device,
                        max_voxels=VOXELNET_MAX_VOXELS,
                        max_points_per_voxel=VOXELNET_MAX_POINTS)


def hold_to_cpu(what: str, pod, request, out: dict, card: str) -> dict:
    """The card's heads and detections of ``request`` against the port's
    CPU run of the same weights (the plain versions, oneDNN): heads within
    HEAD_TOL, detections equal as sets.  -> the heads' max abs diff."""
    t0 = time.perf_counter()
    cpu_model = VoxelNet(pod.cfg)
    cpu_model.load_state_dict(pod.model.state_dict(), strict=True)
    cpu = PodInference(cpu_model, pod.cfg, pod.anchors.cpu().numpy(),
                       device="cpu", max_voxels=pod.max_voxels,
                       max_points_per_voxel=pod.max_points_per_voxel)
    heads_cpu = head_outputs(cpu, request)
    err, bad = heads_mismatch(head_outputs(pod, request), heads_cpu)
    if bad is not None:
        raise AssertionError(f"{what}: GPU vs CPU head {bad} differs: {err}")
    diff = detections_mismatch(out, cpu(*request), pod.cfg.num_class,
                               BOX_ATOL, SCORE_ATOL)
    if diff is not None:
        raise AssertionError(f"{what}, GPU vs CPU: {diff}")
    scores = {k: [round(float(q), 4) for q in torch.quantile(
        torch.sigmoid(v.flatten()[:1 << 20]), torch.tensor([0.5, 0.99, 1.0]))]
        for k, v in heads_cpu.items() if k == "cls_preds"}
    log(f"{what} [{card}]: heads within {HEAD_TOL} of the port's CPU run "
        f"(max abs diff {err}), {int(out['valid'].sum())} detections equal "
        f"as sets (boxes atol {BOX_ATOL}, scores atol {SCORE_ATOL}); class "
        f"logits' sigmoid at the 50/99/100th percentile {scores}; CPU run "
        f"{time.perf_counter() - t0:.1f} s")
    return err


def voxelnet(card: str, tmp: Path, root: Path) -> dict:
    """The voxelnet phase on the car clone at ``root``: train() of
    car.voxelnet.config (every counter set to 0 just before and read just
    after: K1 and its gather once a step), the loss falls; its device step
    with and without cuDNN's deterministic algorithms, in turns, and its
    peak memory; four B = 2 requests served (K1 and K2 each), the first
    held to the CPU run; one request of VOXELNET_VARIANT (K1 only: nearest
    NMS) held the same way; the dense K1's kernels-line entry.  ->
    {"launches", "report", "entry": (entry, fns, ev), "step"}."""
    what = "voxelnet"
    t_phase = time.perf_counter()
    config = voxelnet_config(tmp, root)
    model_dir = tmp / "voxelnet"
    report = {}
    with torch.enable_grad():
        zero_counts()
        t0 = time.perf_counter()
        with flags_in_modules() as seen:
            state = train_mod.train(config, model_dir,
                                    max_steps=VOXELNET_STEPS,
                                    display_step=VOXELNET_DISPLAY,
                                    device="cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train_launches = launch_counts()
        expect_launches(f"{what} training", train_launches,
                        {"pillar_scatter": VOXELNET_STEPS,
                         "pillar_gather": VOXELNET_STEPS})
        if seen != {(False, False)} or state.step != VOXELNET_STEPS:
            raise AssertionError(f"{what} training: {state.step} steps, TF32 "
                                 f"flags {sorted(seen)}")
        log(f"{what} training [{card}]: {VOXELNET_STEPS} steps of train() "
            f"(B = {VOXELNET_B}, SGD with momentum, the sampler) in "
            f"{wall:.2f} s wall; launches {train_launches}")
        windows = training_windows(model_dir, f"{what} training", card)

        # the device step, deterministic (the trainer's) and cuDNN's
        # default algorithms, in turns; peak memory of the first
        bundle = train_mod.Bundle(config)
        prep_ds, loader = bundle.input_reader(training=True, seed=1)
        stream = loader._index_stream()
        batch = batching.merge_batch([prep_ds.example(*next(stream))
                                      for _ in range(VOXELNET_B)])
        example = train_mod.to_device(batch, "cuda")
        step_fn = train_mod.make_train_step(bundle)
        st = train_mod.init_state(bundle, rng_seed=0,
                                  total_steps=VOXELNET_STEPS, device="cuda")
        gather_calls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with recording(pillar_scatter, "pillar_gather", gather_calls):
            step_fn(st, example)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()

        def default_algorithms():
            with substituted(train_mod, "fp32_math",
                             lambda deterministic=False: fp32_math()):
                step_fn(st, example)

        turns = take_turns({"deterministic": lambda: step_fn(st, example),
                            "default": default_algorithms},
                           turns=VOXELNET_STEP_TURNS)
        report.update(steps=VOXELNET_STEPS, wall_s=wall,
                      loss_windows=[w["loss"] for w in windows],
                      voxels=int(batch["voxels"].shape[1]),
                      device_step_ms=turns["deterministic"],
                      device_step_default_ms=turns["default"],
                      peak_bytes=peak, step_peak_bytes=peak - held)
        log(f"{what} training [{card}]: device step (B = {VOXELNET_B}, "
            f"V = {batch['voxels'].shape[1]}, {int(batch['num_voxels'].sum())}"
            f" voxels; in turns, {VOXELNET_STEP_TURNS} of each, ms "
            f"median/min/max) with cuDNN's deterministic algorithms "
            f"{fmt_range(turns['deterministic'])}, with its default ones "
            f"{fmt_range(turns['default'])}; peak memory during a step "
            f"{peak / 2 ** 30:.2f} GiB, of which the step's own (above the "
            f"{held / 2 ** 30:.2f} GiB the process held before it) "
            f"{(peak - held) / 2 ** 30:.2f} GiB")
        step = functools.partial(step_fn, st, example)

    # serving: four B = 2 requests, K1 and K2 each
    pod = voxelnet_pod(config, "cuda")
    requests = kitti_requests(root, VOXELNET_REQUESTS, VOXELNET_B)
    k1_calls = []
    with recording(middle, "scatter_sorted_to_canvas", k1_calls):
        pod(*requests[0])
    torch.cuda.synchronize()
    outs, lat, serve_launches, _ = drive(
        f"{what} serving", card, pod, requests, 1,
        {"pillar_scatter": VOXELNET_REQUESTS, "rotated_iou": None})
    check_outputs(f"{what} serving", outs, pod)
    report.update(latency_ms=lat,
                  detections=[o["valid"].sum(-1).tolist() for o in outs])
    report["head_err"] = hold_to_cpu(f"{what} serving, request 0", pod,
                                     requests[0], outs[0], card)
    check_network_flags(f"{what} serving", pod, requests[0])

    # the variant: nearest NMS, the yaw-quality head, softmax scores
    vpod = voxelnet_pod(config, "cuda", **VOXELNET_VARIANT)
    vpod(*requests[1])
    torch.cuda.synchronize()
    zero_counts()
    vout = vpod(*requests[1])
    variant_launches = launch_counts()
    expect_launches(f"{what} variant", variant_launches,
                    {"pillar_scatter": 1})
    check_outputs(f"{what} variant", [vout], vpod)
    heads = head_outputs(vpod, requests[1])
    if set(heads) != {"box_preds", "cls_preds", "dir_cls_preds",
                      "quality_preds"}:
        raise AssertionError(f"{what} variant: heads {sorted(heads)}")
    report["variant_head_err"] = hold_to_cpu(
        f"{what} variant {VOXELNET_VARIANT}", vpod, requests[1], vout, card)
    del vpod

    (feats, lin, hw), _ = k1_calls[0]
    B, V, C = feats.shape
    D, H, W = pod.model.middle_feature_extractor.grid_dhw
    if hw != D * H * W or pillar_scatter.scatter_plan(
            B, V, hw, C * 4 // 16, pillar_scatter.sm_count(
                feats.device)).route != "rows":
        raise AssertionError(f"{what}: K1 at hw = {hw}, not the rows route "
                             f"of the {D} x {H} x {W} canvas")
    launches = {"voxelnet training": train_launches,
                "voxelnet serving": serve_launches,
                "voxelnet variant": variant_launches}
    entry, fns, ev = k1_forward(k1_calls[0], card, "dense VoxelNet canvas")
    fields, bfns, bev = k1_backward(gather_calls[0], card,
                                    "dense VoxelNet training")
    fns.update(bfns)
    ev.update(bev)
    entry.update(fields, name="pillar_scatter@voxelnet",
                 counter="pillar_scatter", paths=list(launches),
                 launches=sum(n["pillar_scatter"] for n in launches.values()),
                 backward_launches=sum(n["pillar_gather"]
                                       for n in launches.values()))
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"{what} [{card}]: phase in {report['phase_s']:.1f} s; " +
        json.dumps({k: v for k, v in report.items()
                    if k not in ("loss_windows",)}))
    return {"launches": launches, "report": report,
            "entry": (entry, fns, ev), "step": step,
            "pod": pod, "requests": requests, "latency_ms": lat}


# --------------------------------------------------------------------------
# multi-device: data parallelism over two ranks on one card
# --------------------------------------------------------------------------

def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def canvas_scan() -> tuple:
    """A building floor of DP_CANVAS_POINTS points: synthetic scans (16 m
    rooms) side by side, DP_CANVAS_COLUMNS to a row, cut to the count,
    shard-major over DP_RANKS shards with the last one's tail padding.
    -> (points [P, 4], num_valid_per_shard, canvas kwargs)."""
    nx = DP_CANVAS_COLUMNS
    parts, n = [], 0
    while n < DP_CANVAS_POINTS:
        i = len(parts)
        p = generate_building_scene(5000 + i)["points"].copy()
        p[:, 0] += 16.0 * (i % nx)
        p[:, 1] += 16.0 * (i // nx)
        parts.append(p)
        n += len(p)
    ny = -(-len(parts) // nx)
    pts = np.concatenate(parts)[:DP_CANVAS_POINTS].astype(np.float32)
    per = DP_CANVAS_POINTS // DP_RANKS
    nv = np.full(DP_RANKS, per, np.int32)
    nv[-1] = per * 7 // 10
    kw = dict(voxel_size=(0.1, 0.1, 3.6),
              pc_range=(0.0, 0.0, -0.2, 16.0 * nx, 16.0 * ny, 3.4),
              grid_hw=(160 * ny, 160 * nx))
    return pts, nv, kw


def dp_rank(mesh, second_config: str, second_batch: dict,
            pillar_batch: dict) -> dict:
    """The body of each rank (sub-phases b-e, and the timed steps): every
    kernel counter set to 0 before each sub-phase and read after it, the
    plain versions' calls counted throughout.  -> rank 0's results, with
    every rank's counts."""
    plain = {f"{m.__name__.rsplit('.', 1)[-1]}.{a}": [] for m, a in
             PLAIN_VERSIONS}
    out, mine = {}, {}
    with contextlib.ExitStack() as stack:
        for (module, attr), calls in zip(PLAIN_VERSIONS, plain.values()):
            stack.enter_context(recording(module, attr, calls))
        with torch.enable_grad():
            out["second"], mine["second step"] = dp_second_step(
                mesh, second_config, second_batch)
            out["pillar_grads"], out["pillar_step_ms"] = dp_pillar_step(
                mesh, pillar_batch)
        out["evaluate"], mine["evaluate"] = dp_evaluate(mesh)
        out["serve"], mine["serving"] = dp_serve(mesh)
        out["canvas"] = dp_canvas(mesh)
    report = {"launches": mine,
              "plain": {k: len(v) for k, v in plain.items()},
              "device": str(mesh.device),
              "pillar_step_ms": out["pillar_step_ms"],
              "second_step_ms": out["second"].pop("step_ms")}
    out["ranks"] = mesh_mod.gather_objects(report, mesh)
    return out if mesh.is_main else None


def dp_second_step(mesh, config: str, batch: dict) -> tuple:
    """(b) One car.fhd step over the ranks from the seeded weights of
    ``train()``: the gradients of the joined batch (summed over the
    ranks), the state after ``make_train_step``, the loss; then the step
    timed on each rank.  -> (results on rank 0, this rank's counts)."""
    bundle = train_mod.Bundle(config)
    state = train_mod.init_state(bundle, rng_seed=0,
                                 total_steps=SECOND_TRAIN_STEPS,
                                 device=mesh.device)
    example = train_mod.to_device(mesh_mod.shard_batch(batch, mesh),
                                  mesh.device)
    model = state.model.train()
    voxelnet_mod.set_batch_norm_group(model, mesh.group)
    saved = copy.deepcopy(model.state_dict())
    zero_counts()
    _, _, grads = train_mod.loss_and_grads(model, example, bundle.model_cfg,
                                           mesh)
    model.load_state_dict(saved)
    step = train_mod.make_train_step(bundle, mesh)
    metrics = step(state, example)
    torch.cuda.synchronize()
    counts = launch_counts()
    res = {"grads": {n: g.cpu().clone() for (n, _), g in
                     zip(model.named_parameters(), grads)},
           "state": {k: v.cpu().clone()
                     for k, v in model.state_dict().items()},
           "loss": float(metrics["loss"]), "num_pos": int(metrics["num_pos"])}
    res["step_ms"] = cuda_ms(lambda: step(state, example), iters=5, warmup=1)
    return res, counts


def dp_pillar_step(mesh, batch: dict) -> tuple:
    """The first pillar training step of ``train()`` over the ranks: its
    gradients (of the joined batch, for (a)'s check), then the step timed
    on each rank (events).  -> (gradients on the host, event ms)."""
    bundle = train_mod.Bundle(CONFIG)
    state = train_mod.init_state(bundle, rng_seed=0, total_steps=1,
                                 device=mesh.device)
    example = train_mod.to_device(mesh_mod.shard_batch(batch, mesh),
                                  mesh.device)
    step = train_mod.make_train_step(bundle, mesh)
    _, _, grads = train_mod.loss_and_grads(state.model.train(), example,
                                           bundle.model_cfg, mesh)
    grads = {n: g.cpu().clone() for (n, _), g in
             zip(state.model.named_parameters(), grads)}
    return grads, cuda_ms(lambda: step(state, example), iters=10, warmup=2)


def dp_evaluate(mesh) -> tuple:
    """(c) ``evaluate(num_devices=2)`` in place on each rank (as under
    torchrun) with the trained checkpoint over the 32 val scenes; the
    detections handed to the dataset's AP recorded on rank 0."""
    calls = []
    zero_counts()
    t0 = time.perf_counter()
    with recording(building.BuildingDataset, "evaluation", calls):
        result = evaluate(CONFIG, CHECKPOINT, device=mesh.device,
                          num_devices=DP_RANKS, devices=DP_DEVICES)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    dets = calls[0][0][1] if mesh.is_main else None
    return {"result": result, "detections": dets, "wall_s": wall}, counts


def dp_serve(mesh) -> tuple:
    """(d) Sharded serving: the pillar pod (trained checkpoint) and the
    car.fhd.serving pod (seeded weights) with ``mesh``, each rank called
    with the whole request."""
    zero_counts()
    pod = pod_inference_from_checkpoint(
        CONFIG, CHECKPOINT, mesh=mesh, max_voxels=MAX_VOXELS,
        max_points_per_voxel=MAX_POINTS)
    pillar = [pod(*pad_batch([generate_building_scene(s) for s in seeds]))
              for seeds in REQUESTS]
    spod = pod_inference_from_checkpoint(
        SECOND_CONFIG, None, mesh=mesh, seed=SECOND_SEED,
        max_voxels=SECOND_MAX_VOXELS, max_points_per_voxel=SECOND_MAX_POINTS)
    second = [spod(*pad_batch([make_scene(s) for s in seeds]))
              for seeds in SECOND_REQUESTS]
    torch.cuda.synchronize()
    return {"pillar": pillar, "second": second}, launch_counts()


def dp_canvas(mesh) -> dict:
    """(e) The sharded mean canvas of the building floor."""
    pts, nv, kw = canvas_scan()
    fn = sharded_voxelize.make_sharded_mean_canvas(mesh, **kw)
    fn(pts, nv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean, counts = fn(pts, nv)
    torch.cuda.synchronize()
    return {"mean": mean.cpu(), "counts": counts.cpu(),
            "wall_ms": (time.perf_counter() - t0) * 1e3}


@contextlib.contextmanager
def counts_hook(tmp: Path):
    """Child processes started inside the block (the ranks of
    ``train(num_devices=2)``) load COUNTS_HOOK, which writes each one's
    launch counts and the TF32 flags its modules saw into
    ``tmp/counts.<pid>.json`` at exit.  -> a function that reads the
    files of the processes that ran the port."""
    hook = tmp / "counts_hook"
    hook.mkdir(parents=True, exist_ok=True)
    (hook / "sitecustomize.py").write_text(COUNTS_HOOK)
    env = {"PYTHONPATH": os.pathsep.join(
               [str(hook), str(ROOT)] + ([os.environ["PYTHONPATH"]]
                                         if os.environ.get("PYTHONPATH")
                                         else [])),
           "ABR_LAUNCH_COUNTS": str(tmp / "counts.{pid}.json"),
           "ABR_KERNEL_WRAPPERS": json.dumps(
               {n: (fn.__module__, fn.__name__)
                for n, fn in KERNELS.items()})}
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def read():
        return [json.loads(p.read_text())
                for p in sorted(tmp.glob("counts.*.json"))]

    try:
        yield read
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def train_losses(model_dir: Path) -> list:
    """The loss of each step of a ``display_step=1`` run."""
    return [w["loss"] for w in
            (json.loads(x) for x in
             (model_dir / "metrics.jsonl").read_text().splitlines())
            if w["prefix"] == "train"]


def beyond(got: dict, want: dict, tol: dict) -> tuple:
    """Floating entries of two state dicts: (elements outside ``tol``,
    the L2 norm of the difference)."""
    n, sq = 0, 0.0
    for k, w in want.items():
        if w.is_floating_point():
            n += int((~torch.isclose(got[k], w, **tol)).sum())
            sq += float(((got[k] - w).double() ** 2).sum())
    return n, sq ** 0.5


def dp_train(tmp: Path, name: str, steps: int, read_counts=None) -> tuple:
    """``train(num_devices=2)`` of CONFIG for ``steps`` steps into
    ``tmp/name``, its ranks' launch counts read through the counts hook.
    -> (state, losses, rank counts, wall s)."""
    t0 = time.perf_counter()
    with counts_hook(tmp / f"{name}_counts") as read:
        state = train_mod.train(CONFIG, tmp / name, max_steps=steps,
                                display_step=1, num_devices=DP_RANKS,
                                devices=DP_DEVICES)
        ranks = read()
    return (state, train_losses(tmp / name), ranks,
            time.perf_counter() - t0)


def one_train(tmp: Path, name: str, steps: int, flip: bool = False):
    """``train()`` of CONFIG in one process; ``flip``: every batch's rows
    reversed (the control: the same examples, every sum over them in
    another order).  -> (state, losses)."""
    with contextlib.ExitStack() as stack:
        if flip:
            to_dev = train_mod.to_device
            stack.enter_context(substituted(
                train_mod, "to_device", lambda b, d: {
                    k: v.flip(0) for k, v in to_dev(b, d).items()}))
        state = train_mod.train(CONFIG, tmp / name, max_steps=steps,
                                display_step=1, device="cuda")
    return state, train_losses(tmp / name)


def dp_train_pillars(card: str, tmp: Path, g_dp: dict) -> dict:
    """(a) ``train(num_devices=2)`` (it starts its ranks itself) against
    ``train()`` from the same seed and batches.  One step: the loss
    within DP_LOSS_RTOL, the parameters and BatchNorm statistics within
    DP_PARAM_TOL where the element's gradient is not near zero and the
    two float32 gradients of the first batch (``g_dp``: the ranks', from
    :func:`dp_pillar_step`) agree, as train_step_mismatch holds the
    card's step against the CPU's; elsewhere within 2 * lr.  After
    DP_TRAIN_STEPS steps: ``train()`` run again gives its parameters and
    losses bit for bit (the training step runs cuDNN's deterministic
    algorithms), and the DP run, whose sums go over the ranks in gloo's
    order, is held within CONTROL_MARGIN x the distance of ``train()`` on
    the same batches with their rows reversed (the part of its distance
    that another reduction order explains: Adam's first steps move every
    near-zero-gradient element by about lr either way)."""
    with torch.enable_grad():
        dp1, dl1, ranks1, wall1 = dp_train(tmp, "dp1", 1)
        one1, ol1 = one_train(tmp, "one1", 1)
        dp, dl, ranks, wall = dp_train(tmp, "dp", DP_TRAIN_STEPS)
        one, ol = one_train(tmp, "one", DP_TRAIN_STEPS)
        controls = [one_train(tmp, "flip", DP_TRAIN_STEPS, flip=True),
                    one_train(tmp, "again", DP_TRAIN_STEPS)]
    for steps, rs in ((1, ranks1), (DP_TRAIN_STEPS, ranks)):
        if len(rs) != DP_RANKS:
            raise AssertionError(f"dp training: {len(rs)} rank processes "
                                 f"reported launch counts")
        for r in rs:
            expect_launches("dp training: a rank", r["launches"],
                            {"pillar_scatter": steps,
                             "pillar_gather": steps})
            if {tuple(f) for f in r["tf32_seen"]} != {(False, False)}:
                raise AssertionError(f"dp training: a rank's modules saw "
                                     f"TF32 flags {r['tf32_seen']}")
    for d in ("dp1", "dp"):
        text = (tmp / d / "log.txt").read_text()
        if text.count("training finished at step") != 1:
            raise AssertionError(f"dp training: {d}/log.txt not written once")

    # one step: the DP limits, where the float32 gradients disagree 2 * lr
    rel1 = abs(dl1[0] - ol1[0]) / abs(ol1[0])
    if not (len(dl1) == 1 and rel1 <= DP_LOSS_RTOL):
        raise AssertionError(f"dp training, one step: loss {dl1} vs {ol1}")
    bundle = train_mod.Bundle(CONFIG)
    _, loader = bundle.input_reader(training=True, seed=0)
    batch = next(iter(loader))
    state0 = train_mod.init_state(bundle, rng_seed=0, total_steps=1,
                                  device="cuda")
    _, g0 = step_grads(bundle, state0, train_mod.to_device(batch, "cuda"))
    lr = state0.schedule(0)
    got, ref = dp1.model.state_dict(), one1.model.state_dict()
    excused, worst = 0, 0.0
    for n, w in ref.items():
        g = got[n]
        if not w.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f"dp training: {n} {g} vs {w}")
            continue
        share = ((g - w).abs()
                 / (DP_PARAM_TOL["atol"] + DP_PARAM_TOL["rtol"] * w.abs()))
        noise = torch.zeros_like(share, dtype=torch.bool)
        if n in g0:
            go = g0[n]
            noise = (((g_dp[n] - go).abs() > TRAIN_G_AGREE * go.abs())
                     | (go.abs() < TRAIN_G_NOISE * go.abs().max())).to(
                         g.device)
            excused += int((noise & (share > 1)).sum())
        held = share[~noise]
        worst = max(worst, float(held.max()) if held.numel() else 0.0)
        if not (bool((held <= 1).all())
                and bool(((g - w).abs()[noise] <= 2 * lr * 1.01).all())):
            raise AssertionError(
                f"dp training: {n} after one step, max abs diff "
                f"{float((g - w).abs().max())}")
    log(f"multi_device (a) [{card}]: train(num_devices={DP_RANKS}, devices="
        f"{DP_DEVICES}), one step, in {wall1:.1f} s wall (ranks started, "
        f"the final state restored): each rank launched "
        f"{ {k: v for k, v in ranks1[0]['launches'].items() if v} } with "
        f"TF32 off; loss {dl1[0]} vs train()'s {ol1[0]} (rel {rel1:.3g}); "
        f"parameters and BatchNorm statistics within {DP_PARAM_TOL} "
        f"(worst {worst:.3g} of it) but {excused} elements whose float32 "
        f"gradients (ranks', one process's) differ by more than "
        f"{TRAIN_G_AGREE} of |g| or lie below {TRAIN_G_NOISE} * max|g|, "
        f"each within 2 * lr")

    # DP_TRAIN_STEPS steps: train() again equal bit for bit; the DP run
    # within CONTROL_MARGIN x the rows-reversed control's distance
    # (elements outside DP_PARAM_TOL, L2 norm), the part of it that the
    # reduction order explains; the losses printed beside the controls'
    ref = one.model.state_dict()
    (flip, fl), (again, al) = controls
    again_sd = again.model.state_dict()
    unequal = [k for k, v in ref.items() if not torch.equal(again_sd[k], v)]
    if unequal or al != ol:
        raise AssertionError(f"train() twice from one seed and one batch "
                             f"stream: {len(unequal)} tensors differ "
                             f"(first {unequal[:3]}), losses {al} vs {ol}")
    n_dp, l2_dp = beyond(dp.model.state_dict(), ref, DP_PARAM_TOL)
    n_fl, l2_fl = beyond(flip.model.state_dict(), ref, DP_PARAM_TOL)
    rel = [abs(a - b) / abs(b) for a, b in zip(dl, ol)]
    frel = [abs(a - b) / abs(b) for a, b in zip(fl, ol)]
    log(f"multi_device (a) [{card}]: {DP_TRAIN_STEPS} steps in {wall:.1f} s "
        f"wall: train() again equals train() bit for bit (all "
        f"{len(ref)} tensors, losses {ol}); the DP run's losses {dl} (rel "
        f"{rel}), {n_dp} elements outside {DP_PARAM_TOL} (L2 {l2_dp:.4g}); "
        f"the part the reduction order explains, train() on the rows "
        f"reversed: losses rel {frel}, {n_fl} elements (L2 {l2_fl:.4g}); "
        f"held within {CONTROL_MARGIN} x that")
    if not (len(dl) == DP_TRAIN_STEPS
            and n_dp <= CONTROL_MARGIN * n_fl
            and l2_dp <= CONTROL_MARGIN * l2_fl):
        raise AssertionError(f"dp training: {DP_TRAIN_STEPS} steps lie "
                             f"farther from train() than the rows-reversed "
                             f"control")
    return {"launches": {n: sum(r["launches"][n] for r in ranks1 + ranks)
                         for n in KERNELS},
            "wall_s": wall, "excused": excused,
            "losses": [dl, ol] + [cl for _, cl in controls],
            "beyond": [n_dp, n_fl, 0]}


def second_reference(config: Path, batch: dict) -> dict:
    """(b)'s one-process car.fhd step on the joined batch (its gradients
    the same bits when computed again), and the gradients of two
    controls: the same batch with its rows reversed and rolled by one
    (the same examples, every sum over them in another order: the part
    of the DP step's distance that gloo's reduction order explains)."""
    bundle = train_mod.Bundle(config)
    state = train_mod.init_state(bundle, rng_seed=0,
                                 total_steps=SECOND_TRAIN_STEPS,
                                 device="cuda")
    example = train_mod.to_device(batch, "cuda")
    model = state.model.train()
    saved = copy.deepcopy(model.state_dict())
    names = [n for n, _ in model.named_parameters()]
    out = {"controls": []}
    with torch.enable_grad():
        for order in (lambda v: v.flip(0), lambda v: v.roll(1, 0)):
            _, _, grads = train_mod.loss_and_grads(
                model, {k: order(v) for k, v in example.items()},
                bundle.model_cfg)
            out["controls"].append({n: g.cpu() for n, g in zip(names,
                                                               grads)})
            model.load_state_dict(saved)
        _, _, grads = train_mod.loss_and_grads(model, example,
                                               bundle.model_cfg)
        model.load_state_dict(saved)
        _, _, again = train_mod.loss_and_grads(model, example,
                                               bundle.model_cfg)
        model.load_state_dict(saved)
        if not all(torch.equal(a, g) for a, g in zip(again, grads)):
            raise AssertionError("dp second: the one-process step's "
                                 "gradients differ run to run")
        metrics = train_mod.make_train_step(bundle)(state, example)
    out.update(grads={n: g.cpu() for n, g in zip(names, grads)},
               state={k: v.cpu() for k, v in model.state_dict().items()},
               loss=float(metrics["loss"]), num_pos=int(metrics["num_pos"]))
    return out


def grad_distance(got: dict, ref: dict) -> tuple:
    """Over the tensors of two gradient dicts: (the median of each one's
    max |diff| / max |g|, the worst relative L2 distance)."""
    share, l2 = [], []
    for n, w in ref.items():
        d = got[n].double() - w.double()
        if not float(w.abs().max()) > 0:
            raise AssertionError(f"gradient of {n} is zero")
        share.append(float(d.abs().max() / w.abs().max()))
        l2.append(float(d.norm() / w.double().norm()))
    return float(np.median(share)), max(l2), max(share)


def check_dp_second(got: dict, ref: dict, card: str) -> None:
    """The DP step's loss within DP_LOSS_RTOL and the middle's running
    statistics within DP_STATS_SHARE of their max |x|.  Its gradients lie
    as far from the one-process step's as float32 allows: at B = 6 the
    one-process step moves by 3e-3 of max |g| (median tensor) when only
    the order of the rows changes (an H100 80GB HBM3 at 700 W, PERF.md),
    so the median tensor's max-share and the worst tensor's relative L2
    distance are held within CONTROL_MARGIN x the larger of the two
    controls' (:func:`second_reference`)."""
    median, l2, worst = grad_distance(got["grads"], ref["grads"])
    ctrl = [grad_distance(c, ref["grads"]) for c in ref["controls"]]
    c_median, c_l2 = max(c[0] for c in ctrl), max(c[1] for c in ctrl)
    stats = {}
    for n, w in ref["state"].items():
        if n.startswith("middle_feature_extractor") and "running" in n:
            stats[n] = (float((got["state"][n] - w).abs().max())
                        / float(w.abs().max()))
    rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    log(f"multi_device (b) [{card}]: car.fhd step at B = 6 over "
        f"{DP_RANKS} ranks vs one process: loss {got['loss']} vs "
        f"{ref['loss']} (rel {rel:.3g}), num_pos {got['num_pos']} vs "
        f"{ref['num_pos']}; gradients: median tensor {median:.3g} of its "
        f"max |g|, worst {worst:.3g}, worst relative L2 {l2:.3g}; the "
        f"controls (rows reversed, rolled) "
        + ", ".join(f"{c[0]:.3g} / {c[2]:.3g} / {c[1]:.3g}" for c in ctrl)
        + f" (limits {CONTROL_MARGIN} x the larger; the float32-vs-float64 "
        f"limits of the B = 2 step, {SECOND_GRAD_MEDIAN_SHARE} / "
        f"{SECOND_GRAD_SHARE}, are below the controls'); the middle's "
        f"{len(stats)} running statistics worst {max(stats.values()):.3g} "
        f"of max |x| (limit {DP_STATS_SHARE})")
    if not (median <= CONTROL_MARGIN * c_median
            and l2 <= CONTROL_MARGIN * c_l2
            and max(stats.values()) <= DP_STATS_SHARE
            and rel <= DP_LOSS_RTOL and got["num_pos"] == ref["num_pos"]
            and len(stats) > 0):
        raise AssertionError("dp second: the step differs from the "
                             "one-process step")


def check_dp_evaluate(got: dict, ref: dict, num_class: int,
                      card: str) -> None:
    res, want = got["result"], ref["result"]
    if sorted(res) != sorted(want):
        raise AssertionError(f"dp evaluate: keys {sorted(res)}")
    worst = 0.0
    for k, w in want.items():
        if k.endswith("num_gt"):
            if res[k] != w:
                raise AssertionError(f"dp evaluate: {k} {res[k]} != {w}")
            continue
        worst = max(worst, abs(res[k] - w))
    if not worst <= DP_AP_ATOL:
        raise AssertionError(f"dp evaluate: AP {res} vs one device {want}")
    dets, wdets = got["detections"], ref["detections"]
    if len(dets) != len(wdets):
        raise AssertionError(f"dp evaluate: {len(dets)} scenes vs "
                             f"{len(wdets)}")

    def padded(d):
        return {"box3d_lidar": d["box3d_lidar"][None],
                "scores": d["scores"][None],
                "label_preds": d["label_preds"][None],
                "valid": np.ones((1, len(d["scores"])), bool)}

    for i, (d, w) in enumerate(zip(dets, wdets)):
        diff = detections_mismatch(padded(d), padded(w), num_class,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"dp evaluate, scene {i}: {diff}")
    log(f"multi_device (c) [{card}]: evaluate(num_devices={DP_RANKS}) over "
        f"the 32 val scenes in {got['wall_s']:.1f} s: the detections of "
        f"every scene equal one device's as sets (boxes atol {BOX_ATOL}, "
        f"scores atol {SCORE_ATOL}), every AP within {DP_AP_ATOL} (largest "
        f"difference {worst:.3g})")


def multi_device(card: str, pod, requests, second: dict, ev_ref: dict,
                 training: dict, second_training: dict) -> dict:
    """The multi_device phase: data parallelism over DP_RANKS ranks that
    share the card (gloo).  One spawn of ranks for (b) a car.fhd step at
    B = 6, (c) ``evaluate(num_devices=2)``, (d) sharded serving and (e)
    the sharded mean canvas (and the first pillar step's gradients and
    step times); then (a) pillar training through
    ``train(num_devices=2)``; each held to its one-process run here.  Every rank must launch the path's kernels and no plain
    version.  -> {"launches": {path: summed counts}}."""
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "kitti"
        write_clone(root, False, "multi_device", card)
        config = kitti_config(SECOND_TRAIN_CONFIG, tmp, root)
        # the first batch of the sequential loader (seed 0): the same
        # batch, sampler draws included, run after run (the threaded
        # loader's sampler draws in thread-timing order)
        second_batch = batching.device_example(
            sequential_batches(config, 1)[0])
        # the first batch of train() (seed 0)
        pbundle = train_mod.Bundle(CONFIG)
        _, ploader = pbundle.input_reader(training=True, seed=0)
        pillar_batch = batching.device_example(next(iter(ploader)))
        B = len(second_batch["voxels"])
        if B != 6:
            raise AssertionError(f"car.fhd batch of {B}")
        t0 = time.perf_counter()
        got = launch.spawn(dp_rank, DP_RANKS, DP_DEVICES,
                           args=(str(config), second_batch, pillar_batch),
                           timeout=DP_TIMEOUT)
        log(f"multi_device [{card}]: one spawn of {DP_RANKS} ranks on "
            f"{DP_DEVICES} ran (b)-(e) in {time.perf_counter() - t0:.1f} s")
        check_dp_second(got["second"], second_reference(config,
                                                        second_batch), card)
        a = dp_train_pillars(card, tmp, got["pillar_grads"])
    check_dp_evaluate(got["evaluate"], ev_ref, pod.cfg.num_class, card)
    for what, ref_pod, reqs, outs in (
            ("pillar", pod, requests, got["serve"]["pillar"]),
            ("second", second["pod"], second["requests"],
             got["serve"]["second"])):
        for i, (req, o) in enumerate(zip(reqs, outs)):
            diff = detections_mismatch(o, ref_pod(*req), ref_pod.cfg.num_class,
                                       BOX_ATOL, SCORE_ATOL)
            if diff is not None:
                raise AssertionError(f"dp {what} serving, request {i}: "
                                     f"{diff}")
    log(f"multi_device (d) [{card}]: sharded serving equals the unsharded "
        f"pods on {len(requests)} pillar and {len(second['requests'])} "
        f"car.fhd.serving requests (B = 2, one scan a rank)")
    pts, nv, kw = canvas_scan()
    mask = np.zeros(len(pts), bool)
    per = len(pts) // DP_RANKS
    for d in range(DP_RANKS):
        mask[d * per:d * per + nv[d]] = True
    omean, ocnt = sharded_voxelize.single_device_mean_canvas(
        torch.as_tensor(pts[mask], device=pod.device), int(mask.sum()),
        **kw)
    cv = got["canvas"]
    if not (torch.equal(cv["counts"], ocnt.cpu())
            and torch.allclose(cv["mean"], omean.cpu(), **DP_CANVAS_TOL)
            and float(ocnt.sum()) > 0):
        raise AssertionError("dp canvas: differs from the one-device oracle")
    log(f"multi_device (e) [{card}]: sharded mean canvas of "
        f"{DP_CANVAS_POINTS} points ({int(mask.sum())} valid, grid "
        f"{kw['grid_hw']}, {int((ocnt > 0).sum())} occupied cells) over "
        f"{DP_RANKS} ranks in {cv['wall_ms']:.1f} ms wall (rank 0): counts "
        f"equal the oracle's, means within {DP_CANVAS_TOL}")

    # every rank: the path's kernels launched, no plain version called
    expect = {"second step": ("keymatch_gemm", "keymatch_rulebook",
                              "rulebook_hits", "join_grad_weights",
                              "rulebook_inverse", "join_grad_features"),
              "evaluate": ("pillar_scatter", "rotated_iou"),
              "serving": ("pillar_scatter", "keymatch_gemm", "rotated_iou")}
    for r, rank in enumerate(got["ranks"]):
        if rank["device"] != DP_DEVICES[r] or any(rank["plain"].values()):
            raise AssertionError(f"rank {r} on {rank['device']} called plain "
                                 f"versions {rank['plain']}")
        for path, names in expect.items():
            expect_some_launches(f"rank {r}, {path}",
                                 rank["launches"][path], names)
        log(f"multi_device [{card}]: rank {r} launched "
            + json.dumps({p: {n: c for n, c in v.items() if c}
                          for p, v in rank["launches"].items()})
            + f"; plain versions called {sum(rank['plain'].values())} times")
    one_p = training["report"]["device_step_ms"]
    one_s = second_training["report"]["device_step_ms"]
    log(f"multi_device [{card}]: device ms of a training step (events; "
        f"{DP_RANKS} ranks time-share one card over gloo, which stages every "
        f"collective through the host, so these numbers say nothing about "
        f"scaling): pillar B = 2 one process {fmt_range(one_p)}, per rank "
        + ", ".join(fmt_range(r["pillar_step_ms"]) for r in got["ranks"])
        + f"; car.fhd B = 6 one process {fmt_range(one_s)}, per rank "
        + ", ".join(fmt_range(r["second_step_ms"]) for r in got["ranks"]))
    out["launches"] = {
        "dp pillar training": a["launches"],
        **{f"dp {p}": {n: sum(r["launches"][p][n] for r in got["ranks"])
                       for n in KERNELS} for p in expect}}
    out["report"] = {
        "pillar_step_ms": [r["pillar_step_ms"] for r in got["ranks"]],
        "second_step_ms": [r["second_step_ms"] for r in got["ranks"]],
        "one_process_pillar_step_ms": one_p,
        "one_process_second_step_ms": one_s,
        "dp_train_wall_s": a["wall_s"], "excused": a["excused"],
        "evaluate_wall_s": got["evaluate"]["wall_s"],
        "canvas_wall_ms": cv["wall_ms"]}
    return out


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
        exported = export_phase(card, pod, requests, second)
        ev_launches, ev_ref = run_evaluate(card)
        tail = asbuilt(card)
        training = train_pillars(card)
        mixed_pp = mixed_pillars(card, pod, latency_ms)
        second_training = train_second(card)
        multi = multi_device(card, pod, requests, second, ev_ref, training,
                             second_training)
        kitti = kitti_phases(card, second["pod"])
        km, gg = second["km_launches"], second["gg_launches"]
        fm, dyn = second["fm_launches"], second["dyn_launches"]
        per_path = {"pillar serving": launches, "evaluate": ev_launches,
                    "second key-match": km, "second gather-GEMM": gg,
                    "second fused_mean": fm, "second dynamic": dyn,
                    "pillar training": training["launches"],
                    "second training": second_training["launches"],
                    **mixed_pp["launches"], **kitti_launches(kitti),
                    **multi["launches"], **exported["launches"],
                    **tail["launches"]}
        total = {name: sum(p[name] for p in per_path.values())
                 for name in KERNELS}
        log(f"launches by path: {json.dumps(per_path)}; summed {total}")
        check_flat_pfn(pod, requests[0], card)
        # K1 at the KITTI pillar shape: the KITTI paths but VoxelNet's,
        # whose K1 runs at the dense canvas's shape (its own entry)
        pillar_kitti = {p: n for p, n in kitti_launches(kitti).items()
                        if p not in kitti["voxelnet"]["launches"]}
        k5 = phase_k5(second["fm_calls"]["voxel_mean"][0],
                      second["requests"], requests[0], pod.cfg,
                      second["pod"].cfg, total, card)
        phases = [phase_k1(k1_call, training["calls"]["pillar_gather"][0],
                           total["pillar_scatter"], total["pillar_gather"],
                           card),
                  phase_k1_kitti(kitti["serve"]["calls"]["pillar_scatter"][0],
                                 pillar_kitti, card),
                  phase_k2(k2_call, second["km_calls"]["rotated_iou"][0],
                           total["rotated_iou"], card),
                  phase_sparse_gemm("keymatch_gemm",
                                    second["km_calls"]["keymatch_gemm"],
                                    total["keymatch_gemm"], card),
                  phase_sparse_gemm("gather_gemm",
                                    second["gg_calls"]["gather_gemm"],
                                    total["gather_gemm"], card),
                  k5,
                  phase_sparse_gemm("gather_gemm_bf16",
                                    kitti["host"]["mixed"]["calls"],
                                    total["gather_gemm_bf16"], card),
                  phase_k1_bf16(mixed_pp["scatter_call"],
                                mixed_pp["gather_call"],
                                kitti["serve"]["calls"]["pillar_scatter"][0],
                                mixed_pp["launches"], card),
                  phase_sparse_gemm("keymatch_gemm_bf16",
                                    kitti["mixed_km"]["calls"],
                                    total["keymatch_gemm_bf16"], card,
                                    kitti["mixed_km"]["step_calls"]),
                  kitti["voxelnet"]["entry"]]
        # the joins' backward, shared by the two families: its numbers go
        # into both entries
        bw_fields, bw_fns, bw_ev = phase_join_backward(
            second_training["wcalls"], second_training["fcalls"],
            second_training["mcalls"], card)
        del (second_training["wcalls"], second_training["fcalls"],
             second_training["mcalls"])
        bw_counters = ["keymatch_rulebook", "rulebook_hits",
                       "join_grad_weights", "rulebook_inverse",
                       "join_grad_features"]
        for entry, fns, ev in phases[3:5]:
            entry.update(bw_fields, backward_counters=bw_counters,
                         backward_launches={c: total[c]
                                            for c in bw_counters})
            fns.update(bw_fns)
            ev.update(bw_ev)
        phases[0][0]["backward_counters"] = ["pillar_gather"]
        # each time in the kernels line is the median of its calls in
        # turns, with the event times (median, min, max) beside it under
        # *_event_ms
        kernels = time_entries(phases, per_path, card)
        launch_bound = [e for e in kernels
                        if e["name"] in ("pillar_scatter",
                                         "pillar_scatter@kitti",
                                         "pillar_scatter@bf16",
                                         "pillar_scatter@voxelnet",
                                         "voxel_mean")]
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
        k1_in_request(pod, requests[2], card)
        profile_call("bf16 pillar serving",
                     functools.partial(mixed_pp["pod"],
                                       *mixed_pp["requests"][2]), card,
                     mixed_pp["report"]["latency_ms"])
        with torch.enable_grad():
            profile_call("bf16 pillar training step", mixed_pp["step"], card,
                         mixed_pp["report"]["device_step_ms"][0])
        for what, key, lat in (("second key-match", "pod", "latency_ms"),
                               ("second gather-GEMM", "gg", "gg_latency_ms"),
                               ("second fused_mean", "fused",
                                "fm_latency_ms"),
                               ("second dynamic", "dyn", "dyn_latency_ms")):
            profile_call(what, functools.partial(second[key],
                                                 *second["requests"][2]),
                         card, second[lat])
        profile_kitti(kitti, card)
        # where an artifact's request spends its time against the eager
        # pod's: device busy and idle on the same request
        for what in ("pillar", "second key-match"):
            lat = exported["report"][what]["latency_ms"]
            for side, call in exported["calls"][what].items():
                profile_call(f"export {what}: {side}", call, card,
                             lat[side][0])
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
