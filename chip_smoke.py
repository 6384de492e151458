"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the toolchain (torch, CUDA, nvcc, triton, the card);
2. builds every kernel in ``automatic_as_built_reconstruction_tpu_torch/
   csrc/`` with nvcc (one process per source, all at once);
3. serves the as-built pillar detector (``asbuilt_pillars.config`` at full
   width, trained ``artifacts/asbuilt_r2_step8000.pkl``) through
   ``pod_inference_from_checkpoint``: four requests of two synthetic
   scans each (scenes 0-7), served twice over after a warm-up, with
   the kernels' launch counters set to 0 just before and read just
   after; reports the latency's median and range and the scans/s;
   checks the detections against the port's own CPU run (TF32 off for
   convolutions and matmuls) and against the detection counts the JAX
   package gives on scans 0 and 1;
4. serves SECOND (``car.fhd.serving.config`` at full width: 1408 x 1600 x
   40 voxels, the SpMiddleFHD stack, RPN 128, 70 400 anchors; weights and
   BatchNorm statistics drawn from a seed, there being no trained
   checkpoint) the same way: four requests of two 18 000-point scans
   each (scenes 1000-1007), twice over after a warm-up, in the config's
   key-match mode, and once over with ``sparse_keymatch=False`` (the
   gather-GEMM mode on device-built rulebooks), counters read for each;
   checks head outputs and detections against the port's own CPU run,
   the two modes against each other, the launch counts against the
   plan, and prints each block's ``capacity_saturated``;
5. holds each kernel against its plain PyTorch version on the card, on
   the inputs the serving runs gave it (for the rotated IoU also a
   1000 x 1000 set with degenerate boxes; for the two sparse GEMMs the
   largest and the smallest join, the four call forms of the key-match
   function, and unsorted keys); times kernel, plain version and library
   call with CUDA events (median and range) and with torch.profiler
   (device time, the ``ms`` it reports), L2 flushed before each call;
6. prints a ``{"kernels": [...]}`` line, the card's name and power limit
   as ``nvidia-smi`` reports them, and last ``{"ok": true, "device": ...}``.

Exits non-zero, with no result lines, when CUDA is unavailable or any
phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from automatic_as_built_reconstruction_tpu_torch.data.building import (
    generate_building_scene, pad_batch)
from automatic_as_built_reconstruction_tpu_torch.data.kitti_like import (
    make_scene)
from automatic_as_built_reconstruction_tpu_torch.models import (
    middle, pointpillars)
from automatic_as_built_reconstruction_tpu_torch.models.voxelnet import (
    VoxelNet, middle_plan, predict)
from automatic_as_built_reconstruction_tpu_torch.ops import (
    _build, nms, pillar_scatter, rotated_iou, sparse_gather_gemm)
from automatic_as_built_reconstruction_tpu_torch.ops.voxelize import voxelize
from automatic_as_built_reconstruction_tpu_torch.parallel import (
    PodInference, pod_inference_from_checkpoint)
from automatic_as_built_reconstruction_tpu_torch.parallel.inference import (
    detections_mismatch)

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
# SECOND: car.fhd.serving.config, its voxel caps, seeded state
SECOND_CONFIG = (ROOT / "automatic_as_built_reconstruction_tpu_torch"
                 / "configs" / "second" / "car" / "car.fhd.serving.config")
SECOND_MAX_VOXELS, SECOND_MAX_POINTS, SECOND_SEED = 17000, 5, 0
SECOND_REQUESTS = [(1000, 1001), (1002, 1003), (1004, 1005), (1006, 1007)]
# GPU vs CPU head outputs: 14 sparse / dense conv + BN layers and the
# RPN's 6, fp32 sums in another order on each side (FMA tap by tap in the
# kernels and cuDNN on the card; one matmul and oneDNN on the CPU)
HEAD_TOL = dict(rtol=5e-4, atol=5e-4)
# kernel vs plain on the card: up to 27 x 64 fp32 products summed tap by
# tap with FMA against one cuBLAS dot, on values of order 1
GEMM_ATOL = 1e-4
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
L2_FLUSH_BYTES = 64 << 20        # > the H100's 50 MB L2


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


def build_kernels() -> None:
    t0 = time.perf_counter()
    result = _build.build_all()
    per_source = ", ".join(f"{name} {r['seconds']:.1f} s"
                           for name, r in result.items())
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall ({per_source})")
    for name, r in result.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


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


def device_ms(fn, iters: int = 20):
    """Device time per call summed over the kernels ``fn`` launches
    (torch.profiler / CUPTI, one profiling window), L2 flushed before
    each call by a 64 MB device-to-device copy (left out of the sum): the
    card's own time without the host's launch overhead.  Returns
    (ms, {kernel: ms}), or (None, {}) when the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    src = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            dst.copy_(src)
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(("Memcpy", "Memset"))):
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3 / iters)
    if not per_kernel:
        return None, {}
    return sum(per_kernel.values()), per_kernel


def fmt_kernels(per_kernel: dict) -> str:
    return "; ".join(f"{name[:60]} {ms:.4f} ms"
                     for name, ms in sorted(per_kernel.items(),
                                            key=lambda kv: -kv[1]))


@contextlib.contextmanager
def recording(module, name: str, calls: list):
    """Record the arguments of every call to ``module.name``."""
    orig = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, orig)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

# the port's kernel wrappers, and where the serving path looks each one up
KERNELS = {"pillar_scatter": pillar_scatter.scatter_sorted_to_canvas,
           "rotated_iou": rotated_iou.rotate_iou_matrix,
           "keymatch_gemm": sparse_gather_gemm.keymatch_gemm,
           "gather_gemm": sparse_gather_gemm.gather_gemm}
CALL_SITES = {"pillar_scatter": (pointpillars, "scatter_sorted_to_canvas"),
              "rotated_iou": (nms, "rotate_iou_matrix"),
              "keymatch_gemm": (middle, "keymatch_gemm"),
              "gather_gemm": (middle, "gather_gemm")}


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
    with torch.no_grad():
        vox = voxelize(pts, nv, voxel_size=cfg.voxel_size,
                       pc_range=cfg.pc_range, grid_size=cfg.grid_size,
                       max_points=pod.max_points_per_voxel,
                       max_voxels=pod.max_voxels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        preds = pod.model(vox.voxels, vox.num_points, vox.coords)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        anchors = pod.anchors[None].expand(pts.shape[0], *pod.anchors.shape)
        predict(preds, anchors, cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    return {"voxelize": (t1 - t0) * 1e3, "network": (t2 - t1) * 1e3,
            "decode_nms": (t3 - t2) * 1e3}


def profile_request(what: str, pod, request, card: str,
                    latency_ms: float) -> None:
    """One request under torch.profiler: device busy time, its share of
    the profiled wall time and of the unprofiled request latency, and the
    kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pod(*request)
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
    busy = sum(per_kernel.values())
    log(f"{what} [{card}]: profiled request: wall {wall_ms:.3f} ms, device "
        f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} % of the profiled "
        f"wall, idle {100 - 100 * busy / wall_ms:.1f} %; "
        f"{100 * busy / latency_ms:.1f} % of the unprofiled median "
        f"latency {latency_ms:.3f} ms), {n} device events; top: "
        f"{fmt_kernels(dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]))}")


def serve(card: str):
    """The pillar path.  -> (pod, requests, median latency ms, launches,
    recorded K1 call, recorded K2 call)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("serving: torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False (full fp32)")
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
    cfg = pod.cfg
    pts = torch.as_tensor(request[0], device=pod.device)
    nv = torch.as_tensor(request[1], device=pod.device)
    with torch.no_grad():
        vox = voxelize(pts, nv, voxel_size=cfg.voxel_size,
                       pc_range=cfg.pc_range, grid_size=cfg.grid_size,
                       max_points=pod.max_points_per_voxel,
                       max_voxels=pod.max_voxels)
        preds = pod.model(vox.voxels, vox.num_points, vox.coords)
    return {k: v.float().cpu() for k, v in preds.items()}


def heads_mismatch(got: dict, ref: dict):
    """-> ({head: max abs difference}, first head outside HEAD_TOL)."""
    err = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
    bad = [k for k in ref if not torch.allclose(got[k], ref[k], **HEAD_TOL)]
    return err, (bad[0] if bad else None)


def serve_second(card: str):
    """The SECOND path in both sparse-conv modes.  -> dict with the pods,
    the requests, the median latency, launches and recorded kernel calls
    of each mode."""
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

    result = {"pod": pod, "gg": gg, "requests": requests}
    n = len(requests)
    outs, lat, result["km_launches"], result["km_calls"] = drive(
        "second key-match", card, pod, requests, ROUNDS,
        {"keymatch_gemm": joins * n * ROUNDS, "rotated_iou": None})
    gg_outs, gg_lat, result["gg_launches"], result["gg_calls"] = drive(
        "second gather-GEMM", card, gg, requests, 1,
        {"gather_gemm": joins * n, "rotated_iou": None})
    result["latency_ms"] = float(np.median(lat))
    result["gg_latency_ms"] = float(np.median(gg_lat))
    check_outputs("second", outs + gg_outs, pod)
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
    cpu_outs = [cpu(*req) for req in requests]
    for i, out in enumerate(outs):
        diff = detections_mismatch(out, cpu_outs[i % n], cfg.num_class,
                                   BOX_ATOL, SCORE_ATOL)
        if diff is not None:
            raise AssertionError(f"second request {i}, GPU vs CPU: {diff}")
    log(f"second: GPU detections match the port's CPU run on all "
        f"{len(outs)} requests (boxes atol {BOX_ATOL}, scores atol "
        f"{SCORE_ATOL}); CPU run {time.perf_counter() - t0:.1f} s")
    return result


# --------------------------------------------------------------------------
# kernels vs plain versions
# --------------------------------------------------------------------------

def phase_k1(call, launches: int, card: str):
    """-> (kernels-line entry with event times, {key: fn} to time on the
    device)."""
    (feats, lin, hw), _ = call
    B, V, C = feats.shape
    got = pillar_scatter.scatter_sorted_to_canvas(feats, lin, hw)
    ref = pillar_scatter.scatter_sorted_to_canvas_plain(feats, lin, hw)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("pillar_scatter kernel != plain version")
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
    fns = {"ms": lambda: pillar_scatter.scatter_sorted_to_canvas(
               feats, lin, hw),
           "plain_ms": lambda: pillar_scatter.scatter_sorted_to_canvas_plain(
               feats, lin, hw),
           "library_ms": library}
    ev = {k: cuda_ms(fn) for k, fn in fns.items()}
    # bytes this data needs: the occupied rows' features, every id, the
    # whole canvas written once
    nbytes = rows * C * 4 + B * V * 4 + B * hw * C * 4
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"K1 pillar_scatter [{card}]: B={B} V={V} C={C} hw={hw}, "
        f"{rows} occupied rows; kernel == plain exactly; events: kernel "
        f"{fmt_range(ev['ms'])}, plain {fmt_range(ev['plain_ms'])}, "
        f"index_copy_ {fmt_range(ev['library_ms'])}; bound "
        f"{bound_ms:.5f} ms ({nbytes} bytes)")
    entry = {"name": "pillar_scatter", "route": "cuda",
             "source": "automatic_as_built_reconstruction_tpu_torch/csrc/"
                       "pillar_scatter.cu",
             "replaces": "automatic_as_built_reconstruction_tpu/ops/pallas/"
                         "pillar_scatter.py:61",
             "launches": launches, "max_abs_err": 0.0,
             "bound_ms": bound_ms, "bound_by": "bytes"}
    return entry, fns, ev


def iou_cases(R: int, K: int, seed: int = 0) -> torch.Tensor:
    """[R, K, 5] building-scale boxes plus degenerate ones: coincident,
    zero-area pad boxes, thin boxes crossed at 90 degrees."""
    rng = np.random.default_rng(seed)
    b = np.concatenate([rng.uniform(0, 16, (R, K, 2)),
                        rng.uniform(0.05, 3.0, (R, K, 2)),
                        rng.uniform(-np.pi, np.pi, (R, K, 1))], -1)
    b[:, 1] = b[:, 0]
    b[:, 2] = [1e6, 1e6, 0.0, 0.0, 0.0]
    b[:, 3] = [5.0, 5.0, 0.0, 0.0, 0.3]
    b[:, 4] = [5.0, 5.0, 0.07, 0.95, 0.0]
    b[:, 5] = [5.0, 5.0, 0.07, 0.95, math.pi / 2]
    return torch.as_tensor(b, dtype=torch.float32, device="cuda")


def phase_k2(call, launches: int, card: str):
    """-> (kernels-line entry with event times, {key: fn} to time on the
    device)."""
    # 1) degenerate set at R=6, N=K=1000, every criterion
    boxes = iou_cases(6, 1000)
    zero_area_b = (boxes[..., 2] * boxes[..., 3] == 0)[:, None, :]
    worst = 0.0
    for criterion in (-1, 0, 1):
        got = rotated_iou.rotate_iou_matrix(boxes, boxes, criterion)
        ref = rotated_iou.rotate_iou_matrix_plain(boxes, boxes, criterion)
        torch.cuda.synchronize()
        # IoU over the union against a zero-area B is 0/0 (see
        # tests/test_torch_ops.py): held to the other criteria only
        mask = ~zero_area_b if criterion == -1 else torch.ones_like(got,
                                                                    dtype=bool)
        err = float((got - ref).abs()[mask.expand_as(got)].max())
        if not (err <= IOU_ATOL and torch.isfinite(got[mask.expand_as(got)])
                .all()):
            raise AssertionError(f"rotated_iou criterion {criterion}: max "
                                 f"abs err {err} > {IOU_ATOL}")
        worst = max(worst, err)
    log(f"K2 rotated_iou [{card}]: degenerate set R=6 N=K=1000, criteria "
        f"-1/0/1: kernel vs plain max abs err {worst:.3g}")
    # 2) the serving run's own input
    (a, q), _ = call
    R, N, K = a.shape[0], a.shape[1], q.shape[1]
    got = rotated_iou.rotate_iou_matrix(a, q)
    ref = rotated_iou.rotate_iou_matrix_plain(a, q)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= IOU_ATOL:
        raise AssertionError(f"rotated_iou main-path input: max abs err "
                             f"{err}")
    worst = max(worst, err)
    fns = {"ms": lambda: rotated_iou.rotate_iou_matrix(a, q),
           "plain_ms": lambda: rotated_iou.rotate_iou_matrix_plain(a, q)}
    ev = {"ms": cuda_ms(fns["ms"]),
          "plain_ms": cuda_ms(fns["plain_ms"], iters=10)}
    pairs = R * N * K
    # the arithmetic these boxes need and the bytes: the larger bounds it
    flops = rotated_iou.clip_flops(a, q)
    ops_ms = flops / PEAK_FP32_PER_S * 1e3
    bytes_ms = ((R * N + R * K) * 5 * 4 + pairs * 4) / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    big = cuda_ms(lambda: rotated_iou.rotate_iou_matrix(boxes, boxes))
    big_flops = rotated_iou.clip_flops(boxes, boxes)
    log(f"K2 rotated_iou [{card}]: main-path input R={R} N={N} K={K}: max "
        f"abs err {err:.3g}; events: kernel {fmt_range(ev['ms'])}, plain "
        f"{fmt_range(ev['plain_ms'])}; bound {bound_ms:.5f} ms (ops "
        f"{ops_ms:.5f}: {flops} fp32 flops, {flops / pairs:.2f} a pair; "
        f"bytes {bytes_ms:.5f}); degenerate set R=6 N=K=1000: kernel "
        f"{fmt_range(big)}, {big_flops / 6e6:.2f} flops a pair, ops bound "
        f"{big_flops / PEAK_FP32_PER_S * 1e3:.5f} ms")
    entry = {"name": "rotated_iou", "route": "cuda",
             "source": "automatic_as_built_reconstruction_tpu_torch/csrc/"
                       "rotated_iou.cu",
             "replaces": "automatic_as_built_reconstruction_tpu/ops/pallas/"
                         "rotated_iou_pallas.py:158",
             "launches": launches, "max_abs_err": worst,
             "bound_ms": bound_ms,
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "library_ms": None}
    return entry, fns, ev


def join_shape(call) -> str:
    (feats, _, table, w, *_), _ = call
    return (f"B={feats.shape[0]} N={feats.shape[1]} R={table.shape[-1]} "
            f"K={w.shape[0]} Cin={w.shape[1]} Cout={w.shape[2]}")


def phase_sparse_gemm(name: str, calls: list, launches: int, card: str):
    """``keymatch_gemm`` or ``gather_gemm`` against its plain version on
    the joins the serving run's warm-up request gave it.  -> (kernels-line
    entry with event times, {key: fn} to time on the device)."""
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

    largest = max(calls, key=work)
    smallest = next(c for c in calls
                    if tuple(operands(c)[3].shape) == (27, 16, 16))
    worst = 0.0
    for call in calls:          # every join of the request
        err, scale = check(call)
        worst = max(worst, err)
        log(f"{name} [{card}]: {join_shape(call)}: kernel vs plain max abs "
            f"err {err:.3g} (values up to {scale:.3g})")

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

    def bound(call):
        feats, a, b, w = operands(call)
        B, R, Cout = feats.shape[0], b.shape[-1], w.shape[2]
        if keymatch:
            hits = sparse_gather_gemm.count_hits(a, b)
        else:
            hits = int(b.sum())
        nbytes = sum(t.numel() * t.element_size()
                     for t in (feats, a, b, w)) + B * R * Cout * 4
        flops = 2 * hits * w.shape[1] * Cout
        return (hits, nbytes, flops, nbytes / PEAK_BYTES_PER_S * 1e3,
                flops / PEAK_FP32_PER_S * 1e3)

    fns = {"ms": lambda: kernel(*largest[0]),
           "plain_ms": lambda: plain(*operands(largest))}
    ev = {"ms": cuda_ms(fns["ms"], iters=20),
          "plain_ms": cuda_ms(fns["plain_ms"], iters=5, warmup=1)}
    hits, nbytes, flops, bytes_ms, ops_ms = bound(largest)
    taps = operands(largest)[2].numel()
    log(f"{name} [{card}]: largest join {join_shape(largest)}: {hits} hits "
        f"of {taps} (tap, row) pairs ({100 * hits / taps:.1f} %); events: "
        f"kernel {fmt_range(ev['ms'])}, plain {fmt_range(ev['plain_ms'])}; "
        f"bound {max(ops_ms, bytes_ms):.5f} ms (ops {ops_ms:.5f}: {flops} "
        f"needed fp32 flops; bytes {bytes_ms:.5f}: {nbytes})")
    s_hits, s_bytes, s_flops, s_bytes_ms, s_ops_ms = bound(smallest)
    s_ev = cuda_ms(lambda: kernel(*smallest[0]), iters=20)
    s_dev, _ = device_ms(lambda: kernel(*smallest[0]))
    log(f"{name} [{card}]: smallest join {join_shape(smallest)}: {s_hits} "
        f"hits; events: kernel {fmt_range(s_ev)}; device "
        f"{'not measured' if s_dev is None else f'{s_dev:.5f} ms'}; bound "
        f"{max(s_ops_ms, s_bytes_ms):.5f} ms (ops {s_ops_ms:.5f}, bytes "
        f"{s_bytes_ms:.5f})")
    line = {"keymatch_gemm": 1098, "gather_gemm": 331}[name]
    entry = {"name": name, "route": "cuda",
             "source": "automatic_as_built_reconstruction_tpu_torch/csrc/"
                       "sparse_gather_gemm.cu",
             "replaces": "automatic_as_built_reconstruction_tpu/ops/pallas/"
                         f"sparse_gather_gemm.py:{line}",
             "launches": launches, "max_abs_err": worst,
             "shape": join_shape(largest), "hits": hits,
             "bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "library_ms": None}
    return entry, fns, ev


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
        build_kernels()
        pod, requests, latency_ms, launches, k1_call, k2_call = serve(card)
        second = serve_second(card)
        km, gg = second["km_launches"], second["gg_launches"]
        iou_launches = (launches["rotated_iou"] + km["rotated_iou"]
                        + gg["rotated_iou"])
        log(f"rotated_iou launches: pillar path {launches['rotated_iou']}, "
            f"second key-match {km['rotated_iou']}, second gather-GEMM "
            f"{gg['rotated_iou']}")
        phases = [phase_k1(k1_call, launches["pillar_scatter"], card),
                  phase_k2(k2_call, iou_launches, card),
                  phase_sparse_gemm("keymatch_gemm",
                                    second["km_calls"]["keymatch_gemm"],
                                    km["keymatch_gemm"], card),
                  phase_sparse_gemm("gather_gemm",
                                    second["gg_calls"]["gather_gemm"],
                                    gg["gather_gemm"], card)]
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
            entry["ms_from"] = ("torch.profiler device time" if measured
                                else "cuda events (median)")
            kernels.append(entry)
        profile_request("serving", pod, requests[2], card, latency_ms)
        profile_request("second key-match", second["pod"],
                        second["requests"][2], card, second["latency_ms"])
        profile_request("second gather-GEMM", second["gg"],
                        second["requests"][2], card,
                        second["gg_latency_ms"])
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
