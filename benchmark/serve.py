"""The ``serve`` entry: one client in a closed loop calls the program's
serving entry, ``PodInference.__call__`` (built as
``pod_inference_from_checkpoint`` builds it), on a pool of distinct
requests, sending the next when the last answer is back.

Set-up builds the program and the requests, and serves every request of
the pool once.  The window then runs for ``--seconds``: each request's
latency runs from the call until its host answer returns, and the window
ends with the first answer after ``--seconds`` once every request of the
pool has been served in it.  For the sampled requests
(drawn from the seed) the answer of their last call in the window is kept
with what the program's voxelization and network gave for it, taken from
the same call.  Once the window has closed and the program is freed, the
reference judges them stage by stage:

- ``vox_mismatch``: voxels, point counts or coordinates that differ from
  the reference's voxelization of the same points (exact);
- ``head_gap``: the largest gap of a head map from the reference network's
  (run on the reference's voxels), over the head's largest magnitude;
- ``det_unmatched_pct``: detections of the program that the reference's
  decode and NMS, run on the program's own head maps, does not give
  (per scan and class, boxes within 1e-3, scores within 1e-4), and the
  reference's that the program does not, as a share of both.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import numpy as np
import torch

from . import tracing, weights as bench_weights
from .reference import compare, network, postprocess, voxelize
from .traffic import generate

PKG = "automatic_as_built_reconstruction_tpu_torch"
POSTPROCESS = (f"{PKG}.models.voxelnet", "predict", "bench.postprocess")


def build_program(config: dict, weights: Dict[str, torch.Tensor], device):
    """The program's serving pod for a configuration file."""
    from automatic_as_built_reconstruction_tpu_torch.parallel import inference
    vox = config["model"]["voxel"]
    kw = dict(device=device, max_voxels=int(vox["max_voxels"]),
              max_points_per_voxel=int(vox["max_points"]))
    path = config["program"]["serve"]
    if config["weights"].get("seeded"):
        model, cfg, anchors = inference.build_from_config(path)
        model.load_state_dict(weights, strict=True)
        return inference.PodInference(model, cfg, anchors, **kw)
    return inference.pod_inference_from_checkpoint(
        path, config["weights"]["checkpoint"], **kw)


class Taps:
    """The pod's stages wrapped from the outside: the sampled requests'
    voxels and head maps kept; in a traced run, profiler ranges and CUDA
    events at the stage boundaries."""

    def __init__(self, pod, trace: bool):
        self.current = None
        self.sample: set = set()
        self.kept: Dict[int, dict] = {}
        self.events = tracing.StageEvents() if trace else None
        voxelize_fn, forward_fn = pod.voxelize, pod.model.forward
        program_fn = pod.program

        def voxelize_stage(pts, nv):
            if self.events is not None:
                self.events.start()
            with tracing.record("bench.voxelize"):
                out = voxelize_fn(pts, nv)
            if self.events is not None:
                self.events.mark()
            if self.current in self.sample:
                self.kept.setdefault(self.current, {})["voxels"] = out
            return out

        def network_stage(*args, **kw):
            with tracing.record("bench.network"):
                out = forward_fn(*args, **kw)
            if self.events is not None:
                self.events.mark()
            if self.current in self.sample:
                self.kept.setdefault(self.current, {})["heads"] = out
            return out

        def program(pts, nv):
            out = program_fn(pts, nv)
            if self.events is not None:
                self.events.mark()
            return out

        pod.voxelize = voxelize_stage
        pod.model.forward = network_stage
        pod.program = program


def well_formed(out: dict, B: int, C: int, D: int) -> bool:
    boxes = out.get("box3d_lidar")
    return (boxes is not None and boxes.shape == (B, C * D, 7)
            and out["valid"].shape == (B, C * D)
            and bool(np.isfinite(boxes[out["valid"]]).all()))


def run(ctx) -> dict:
    config, model, mix = ctx.config, ctx.config["model"], ctx.mix
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    marks = [("start", time.perf_counter() - ctx.t0)]
    requests = generate.make_requests(mix, ctx.seed)
    marks.append(("requests", time.perf_counter() - ctx.t0))
    # the program reads a checkpoint itself; drawn weights (and the
    # control, which is the reference) are handed to it
    weights = (bench_weights.cell_weights(config, ctx.seed, dev)
               if config["weights"].get("seeded") or ctx.control else None)
    pod = ctx.program_factory(config, weights, dev)
    marks.append(("program", time.perf_counter() - ctx.t0))
    taps = Taps(pod, ctx.trace and cuda)
    targets = list(ctx.wrap_targets) + [POSTPROCESS]
    calls, collecting = {t[2]: [] for t in targets}, [False]
    B = int(mix["batch"])
    C, D = model["head"]["num_class"], model["post"]["nms_post_max_size"]
    rng = np.random.default_rng(int(ctx.seed) + 1)
    sample = sorted(rng.choice(len(requests),
                               int(ctx.workload["check"]["requests"]),
                               replace=False).tolist())
    result = {"attempted": 0, "failed": 0}
    with tracing.wrapped(targets, calls, collecting):
        for k, req in enumerate([] if ctx.control else requests):
            taps.current = k                        # every shape, once
            pod(*req)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - ctx.t0
        marks.append(("warm-up", setup_s))
        print("set-up s: " + ", ".join(f"{n} {t:.2f}" for n, t in marks),
              file=sys.stderr)
        if cuda:
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        if taps.events is not None:
            taps.events.requests.clear()
        taps.sample, taps.kept = set(sample), {}
        answers, lat, served = {}, [], []
        t_start = time.perf_counter()
        deadline = t_start + ctx.seconds
        i = 0
        while True:
            k = i % len(requests)
            taps.current = k
            t = time.perf_counter()
            with tracing.record("bench.request"):
                out = pod(*requests[k])
            t1 = time.perf_counter()
            lat.append((t1 - t) * 1e3)
            served.append(k)
            result["attempted"] += 1
            if not well_formed(out, B, C, D):
                result["failed"] += 1
            if k in taps.sample:
                answers[k] = out
            i += 1
            if t1 >= deadline and i >= len(requests):
                break
        window_s = t1 - t_start
        taps.sample = set()
        rec = None
        if ctx.trace and cuda:
            stage_ms = taps.events.stage_ms()
            taps.events = None
            collecting[0] = True
            n_prof = int(ctx.workload.get("profile_requests", len(requests)))
            prof_served = []

            def slice_requests():
                for j in range(n_prof):
                    prof_served.append(j % len(requests))
                    with tracing.record("bench.request"):
                        pod(*requests[j % len(requests)])

            trace_slice = tracing.profile_slice(slice_requests)
            collecting[0] = False
            rec = dict(stage_ms=stage_ms, slice=trace_slice, calls=calls,
                       slice_served=prof_served)
        if cuda:
            torch.cuda.synchronize()
            window_peak = torch.cuda.max_memory_allocated(dev)
    kept = taps.kept
    del pod, taps, weights
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result["memory_peak_bytes"] = (max(setup_peak, window_peak) if cuda
                                   else 0)
    ref_weights = bench_weights.cell_weights(config, ctx.seed, dev)
    result["checks"] = judge(config, requests, sample, kept, answers,
                             ref_weights, dev)
    q = np.percentile(lat, [5, 50, 95, 99])
    print(f"window: {len(lat)} requests in {window_s:.3f} s; latency ms "
          f"p5 {q[0]:.3f} p50 {q[1]:.3f} p95 {q[2]:.3f} p99 {q[3]:.3f} "
          f"max {max(lat):.3f}", file=sys.stderr)
    result["e2e"] = {
        "setup_s": setup_s,
        "scans_per_s": B * len(lat) / window_s,
        "latency_p95_ms": float(np.percentile(lat, 95)),
    }
    if rec is not None:
        rec.update(window_s=window_s, served=served, batch=B,
                   window_peak_bytes=window_peak, model=model,
                   work=work_counts(config, requests, ref_weights, dev))
        result["records"] = rec
    return result


def judge(config, requests, sample, kept, answers, w,
          dev) -> Dict[str, float]:
    """The reference's stage-by-stage comparison of the kept requests
    (``w``: the reference's weights)."""
    model = config["model"]
    v = model["voxel"]
    n_vox = 0
    gap = 0.0
    unmatched = total = 0
    stats = {"ties": 0}
    for k in sample:
        got = kept.get(k, {})
        if "voxels" not in got or "heads" not in got or k not in answers:
            return {"vox_mismatch": float("inf"), "head_gap": float("inf"),
                    "det_unmatched_pct": 100.0}
        pts, nv = requests[k]
        ref_vox = voxelize.voxelize(
            torch.as_tensor(pts, device=dev), nv, pc_range=v["pc_range"],
            voxel_size=v["voxel_size"], max_points=v["max_points"],
            max_voxels=v["max_voxels"])
        n_vox += compare.voxel_mismatch(got["voxels"], ref_vox)
        ref_heads = network.heads(ref_vox, model, w)
        gap = max(gap, compare.head_gap(got["heads"], ref_heads))
        del ref_heads
        ref_dets = postprocess.predict(got["heads"], model,
                                       follow=answers[k], stats=stats)
        u, t = compare.unmatched(answers[k], ref_dets,
                                 model["head"]["num_class"])
        unmatched, total = unmatched + u, total + t
    print(f"compared {len(sample)} requests: {total} detections of both "
          f"sides, {unmatched} without a partner, {stats['ties']} NMS "
          f"decisions"
          f" within rounding of a threshold", file=sys.stderr)
    return {"vox_mismatch": float(n_vox), "head_gap": gap,
            "det_unmatched_pct": 100.0 * unmatched / max(total, 1)}


def work_counts(config, requests, w, dev) -> list:
    """Per pool request, what its work needs, from the reference (``w``:
    its weights): points in kept voxels, voxels, per sparse convolution
    (hits, Cin, Cout) summed over the scans, and per scan and class the
    candidates NMS weighs."""
    model = config["model"]
    v = model["voxel"]
    out = []
    for pts, nv in requests:
        vox = voxelize.voxelize(
            torch.as_tensor(pts, device=dev), nv, pc_range=v["pc_range"],
            voxel_size=v["voxel_size"], max_points=v["max_points"],
            max_voxels=v["max_voxels"])
        item = {"points": int(vox.num_points.sum()),
                "voxels": int((vox.coords[..., 0] >= 0).sum()),
                "scans": len(nv),
                "nms_candidates": postprocess.candidate_counts(
                    network.heads(vox, model, w), model)}
        if model["middle"]["kind"] == "sparse":
            item["sparse"] = network.sparse_hits(vox.coords, model)
        out.append(item)
    return out
