"""What a ``--trace 1`` run records, from the benchmark's own files: CUDA
events and profiler ranges around the program's layers (its callables
wrapped from the outside), and one ``torch.profiler`` slice read back
from its Chrome trace.

Ranges are ``torch.profiler.record_function`` labels (``bench.request``,
``bench.voxelize``, ``bench.network``, ``bench.postprocess`` and each
per-layer metric's own, such as ``bench.k1``).  A device kernel belongs to
a range when the runtime call that launched it lies inside the range on
the same host thread.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def record(label: str):
    return torch.profiler.record_function(label)


def _shapes(args) -> list:
    return [tuple(a.shape) if isinstance(a, torch.Tensor) else a
            for a in args if isinstance(a, (torch.Tensor, int, float))]


@contextlib.contextmanager
def wrapped(targets, calls: Dict[str, list], collecting: List[bool]):
    """Wrap ``(module, attribute, label)`` callables in a profiler range;
    while ``collecting[0]`` holds, append each call's argument shapes to
    ``calls[label]``.  Restored on exit.  A target that is not there is
    skipped (its metric then finds nothing to read)."""
    undo = []
    try:
        for module_name, attr, label in targets:
            try:
                module = importlib.import_module(module_name)
                fn = getattr(module, attr)
            except (ImportError, AttributeError):
                continue

            def call(*args, __fn=fn, __label=label, **kw):
                if collecting[0]:
                    calls[__label].append(_shapes(args))
                with record(__label):
                    return __fn(*args, **kw)

            setattr(module, attr, call)
            undo.append((module, attr, fn))
        yield
    finally:
        for module, attr, fn in reversed(undo):
            setattr(module, attr, fn)


def profile_slice(run_requests) -> "Slice":
    """Run ``run_requests()`` under ``torch.profiler`` (CPU and CUDA) and
    read its Chrome trace back."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_requests()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return Slice(json.load(f))
    finally:
        os.remove(path)


class Slice:
    """A profiled slice: device activity, ranges and host events."""

    def __init__(self, trace: dict):
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        self.device = sorted(
            (float(e["ts"]), float(e["dur"]), e["name"],
             (e.get("args") or {}).get("correlation"))
            for e in events if e.get("cat") in DEVICE_CATS)
        launch = {}
        for e in events:
            corr = (e.get("args") or {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launch[corr] = (float(e["ts"]), e.get("tid"))
        self.ranges: Dict[str, List[Tuple[float, float, object]]] = \
            defaultdict(list)
        self.host: List[Tuple[float, float, str, object]] = []
        for e in events:
            if e.get("cat") == "user_annotation":
                self.ranges[e["name"]].append(
                    (float(e["ts"]), float(e["dur"]), e.get("tid")))
            if e.get("cat") in HOST_CATS:
                self.host.append((float(e["ts"]), float(e["dur"]),
                                  e["name"], e.get("tid")))
        for r in self.ranges.values():
            r.sort()
        self.launch_of = [launch.get(c) for _, _, _, c in self.device]
        req = self.ranges.get("bench.request", [])
        self.t0 = req[0][0] if req else None
        self.t1 = max(a + d for a, d, _ in req) if req else None
        self.main_tid = req[0][2] if req else None
        self.requests = len(req)

    @property
    def window_us(self) -> float:
        return (self.t1 - self.t0) if self.requests else 0.0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Merged device-busy intervals inside the window."""
        out: List[Tuple[float, float]] = []
        if not self.requests:
            return out
        for ts, dur, _, _ in self.device:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def device_us_in(self, label: str) -> Optional[float]:
        """Device time of the kernels launched inside ``label``'s ranges;
        None where the slice has no such range."""
        ranges = self.ranges.get(label)
        if not ranges:
            return None
        starts = [r[0] for r in ranges]
        total = 0.0
        for (ts, dur, _, _), launch in zip(self.device, self.launch_of):
            if launch is None:
                continue
            t, tid = launch
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= starts[i] + ranges[i][1] and \
                    ranges[i][2] == tid:
                total += dur
        return total

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for ts, dur, name, _ in self.device:
            if self.requests and self.t0 <= ts <= self.t1:
                by_name[name] += dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us * 1e-6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device work, each named by what the
        host thread was doing at its middle: the innermost ``bench.*``
        range and the innermost host event."""
        busy = self.busy_intervals()
        if not busy:
            return []
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        host = [h for h in self.host if h[3] == self.main_tid]
        out = []
        for length, a, b in gaps[:n]:
            mid = (a + b) / 2
            inside = [h for h in host if h[0] <= mid <= h[0] + h[1]]
            stage = min((h for h in inside if h[2].startswith("bench.")),
                        key=lambda h: h[1], default=None)
            inner = min(inside, key=lambda h: h[1], default=None)
            name = "|".join(x[2] for x in (stage, inner) if x is not None)
            out.append([name or "host: no event", length * 1e-6])
        return out


def mean_stage_ms(rec: dict, stage: str) -> Optional[float]:
    """A stage's mean device time a request over the traced window."""
    times = rec.get("stage_ms", {}).get(stage)
    return sum(times) / len(times) if times else None


class StageEvents:
    """CUDA events at a request's stage boundaries: start, voxelized,
    network done, detections done."""

    def __init__(self):
        self.requests: List[list] = []

    def mark(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.requests[-1].append(ev)

    def start(self) -> None:
        self.requests.append([])
        self.mark()

    def stage_ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        out: Dict[str, List[float]] = defaultdict(list)
        for evs in self.requests:
            if len(evs) != 4:
                continue
            for name, a, b in (("voxelize", 0, 1), ("network", 1, 2),
                               ("postprocess", 2, 3)):
                out[name].append(evs[a].elapsed_time(evs[b]))
        return dict(out)
