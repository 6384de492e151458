"""Runs one cell once and assembles its result line.

Everything is found by name: the cell ``benchmark/workloads/<cell>.json``
names its configuration (``benchmark/configs/<config>.json``), its traffic
mix (``benchmark/traffic/mixes/<traffic>.json``) and its entry (the module
``benchmark/<entry>.py``, whose ``run(ctx)`` drives the program); each
per-layer metric that ``BENCHMARK.json`` lists for the cell is read by
``benchmark/metrics/<metric>.py`` (``read(records)``, and the callables
it needs wrapped in ``TARGETS``).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import types
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "automatic_as_built_reconstruction_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(cell: str, base: Path = HERE) -> Dict[str, dict]:
    workload = load_json(base / "workloads" / f"{cell}.json")
    return {"workload": workload,
            "config": load_json(base / "configs"
                                / f"{workload['config']}.json"),
            "mix": load_json(base / "traffic" / "mixes"
                             / f"{workload['traffic']}.json")}


def _for_cell(entries: List[dict], cell: str) -> List[dict]:
    return [e for e in entries if cell in e.get("workloads", [cell])]


def load_reader(name: str, base: Path = HERE):
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name (before the
    first dot, whole) is JAX's or the JAX package's."""
    return sorted(n for n in (sys.modules if names is None else names)
                  if n.split(".", 1)[0] in FORBIDDEN)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device: str = "cuda", chips: int = 1,
             manifest: Optional[dict] = None,
             files: Optional[Dict[str, dict]] = None,
             program_factory=None, control: bool = False) -> dict:
    """One run -> its result line (a dict, ``checks`` last).  With
    ``control`` (a stand-in for the program, ``program_factory``) there
    is no warm-up."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    files = files or cell_files(cell)
    wl = files["workload"]
    e2e = [m["name"] for m in _for_cell(manifest["end_to_end"], cell)]
    layer = [m["name"] for m in _for_cell(manifest["per_layer"], cell)]
    readers = {name: load_reader(name) for name in layer} if trace else {}
    entry = importlib.import_module(f"benchmark.{wl['entry']}")
    ctx = types.SimpleNamespace(
        cell=cell, seed=int(seed), seconds=float(seconds), trace=trace,
        device=device, t0=t0, workload=wl, config=files["config"],
        mix=files["mix"],
        program_factory=program_factory or entry.build_program,
        control=control,
        wrap_targets=[t for r in readers.values()
                      for t in getattr(r, "TARGETS", ())])
    out = entry.run(ctx)

    limits = wl["check"]["limits"]
    # a number that could not be read (no answer, a non-finite gap)
    # fails as the largest float JSON carries
    checks = {name: {"value": value if math.isfinite(value) else 1e300,
                     "limit": limits[name]}
              for name, value in out["checks"].items()}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and out["failed"] == 0 and out["attempted"] > 0)
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": _device_name(device), "count": chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    units = {m["name"]: m["unit"]
             for m in manifest["end_to_end"] + manifest["per_layer"]}
    metrics: Dict[str, dict] = {}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if not trace:
        for name in e2e:
            metrics[name] = {"value": out["e2e"][name], "unit": units[name]}
    elif "records" in out:
        rec = out["records"]
        for name, reader in readers.items():
            value = reader.read(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        sl = rec["slice"]
        device_info["busy_s"] = sl.busy_us * 1e-6
        device_info["window_s"] = sl.window_us * 1e-6
        result["breakdown"] = {"device_ops": sl.top_ops(),
                               "idle_gaps": sl.idle_gaps()}
    result["checks"] = checks
    return result


def _device_name(device: str) -> str:
    if device == "cuda":
        import torch
        return torch.cuda.get_device_name()
    return device


def check_lines(result: dict) -> List[str]:
    """The numbers compared, each beside its limit (the last lines a run
    prints on standard error)."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for name, c in result["checks"].items()]
