"""Small cells for the CPU tests: the real harness on the CPU, with the
configuration files of ``data/``."""
import json
import time
from pathlib import Path

from benchmark import harness

DATA = Path(__file__).resolve().parent / "data"
LIMITS = {"vox_mismatch": 0, "head_gap": 1e-4, "det_unmatched_pct": 1.0}
TINY_ROOMS = {"scene": "building_room", "batch": 2, "pool": 2}
SMALL_STREET = {"scene": "kitti_like", "points": 2500, "batch": 1,
                "pool": 1}


def files(config: str, mix: dict) -> dict:
    requests = min(2, mix["pool"])
    return {"workload": {"config": config, "traffic": "test",
                         "entry": "serve", "chips": 1,
                         "check": {"requests": requests,
                                   "limits": dict(LIMITS)}},
            "config": json.loads((DATA / f"{config}.json").read_text()),
            "mix": mix}


def run(config: str, mix: dict, seed: int = 5, seconds: float = 3.0,
        **kw) -> dict:
    return harness.run_cell("test", seed, seconds, False,
                            t0=time.perf_counter(), device="cpu",
                            manifest=harness.load_json(
                                harness.ROOT / "BENCHMARK.json"),
                            files=files(config, mix), **kw)
