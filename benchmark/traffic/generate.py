"""The one traffic generator: a mix file (``benchmark/traffic/mixes/<name>
.json``) and a seed -> the pool of distinct requests a run cycles.

A mix names its ``scene`` generator (``building_room``: one synthetic
room scan, 44-90 k points; ``kitti_like``: a street scan of ``points``
points), the ``batch`` of scans a request carries and the ``pool`` of
distinct requests.  Each scan gets its own scene seed drawn from the run's
seed; a request is its scans padded to the longest (``pad_batch``).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import scenes

SCENES = {
    "building_room": lambda seed, mix: scenes.generate_building_scene(seed),
    "kitti_like": lambda seed, mix: scenes.make_scene(seed,
                                                      int(mix["points"])),
}


def scene_seeds(mix: dict, seed: int) -> np.ndarray:
    """[pool, batch] scene seeds of a run."""
    rng = np.random.default_rng(int(seed))
    return rng.integers(0, 2**62, size=(int(mix["pool"]), int(mix["batch"])))


def make_requests(mix: dict, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """-> [(points [B, P, C] float32, num_valid [B] int32)] * pool."""
    make = SCENES[mix["scene"]]
    return [scenes.pad_batch([make(int(s), mix) for s in row])
            for row in scene_seeds(mix, seed)]
